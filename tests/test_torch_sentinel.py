"""The port's SDC sentinel against the JAX package's, on the CPU.

The same numpy trees through both packages: ``tree_digest`` within 1e-6 of
each other, the per-shard digests of ``cross_replica_digests`` as the JAX
package's ``shard_map`` computes them; the same trip kinds from
``Sentinel`` (``nan_loss``, ``nonfinite``, ``norm_spike``,
``replica_divergence``, ``oracle_mismatch``) and ``StageDigests``
(``stage_digest``, ``shard_divergence``) on the same observations, with the
same detail text; ``inject_bit_flip`` flipping the same element of the same
leaf for the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cuda_mpi_gpu_cluster_programming_tpu.resilience import sentinel as jsen
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import sentinel as tsen
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_leaves


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    return [
        {"a": rng.standard_normal(17).astype(np.float32), "b": rng.random((3, 4), dtype=np.float32)},
        {"conv1": {"w": (rng.random((11, 11, 3, 8), dtype=np.float32) - 0.5), "b": np.zeros(8, np.float32)},
         "conv2": {"w": rng.standard_normal((5, 5, 8, 16)).astype(np.float32), "b": rng.random(16, dtype=np.float32)}},
        [rng.random((2, 9, 9, 5), dtype=np.float32) * 30.0, -rng.random(7, dtype=np.float32)],
    ]


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _trip(fn):
    with pytest.raises(Exception) as ei:
        fn()
    return ei.value


# ------------------------------------------------------------- digests ---


@pytest.mark.parametrize("i", range(3))
def test_tree_digest_is_the_jax_packages(i):
    tree = _trees()[i]
    want = float(jsen.tree_digest(jax.tree.map(jnp.asarray, tree)))
    got = tsen.tree_digest(_torch(tree))
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-6)
    # any change moves it: a sign flip, a swap
    flipped = _torch(tree)
    tree_leaves(flipped)[-1].view(-1)[1] *= -1
    assert float(tsen.tree_digest(flipped)) != float(got)


def test_cross_replica_digests_are_the_jax_packages():
    rows = np.tile(np.arange(16.0, dtype=np.float32)[None], (8, 1))
    rows[3, 5] += 7.0  # one replica drifts
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("dp",))
    want = np.asarray(jsen.cross_replica_digests(jnp.asarray(rows), mesh, "dp"), np.float64)
    got = tsen.cross_replica_digests(torch.from_numpy(rows), 8)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(got.max() - got.min()) > 0.0
    clean = torch.ones((8, 4))
    assert float(tsen.replica_spread(list(clean.chunk(8)))) == 0.0
    assert float(tsen.replica_spread([clean[0], clean[1] + 1])) > 0.0


def test_replicated_shard_spread_compares_the_copies():
    t = torch.ones((4, 4))
    assert tsen.replicated_shard_spread({"w": tsen.Replicas([t, t.clone(), t.clone()])}) == 0.0
    assert tsen.replicated_shard_spread({"w": t}) == 0.0  # one copy: nothing to compare, as a single-device leaf
    bad = t.clone()
    bad[1, 1] = 5.0
    assert tsen.replicated_shard_spread({"w": tsen.Replicas([t, bad])}) == pytest.approx(4.0)
    s = tsen.Sentinel()
    e = _trip(lambda: s.check_divergence(3, {"w": tsen.Replicas([t, bad])}))
    assert isinstance(e, tsen.SDC) and e.kind == "replica_divergence" and e.step == 3


# ------------------------------------------------------------- sentinel ---


def test_sentinel_trips_are_the_jax_packages():
    """The same observation sequence through both sentinels trips the same
    kinds at the same steps with the same detail."""
    cfg = dict(window=4, warmup=2, spike_factor=1e3)
    js, ts = jsen.Sentinel(jsen.SentinelConfig(**cfg)), tsen.Sentinel(tsen.SentinelConfig(**cfg))
    for step, (v, name) in enumerate([(1.0, "loss"), (0.9, "loss"), (0.8, "loss"), (1e6, "loss"),
                                      (float("nan"), "loss"), (float("inf"), "grad_norm"), (0.7, "loss")]):
        try:
            want = js.check_scalar(step, v, name)
        except jsen.SDC as je:
            te = _trip(lambda: ts.check_scalar(step, v, name))
            assert (te.kind, te.step, str(te)) == (je.kind, je.step, str(je))
        else:
            assert ts.check_scalar(step, v, name) == want
    assert [t.kind for t in ts.trips] == [t.kind for t in js.trips] == ["norm_spike", "nan_loss", "nonfinite"]


@pytest.mark.parametrize("i", range(3))
def test_check_tree_norm_and_trips_are_the_jax_packages(i):
    tree = _trees()[i]
    js, ts = jsen.Sentinel(), tsen.Sentinel()
    want = js.check_tree(0, jax.tree.map(jnp.asarray, tree))
    assert ts.check_tree(0, _torch(tree)) == pytest.approx(want, rel=1e-6)
    bad = _torch(tree)
    tree_leaves(bad)[-1].view(-1)[0] = float("nan")
    je = _trip(lambda: jsen.Sentinel().check_tree(1, jax.tree.map(lambda t: jnp.asarray(t.numpy()), bad)))
    te = _trip(lambda: tsen.Sentinel().check_tree(1, bad))
    assert (te.kind, str(te)) == (je.kind, str(je))


def test_oracle_check_passes_on_the_cpu_and_trips_when_corrupt(monkeypatch):
    assert tsen.oracle_spot_check(device="cpu") < 1e-3
    s = tsen.Sentinel(tsen.SentinelConfig(oracle_every=2))
    s.check_tree(0, {"w": torch.ones(3)})
    assert tsen.oracle_spot_check(device="cpu", _corrupt=True) == pytest.approx(1.0, abs=1e-3)
    real = tsen.oracle_spot_check
    monkeypatch.setattr(tsen, "oracle_spot_check", lambda tol, device: real(tol, _corrupt=True, device=device))
    e = _trip(lambda: s.check_tree(1, {"w": torch.ones(3)}))
    assert isinstance(e, tsen.SDC) and e.kind == "oracle_mismatch"


# --------------------------------------------------------- stage digests ---


@pytest.mark.parametrize("case", ["nonfinite", "replicated", "expect", "clean"])
def test_stage_digest_trips_are_the_jax_packages(case):
    digs = {"conv1": np.ones(4), "conv2": np.array([1.0, 2.0, 2.0, 1.0]), "out": np.full(4, 5.0)}
    kw = {}
    if case == "nonfinite":
        digs["conv2"] = np.array([1.0, np.nan, 1.0, 1.0])
    elif case == "replicated":
        digs = {"out": np.array([5.0, 5.0, 5.0, 5.5])}
        kw = dict(replicated=True)
    elif case == "expect":
        kw = dict(expect={"out": np.array([5.0, 5.0, 5.0, 5.1])}, rtol=1e-3)
    jc, tc = jsen.StageDigests(site="sp"), tsen.StageDigests(site="sp")
    tdigs = {k: torch.from_numpy(v.astype(np.float32)) for k, v in digs.items()}
    if case == "clean":
        host = tc.check(0, tdigs)
        assert {k: v.tolist() for k, v in host.items()} == {k: v.tolist() for k, v in jc.check(0, digs).items()}
        assert tc.trips == []
        return
    je = _trip(lambda: jc.check(3, digs, **kw))
    te = _trip(lambda: tc.check(3, tdigs, **kw))
    assert (te.kind, te.step, str(te)) == (je.kind, je.step, str(je))
    assert tc.trips == [te]


# ---------------------------------------------------------------- bit flip ---


@pytest.mark.parametrize("seed", range(4))
def test_inject_bit_flip_flips_the_jax_packages_element(seed):
    tree = _trees(1)[1]
    jtree, jloc = jsen.inject_bit_flip(jax.tree.map(jnp.asarray, tree), seed=seed)
    ttree, tloc = tsen.inject_bit_flip(_torch(tree), seed=seed)
    assert tloc == jloc is not None
    for a, b in zip(tree_leaves(ttree), jax.tree.leaves(jtree)):
        assert np.array_equal(a.numpy().view(np.uint32), np.asarray(b).view(np.uint32))
    changed = sum(int((a != torch.from_numpy(np.array(b))).sum())
                  for a, b in zip(tree_leaves(ttree), tree_leaves(_torch(tree))))
    assert changed == 1
    with pytest.raises(tsen.SDC):
        s = tsen.Sentinel()
        s.check_tree(0, _torch(tree))
        s.check_tree(1, _torch(tree))
        s.check_tree(2, ttree)
