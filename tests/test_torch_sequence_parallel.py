"""The port's ring and Ulysses attention (``parallel/sequence_parallel.py``)
against the JAX package's, on the CPU.

The same q, k, v, made with numpy from a seed, go through the JAX
package's ``ring_attention``/``ulysses_attention`` on its virtual 8-device
CPU mesh (its flash engine's Pallas kernel in interpret mode, as its own
tests run it) and through the port's over a mesh of CPU slots, where the
flash engine runs the plain versions of the flash kernels. The gradients
are in ``tests/test_torch_sequence_parallel_grads.py``.

Tolerances and why:
- fp32: 1e-5 abs and rel. Both sides are exact attention in fp32 summed in
  other orders (the JAX package holds each to its oracle at 2e-5; the
  two sides measure within 1e-6 of each other here).
- bf16: 3e-2 abs and rel, the JAX package's bf16 tolerance: the same bf16
  inputs, one fp32 result rounded once to bf16 on each side.
- digests: rtol 1e-5, the fp32 rule on a sum of a block's values.
- validation: the same message, word for word, raised before any work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.parallel import sequence_parallel as jsp
from cuda_mpi_gpu_cluster_programming_tpu.parallel.mesh import make_mesh as jmake_mesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import halo
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import sequence_parallel as tsp
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.mesh import make_mesh

FNS = {"ring": (jsp.ring_attention, tsp.ring_attention), "ulysses": (jsp.ulysses_attention, tsp.ulysses_attention)}
TOL = {"fp32": 1e-5, "bf16": 3e-2}


def _qkv(seed, shape=(2, 64, 8, 16)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]


def _both(arrays, dtype="fp32"):
    """The arrays as JAX arrays and as CPU tensors of one dtype (bf16: the same rounding of the fp32 draws)."""
    if dtype == "bf16":
        return [jnp.asarray(a, jnp.bfloat16) for a in arrays], [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _sp_mesh():
    """The (sp, tp) = (4, 2) meshes of the JAX package's sp x tp tests."""
    return (jmake_mesh(2, axis_name="tp", dp=4, dp_axis_name="sp"),
            make_mesh(2, axis_name="tp", dp=4, dp_axis_name="sp", device="cpu"))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("engine", ["einsum", "flash"])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_matches_the_jax_package(strategy, engine, n, causal):
    jfn, tfn = FNS[strategy]
    (jq, jk, jv), (q, k, v) = _both(_qkv(21))
    want = jax.jit(lambda q, k, v: jfn(q, k, v, n_shards=n, causal=causal, engine=engine))(jq, jk, jv)
    got = tfn(q, k, v, n_shards=n, causal=causal, engine=engine, mesh=make_mesh(n, device="cpu"))
    assert got.dtype == torch.float32
    _close(got, want, TOL["fp32"])


@pytest.mark.parametrize("engine", ["einsum", "flash"])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_bf16_matches_the_jax_package(strategy, engine):
    jfn, tfn = FNS[strategy]
    (jq, jk, jv), (q, k, v) = _both(_qkv(23), "bf16")
    want = jax.jit(lambda q, k, v: jfn(q, k, v, n_shards=4, causal=True, engine=engine))(jq, jk, jv)
    got = tfn(q, k, v, n_shards=4, causal=True, engine=engine)  # the default mesh: 4 slots on q's device
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL["bf16"])


@pytest.mark.parametrize("engine", ["einsum", "flash"])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_head_axis_on_an_sp_by_tp_mesh(strategy, engine):
    """sp x tp: heads split over "tp", the sequence over "sp" inside each head group."""
    jfn, tfn = FNS[strategy]
    jmesh, mesh = _sp_mesh()
    (jq, jk, jv), (q, k, v) = _both(_qkv(41, (2, 64, 8, 16)))
    kw = dict(n_shards=4, causal=True, engine=engine, head_axis="tp")
    want = jax.jit(lambda q, k, v: jfn(q, k, v, mesh=jmesh, **kw))(jq, jk, jv)
    halo.reset_collectives()
    got = tfn(q, k, v, mesh=mesh, **kw)
    _close(got, want, TOL["fp32"])
    # one SPMD operation a rotation or reshard, whatever the number of head groups
    want_c = {"ppermute": 8} if strategy == "ring" else {"all_to_all": 4}
    assert halo.COLLECTIVES == {**dict.fromkeys(halo.COLLECTIVES, 0), **want_c}


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_with_digests_are_the_jax_packages(strategy):
    jfn, tfn = FNS[strategy]
    (jq, jk, jv), (q, k, v) = _both(_qkv(5))
    want_out, want = jax.jit(lambda q, k, v: jfn(q, k, v, n_shards=4, causal=True, with_digests=True))(jq, jk, jv)
    got_out, got = tfn(q, k, v, n_shards=4, causal=True, with_digests=True, mesh=make_mesh(4, device="cpu"))
    _close(got_out, want_out, TOL["fp32"])
    assert set(got) == {"qkv", "out"}
    for key in ("qkv", "out"):
        assert got[key].shape == (4,) and got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5)


def _validation_cases():
    def q(l=64, h=8):
        return (2, l, h, 16)

    return [
        ("ring", q(l=63), dict(n_shards=8)),
        ("ulysses", q(l=63), dict(n_shards=8)),
        ("ulysses", q(h=6), dict(n_shards=4)),
        ("ring", q(), dict(n_shards=4, engine="warp")),
        ("ulysses", q(), dict(n_shards=4, engine="warp")),
        ("ring", q(l=320), dict(n_shards=2, engine="flash")),  # a per-shard block of 160 against the 128 block
        ("ulysses", q(l=320), dict(n_shards=8, engine="flash")),
        ("ring", q(), dict(n_shards=4, head_axis="tp")),  # head_axis without a mesh
        ("ring", q(l=128, h=5), dict(n_shards=4, head_axis="tp", mesh="sp_tp")),
        ("ring", q(l=128), dict(n_shards=4, head_axis="ep", mesh="sp_tp")),
        ("ulysses", q(l=128, h=4), dict(n_shards=4, head_axis="tp", mesh="sp_tp")),  # 4 % (4 x 2)
        ("ring", q(), dict(n_shards=2, mesh="four")),  # n_shards against the mesh's axis
        ("ulysses", q(), dict(n_shards=2, mesh="four")),
    ]


@pytest.mark.parametrize("strategy,shape,kw", _validation_cases())
def test_validation_messages_are_the_jax_packages(strategy, shape, kw):
    jfn, tfn = FNS[strategy]
    meshes = {"sp_tp": _sp_mesh(), "four": (jmake_mesh(4), make_mesh(4, device="cpu"))}
    jkw, tkw = dict(kw), dict(kw)
    if "mesh" in kw:
        jkw["mesh"], tkw["mesh"] = meshes[kw["mesh"]]
    (jq, jk, jv), (q, k, v) = _both(_qkv(0, shape))
    with pytest.raises(ValueError) as want:
        jfn(jq, jk, jv, **jkw)
    with pytest.raises(ValueError) as got:
        tfn(q, k, v, **tkw)
    assert str(got.value) == str(want.value)


def test_the_einsum_engine_accepts_what_the_flash_block_rule_refuses():
    (q, k, v) = _both(_qkv(25, (1, 320, 2, 8)))[1]
    out = tsp.ring_attention(q, k, v, n_shards=2, engine="einsum", mesh=make_mesh(2, device="cpu"))
    assert out.shape == (1, 320, 2, 8) and bool(torch.isfinite(out).all())


def _counting(monkeypatch):
    """Counts of the flash kernels' wrappers called (on the CPU they run the plain versions)."""
    calls = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    for name in calls:
        real = getattr(ck, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ck, name, counted)
    return calls


@pytest.mark.parametrize("engine", ["einsum", "flash"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_kernel_calls_and_collectives_are_as_tabled(monkeypatch, strategy, n, causal, engine):
    """Per attention call: the causal ring calls each flash kernel n(n+1)/2
    times (n diagonal hops, n(n-1)/2 full ones; the rest skipped), the full
    ring n^2, Ulysses n, the einsum engine none; the ring rotates K and V
    every hop (2n ppermute), Ulysses reshards four times."""
    calls = _counting(monkeypatch)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in _qkv(7, (1, 32, 4, 8))]
    halo.reset_collectives()
    out = FNS[strategy][1](*leaves, n_shards=n, causal=causal, engine=engine, mesh=make_mesh(n, device="cpu"))
    want_c = {"ppermute": 2 * n} if strategy == "ring" else {"all_to_all": 4}
    assert halo.COLLECTIVES == {**dict.fromkeys(halo.COLLECTIVES, 0), **want_c}
    torch.autograd.grad(out.sum(), leaves)
    per = 0 if engine == "einsum" else (n if strategy == "ulysses" else (n * (n + 1) // 2 if causal else n * n))
    assert calls == {"flash_fwd": per, "flash_dq": per, "flash_dkv": per}


def test_the_inputs_are_left_as_they_were():
    """A ring "move" to the slot's own device is a no-op ``.to()``; nothing is
    written in place, so the resident blocks stay the caller's inputs."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, (1, 32, 4, 8)))
    before = [t.clone() for t in (q, k, v)]
    tsp.ring_attention(q, k, v, n_shards=4, causal=True, engine="flash", mesh=make_mesh(4, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip((q, k, v), before))
