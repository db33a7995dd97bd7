"""FSDP in the port (``parallel/fsdp.py``), against the JAX package's, on the CPU.

``fsdp_spec`` against the JAX function of that name on every shape of the
JAX tests and the LM's leaves; ``shard_params_fsdp``'s placement against
the JAX ``PartitionSpec`` of each leaf (the dim, the pieces, the sharded
byte fraction) on a ``(dp,)`` and a ``(dp, sp)`` mesh; then ``forward_lm``,
``lm_loss`` and one ``make_lm_train_step`` step on the FSDP params against
the JAX package's on the same weights (its ``init_transformer`` tree carried
over by ``lm_params_from_jax``) and tokens made with numpy from a seed, at
``tests/test_fsdp.py``'s config, alone and composed with ring flash
attention over "sp".

Tolerances and why:
- logits: rtol 2e-5, atol 1e-5, the JAX package's forward tolerance for a
  sharded forward against the unsharded one (``tests/test_tensor_parallel.py``);
- the loss: rtol 1e-5, ``tests/test_fsdp.py``'s (1e-4 composed with the
  ring, that file's ring test);
- gradients: each leaf within 1e-5 x its max |JAX grad| (2e-5 with the
  ring's merge), ``tests/test_torch_lm_tp.py``'s rule;
- params after one step at ``tests/test_fsdp.py``'s lr 1e-2: rtol 2e-5,
  atol 2e-6, that file's, after an SGD step (optax.sgd on the JAX side).
  Adam's first update lr g / (|g| + eps) turns two frameworks' gradient
  rounding into up to lr where |g| is near eps, so the Adam step's params
  are held to ``tests/test_torch_lm_tp.py``'s 1e-4 abs instead;
- ROADMAP Queue 3 item 12's ruling, checked in every run: at this config
  the port's FSDP dp 4 step against the port's one-device step holds
  ``tests/test_fsdp.py``'s rule after one Adam step (loss rtol 1e-5, params
  rtol 2e-5, atol 2e-6), and its gradients, leaf by leaf as a share of the
  leaf's max, are as far apart as the JAX package's own pair's
  (``shard_params_fsdp`` over 4 devices against the replicated step):
  6.68e-7 against 6.38e-7 measured, within 2x held. The JAX pairs read
  5.24e-7 to 1.04e-6 by dp and by how the step is compiled, and summing
  the port's reduce-scatter in a tree or in float64 gives 7.42e-7: the gap
  is each slot's products at B/dp rows, not the sum's order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec

from cuda_mpi_gpu_cluster_programming_tpu.models import transformer as jtf
from cuda_mpi_gpu_cluster_programming_tpu.parallel import fsdp as jfsdp
from cuda_mpi_gpu_cluster_programming_tpu.parallel.mesh import make_mesh as jmake_mesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import transformer as ttf
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import fsdp, halo
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.mesh import make_mesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.optim import adam, sgd
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_leaves
from torch_threads import one_intra_op_thread  # noqa: unused-import (an autouse fixture)

KW = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=64)  # tests/test_fsdp.py:29
RTOL, ATOL = 2e-5, 1e-5


@pytest.fixture(scope="module")
def lm():
    jcfg = jtf.TransformerConfig(**KW)
    jparams = jtf.init_transformer(jax.random.PRNGKey(1), jcfg)
    return jcfg, jparams, ttf.lm_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("shape,dp", [((128, 512), 8), ((512, 128), 8), ((8, 512), 4), ((10, 8), 4), ((6, 512), 4),
                                      ((8, 6), 4), ((3, 5), 4), ((), 4), ((16,), 8), ((64, 3, 64), 4),
                                      ((256, 64), 2), ((64,), 3), ((4, 4), 8)])
def test_fsdp_spec_is_the_jax_packages(shape, dp):
    assert fsdp.fsdp_spec(shape, dp) == tuple(jfsdp.fsdp_spec(shape, dp))
    assert fsdp.fsdp_spec(shape, dp, "fsdp") == tuple(jfsdp.fsdp_spec(shape, dp, "fsdp"))


def _jax_dim(leaf):
    spec = tuple(leaf.sharding.spec)
    return spec.index("dp") if "dp" in spec else None


@pytest.mark.parametrize("mesh_kind", ["dp8", "dp2_sp4"])
def test_placement_is_the_jax_packages(lm, mesh_kind):
    """Each leaf splits on the dim its JAX spec names (only ever "dp"), into
    contiguous pieces that join back bit for bit; the sharded byte fraction
    is the JAX package's."""
    _, jparams, params = lm
    if mesh_kind == "dp8":
        jmesh, mesh, dp = jmake_mesh(8, axis_name="dp"), make_mesh(8, axis_name="dp", device="cpu"), 8
    else:
        jmesh = JMesh(np.array(jax.devices()).reshape(2, 4), ("dp", "sp"))
        mesh, dp = make_mesh(4, axis_name="sp", dp=2, device="cpu"), 2
    want = jfsdp.shard_params_fsdp(jparams, jmesh)
    got = fsdp.shard_params_fsdp(params, mesh)
    for jleaf, leaf, whole in zip(jax.tree.leaves(want), fsdp._pieces_leaves(got), tree_leaves(params)):
        dim = _jax_dim(jleaf)
        if dim is None:
            assert isinstance(leaf, torch.Tensor) and torch.equal(leaf, whole)
            continue
        assert isinstance(leaf, fsdp.Pieces) and leaf.dim == dim and leaf.axis == "dp" and len(leaf) == dp
        assert all(p.is_contiguous() and p.shape[dim] == whole.shape[dim] // dp for p in leaf)
        assert torch.equal(leaf.whole(), whole)
    assert fsdp.sharded_fraction(got) == pytest.approx(jfsdp.sharded_fraction(want), abs=0)
    assert fsdp.sharded_fraction(got) > 0.9
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(fsdp.gather_params(got)), tree_leaves(params)))
    assert fsdp.gather_params(params) is not params and fsdp.sharded_fraction(params) == 0.0


def test_forward_and_loss_on_fsdp_params_match_the_jax_forward(lm):
    jcfg, jparams, params = lm
    toks = _tokens((8, 33))
    want = np.asarray(jax.jit(lambda p, t: jtf.forward_lm(p, t, jcfg))(jparams, jnp.asarray(toks[:, :-1])))
    cfg = ttf.TransformerConfig(**KW)
    fs = fsdp.shard_params_fsdp(params, make_mesh(4, axis_name="dp", device="cpu"))
    halo.reset_collectives()
    got = ttf.forward_lm(fs, torch.from_numpy(toks[:, :-1]), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    n_leaves = len(tree_leaves(params))
    assert halo.COLLECTIVES == {**dict.fromkeys(halo.COLLECTIVES, 0), "all_gather": n_leaves}
    loss = ttf.lm_loss(fs, torch.from_numpy(toks), cfg)
    want_loss = jax.jit(lambda p, t: jtf.lm_loss(p, t, jcfg))(jparams, jnp.asarray(toks))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    with pytest.raises(ValueError, match="batch 6 not divisible by the dp axis"):
        ttf.forward_lm(fs, torch.from_numpy(toks[:6, :-1]), cfg)


def _catch_step(cfg, mesh, params, toks, opt):
    """One step, the gradients caught on their way to the optimizer."""
    init, update = opt
    caught = {}

    def spy(grads, state, p=None):
        caught["g"] = grads
        return update(grads, state, p)

    _, step = ttf.make_lm_train_step(cfg, mesh=mesh, optimizer=(init, spy))
    state = init(params)
    new, state, loss = step(params, state, torch.from_numpy(toks))
    return new, state, loss, caught["g"], step


@pytest.mark.parametrize("composed", [False, True], ids=["dp8", "dp2_x_ring_flash_sp4"])
def test_step_on_fsdp_params_matches_the_jax_step(lm, composed):
    """One step on FSDP params against the JAX package's replicated step on
    the same weights and tokens (the JAX tests' claim: placement does not
    change the math): the loss, every gradient leaf (the pieces joined), the
    params after an SGD and an Adam step at lr 1e-2; the layout survives
    the update, and each sharded leaf's gradient is reduce-scattered."""
    jcfg, jparams, params = lm
    if composed:
        over, loss_rtol, g_rel = dict(attn_impl="ring", attn_engine="flash", sp_shards=4), 1e-4, 2e-5
        mesh, toks = make_mesh(4, axis_name="sp", dp=2, device="cpu"), _tokens((4, 33), 2)
    else:
        over, loss_rtol, g_rel = {}, 1e-5, 1e-5
        mesh, toks = make_mesh(8, axis_name="dp", device="cpu"), _tokens((8, 33), 2)
    cfg = ttf.TransformerConfig(**KW, **over)
    fs = fsdp.shard_params_fsdp(params, mesh)
    want_loss, want_grads = jax.jit(jax.value_and_grad(lambda p: jtf.lm_loss(p, jnp.asarray(toks), jcfg)))(jparams)
    for name, opt, jopt in (("sgd", sgd(1e-2), optax.sgd(1e-2)), ("adam", adam(1e-2), optax.adam(1e-2))):
        # the JAX step's update (make_lm_train_step: value_and_grad, then the optax update) on its gradients
        j_new = optax.apply_updates(jparams, jopt.update(want_grads, jopt.init(jparams), jparams)[0])
        halo.reset_collectives()
        new, state, loss, grads, step = _catch_step(cfg, mesh, fs, toks, opt)
        n_leaves = len(tree_leaves(params))
        assert halo.COLLECTIVES["all_gather"] == halo.COLLECTIVES["reduce_scatter"] == n_leaves
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=loss_rtol)
        for g, w in zip(tree_leaves(fsdp.gather_params(grads)), jax.tree.leaves(want_grads)):
            w = np.asarray(w)
            assert g.shape == w.shape and float(np.abs(g.numpy() - w).max()) <= g_rel * float(np.abs(w).max())
        assert isinstance(new["layers"][0]["wqkv"], fsdp.Pieces) and fsdp.sharded_fraction(new) > 0.95
        for a, b in zip(tree_leaves(fsdp.gather_params(new)), jax.tree.leaves(j_new)):
            if name == "sgd":
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-6)
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)
    _, _, loss2 = step(new, state, torch.from_numpy(toks))
    assert float(loss2) < float(loss)


def test_fsdp_trains_multiple_steps(lm):
    """``tests/test_fsdp.py``'s multi-step run (3 Adam steps here): the loss
    falls, stays finite, and ``lm_loss`` evaluates on the trained pieces."""
    _, _, params = lm
    cfg = ttf.TransformerConfig(**KW)
    fs = fsdp.shard_params_fsdp(params, make_mesh(8, axis_name="dp", device="cpu"))
    toks = torch.from_numpy(_tokens((8, 33), 3))
    init, step = ttf.make_lm_train_step(cfg, lr=3e-3)
    state, losses = init(fs), []
    for _ in range(3):
        fs, state, loss = step(fs, state, toks)
        losses.append(float(loss))
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    assert np.isfinite(float(ttf.lm_loss(fs, toks, cfg)))


def test_bf16_remat_and_accumulation_compose_with_fsdp(lm):
    """``--compute bf16`` casts once a step (the pieces) and the gradient
    reaches the fp32 pieces; accumulation and remat are the plain step
    within rounding (an SGD step: the params move by lr x the gradient, so
    they show its rounding as it is); masters stay fp32 pieces."""
    _, _, params = lm
    toks = torch.from_numpy(_tokens((8, 33), 4))
    mesh = make_mesh(4, axis_name="dp", device="cpu")
    cfg = ttf.TransformerConfig(**KW)
    fs = fsdp.shard_params_fsdp(params, mesh)
    init, base = ttf.make_lm_train_step(cfg, optimizer=sgd(1e-2))
    p1, _, l1 = base(fs, init(fs), toks)
    for accum, c, dtype, rtol in ((2, cfg, None, 1e-5), (1, dataclasses.replace(cfg, remat=True), None, 1e-6),
                                  (2, cfg, torch.bfloat16, 1e-2)):
        init, step = ttf.make_lm_train_step(c, optimizer=sgd(1e-2), accum_steps=accum, compute_dtype=dtype)
        p, _, loss = step(fs, init(fs), toks)
        np.testing.assert_allclose(float(loss), float(l1), rtol=rtol)
        assert all(t.dtype == torch.float32 for t in tree_leaves(p)) and isinstance(p["embed"], fsdp.Pieces)
        if dtype is None:
            for a, b in zip(tree_leaves(p), tree_leaves(p1)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_generation_on_fsdp_params_is_the_whole_trees(lm):
    _, _, params = lm
    cfg = ttf.TransformerConfig(**KW)
    fs = fsdp.shard_params_fsdp(params, make_mesh(4, axis_name="dp", device="cpu"))
    prompt = torch.from_numpy(_tokens((2, 8), 5))
    assert torch.equal(ttf.generate(fs, prompt, cfg, steps=6), ttf.generate(params, prompt, cfg, steps=6))


def test_mesh_without_the_axis_is_refused(lm):
    _, _, params = lm
    with pytest.raises(ValueError, match="axis 'dp' not in mesh axes"):
        fsdp.shard_params_fsdp(params, make_mesh(4, axis_name="sp", device="cpu"))


def _worst_leaf_gap(got, want):
    """The largest |got - want| over the leaves, each as a share of the leaf's max |want|."""
    return max(float(np.abs(a - b).max()) / float(np.abs(b).max()) for a, b in zip(got, want))


def test_fsdp_adam_step_is_the_ports_one_device_step_and_as_near_it_as_jaxs_pair(lm):
    """ROADMAP Queue 3 item 12's ruling at this file's config and tokens
    (the module docstring's numbers). At TINY_LM both frameworks' pairs miss
    the JAX test's rule after Adam (``chip_smoke.py``'s FSDP_* note), where
    |g| is near eps, which Adam's first update amplifies."""
    jcfg, jparams, params = lm
    cfg = ttf.TransformerConfig(**KW)
    toks = _tokens((8, 33), 2)
    mesh = make_mesh(4, axis_name="dp", device="cpu")
    one, _, one_loss, one_g, _ = _catch_step(cfg, None, params, toks, adam(1e-2))
    fs, _, fs_loss, fs_g, _ = _catch_step(cfg, mesh, fsdp.shard_params_fsdp(params, mesh), toks, adam(1e-2))
    port_g = _worst_leaf_gap([g.numpy() for g in tree_leaves(fsdp.gather_params(fs_g))],
                             [g.numpy() for g in tree_leaves(one_g)])
    pairs = list(zip(tree_leaves(fsdp.gather_params(fs)), tree_leaves(one)))
    np.testing.assert_allclose(float(fs_loss), float(one_loss), rtol=1e-5)
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-6)

    jmesh = jmake_mesh(4, axis_name="dp")
    jtoks = jnp.asarray(toks)
    grads = jax.jit(jax.grad(lambda p, t: jtf.lm_loss(p, t, jcfg)))
    rep_g = grads(jparams, jtoks)
    fs_jg = grads(jfsdp.shard_params_fsdp(jparams, jmesh),
                  jax.device_put(jtoks, NamedSharding(jmesh, PartitionSpec("dp"))))
    jax_g = _worst_leaf_gap([np.asarray(g) for g in jax.tree.leaves(fs_jg)],
                            [np.asarray(g) for g in jax.tree.leaves(rep_g)])
    gap = max(float((a - b).abs().max()) for a, b in pairs)
    print(f"Queue 3 item 12: port FSDP dp 4 against the port's one device: gradients {port_g:.3g} of their leaf's max "
          f"apart, params after an Adam step {gap:.3g}; JAX FSDP dp 4 against replicated: gradients {jax_g:.3g}")
    assert port_g <= 2 * jax_g
