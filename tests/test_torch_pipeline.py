"""Pipeline parallelism in the port (``parallel/pipeline.py``), against the
JAX package's, on the CPU.

``pipeline_lm_forward``, ``pipeline_lm_loss`` and their gradients at
``tests/test_pipeline.py``'s config and stage/microbatch grid, on "pp"
meshes of CPU slots and on a ``(dp, pp)`` mesh, against the JAX package's
functions of those names on its 8 CPU devices, on the same weights (its
``init_transformer`` tree carried over by ``lm_params_from_jax``) and
tokens made with numpy from a seed; the validations in its words; the
schedule's hand-offs (M + S - 2 ``ppermute``: the bubbles run nothing) and
the flash launches (one a layer a microbatch). A pipelined MoE is held to
the JAX pipeline, whose capacity comes from the microbatch's tokens.

Tolerances and why:
- logits: rtol 2e-5, atol 1e-5, ``tests/test_pipeline.py``'s;
- the loss: 1e-5 abs, that file's;
- gradients: rtol 2e-4, atol 2e-5, that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.models import transformer as jtf
from cuda_mpi_gpu_cluster_programming_tpu.parallel import pipeline as jpp
from cuda_mpi_gpu_cluster_programming_tpu.parallel.mesh import make_mesh as jmake_mesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import transformer as ttf
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import halo, pipeline
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.mesh import make_mesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_leaves, tree_unflatten
from torch_threads import one_intra_op_thread  # noqa: unused-import (an autouse fixture)

KW = dict(d_model=32, n_heads=2, n_layers=4, d_ff=64, max_len=64)  # tests/test_pipeline.py:25
MOE_KW = dict(d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=64, n_experts=8, capacity_factor=2.0)
RTOL, ATOL = 2e-5, 1e-5


def _pair(kw):
    jcfg = jtf.TransformerConfig(**kw)
    jparams = jtf.init_transformer(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, ttf.TransformerConfig(**kw), ttf.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                                                               device="cpu")


@pytest.fixture(scope="module")
def lm():
    toks = np.random.default_rng(1).integers(0, 256, (8, 17)).astype(np.int32)
    return (*_pair(KW), toks)


@pytest.fixture(scope="module")
def jax_sequential(lm):
    jcfg, jparams, _, _, toks = lm
    return np.asarray(jax.jit(lambda p, t: jtf.forward_lm(p, t, jcfg))(jparams, jnp.asarray(toks)))


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 2), (4, 8), (1, 1)])
def test_pipeline_forward_matches_the_jax_forward(lm, jax_sequential, n_stages, n_micro):
    """Every (S, M) of ``tests/test_pipeline.py``'s grid against the JAX
    package's sequential ``forward_lm`` (that file's claim: pipelining
    reorders scheduling, not arithmetic), and (2, 4) against its
    ``pipeline_lm_forward`` too; the hand-offs counted."""
    jcfg, jparams, cfg, params, toks = lm
    halo.reset_collectives()
    got = pipeline.pipeline_lm_forward(params, torch.from_numpy(toks), cfg, n_stages=n_stages,
                                       n_microbatches=n_micro)
    np.testing.assert_allclose(got.numpy(), jax_sequential, rtol=RTOL, atol=ATOL)
    # one hand-off a step in which a stage other than the last ran: M + S - 2 (none for one stage)
    hops = n_micro + n_stages - 2 if n_stages > 1 else 0
    assert halo.COLLECTIVES == {**dict.fromkeys(halo.COLLECTIVES, 0), "ppermute": hops}
    if (n_stages, n_micro) == (2, 4):
        want = np.asarray(jax.jit(lambda p, t: jpp.pipeline_lm_forward(p, t, jcfg, n_stages=2, n_microbatches=4))(
            jparams, jnp.asarray(toks)))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_pipeline_loss_and_gradients_match_the_jax_pipeline(lm):
    jcfg, jparams, cfg, params, toks = lm
    want = float(jax.jit(lambda p, t: jpp.pipeline_lm_loss(p, t, jcfg, n_stages=4, n_microbatches=2))(
        jparams, jnp.asarray(toks)))
    got = float(pipeline.pipeline_lm_loss(params, torch.from_numpy(toks), cfg, n_stages=4, n_microbatches=2))
    assert abs(got - want) < 1e-5, (got, want)
    j_grads = jax.jit(jax.grad(lambda p: jpp.pipeline_lm_loss(p, jnp.asarray(toks), jcfg, n_stages=2,
                                                              n_microbatches=4)))(jparams)
    leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(params)]
    loss = pipeline.pipeline_lm_loss(tree_unflatten(params, leaves), torch.from_numpy(toks), cfg, n_stages=2,
                                     n_microbatches=4)
    grads = torch.autograd.grad(loss, leaves)
    for g, w in zip(grads, jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)


def test_pipeline_trains_through_the_shared_step(lm):
    """Every stage's layers get a gradient, and ``make_lm_train_step`` with the
    pipelined loss lowers it (``tests/test_pipeline.py``'s training check)."""
    _, _, cfg, params, toks = lm
    mesh = make_mesh(4, axis_name="pp", device="cpu")
    loss_fn = lambda p, t: pipeline.pipeline_lm_loss(p, t, cfg, n_stages=4, n_microbatches=2, mesh=mesh)  # noqa: E731
    leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(params)]
    grads = tree_unflatten(params, list(torch.autograd.grad(loss_fn(tree_unflatten(params, leaves),
                                                                    torch.from_numpy(toks)), leaves)))
    for i, layer in enumerate(grads["layers"]):
        assert sum(float(g.abs().sum()) for g in tree_leaves(layer)) > 0, f"layer {i} got no gradient"
    init, step = ttf.make_lm_train_step(cfg, lr=1e-2, loss_fn=loss_fn)
    p, state, l0 = step(params, init(params), torch.from_numpy(toks))
    _, _, l1 = step(p, state, torch.from_numpy(toks))
    assert float(l1) < float(l0)


def test_pipeline_composes_with_dp(lm):
    """dp x pp: each dp row pipelines its share of every microbatch; the JAX
    package's forward and loss on its (dp, pp) mesh."""
    jcfg, jparams, cfg, params, toks = lm
    jmesh = jmake_mesh(4, axis_name="pp", dp=2)
    mesh = make_mesh(4, axis_name="pp", dp=2, device="cpu")
    kw = dict(n_stages=4, n_microbatches=2, dp_axis="dp")
    want = np.asarray(jax.jit(lambda p, t: jpp.pipeline_lm_forward(p, t, jcfg, mesh=jmesh, **kw))(
        jparams, jnp.asarray(toks)))
    halo.reset_collectives()
    got = pipeline.pipeline_lm_forward(params, torch.from_numpy(toks), cfg, mesh=mesh, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert halo.COLLECTIVES["ppermute"] == 2 + 4 - 2  # the rows hand off in the same steps
    want_l = float(jax.jit(lambda p, t: jpp.pipeline_lm_loss(p, t, jcfg, mesh=jmesh, **kw))(jparams,
                                                                                          jnp.asarray(toks)))
    assert abs(float(pipeline.pipeline_lm_loss(params, torch.from_numpy(toks), cfg, mesh=mesh, **kw)) - want_l) < 1e-5


@pytest.mark.parametrize("case", ["stages", "microbatches", "dp", "dp_no_mesh", "dp_axis"])
def test_validations_are_the_jax_packages(lm, case):
    jcfg, jparams, cfg, params, toks = lm
    kw = {"stages": dict(n_stages=3, n_microbatches=2), "microbatches": dict(n_stages=2, n_microbatches=3),
          "dp": dict(n_stages=2, n_microbatches=2, dp_axis="dp"),
          "dp_no_mesh": dict(n_stages=2, n_microbatches=2, dp_axis="dp"),
          "dp_axis": dict(n_stages=2, n_microbatches=2, dp_axis="data")}[case]
    rows = 6 if case == "dp" else 8
    jmesh = tmesh = None
    if case in ("dp", "dp_axis"):
        jmesh, tmesh = jmake_mesh(2, axis_name="pp", dp=4), make_mesh(2, axis_name="pp", dp=4, device="cpu")
    with pytest.raises(ValueError) as want:
        jpp.pipeline_lm_forward(jparams, jnp.asarray(toks[:rows]), jcfg, mesh=jmesh, **kw)
    with pytest.raises(ValueError) as got:
        pipeline.pipeline_lm_forward(params, torch.from_numpy(toks[:rows]), cfg, mesh=tmesh, **kw)
    assert str(got.value) == str(want.value)


def test_stack_layers_roundtrip(lm):
    _, jparams, _, params, _ = lm
    stacked = pipeline.stack_layers(params["layers"])
    want = jpp.stack_layers(jparams["layers"])
    for a, b in zip(tree_leaves(stacked), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape and a.shape[0] == KW["n_layers"]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    staged = pipeline._reshape_stages(stacked, 2)
    assert all(t.shape[:2] == (2, 2) for t in tree_leaves(staged))


def test_pipelined_moe_matches_the_jax_pipeline():
    """A MoE decoder stack pipelined: each microbatch routes alone (its
    capacity from the microbatch's tokens), as in the JAX pipeline, so it is
    held to ``pipeline_lm_forward`` of the JAX package, not ``forward_lm``."""
    jcfg, jparams, cfg, params = _pair(MOE_KW)
    toks = np.random.default_rng(2).integers(0, 256, (4, 16)).astype(np.int32)
    kw = dict(n_stages=2, n_microbatches=2)
    want = np.asarray(jax.jit(lambda p, t: jpp.pipeline_lm_forward(p, t, jcfg, **kw))(jparams, jnp.asarray(toks)))
    got = pipeline.pipeline_lm_forward(params, torch.from_numpy(toks), cfg, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want_l = float(jax.jit(lambda p, t: jpp.pipeline_lm_loss(p, t, jcfg, **kw))(jparams, jnp.asarray(toks)))
    assert abs(float(pipeline.pipeline_lm_loss(params, torch.from_numpy(toks), cfg, **kw)) - want_l) < 1e-5


def test_pipelined_flash_launches_once_a_layer_a_microbatch(lm, monkeypatch):
    """With ``attn_impl="flash"`` each microbatch's layer calls the flash
    forward once on its slot: S x (L/S) x M = L x M calls; the bubbles none."""
    _, _, cfg, params, toks = lm
    calls = {"n": 0}
    real = ck.flash_fwd

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ck, "flash_fwd", counted)
    fcfg = ttf.TransformerConfig(**KW, attn_impl="flash")
    got = pipeline.pipeline_lm_forward(params, torch.from_numpy(toks), fcfg, n_stages=2, n_microbatches=4)
    assert calls["n"] == KW["n_layers"] * 4
    np.testing.assert_allclose(got.numpy(), ttf.forward_lm(params, torch.from_numpy(toks), cfg).numpy(),
                               rtol=1e-4, atol=2e-4)
