"""The LM's Megatron tensor parallelism and its sp x tp composition in the
port, against the JAX package's, on the CPU.

``shard_lm_params_tp`` (``parallel/tensor_parallel.py``) against the JAX
function of that name: which dim each key splits on, the MoE and
divisibility rules. Then ``forward_lm`` and ``make_lm_train_step`` on the
TP params, on a ``(tp,)``, a ``(dp, tp)`` and an ``(sp, tp)`` mesh of CPU
slots (ring and Ulysses attention over "sp", heads over "tp"), against the
JAX package's unsharded forward and step on the same weights (its
``init_transformer`` tree carried over by ``lm_params_from_jax``) and the
same tokens, made with numpy from a seed.

Tolerances and why:
- logits: rtol 2e-5, atol 1e-5, the JAX package's own for its TP forward
  against the unsharded one (``tests/test_tensor_parallel.py``): the
  ``psum`` adds the slots' partial products in slot order, so the sums
  round in another order;
- gradients: each leaf within 1e-5 x its max |JAX grad|, the loss rtol
  1e-5, params after one Adam step 1e-4 abs (``tests/test_torch_train.py``'s
  rules: Adam's first step is about lr x sign(g));
- the bf16 step against the fp32 one: the loss within 1e-2 rel, the
  bf16 logits' rounding (``chip_smoke.py``'s TINY_LM rule).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.models import transformer as jtf
from cuda_mpi_gpu_cluster_programming_tpu.parallel.mesh import make_mesh as jmake_mesh
from cuda_mpi_gpu_cluster_programming_tpu.parallel.tensor_parallel import shard_lm_params_tp as jshard
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import transformer as ttf
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import halo
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import tensor_parallel as ttp
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.mesh import make_mesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.optim import adam
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_leaves

# tests/test_tensor_parallel.py's and tests/test_sequence_parallel.py's LM
KW = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=64)
RTOL, ATOL = 2e-5, 1e-5


def _pair(**over):
    jcfg = jtf.TransformerConfig(**{**KW, **over})
    jparams = jtf.init_transformer(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, ttf.lm_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _meshes():
    return {"tp": make_mesh(4, axis_name="tp", device="cpu"),
            "dp_tp": make_mesh(4, axis_name="tp", dp=2, device="cpu"),
            "sp_tp": make_mesh(2, axis_name="tp", dp=4, dp_axis_name="sp", device="cpu"),
            # Ulysses with heads over "tp" needs n_heads (4) divisible by sp x tp
            "sp2_tp2": make_mesh(2, axis_name="tp", dp=2, dp_axis_name="sp", device="cpu")}


def test_layout_is_the_jax_packages():
    """Each sharded key splits on the dim its JAX PartitionSpec names, into
    contiguous pieces that join back bit for bit; the rest stays whole."""
    _, jparams, params = _pair()
    want = jshard(jparams, jmake_mesh(4, axis_name="tp"))
    got = ttp.shard_lm_params_tp(params, _meshes()["tp"])
    for jl, tl, whole in zip(want["layers"], got["layers"], params["layers"]):
        for key in ("wqkv", "w_up", "wo", "w_down"):
            spec = tuple(jl[key].sharding.spec) + (None,) * (jl[key].ndim - len(jl[key].sharding.spec))
            dim = spec.index("tp")
            pieces = tl[key]
            assert isinstance(pieces, list) and len(pieces) == 4
            assert all(p.is_contiguous() and p.shape[dim] == whole[key].shape[dim] // 4 for p in pieces)
            assert torch.equal(torch.cat(pieces, dim=dim), whole[key])
        for key in ("attn_norm", "mlp_norm"):
            assert torch.equal(tl[key]["g"], whole[key]["g"]) and jl[key]["g"].sharding.is_fully_replicated
    assert isinstance(got["embed"], torch.Tensor) and want["embed"].sharding.is_fully_replicated
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ttp.gather_lm_params_tp(got)), tree_leaves(params)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ttp.gather_lm_params_tp(params)), tree_leaves(params)))


def test_moe_expert_stacks_stay_replicated():
    _, jparams, params = _pair(n_heads=2, n_layers=1, n_experts=2)
    want = jshard(jparams, jmake_mesh(4, axis_name="tp"))["layers"][0]
    got = ttp.shard_lm_params_tp(params, _meshes()["tp"])["layers"][0]
    for key in ("w_up", "w_down", "router"):
        assert want[key].sharding.is_fully_replicated
        assert isinstance(got[key], torch.Tensor) and torch.equal(got[key], params["layers"][0][key])
    assert isinstance(got["wqkv"], list) and isinstance(got["wo"], list)


def test_divisibility_message_is_the_jax_packages():
    jcfg = jtf.TransformerConfig(d_model=30, n_heads=2, n_layers=1, d_ff=60)
    jparams = jtf.init_transformer(jax.random.PRNGKey(0), jcfg)
    params = ttf.lm_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    with pytest.raises(ValueError, match="not divisible") as want:
        jshard(jparams, jmake_mesh(4, axis_name="tp"))
    with pytest.raises(ValueError) as got:
        ttp.shard_lm_params_tp(params, n_shards=4)  # the default mesh: 4 slots on the params' device
    assert str(got.value) == str(want.value)


SP_CASES = [("reference", "einsum", "tp", "tp"), ("flash", "einsum", "dp_tp", "tp"),
            ("ring", "einsum", "sp_tp", "tp"), ("ring", "flash", "sp_tp", "tp"),
            ("ulysses", "einsum", "sp2_tp2", "tp"), ("ulysses", "flash", "sp2_tp2", "tp"),
            ("ring", "flash", "sp_tp", None)]


@pytest.mark.parametrize("impl,engine,mesh_key,head_axis", SP_CASES)
def test_forward_on_tp_params_matches_the_unsharded_jax_forward(monkeypatch, impl, engine, mesh_key, head_axis):
    jcfg, jparams, params = _pair()
    toks = _tokens((2, 32))
    want = np.asarray(jax.jit(lambda p, t: jtf.forward_lm(p, t, jcfg))(jparams, jnp.asarray(toks)))
    mesh = _meshes()[mesh_key]
    sp = mesh.axis_size("sp") or 1
    cfg = ttf.TransformerConfig(**KW, attn_impl=impl, attn_engine=engine, sp_shards=sp, sp_head_axis=head_axis)
    tp_params = ttp.shard_lm_params_tp(params, mesh, axis_name="tp")
    calls = {"n": 0}
    real = ck.flash_fwd

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ck, "flash_fwd", counted)
    halo.reset_collectives()
    got = ttf.forward_lm(tp_params, torch.from_numpy(toks), cfg, mesh=mesh)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    layers = KW["n_layers"]
    ring = {"ppermute": 2 * sp * layers} if impl == "ring" else {}
    a2a = {"all_to_all": 4 * layers} if impl == "ulysses" else {}
    assert halo.COLLECTIVES == {**dict.fromkeys(halo.COLLECTIVES, 0), "psum": 2 * layers, **ring, **a2a}
    # flash_fwd calls a layer: one a tp slot (flash), a ring of n(n+1)/2 a head group, Ulysses n a head group
    groups = 2 if head_axis else 1
    per_layer = {"reference": 0, "flash": 4}.get(impl, 0)
    if engine == "flash":
        per_layer = groups * (sp * (sp + 1) // 2 if impl == "ring" else sp)
    assert calls["n"] == per_layer * layers


def _catch_step(cfg, mesh, params, toks, lr=5e-2):
    """One step of the port's make_lm_train_step, the gradients caught on
    their way to the optimizer: (new params, state, loss, grads)."""
    init, update = adam(lr)
    caught = {}

    def spy(grads, state, p=None):
        caught["g"] = grads
        return update(grads, state, p)

    _, step = ttf.make_lm_train_step(cfg, mesh=mesh, optimizer=(init, spy))
    state = init(params)
    new, state, loss = step(params, state, torch.from_numpy(toks))
    return new, state, loss, caught["g"], step


@pytest.mark.parametrize("impl,engine,mesh_key", [("reference", "einsum", "dp_tp"), ("ring", "einsum", "sp_tp"),
                                                  ("ring", "flash", "sp_tp"), ("ulysses", "flash", "sp2_tp2")])
def test_train_step_on_tp_params_matches_the_unsharded_jax_step(impl, engine, mesh_key):
    """One step on TP params against the JAX package's unsharded step
    (optax Adam, lr 5e-2) on the same weights, then a second step: the loss
    falls (``tests/test_sequence_parallel.py``'s sp x tp check). L = 17 so
    the loss's shift leaves 16 positions, divisible by the 4 sp shards."""
    jcfg, jparams, params = _pair()
    toks = _tokens((2, 17), 2)
    j_init, j_step = jtf.make_lm_train_step(jcfg, lr=5e-2)
    want_loss, want_grads = jax.value_and_grad(lambda p: jtf.lm_loss(p, jnp.asarray(toks), jcfg))(jparams)
    j_new, _, j_loss = j_step(jparams, j_init(jparams), jnp.asarray(toks))
    mesh = _meshes()[mesh_key]
    sp = mesh.axis_size("sp") or 1
    cfg = ttf.TransformerConfig(**KW, attn_impl=impl, attn_engine=engine, sp_shards=sp, sp_head_axis="tp")
    tp_params = ttp.shard_lm_params_tp(params, mesh, axis_name="tp")
    new, state, loss, grads, step = _catch_step(cfg, mesh, tp_params, toks)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for g, w in zip(tree_leaves(ttp.gather_lm_params_tp(grads)), jax.tree.leaves(want_grads)):
        w = np.asarray(w)
        assert g.shape == w.shape and float(np.abs(g.numpy() - w).max()) <= 1e-5 * float(np.abs(w).max())
    assert isinstance(new["layers"][0]["wqkv"], list)  # the layout survives the update
    for g, w in zip(tree_leaves(ttp.gather_lm_params_tp(new)), jax.tree.leaves(j_new)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    _, _, loss2 = step(new, state, torch.from_numpy(toks))
    assert float(loss2) < float(loss)


def test_accumulation_bf16_and_remat_compose_with_ring_and_tp():
    """accum_steps=2, remat and bf16 mixed precision on TP params with the
    ring's flash engine: fp32 accumulation is the full-batch step within
    rounding, remat the same values, bf16 within its rounding; masters
    stay fp32 pieces."""
    _, _, params = _pair()
    toks = torch.from_numpy(_tokens((2, 17), 3))
    mesh = _meshes()["sp_tp"]
    cfg = ttf.TransformerConfig(**KW, attn_impl="ring", attn_engine="flash", sp_shards=4, sp_head_axis="tp")
    tp_params = ttp.shard_lm_params_tp(params, mesh, axis_name="tp")
    init, base = ttf.make_lm_train_step(cfg, mesh=mesh, lr=1e-2)
    p1, _, l1 = base(tp_params, init(tp_params), toks)
    for accum, c, dtype, rtol in ((2, cfg, None, 1e-5), (1, dataclasses.replace(cfg, remat=True), None, 1e-6),
                                  (2, dataclasses.replace(cfg, remat=True), torch.bfloat16, 1e-2)):
        init, step = ttf.make_lm_train_step(c, mesh=mesh, lr=1e-2, accum_steps=accum, compute_dtype=dtype)
        p, _, loss = step(tp_params, init(tp_params), toks)
        np.testing.assert_allclose(float(loss), float(l1), rtol=rtol)
        assert all(t.dtype == torch.float32 for t in tree_leaves(p)) and isinstance(p["layers"][1]["w_up"], list)
        if dtype is None:
            for a, b in zip(tree_leaves(p), tree_leaves(p1)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_generation_on_tp_params_is_the_whole_trees():
    """Decode runs on one device, as in the JAX package: TP params are
    joined first, so greedy generation picks the whole tree's tokens."""
    _, _, params = _pair()
    cfg = ttf.TransformerConfig(**KW)
    prompt = torch.from_numpy(_tokens((2, 8), 4))
    tp_params = ttp.shard_lm_params_tp(params, _meshes()["tp"])
    assert torch.equal(ttf.generate(tp_params, prompt, cfg, steps=6), ttf.generate(params, prompt, cfg, steps=6))


def test_tp_needs_whole_heads_on_a_slot():
    _, _, params = _pair(n_heads=2)
    tp_params = ttp.shard_lm_params_tp(params, _meshes()["tp"])
    with pytest.raises(ValueError, match="n_heads 2 not divisible by 4 tp shards"):
        ttf.forward_lm(tp_params, torch.from_numpy(_tokens((1, 8))), ttf.TransformerConfig(**{**KW, "n_heads": 2}))


@pytest.mark.parametrize("impl,engine", [("ring", "einsum"), ("ring", "flash"), ("ulysses", "einsum"),
                                         ("ulysses", "flash")])
def test_sequence_parallel_lm_matches_the_jax_packages(impl, engine):
    """The whole tree with ring or Ulysses attention over 4 "sp" slots
    against the JAX package's forward_lm with the same attention on its
    mesh: the logits at the fp32 rule of ``tests/test_torch_transformer.py``
    (rtol 1e-4, atol 2e-4: the two frameworks' matmuls sum in other orders
    through every layer)."""
    over = dict(attn_impl=impl, attn_engine=engine, sp_shards=4)
    jcfg, jparams, params = _pair(**over)
    toks = _tokens((2, 32), 5)
    want = np.asarray(jax.jit(lambda p, t: jtf.forward_lm(p, t, jcfg))(jparams, jnp.asarray(toks)))
    got = ttf.forward_lm(params, torch.from_numpy(toks), ttf.TransformerConfig(**KW, **over))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-4)
