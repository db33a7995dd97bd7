"""Expert parallelism in the port (``parallel/expert.py``), against the JAX
package's, on the CPU.

``shard_moe_params`` against the JAX function of that name (which leaves
split over "ep", the divisibility rule in its words), then ``forward_lm``
and ``make_ep_train_step`` on the ep-sharded params against the JAX
package's on its 8 CPU devices, at ``tests/test_expert_parallel.py``'s MoE
config, on the same weights (its ``init_transformer`` tree carried over by
``lm_params_from_jax``) and tokens made with numpy from a seed; the
dispatch and return counted (two ``all_to_all`` a MoE layer).

Tolerances and why:
- logits: rtol 2e-5, atol 1e-5, ``tests/test_expert_parallel.py``'s;
- the loss: rtol 1e-5 and each gradient leaf within 1e-5 x its max |JAX
  grad|, ``tests/test_torch_lm_tp.py``'s rules; the params after one SGD
  step rtol 2e-5, atol 2e-6 (``tests/test_fsdp.py``'s rule for params after
  a step). An Adam step is not compared leaf by leaf: its first update
  lr g / (|g| + eps) turns the two frameworks' gradient rounding into up to
  lr where |g| is near eps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.models import transformer as jtf
from cuda_mpi_gpu_cluster_programming_tpu.parallel import expert as jep
from cuda_mpi_gpu_cluster_programming_tpu.parallel.mesh import make_mesh as jmake_mesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import transformer as ttf
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import expert, fsdp, halo
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.mesh import make_mesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.optim import sgd
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_leaves
from torch_threads import one_intra_op_thread  # noqa: unused-import (an autouse fixture)

MOE_KW = dict(d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=64, n_experts=8,
              capacity_factor=2.0)  # tests/test_expert_parallel.py:26
RTOL, ATOL = 2e-5, 1e-5


@pytest.fixture(scope="module")
def moe():
    jcfg = jtf.TransformerConfig(**MOE_KW)
    jparams = jtf.init_transformer(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(1).integers(0, 256, (4, 16)).astype(np.int32)
    return jcfg, jparams, ttf.TransformerConfig(**MOE_KW), ttf.lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu"), toks


@pytest.mark.parametrize("ep", [2, 4, 8])
def test_expert_leaves_split_as_the_jax_package_places_them(moe, ep):
    """The expert stacks split along E into ep pieces (the JAX spec's "ep"
    on dim 0), piece j on ep slot j, joining back bit for bit; every other
    leaf whole, as JAX replicates it."""
    _, jparams, _, params, _ = moe
    want = jep.shard_moe_params(jparams, jmake_mesh(ep, axis_name="ep"))
    got = expert.shard_moe_params(params, make_mesh(ep, axis_name="ep", device="cpu"))
    for jl, tl, whole in zip(want["layers"], got["layers"], params["layers"]):
        for key in ("w_up", "w_down"):
            assert tuple(jl[key].sharding.spec)[0] == "ep" and len(jl[key].sharding.device_set) == ep
            assert isinstance(tl[key], fsdp.Pieces) and tl[key].axis == "ep" and len(tl[key]) == ep
            assert all(p.shape[0] == MOE_KW["n_experts"] // ep for p in tl[key])
            assert torch.equal(tl[key].whole(), whole[key])
        for key in ("router", "wqkv", "wo"):
            assert jl[key].sharding.is_fully_replicated and isinstance(tl[key], torch.Tensor)
    assert isinstance(got["embed"], torch.Tensor) and want["embed"].sharding.is_fully_replicated
    assert fsdp.sharded_fraction(got, "ep") > 0.5 and not fsdp.has_pieces(got, "dp")


def test_dense_model_stays_whole():
    jcfg = jtf.TransformerConfig(d_model=32, n_heads=2, n_layers=1, d_ff=64)
    params = ttf.lm_params_from_jax(jax.tree.map(np.asarray, jtf.init_transformer(jax.random.PRNGKey(0), jcfg)),
                                    device="cpu")
    got = expert.shard_moe_params(params, make_mesh(4, axis_name="ep", device="cpu"))
    assert not fsdp.has_pieces(got)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(params)))


def test_divisibility_message_is_the_jax_packages():
    jcfg = jtf.TransformerConfig(d_model=32, n_heads=2, n_layers=1, d_ff=64, n_experts=6)
    jparams = jtf.init_transformer(jax.random.PRNGKey(0), jcfg)
    params = ttf.lm_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    with pytest.raises(ValueError, match="not divisible") as want:
        jep.shard_moe_params(jparams, jmake_mesh(4, axis_name="ep"))
    with pytest.raises(ValueError) as got:
        expert.shard_moe_params(params, n_shards=4)  # the default mesh: 4 slots on the params' device
    assert str(got.value) == str(want.value)


def test_ep_forward_matches_the_jax_forward(moe):
    jcfg, jparams, cfg, params, toks = moe
    want = np.asarray(jax.jit(lambda p, t: jtf.forward_lm(p, t, jcfg))(
        jep.shard_moe_params(jparams, jmake_mesh(8, axis_name="ep")), jnp.asarray(toks)))
    sharded = expert.shard_moe_params(params, make_mesh(8, axis_name="ep", device="cpu"))
    halo.reset_collectives()
    got = ttf.forward_lm(sharded, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert halo.COLLECTIVES == {**dict.fromkeys(halo.COLLECTIVES, 0), "all_to_all": 2 * MOE_KW["n_layers"]}
    # the replicated forward, and the aux loss, are the same function
    whole, aux_whole = ttf.forward_lm(params, torch.from_numpy(toks), cfg, return_aux=True)
    _, aux = ttf.forward_lm(sharded, torch.from_numpy(toks), cfg, return_aux=True)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=RTOL, atol=ATOL)
    assert float(aux) == float(aux_whole)


def test_ep_train_step_matches_the_jax_step(moe):
    """``make_ep_train_step`` on ep-sharded params against the JAX package's
    on its ep mesh (lr 5e-2, SGD on both sides): the loss, every gradient
    leaf, the params after the step; the pieces stay on their slots, and a
    second step (Adam, ``tests/test_expert_parallel.py``'s check) lowers the
    loss."""
    jcfg, jparams, cfg, params, toks = moe
    jmesh = jmake_mesh(8, axis_name="ep")
    jsharded = jep.shard_moe_params(jparams, jmesh)
    j_init, j_step = jep.make_ep_train_step(jcfg, jmesh, optimizer=optax.sgd(5e-2))
    j_new, _, j_loss = j_step(jsharded, j_init(jsharded), jnp.asarray(toks))
    want_grads = jax.jit(jax.grad(lambda p: jtf.lm_loss(p, jnp.asarray(toks), jcfg)))(jparams)
    mesh = make_mesh(8, axis_name="ep", device="cpu")
    sharded = expert.shard_moe_params(params, mesh)
    init, update = sgd(5e-2)
    caught = {}

    def spy(grads, state, p=None):
        caught["g"] = grads
        return update(grads, state, p)

    _, step = expert.make_ep_train_step(cfg, mesh, optimizer=(init, spy))
    state = init(sharded)
    new, state, loss = step(sharded, state, torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for g, w in zip(tree_leaves(fsdp.gather_params(caught["g"])), jax.tree.leaves(want_grads)):
        w = np.asarray(w)
        assert g.shape == w.shape and float(np.abs(g.numpy() - w).max()) <= 1e-5 * float(np.abs(w).max())
    assert isinstance(new["layers"][0]["w_up"], fsdp.Pieces) and len(new["layers"][0]["w_up"]) == 8
    for a, b in zip(tree_leaves(fsdp.gather_params(new)), jax.tree.leaves(j_new)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-6)
    init, step = expert.make_ep_train_step(cfg, mesh, lr=5e-2)
    p, state, l0 = step(sharded, init(sharded), torch.from_numpy(toks))
    _, _, l1 = step(p, state, torch.from_numpy(toks))
    assert float(l1) < float(l0)


def test_ep_bf16_step_and_generation(moe):
    """bf16 mixed precision on ep pieces: the loss within the bf16 rule
    (1e-2 rel) of the fp32 step, masters fp32 pieces; greedy generation on
    ep params is the whole tree's (decode runs on one device)."""
    _, _, cfg, params, toks = moe
    sharded = expert.shard_moe_params(params, make_mesh(4, axis_name="ep", device="cpu"))
    t = torch.from_numpy(toks)
    init, step = ttf.make_lm_train_step(cfg, lr=1e-2)
    _, _, l32 = step(sharded, init(sharded), t)
    init, step = ttf.make_lm_train_step(cfg, lr=1e-2, compute_dtype=torch.bfloat16)
    p, _, l16 = step(sharded, init(sharded), t)
    np.testing.assert_allclose(float(l16), float(l32), rtol=1e-2)
    assert all(x.dtype == torch.float32 for x in tree_leaves(p)) and isinstance(p["layers"][1]["w_down"], fsdp.Pieces)
    assert torch.equal(ttf.generate(sharded, t[:2, :6], cfg, steps=5), ttf.generate(params, t[:2, :6], cfg, steps=5))
