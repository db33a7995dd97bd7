"""The port's ``training.py`` against the JAX package's, on the CPU.

The same numpy params, inputs and targets through both packages' steps:
the single-device step, the row-sharded one (``sp_shards=2``), the
tensor-parallel one (``tp_shards=2``), with the gradient's global norm, the
elastic step builder's rungs, and full AlexNet's classifier step with Adam.
Losses, grad norms and updated params agree within 1e-5 of the max (the
gradients come from ``torch.autograd`` against ``jax.value_and_grad``, so
the sums round differently); SGD is optax's ``(-lr) * g``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu import training as jtrain
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet_full as jfull
from cuda_mpi_gpu_cluster_programming_tpu.parallel.mesh import make_mesh as jmesh
from cuda_mpi_gpu_cluster_programming_tpu.resilience.supervisor import LadderEntry as JEntry
from cuda_mpi_gpu_cluster_programming_tpu_torch import training as ttrain
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet as talex
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet_full as tfull
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.mesh import make_mesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.supervisor import LadderEntry
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.optim import adam, sgd
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_leaves

JCFG = dataclasses.replace(jalex.BLOCKS12, in_height=63, in_width=63)
TCFG = dataclasses.replace(talex.BLOCKS12, in_height=63, in_width=63)
REL = 1e-5


def _case(seed=30, batch=2):
    rng = np.random.default_rng(seed)

    def w(*shape):
        fan_in = shape[0] * shape[1] * shape[2]
        return ((rng.random(shape, dtype=np.float32) - 0.5) * (4 / fan_in**0.5)).astype(np.float32)

    params = {"conv1": {"w": w(11, 11, 3, 96), "b": ((rng.random(96, dtype=np.float32) - 0.5) * 0.2)},
              "conv2": {"w": w(5, 5, 96, 256), "b": ((rng.random(256, dtype=np.float32) - 0.5) * 0.2)}}
    x = rng.random((batch, 63, 63, 3), dtype=np.float32)
    y = rng.random((batch, *talex.output_shape(TCFG)), dtype=np.float32)
    return params, x, y


CASE = _case()


def _close(got, want, rel=REL):
    for a, b in zip(tree_leaves(got) if not isinstance(got, torch.Tensor) else [got],
                    jax.tree.leaves(want) if not isinstance(got, torch.Tensor) else [want]):
        a = a.detach().numpy().astype(np.float64)
        b = np.asarray(b, np.float64)
        scale = max(float(np.max(np.abs(b))), 1e-30)
        assert float(np.max(np.abs(a - b))) <= rel * scale, (float(np.max(np.abs(a - b))), scale)


def _run(kw_t, kw_j, steps=2, lr=1e-2):
    params, x, y = CASE
    ti, ts = ttrain.make_train_step(TCFG, lr=lr, with_grad_norm=True, device="cpu", **kw_t)
    ji, js = jtrain.make_train_step(JCFG, lr=lr, with_grad_norm=True, **kw_j)
    tp, to = tinit.params_from_jax(params, device="cpu"), None
    jp = jax.tree.map(jnp.asarray, params)
    to, jo = ti(tp), ji(jp)
    for _ in range(steps):
        tp, to, tl, tg = ts(tp, to, torch.from_numpy(x), torch.from_numpy(y))
        jp, jo, jl, jg = js(jp, jo, jnp.asarray(x), jnp.asarray(y))
        assert float(tl) == pytest.approx(float(jl), rel=REL) and float(tg) == pytest.approx(float(jg), rel=REL)
    _close(tp, jp)
    return tp


def test_single_device_step_matches_the_jax_step():
    p = _run({}, {})
    params, _, _ = CASE
    assert not np.array_equal(p["conv1"]["w"].numpy(), params["conv1"]["w"])  # it moved


def test_row_sharded_step_matches_the_jax_step_and_the_unsharded_one():
    p_sp = _run({"sp_shards": 2, "mesh": make_mesh(2, device="cpu")}, {"sp_shards": 2, "mesh": jmesh(2)})
    params, x, y = CASE
    _i, one = ttrain.make_train_step(TCFG, lr=1e-2, device="cpu")
    tp, to = tinit.params_from_jax(params, device="cpu"), ()
    for _ in range(2):
        tp, to, _l = one(tp, to, torch.from_numpy(x), torch.from_numpy(y))
    _close(p_sp, {k: {kk: vv.numpy() for kk, vv in v.items()} for k, v in tp.items()}, rel=1e-6)
    with pytest.raises(ValueError, match="sp_shards=4"):
        ttrain.make_train_step(TCFG, mesh=make_mesh(2, device="cpu"), sp_shards=4, device="cpu")


def test_tensor_parallel_step_matches_the_jax_step():
    _run({"tp_shards": 2}, {"tp_shards": 2, "mesh": jmesh(2, axis_name="tp")}, steps=1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ttrain.make_train_step(TCFG, sp_shards=2, tp_shards=2, device="cpu")


def test_remat_and_a_data_parallel_mesh_change_nothing():
    params, x, y = CASE
    outs = []
    for kw in ({}, {"remat": True}, {"mesh": make_mesh(2, dp=2, device="cpu")}):
        i, s = ttrain.make_train_step(TCFG, lr=1e-2, device="cpu", **kw)
        p = tinit.params_from_jax(params, device="cpu")
        outs.append(s(p, i(p), torch.from_numpy(x), torch.from_numpy(y)))
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(o[0]), tree_leaves(outs[0][0])))
        assert torch.equal(o[2], outs[0][2])


def test_elastic_builder_maps_each_rung_to_its_strategy():
    params, x, y = CASE
    build = ttrain.make_elastic_step_builder(TCFG, optimizer=sgd(1e-2), device="cpu")
    jbuild = jtrain.make_elastic_step_builder(JCFG, optimizer=optax.sgd(1e-2))
    for entry, mesh, jm in ((LadderEntry("halo", "reference", 2), make_mesh(2, device="cpu"), jmesh(2)),
                            (LadderEntry("single", "reference", 1), None, None)):
        tp = tinit.params_from_jax(params, device="cpu")
        out = build(entry, mesh)(tp, (), torch.from_numpy(x), torch.from_numpy(y))
        jentry = JEntry(entry.strategy, entry.tier, entry.n_shards)
        jp = jax.tree.map(jnp.asarray, params)
        jout = jbuild(jentry, jm)(jp, optax.sgd(1e-2).init(jp), jnp.asarray(x), jnp.asarray(y))
        _close(out[0], jout[0])
        assert float(out[2]) == pytest.approx(float(jout[2]), rel=REL)
    with pytest.raises(ValueError, match="no elastic training step"):
        build(LadderEntry("fsdp", "reference", 2), None)


def test_full_alexnet_classifier_step_matches_the_jax_step():
    jcfg = jfull.AlexNetConfig(blocks12=dataclasses.replace(jalex.BLOCKS12, in_height=99, in_width=99),
                               fc6=64, fc7=32, num_classes=10)
    tcfg = tfull.AlexNetConfig(blocks12=dataclasses.replace(talex.BLOCKS12, in_height=99, in_width=99),
                               fc6=64, fc7=32, num_classes=10)
    params = jfull.init_full_random(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    x = rng.random((2, 99, 99, 3), dtype=np.float32)
    labels = np.array([3, 7], np.int32)
    ji, js = jtrain.make_classifier_train_step(jcfg, lr=1e-3)
    ti, ts = ttrain.make_classifier_train_step(tcfg, lr=1e-3)
    jp, tp = params, tinit.params_from_jax(params, device="cpu")
    jo, to = ji(jp), ti(tp)
    for _ in range(2):
        jp, jo, jl = js(jp, jo, jnp.asarray(x), jnp.asarray(labels))
        tp, to, tl = ts(tp, to, torch.from_numpy(x), torch.from_numpy(labels))
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    # Adam's step is lr * m / sqrt(nu), about lr in size whatever the gradient's, so where a gradient is at its
    # rounding's level the two packages' steps may differ by up to lr a step; everywhere else they agree
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        diff = np.abs(a.numpy().astype(np.float64) - np.asarray(b, np.float64))
        assert float(diff.max()) <= 2 * 1e-3 and float(diff.mean()) <= 1e-6
    assert int(to["count"]) == 2 and adam(1e-3)[0](tp)["count"].dtype == torch.int32
