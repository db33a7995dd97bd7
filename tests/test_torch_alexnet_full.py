"""The port's full AlexNet (``v6_full_jit``, ``v6_full_pallas``) against the
JAX package's, on the CPU.

At the JAX tests' ``SMALL`` config (99x99 input, fc6 64, fc7 32, 10
classes; spatial 2x2x256 after pool5) JAX-drawn params and input go through
JAX ``forward_alexnet`` (its reference ops: no Pallas in interpret mode) and
through the port's two tiers (on the CPU the kernel tier runs each kernel's
plain version). fp32: rtol 2e-5, atol 2e-4, JAX's own tier tolerance
(``tests/test_alexnet_full.py``). bf16: the port's tiers within the bf16
budget of ``precision/gate.py`` (2e-2 of the oracle's max) of the fp32
oracle, the budget the JAX package's own bf16 forward meets here too. One
test runs the full size at batch 1: JAX's seed-0 params and input carried
across must give the V6 golden (``tests/oracle.py``) to atol 2e-3.
"""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch
from oracle import V6_RANDOM_SEED0_BATCH1_FIRST10

from cuda_mpi_gpu_cluster_programming_tpu import configs as jcfg
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet_full as jfull
from cuda_mpi_gpu_cluster_programming_tpu.models import init as jinit
from cuda_mpi_gpu_cluster_programming_tpu.precision import gate as jgate
from cuda_mpi_gpu_cluster_programming_tpu.tuning import plan as jplan
from cuda_mpi_gpu_cluster_programming_tpu_torch import configs as tcfg
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet as talex
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet_full as tfull
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import kernel_model as km
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import reference as tops
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops.variants import KernelVariants
from cuda_mpi_gpu_cluster_programming_tpu_torch.tuning import plan as tplan
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import profiling as tprof

tat = importlib.import_module("cuda_mpi_gpu_cluster_programming_tpu_torch.tuning.autotune")

J_SMALL = jfull.AlexNetConfig(blocks12=dataclasses.replace(jalex.BLOCKS12, in_height=99, in_width=99),
                              fc6=64, fc7=32, num_classes=10)
T_SMALL = tfull.AlexNetConfig(blocks12=dataclasses.replace(talex.BLOCKS12, in_height=99, in_width=99),
                              fc6=64, fc7=32, num_classes=10)
TIERS = ("v6_full_jit", "v6_full_pallas")
BF16_REL = jgate.DEFAULT_BUDGETS["bf16"]["*"].max_rel  # 2e-2 of the oracle's max


def _jax_case(seed, batch=2):
    params = jfull.init_full_random(jax.random.PRNGKey(seed), J_SMALL)
    x = jax.random.uniform(jax.random.PRNGKey(0), (batch, 99, 99, 3))
    return params, x


def _port(params, x):
    return tinit.params_from_jax(params, device="cpu"), torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def case():
    params, x = _jax_case(4)
    return params, x, np.asarray(jfull.forward_alexnet(params, x, J_SMALL))


def test_dims_param_shapes_and_flops_match_jax():
    assert tfull.spatial_output_shape(tfull.ALEXNET) == jfull.spatial_output_shape(jfull.ALEXNET) == (6, 6, 256)
    assert tfull.spatial_output_shape(T_SMALL) == (2, 2, 256)
    for tcfg_, jcfg_ in ((tfull.ALEXNET, jfull.ALEXNET), (T_SMALL, J_SMALL)):
        assert tfull._param_shapes(tcfg_) == jfull._param_shapes(jcfg_)
        assert [(n, i, o) for n, _s, i, o in talex.layer_dims(tcfg_)] == \
            [(n, i, o) for n, _s, i, o in jalex.layer_dims(jcfg_)]
        assert list(talex.stage_flops(tcfg_)) == list(jalex.stage_flops(jcfg_))
        assert talex.flops_per_image(tcfg_) == jalex.flops_per_image(jcfg_)
    shapes = tfull._param_shapes(tfull.ALEXNET)
    assert shapes["conv4"][0] == (3, 3, 384, 384) and shapes["fc6"][0] == (6 * 6 * 256, 4096)
    p = tfull.init_full_deterministic(T_SMALL, device="cpu")
    assert {k: (tuple(v["w"].shape), tuple(v["b"].shape)) for k, v in p.items()} == tfull._param_shapes(T_SMALL)
    assert jplan.shape_key(J_SMALL) == tplan.shape_key(T_SMALL) == "alexnet_full_99x99x3"


def test_blocks12_prefix_bitwise():
    """forward_spatial is forward_blocks12 followed by conv3..conv5 (ReLU
    each) and pool5, bit for bit: the Blocks 1-2 prefix keeps its golden."""
    params, x = _port(*_jax_case(1, batch=1))
    want = talex.forward_blocks12(params, x, T_SMALL.blocks12)
    for name in ("conv3", "conv4", "conv5"):
        spec = getattr(T_SMALL, name)
        want = tops.relu(tops.conv2d(want, params[name]["w"], params[name]["b"], stride=spec.stride,
                                     padding=spec.padding))
    want = tops.maxpool(want, window=3, stride=2)
    assert torch.equal(tfull.forward_spatial(params, x, T_SMALL), want)


@pytest.mark.parametrize("key", TIERS)
def test_tier_fp32_matches_jax(case, key):
    params, x, want = case
    got = tcfg.build_forward(tcfg.REGISTRY[key], T_SMALL, device="cpu")(*_port(params, x))
    assert got.shape == (2, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("key", TIERS)
def test_tier_bf16_within_the_gate_budget(case, key):
    params, x, want = case
    jbf16 = np.asarray(jcfg.build_forward(jcfg.REGISTRY[key.replace("pallas", "jit")], J_SMALL,
                                          policy="bf16")(params, x))
    got = tcfg.build_forward(tcfg.REGISTRY[key], T_SMALL, policy="bf16", device="cpu")(*_port(params, x)).numpy()
    omax = np.abs(want).max()
    assert np.abs(jbf16 - want).max() <= BF16_REL * omax  # the JAX package's bf16 meets the budget
    assert np.abs(got - want).max() <= BF16_REL * omax


@pytest.mark.parametrize("fuse", ["hpool", "block"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_routes_bitwise_staged_on_the_full_model(case, fuse, dtype):
    """fuse="hpool" and "block" reach conv1, conv2 and conv5 (the conv ->
    pool adjacencies the chain walker finds; conv5 -> pool5 has no LRN)."""
    params, x, _want = case
    p, xx = _port(params, x)
    p, xx = tinit.params_to(p, dtype=dtype), xx.to(dtype)
    staged = km.forward_alexnet_kernels(p, xx, T_SMALL, variants=KernelVariants())
    fused = km.forward_alexnet_kernels(p, xx, T_SMALL, variants=KernelVariants(fuse=fuse))
    assert torch.equal(fused, staged)


def test_softmax_and_dropout(case):
    params, x, _want = case
    p, xx = _port(params, x)
    probs = tfull.predict(p, xx, T_SMALL)
    np.testing.assert_allclose(probs.sum(-1).numpy(), np.ones(2), rtol=1e-5)
    eval1, eval2 = tfull.forward_alexnet(p, xx, T_SMALL), tfull.forward_alexnet(p, xx, T_SMALL)
    assert torch.equal(eval1, eval2)
    train = tfull.forward_alexnet(p, xx, T_SMALL, generator=torch.Generator().manual_seed(0))
    again = tfull.forward_alexnet(p, xx, T_SMALL, generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(train, eval1) and torch.equal(train, again)


def test_int8w_is_refused_on_full_configs():
    for key in TIERS:
        with pytest.raises(ValueError, match="Blocks 1-2"):
            tcfg.build_forward(tcfg.REGISTRY[key], T_SMALL, policy="int8w", device="cpu")
        with pytest.raises(ValueError, match="Blocks 1-2"):
            jcfg.build_forward(jcfg.REGISTRY[key], J_SMALL, policy="int8w")


def test_tuning_and_breakdown_walk_five_conv_layers(tmp_path):
    with pytest.raises(ValueError, match="alexnet_full"):
        tat.autotune_precision(tmp_path / "p.json", T_SMALL, batch=2, device="cpu")
    plan, cached = tat.autotune(tmp_path / "p.json", T_SMALL, dtype="fp32", batch=2, log=lambda s: None,
                                timer=lambda g, v, *a: (1.0 + len(v.label()) / 100.0, 0.01, 3), device="cpu")
    assert not cached and [n for n, _v in plan.layers] == ["conv1", "conv2", "conv3", "conv4", "conv5"]
    assert plan.shape_key == "alexnet_full_99x99x3" and not plan.degraded
    assert all(plan.stats[n]["failed"] == 0 for n, _v in plan.layers)
    params, x = _port(*_jax_case(3, batch=1))
    for tier, fwd in (("reference", tfull.forward_alexnet), ("kernels", km.forward_alexnet_kernels)):
        stages = tprof.stage_fns(T_SMALL, tier=tier)
        assert [n for n, _f in stages] == ["conv1", "pool1", "conv2", "pool2", "lrn2", "conv3", "conv4", "conv5",
                                           "pool5", "fc6", "fc7", "fc8"]
        cur = x
        for _n, f in stages:
            cur = f(params, cur)
        assert torch.equal(cur, fwd(params, x, T_SMALL))


@pytest.fixture(scope="module")
def golden_case():
    """JAX's seed-0 params and input at full size, batch 1, as its run.py
    draws them (``kp, kx = split(PRNGKey(0))``), carried across."""
    kp, kx = jax.random.split(jax.random.PRNGKey(0))
    params = jfull.init_full_random(kp)
    x = jinit.random_input(kx, batch=1)
    return tinit.params_from_jax(params, device="cpu"), torch.from_numpy(np.array(x))


@pytest.mark.parametrize("key", TIERS)
def test_v6_golden_at_full_size(golden_case, key):
    params, x = golden_case
    out = tcfg.build_forward(tcfg.REGISTRY[key], device="cpu")(params, x)
    assert out.shape == (1, 1000)
    first10 = out[0, :10].numpy()
    np.testing.assert_allclose(first10, np.array(V6_RANDOM_SEED0_BATCH1_FIRST10, np.float32), atol=2e-3)
    assert len({round(float(v), 4) for v in first10[:5]}) == 5  # discriminative, unlike the constant init

