"""The port's Blocks 1-2 slice against the JAX package, on the CPU.

The same numpy-seeded params and input go through the JAX package's
``build_forward`` (Pallas in interpret mode for ``v3_pallas``) and the
port's, config by config. Budgets are the JAX package's
``precision/gate.py`` ones: fp32 1e-4 abs and 1e-5 of the stage max (both
sides accumulate in fp32, in different orders); bf16 2e-2 of the max
against the fp32 oracle (bf16 operand rounding through two convs).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu import configs as jcfg
from cuda_mpi_gpu_cluster_programming_tpu import harness as jharness
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.models import init as jinit
from cuda_mpi_gpu_cluster_programming_tpu.utils import timing as jtiming
from cuda_mpi_gpu_cluster_programming_tpu_torch import configs as tcfg
from cuda_mpi_gpu_cluster_programming_tpu_torch import run as trun
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet as talex
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.specs import spec_for
from cuda_mpi_gpu_cluster_programming_tpu_torch.precision.policy import resolve_policy
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import timing as ttiming

GOLDEN_FIRST10 = np.array(
    [29.2932, 25.9153, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255],
    dtype=np.float32,
)
FP32_ABS, FP32_REL, BF16_REL = 1e-4, 1e-5, 2e-2


def _geometry(hw):
    return (
        dataclasses.replace(jalex.BLOCKS12, in_height=hw, in_width=hw),
        dataclasses.replace(talex.BLOCKS12, in_height=hw, in_width=hw),
    )


def _numpy_case(hw, seed=2026):
    """init_params_random's distribution (uniform [0,1) weights, bias 0.1)
    and a uniform [0,1) input, drawn with numpy."""
    rng = np.random.default_rng(seed + hw)
    params = {
        "conv1": {"w": rng.random((11, 11, 3, 96), dtype=np.float32), "b": np.full(96, 0.1, np.float32)},
        "conv2": {"w": rng.random((5, 5, 96, 256), dtype=np.float32), "b": np.full(256, 0.1, np.float32)},
    }
    return params, rng.random((2, hw, hw, 3), dtype=np.float32)


_JAX_OUT = {}


def _jax_out(key, policy, hw):
    """The JAX package's output for one config/policy/geometry (cached:
    each costs a jit compile)."""
    if (key, policy, hw) not in _JAX_OUT:
        params, x = _numpy_case(hw)
        jcfg_geo, _ = _geometry(hw)
        fwd = jcfg.build_forward(jcfg.REGISTRY[key], jcfg_geo, compute=policy)
        out = fwd(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
        _JAX_OUT[(key, policy, hw)] = np.asarray(out, dtype=np.float32)
    return _JAX_OUT[(key, policy, hw)]


def _rel_of_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("key", ["v3_pallas", "v1_jit"])
@pytest.mark.parametrize("hw", [67, 45])  # 45: (45 - 11) % 4 != 0, the floor crop
def test_slice_matches_jax(hw, key, policy):
    params, x = _numpy_case(hw)
    _, tgeo = _geometry(hw)
    fwd = tcfg.build_forward(tcfg.REGISTRY[key], tgeo, policy=policy, device="cpu")
    got = fwd(tinit.params_from_jax(params, "cpu"), torch.from_numpy(x)).numpy()
    want = _jax_out(key, policy, hw)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, *talex.output_shape(tgeo))
    assert np.isfinite(got).all()
    oracle = _jax_out("v1_jit", "fp32", hw)
    if policy == "fp32":
        assert float(np.abs(got - want).max()) <= FP32_ABS
        assert _rel_of_max(got, want) <= FP32_REL
    else:
        assert _rel_of_max(got, want) <= BF16_REL
        assert _rel_of_max(got, oracle) <= BF16_REL


@pytest.mark.parametrize("key", ["v3_pallas", "v1_jit"])
def test_golden_first10(key):
    fwd = tcfg.build_forward(tcfg.REGISTRY[key], device="cpu")
    out = fwd(tinit.init_params_deterministic(device="cpu"), tinit.deterministic_input(1, device="cpu"))
    assert tuple(out.shape) == (1, 13, 13, 256)
    np.testing.assert_allclose(out[0].reshape(-1)[:10].numpy(), GOLDEN_FIRST10, rtol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_jax_carries_values_and_dtypes(dtype):
    jp = jinit.init_params_random(jax.random.PRNGKey(7), dtype=dtype)
    tp = tinit.params_from_jax(jp, device="cpu")
    assert set(tp) == {"conv1", "conv2"}
    for layer in jp:
        for name in ("w", "b"):
            t = tp[layer][name]
            assert t.dtype == (torch.float32 if dtype == jnp.float32 else torch.bfloat16)
            assert tuple(t.shape) == jp[layer][name].shape
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(jp[layer][name], dtype=np.float32))


def test_reference_layout_converters_match_jax():
    w = np.random.default_rng(5).random((5, 5, 4, 6), dtype=np.float32)
    flat = tinit.to_reference_layout(torch.from_numpy(w))
    np.testing.assert_array_equal(flat, jinit.to_reference_layout(w))
    back = tinit.from_reference_layout(flat, 5, 4, 6, device="cpu")
    np.testing.assert_array_equal(back.numpy(), np.asarray(jinit.from_reference_layout(flat, 5, 4, 6)))


def _dims(alex, geo):
    return [(n, type(s).__name__, dataclasses.asdict(s), i, o) for n, s, i, o in alex.layer_dims(geo)]


@pytest.mark.parametrize("hw", [227, 67, 45])
def test_shapes_and_flops_match_jax(hw):
    jgeo, tgeo = _geometry(hw)
    assert _dims(talex, tgeo) == _dims(jalex, jgeo)
    assert talex.output_shape(tgeo) == jalex.output_shape(jgeo)
    assert list(talex.stage_flops(tgeo)) == list(jalex.stage_flops(jgeo))
    assert talex.flops_per_image(tgeo) == jalex.flops_per_image(jgeo)
    assert talex.matmul_flops_per_image(tgeo) == jalex.matmul_flops_per_image(jgeo)


def test_flops_per_image_default():
    assert talex.flops_per_image() == 1_108_641_024


def test_run_cli_stdout_contract(capsys):
    rc = trun.main(
        ["--config", "v3_pallas", "--device", "cpu", "--height", "67", "--width", "67",
         "--batch", "2", "--repeats", "1", "--warmup", "1"]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert jharness._RE_PRECISION.search(out).group(1) == "fp32"
    assert float(jharness._RE_COMPILE.search(out).group(1)) > 0
    assert jharness._RE_SHAPE.search(out).group(1) == "3x3x256"
    first10 = [float(v) for v in jharness._RE_FIRST.search(out).group(1).split()]
    assert len(first10) == 10 and np.isfinite(first10).all()
    assert float(jharness._RE_TIME.search(out).group(1)) > 0
    assert re.search(r"^AlexNet CPU Forward Pass completed in", out, re.MULTILINE)
    assert re.search(r"^Timing stats: n=\d+ ci95=", out, re.MULTILINE)
    assert re.search(r"^Kernel launches: conv2d=0 maxpool2d=0 lrn=0 conv_block=0 (\w+=0 )*passes=\d+$", out,
                     re.MULTILINE)


def test_run_cli_lists_both_configs(capsys):
    assert trun.main(["--list-configs"]) == 0
    out = capsys.readouterr().out
    assert "v1_jit" in out and "v3_pallas" in out


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--config", "v3_pallas", "--height", "67", "--width", "67"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcfg.build_forward(tcfg.REGISTRY["v1_jit"])


def test_int8w_names_the_roadmap_item():
    pol = resolve_policy("int8w")
    assert pol.name == "int8w" and pol.quantized and pol.layer("conv1").params == "int8"
    with pytest.raises(ValueError):
        resolve_policy("fp64")
    assert resolve_policy(None).name == "fp32"


def test_amortized_stats_ci_matches_jax_estimator():
    samples = [1.0, 1.1, 0.9, 1.0, 8.0]
    t = ttiming.AmortizedStats(samples, 10, False, 0.0)
    j = jtiming.AmortizedStats(samples, 10, False, 0.0)
    assert (t.per_call_ms, t.ci95_ms, t.stdev_ms) == (j.per_call_ms, j.ci95_ms, j.stdev_ms)


def test_amortized_stats_on_cpu_measures_a_positive_time():
    x = torch.ones(64, 64)
    st = ttiming.amortized_stats(torch.mm, x, x, n_small=2, n_large=6, min_samples=1, max_samples=2)
    assert st.per_call_ms > 0 and st.n_chain >= 6


def test_amortized_stats_on_cpu_does_a_fixed_amount_of_work():
    """On the CPU a preempted short run (here: a slow first chain) neither
    doubles the long chain nor draws more pairs than ``min_samples``: the
    call count is fixed whatever the host's load."""
    import time

    calls = []

    def fn(x):
        calls.append(1)
        if 2 <= len(calls) <= 3:  # the first short chain, preempted
            time.sleep(0.05)
        return x

    st = ttiming.amortized_stats(fn, torch.ones(1), n_small=2, n_large=6, min_samples=3, max_samples=15)
    assert st.n_chain == 6 and st.shadowed and len(calls) == 1 + 2 + 6
    calls.clear()
    st = ttiming.amortized_stats(lambda x: calls.append(1) or x, torch.ones(1), n_small=2, n_large=6, min_samples=3,
                                 max_samples=15)
    assert st.n_chain == 6 and len(calls) <= 1 + 2 * 3 * (2 + 6)


@pytest.mark.parametrize(
    "name, part",
    [("NVIDIA H100 80GB HBM3", "H100 SXM"), ("NVIDIA H100 PCIe", "H100 PCIe"), ("NVIDIA H100 NVL", "H100 NVL")],
)
def test_spec_tells_h100_parts_apart(name, part):
    spec, assumed = spec_for(name)
    assert spec.name == part and not assumed
    t, by = spec.bound_ms(26.99e9, 0.228e9, "fp32")
    assert by == "operations" and t == pytest.approx(26.99e9 / (spec.fp32_tflops * 1e9))
    assert spec_for("cpu") == (spec_for("NVIDIA H100 80GB HBM3")[0], True)
