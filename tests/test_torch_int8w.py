"""The port's ``int8w`` policy against the JAX package, on the CPU.

Quantization is held BITWISE to the JAX package's (``q`` and ``scale``,
including an all-zero channel and exact .5 ties: both round half to even).
The forwards are held to the JAX package's int8w budget, 6e-2 of the max
(``precision/gate.py``), and one conv to 1 bf16 ulp (both round one fp32
result to bf16; another summation order can flip that rounding). Inputs
are numpy-seeded, small (43x43 and 45x45, batch 2); the JAX Pallas tier
runs in interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu import configs as jcfg
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.ops import pallas_kernels as pk
from cuda_mpi_gpu_cluster_programming_tpu.ops import reference as jref
from cuda_mpi_gpu_cluster_programming_tpu.precision import gate as jgate
from cuda_mpi_gpu_cluster_programming_tpu.precision import quantize as jq
from cuda_mpi_gpu_cluster_programming_tpu_torch import configs as tcfg
from cuda_mpi_gpu_cluster_programming_tpu_torch import run as trun
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet as talex
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import reference as tref
from cuda_mpi_gpu_cluster_programming_tpu_torch.precision import gate as tgate
from cuda_mpi_gpu_cluster_programming_tpu_torch.precision import quantize as tq

INT8W_REL = 6e-2
BF16_ULP_REL = 2.0**-7


def _geometry(hw):
    return (
        dataclasses.replace(jalex.BLOCKS12, in_height=hw, in_width=hw),
        dataclasses.replace(talex.BLOCKS12, in_height=hw, in_width=hw),
    )


def _numpy_case(hw, seed=2026):
    rng = np.random.default_rng(seed + hw)
    params = {
        "conv1": {"w": rng.random((11, 11, 3, 96), dtype=np.float32), "b": np.full(96, 0.1, np.float32)},
        "conv2": {"w": rng.random((5, 5, 96, 256), dtype=np.float32), "b": np.full(256, 0.1, np.float32)},
    }
    return params, rng.random((2, hw, hw, 3), dtype=np.float32)


def _jp(params):
    return {n: {k: jnp.asarray(a) for k, a in p.items()} for n, p in params.items()}


def _rel_of_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tie_weights():
    """HWIO weights with an all-zero channel (1) and a channel (0) whose
    max is 127, so scale is 1.0 and the .5 values are exact ties."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    w[..., 1] = 0.0
    w[..., 0] = 0.0
    w[0, 0, :, 0] = [127.0, 2.5, -3.5, 0.5]
    w[1, 1, :, 0] = [-0.5, 1.5, -2.5, 126.5]
    return w


@pytest.mark.parametrize("case", ["ties", "normal", "uniform_conv2"])
def test_quantize_channelwise_bitwise_jax(case):
    if case == "ties":
        w = _tie_weights()
    elif case == "normal":
        w = np.random.default_rng(4).standard_normal((11, 11, 3, 96)).astype(np.float32)
    else:
        w = _numpy_case(43)[0]["conv2"]["w"]
    jqv, js = jq.quantize_channelwise(jnp.asarray(w))
    tqv, ts = tq.quantize_channelwise(torch.from_numpy(w))
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if case == "ties":
        assert ts[1] == 1.0 and (tqv[..., 1] == 0).all()
        assert tqv[0, 0, :, 0].tolist() == [127, 2, -4, 0] and tqv[1, 1, :, 0].tolist() == [0, 2, -2, 126]


def test_dequantize_and_error_bound_match_jax():
    w = np.random.default_rng(5).standard_normal((5, 5, 8, 16)).astype(np.float32)
    tqv, ts = tq.quantize_channelwise(torch.from_numpy(w))
    jqv, js = jq.quantize_channelwise(jnp.asarray(w))
    np.testing.assert_array_equal(tq.dequantize(tqv, ts).numpy(), np.asarray(jq.dequantize(jqv, js)))
    bound = tq.roundtrip_error_bound(torch.from_numpy(w))
    np.testing.assert_array_equal(bound.numpy(), np.asarray(jq.roundtrip_error_bound(jnp.asarray(w))))
    assert (np.abs(tq.dequantize(tqv, ts).numpy() - w) <= bound.numpy()).all()


def test_quantize_conv_params_keeps_the_bias():
    params = tinit.params_from_jax(_numpy_case(43)[0], "cpu")
    qp = tq.quantize_conv_params(params)
    assert set(qp) == {"conv1", "conv2"}
    for name in qp:
        assert set(qp[name]) == {"q", "scale", "b"} and qp[name]["b"] is params[name]["b"]


@pytest.mark.parametrize("tier", ["reference", "kernels"])
@pytest.mark.parametrize("relu", [True, False])
def test_int8w_conv_matches_jax(tier, relu):
    rng = np.random.default_rng(9)
    x = rng.random((2, 13, 13, 12), dtype=np.float32)
    w = rng.standard_normal((5, 5, 12, 16)).astype(np.float32)
    b = (0.5 * rng.standard_normal(16)).astype(np.float32)
    jqv, js = jq.quantize_channelwise(jnp.asarray(w))
    want = jq.int8w_conv(
        jnp.asarray(x), jqv, js, jnp.asarray(b), stride=1, padding=2, relu=relu,
        tier="pallas" if tier == "kernels" else "reference",
    )
    tqv, ts = tq.quantize_channelwise(torch.from_numpy(w))
    got = tq.int8w_conv(torch.from_numpy(x), tqv, ts, torch.from_numpy(b), stride=1, padding=2, relu=relu, tier=tier)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP_REL, atol=1e-5 * np.abs(want).max())


def test_reference_conv_accumulates_bf16_operands_in_fp32():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((1, 9, 9, 8)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = jref.conv2d(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(b),
        stride=1, padding=1, preferred_element_type=jnp.float32,
    )
    got = tref.conv2d(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(b),
        stride=1, padding=1, preferred_element_type=torch.float32,
    )
    assert got.dtype == torch.float32  # F.conv2d on bf16 would return bf16
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    same = tref.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride=1, padding=1)
    assert same.dtype == torch.float32


_JAX_OUT = {}


def _jax_int8w(key, fuse, hw):
    if (key, fuse, hw) not in _JAX_OUT:
        params, x = _numpy_case(hw)
        jgeo, _ = _geometry(hw)
        tier = "pallas" if key == "v3_pallas" else "reference"
        out = jq.forward_blocks12_int8w(_jp(params), jnp.asarray(x), jgeo, variants=pk.KernelVariants(fuse=fuse),
                                        tier=tier)
        _JAX_OUT[(key, fuse, hw)] = np.asarray(out, np.float32)
    return _JAX_OUT[(key, fuse, hw)]


@pytest.mark.parametrize("key", ["v1_jit", "v3_pallas"])
@pytest.mark.parametrize("hw", [43, 45])
def test_build_forward_int8w_staged_matches_jax(hw, key):
    params, x = _numpy_case(hw)
    _, tgeo = _geometry(hw)
    fwd = tcfg.build_forward(tcfg.REGISTRY[key], tgeo, policy="int8w", device="cpu")
    got = fwd(tinit.params_from_jax(params, "cpu"), torch.from_numpy(x)).numpy()
    want = _jax_int8w(key, "none", hw)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, *talex.output_shape(tgeo))
    rel = _rel_of_max(got, want)
    print(f"int8w staged {key} {hw}x{hw}: rel_of_max={rel:.3g}")
    assert rel <= INT8W_REL


def test_build_forward_int8w_matches_the_jax_build_forward():
    params, x = _numpy_case(43)
    jgeo, tgeo = _geometry(43)
    want = np.asarray(jcfg.build_forward(jcfg.REGISTRY["v1_jit"], jgeo, policy="int8w")(_jp(params), jnp.asarray(x)))
    got = tcfg.build_forward(tcfg.REGISTRY["v1_jit"], tgeo, policy="int8w", device="cpu")(
        tinit.params_from_jax(params, "cpu"), torch.from_numpy(x)
    ).numpy()
    assert _rel_of_max(got, want) <= INT8W_REL


def test_int8w_taps_match_jax_stage_by_stage():
    params, x = _numpy_case(43)
    jgeo, tgeo = _geometry(43)
    _jo, jst = jq.forward_blocks12_int8w(_jp(params), jnp.asarray(x), jgeo, tier="reference", taps=True)
    _to, tst = tq.forward_blocks12_int8w(tinit.params_from_jax(params, "cpu"), torch.from_numpy(x), tgeo,
                                         tier="reference", taps=True)
    assert list(tst) == list(jst) == ["conv1", "pool1", "conv2", "pool2", "lrn2"]
    for stage in jst:
        assert _rel_of_max(tst[stage].numpy(), np.asarray(jst[stage])) <= INT8W_REL, stage


@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8w"])
def test_screen_matches_jax_verdict(policy):
    params, x = _numpy_case(43)
    jgeo, tgeo = _geometry(43)
    got = tgate.ToleranceGate().screen(policy, tinit.params_from_jax(params, "cpu"), torch.from_numpy(x), tgeo)
    want = jgate.ToleranceGate(preflight=False).screen(policy, _jp(params), jnp.asarray(x), jgeo)
    assert got.passed and want.passed and got.margin > 0
    assert [s.stage for s in got.stages] == [s.stage for s in want.stages]
    for g, w in zip(got.stages, want.stages):
        assert (g.abs_budget, g.rel_budget) == (w.abs_budget, w.rel_budget)


def test_budgets_are_the_jax_budgets():
    assert tgate.DEFAULT_BUDGETS.keys() == jgate.DEFAULT_BUDGETS.keys()
    for pol, table in jgate.DEFAULT_BUDGETS.items():
        assert {k: dataclasses.astuple(v) for k, v in tgate.DEFAULT_BUDGETS[pol].items()} == {
            k: dataclasses.astuple(v) for k, v in table.items()
        }
    assert tgate.BLOCK_BOUNDARIES == jgate.BLOCK_BOUNDARIES


def test_screen_fails_a_corrupted_candidate():
    params, x = _numpy_case(43)
    _, tgeo = _geometry(43)
    tp = tinit.params_from_jax(params, "cpu")
    bad = {n: {k: v.clone() for k, v in p.items()} for n, p in tp.items()}
    bad["conv2"]["w"][0, 0, 0, :] += 50.0
    res = tgate.ToleranceGate().screen("fp32", tp, torch.from_numpy(x), tgeo, candidate_params=bad)
    assert not res.passed and res.margin < 0 and "stage" in res.reason()


@pytest.mark.parametrize("kw", [dict(preflight=True), dict(journal=object())])
def test_gate_journal_and_preflight_name_the_roadmap(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, item 8"):
        tgate.ToleranceGate(**kw)


def test_run_cli_int8w(capsys):
    rc = trun.main(["--config", "v3_pallas", "--device", "cpu", "--dtype", "int8w", "--height", "67",
                    "--width", "67", "--batch", "2", "--repeats", "1", "--warmup", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Precision: dtype=int8w source=dtype gate=none" in out
    assert "Final Output Shape: 3x3x256" in out
    assert "conv_block=0" in out
