"""The port's fused-block route (``fuse="block"``) against the JAX package.

On the CPU the ``conv_block`` wrapper runs its plain version; the JAX
package's ``_block_kernel`` runs in Pallas interpret mode, as its own tests
run it. Inputs are numpy-seeded at small sizes (43x43 as in
``tests/test_megakernel.py``, and 45x45), batch 2. Budgets are the JAX
package's ``precision/gate.py`` ones: fp32 1e-4 abs and 1e-5 of the max
(both accumulate in fp32, in different orders); bf16 2e-2 of the max;
int8w 6e-2 of the max. The port's fused plain chain is held BITWISE to its
staged plain chain: the same functions, composed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.ops import megakernel as jmk
from cuda_mpi_gpu_cluster_programming_tpu.ops import pallas_kernels as pk
from cuda_mpi_gpu_cluster_programming_tpu.ops.pallas_model import forward_blocks12_pallas
from cuda_mpi_gpu_cluster_programming_tpu.precision import quantize as jq
from cuda_mpi_gpu_cluster_programming_tpu_torch import configs as tcfg
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet as talex
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import megakernel as tmk
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import variants as tv
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops.kernel_model import forward_blocks12_kernels
from cuda_mpi_gpu_cluster_programming_tpu_torch.precision import quantize as tq
from cuda_mpi_gpu_cluster_programming_tpu_torch.precision.gate import BLOCK_BOUNDARIES, ToleranceGate

FP32_ABS, FP32_REL, BF16_REL, INT8W_REL = 1e-4, 1e-5, 2e-2, 6e-2
TORCH_DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


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


def _rel_of_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_budget(policy, got, want, what):
    err, rel = float(np.abs(got - want).max()), _rel_of_max(got, want)
    print(f"{what} {policy}: max_abs={err:.3g} rel_of_max={rel:.3g}")
    if policy == "fp32":
        assert err <= FP32_ABS and rel <= FP32_REL
    else:
        assert rel <= (BF16_REL if policy == "bf16" else INT8W_REL)


# ------------------------------------------------------------ fusibility ---

_OK = dict(variant="vcol", row_block=64, k_block=0, pool="sep2", out_h=9, pool_window=3)


@pytest.mark.parametrize(
    "patch, needle",
    [({}, ""), (dict(variant="g8"), "taps/vcol"), (dict(pool="phases"), "sep2"), (dict(row_block=8), "whole image"),
     (dict(k_block=128), "k_block"), (dict(pool_window=0), "adjacent pool"), (dict(variant="taps", out_h=64), "")],
    ids=["ok", "g8", "phases", "row_block", "k_block", "no_pool", "taps"],
)
def test_block_fusible_reason_equals_jax(patch, needle):
    kw = {**_OK, **patch}
    why = tmk.block_fusible_reason(**kw)
    assert why == jmk.block_fusible_reason(**kw)
    assert needle in why and bool(why) == bool(needle)


def test_conv_block_raises_not_falls_back():
    params, x = _numpy_case(43)
    tp = tinit.params_from_jax(params, "cpu")
    with pytest.raises(ValueError, match="block fusion"):
        tmk.conv_block(
            torch.from_numpy(x), tp["conv1"]["w"], tp["conv1"]["b"], stride=4, padding=0,
            pool_window=3, pool_stride=2, variant="vcol", row_block=4,  # < out_h: not whole-image
        )


# ------------------------------------------------- conv_block_plain vs JAX ---


def _block_case(block, hw, seed=11):
    """Block 1 at an hw x hw x 3 input, or block 2 at the 96-channel input
    block 1 gives for hw; normal weights scaled to fan-in so ReLU clamps."""
    rng = np.random.default_rng(seed + hw + 7 * block)
    spec = talex.BLOCKS12
    if block == 1:
        c, cspec, pspec, lrn, h = 3, spec.conv1, spec.pool1, None, hw
    else:
        c, cspec, pspec, lrn = 96, spec.conv2, spec.pool2, spec.lrn2
        h = (hw - 11) // 4 + 1
        h = (h - 3) // 2 + 1
    f, k = cspec.filter_size, cspec.out_channels
    x = rng.random((2, h, h, c), dtype=np.float32)
    w = (rng.standard_normal((f, f, c, k)) / np.sqrt(f * f * c)).astype(np.float32)
    b = (0.2 * rng.standard_normal(k)).astype(np.float32)
    kw = dict(stride=cspec.stride, padding=cspec.padding, pool_window=pspec.window, pool_stride=pspec.stride)
    return x, w, b, kw, lrn


def _jax_lrn(lrn):
    return None if lrn is None else jalex.BLOCKS12.lrn2.__class__(**dataclasses.asdict(lrn))


@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8w"])
@pytest.mark.parametrize("block", [1, 2])
@pytest.mark.parametrize("hw", [43, 45])
def test_conv_block_plain_matches_jax(hw, block, policy):
    x, w, b, kw, lrn = _block_case(block, hw)
    if policy == "int8w":
        q, s = jq.quantize_channelwise(jnp.asarray(w))
        want = jmk.int8w_conv_block_pallas(jnp.asarray(x), q, s, jnp.asarray(b), lrn=_jax_lrn(lrn), **kw)
        got = ck.conv_block(
            torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(np.array(q)),
            torch.from_numpy(b), scale=torch.from_numpy(np.array(s)), lrn=lrn, **kw,
        )
        assert got.dtype == (torch.float32 if block == 2 else torch.bfloat16)
    else:
        jd, td = JAX_DT[policy], TORCH_DT[policy]
        want = jmk.conv_block_pallas(
            jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd), jnp.asarray(b).astype(jd), lrn=_jax_lrn(lrn), **kw
        )
        got = ck.conv_block(
            torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), torch.from_numpy(b).to(td), lrn=lrn, **kw
        )
        assert got.dtype == td
    want = np.asarray(want.astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    assert (want == 0).any() or block == 2  # ReLU clamped something in block 1
    _assert_budget(policy, got.float().numpy(), want, f"block{block} {hw}x{hw}")


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("hw", [43, 45])
def test_fused_plain_chain_bitwise_equals_staged(hw, policy):
    params, x = _numpy_case(hw)
    _, tgeo = _geometry(hw)
    tp = tinit.params_from_jax(params, "cpu")
    td = TORCH_DT[policy]
    tp = {n: {k: v.to(td) for k, v in p.items()} for n, p in tp.items()}
    xt = torch.from_numpy(x).to(td)
    staged = forward_blocks12_kernels(tp, xt, tgeo, variants=tv.KernelVariants(fuse="none"))
    fused = forward_blocks12_kernels(tp, xt, tgeo, variants=tv.KernelVariants(fuse="block"))
    assert fused.dtype == staged.dtype == td
    assert torch.equal(fused, staged)


# ------------------------------------------------------ the fused forward ---

_JAX_FWD = {}


def _jax_forward(policy, fuse, hw):
    if (policy, fuse, hw) not in _JAX_FWD:
        params, x = _numpy_case(hw)
        jgeo, _ = _geometry(hw)
        jp = {n: {k: jnp.asarray(a) for k, a in p.items()} for n, p in params.items()}
        v = pk.KernelVariants(fuse=fuse)
        if policy == "int8w":
            out = jq.forward_blocks12_int8w(jp, jnp.asarray(x), jgeo, variants=v, tier="pallas")
        else:
            jd = JAX_DT[policy]
            jp = {n: {k: a.astype(jd) for k, a in p.items()} for n, p in jp.items()}
            out = forward_blocks12_pallas(jp, jnp.asarray(x).astype(jd), jgeo, variants=v)
        _JAX_FWD[(policy, fuse, hw)] = np.asarray(out.astype(jnp.float32))
    return _JAX_FWD[(policy, fuse, hw)]


@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8w"])
@pytest.mark.parametrize("hw", [43, 45])
def test_build_forward_fused_matches_jax(hw, policy):
    params, x = _numpy_case(hw)
    _, tgeo = _geometry(hw)
    fwd = tcfg.build_forward(
        tcfg.REGISTRY["v3_pallas"], tgeo, policy=policy, variants=tv.KernelVariants(fuse="block"), device="cpu"
    )
    got = fwd(tinit.params_from_jax(params, "cpu"), torch.from_numpy(x)).numpy()
    want = _jax_forward(policy, "block", hw)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, *talex.output_shape(tgeo))
    assert np.isfinite(got).all()
    _assert_budget(policy, got, want, f"v3_pallas fuse=block {hw}x{hw}")


def test_fused_int8w_within_budget_of_staged_int8w():
    params, x = _numpy_case(43)
    _, tgeo = _geometry(43)
    tp, xt = tinit.params_from_jax(params, "cpu"), torch.from_numpy(x)
    outs = [
        tq.forward_blocks12_int8w(tp, xt, tgeo, variants=tv.KernelVariants(fuse=f), tier="kernels").numpy()
        for f in ("none", "block")
    ]
    assert _rel_of_max(outs[1], outs[0]) <= INT8W_REL


@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8w"])
def test_screen_blocks_passes_all_policies(policy):
    params, x = _numpy_case(43)
    _, tgeo = _geometry(43)
    res = ToleranceGate().screen_blocks(policy, tinit.params_from_jax(params, "cpu"), torch.from_numpy(x), tgeo)
    print(policy, res.to_obj())
    assert res.passed, res.reason()
    assert res.margin > 0
    assert {c.stage for c in res.stages} == {b for b, _ in BLOCK_BOUNDARIES}


def _counting(monkeypatch):
    """Count the wrapper calls of the kernel module (on the CPU the
    wrappers launch nothing, so the route is read from the calls)."""
    calls = {name: 0 for name in ("conv2d", "maxpool2d", "lrn", "conv_block")}
    for name, fn in (("conv2d", "conv2d_bias_relu"), ("maxpool2d", "maxpool2d"), ("lrn", "lrn"),
                     ("conv_block", "conv_block")):
        orig = getattr(ck, fn)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(ck, fn, wrapped)
    return calls


@pytest.mark.parametrize(
    "policy, fuse, want",
    [
        ("fp32", "block", {"conv2d": 0, "maxpool2d": 0, "lrn": 0, "conv_block": 2}),
        ("int8w", "block", {"conv2d": 0, "maxpool2d": 0, "lrn": 0, "conv_block": 2}),
        ("fp32", "none", {"conv2d": 2, "maxpool2d": 2, "lrn": 1, "conv_block": 0}),
        ("int8w", "none", {"conv2d": 2, "maxpool2d": 2, "lrn": 0, "conv_block": 0}),
    ],
)
def test_route_calls_per_forward(monkeypatch, policy, fuse, want):
    calls = _counting(monkeypatch)
    params, x = _numpy_case(43)
    _, tgeo = _geometry(43)
    fwd = tcfg.build_forward(
        tcfg.REGISTRY["v3_pallas"], tgeo, policy=policy, variants=tv.KernelVariants(fuse=fuse), device="cpu"
    )
    fwd(tinit.params_from_jax(params, "cpu"), torch.from_numpy(x))
    assert calls == want


def test_fuse_block_with_a_refused_geometry_runs_staged(monkeypatch):
    calls = _counting(monkeypatch)
    params, x = _numpy_case(43)
    _, tgeo = _geometry(43)
    v = tv.LayerVariants(layers=(("conv1", tv.KernelVariants(fuse="block", row_block=8)),),
                         default=tv.KernelVariants(fuse="block"))
    fwd = tcfg.build_forward(tcfg.REGISTRY["v3_pallas"], tgeo, variants=v, device="cpu")
    fwd(tinit.params_from_jax(params, "cpu"), torch.from_numpy(x))
    # conv1 has 9 output rows > row_block 8: the gate sends block 1 staged
    assert calls == {"conv2d": 1, "maxpool2d": 1, "lrn": 0, "conv_block": 1}


# ---------------------------------------------------------------- knobs ---


@pytest.mark.parametrize(
    "knob, item",
    [(dict(fuse="hpool"), "item 2"), (dict(conv="g8"), "item 6"), (dict(pool="phases"), "item 7"),
     (dict(conv="taps"), "item 2"), (dict(k_block=128), "item 2")],
)
def test_unported_knob_raises_naming_roadmap(knob, item):
    """No knob is unported any more: ROADMAP Queue 2 items 2-7 ported every
    kernel they need (``item`` names the one each knob waited for), so each
    builds, runs and agrees with the default route."""
    v = tv.KernelVariants(**knob)
    params, x = _numpy_case(43)
    _, tgeo = _geometry(43)
    tp, tx = tinit.params_from_jax(params, "cpu"), torch.from_numpy(x)
    got = tcfg.build_forward(tcfg.REGISTRY["v3_pallas"], tgeo, variants=v, device="cpu")(tp, tx)
    want = forward_blocks12_kernels(tp, tx, tgeo, variants=tv.KernelVariants())
    assert got.shape == want.shape and _rel_of_max(got.numpy(), want.numpy()) <= FP32_REL


def test_reference_tier_ignores_variants():
    fwd = tcfg.build_forward(tcfg.REGISTRY["v1_jit"], variants=tv.KernelVariants(conv="g8"), device="cpu")
    assert callable(fwd)


@pytest.mark.parametrize("value", ["block", "none", "", "BLOCK", " hpool "])
def test_fuse_env_resolves_as_in_jax(monkeypatch, value):
    monkeypatch.setenv("TPU_FRAMEWORK_FUSE", value)
    tvar, jvar = tv.KernelVariants.resolve(), pk.KernelVariants.resolve()
    assert tuple(tvar) == tuple(jvar)
    assert tvar.label() == jvar.label() and repr(tvar) == repr(jvar)


@pytest.mark.parametrize("env", ["TPU_FRAMEWORK_FUSE", "TPU_FRAMEWORK_CONV", "TPU_FRAMEWORK_ROWBLOCK"])
def test_bad_env_value_raises_as_in_jax(monkeypatch, env):
    monkeypatch.setenv(env, "bogus")
    with pytest.raises(ValueError) as tp_err:
        tv.KernelVariants.resolve()
    with pytest.raises(ValueError) as jx_err:
        pk.KernelVariants.resolve()
    assert str(tp_err.value) == str(jx_err.value)


def test_variants_bind_knobs_label_and_layers_match_jax():
    for kw in (dict(k_block=64), dict(k_block=128), dict(fuse="block", row_block=32)):
        for k in (0, 96, 256):
            t, j = tv.KernelVariants(**kw).bind(k), pk.KernelVariants(**kw).bind(k)
            assert t.label() == j.label() and t.effective_k_block == j.effective_k_block
            assert tuple(t.knobs()) == tuple(j.knobs())
    tl = tv.LayerVariants(layers=(("conv2", tv.KernelVariants(fuse="block")),))
    jl = pk.LayerVariants(layers=(("conv2", pk.KernelVariants(fuse="block")),))
    for name in ("conv1", "conv2"):
        assert tuple(tl.for_layer(name)) == tuple(jl.for_layer(name))


def test_fuse_env_reaches_the_cli(monkeypatch, capsys):
    from cuda_mpi_gpu_cluster_programming_tpu_torch import run as trun

    monkeypatch.setenv("TPU_FRAMEWORK_FUSE", "hpool")
    rc = trun.main(["--config", "v3_pallas", "--device", "cpu", "--height", "67", "--width", "67",
                    "--repeats", "1", "--warmup", "1"])
    assert rc == 0 and "Final Output Shape: 3x3x256" in capsys.readouterr().out
    monkeypatch.setenv("TPU_FRAMEWORK_CONV", "g8")
    rc = trun.main(["--config", "v3_pallas", "--device", "cpu", "--height", "67", "--width", "67",
                    "--repeats", "1", "--warmup", "1"])
    assert rc == 0 and "Final Output Shape: 3x3x256" in capsys.readouterr().out


# -------------------------------------------------------------- wrapper ---


def test_cpu_conv_block_takes_the_plain_path_and_launches_nothing():
    x, w, b, kw, lrn = _block_case(2, 43)
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    ck.reset_launches()
    got = ck.conv_block(xt, wt, bt, lrn=lrn, **kw)
    assert torch.equal(got, ck.conv_block_plain(xt, wt, bt, lrn=lrn, **kw))
    assert ck.LAUNCHES == dict.fromkeys(ck.LAUNCHES, 0)


@pytest.mark.parametrize("bad", ["fp16", "mixed", "int8w_fp32_x", "int8w_bf16_bias", "bias_shape", "empty"])
def test_conv_block_wrapper_rejects_bad_input(bad):
    x, w, b = torch.zeros(1, 9, 9, 4), torch.zeros(3, 3, 4, 8), torch.zeros(8)
    kw = dict(stride=1, padding=0, pool_window=3, pool_stride=2)
    scale = None
    if bad == "fp16":
        x, w, b = x.half(), w.half(), b.half()
    elif bad == "mixed":
        w = w.to(torch.bfloat16)
    elif bad == "int8w_fp32_x":
        w, scale = w.to(torch.int8), torch.ones(8)
    elif bad == "int8w_bf16_bias":
        x, w, b, scale = x.to(torch.bfloat16), w.to(torch.int8), b.to(torch.bfloat16), torch.ones(8)
    elif bad == "bias_shape":
        b = torch.zeros(7)
    elif bad == "empty":
        x = torch.zeros(1, 3, 3, 4)  # conv gives 1x1: no 3x3 pool window fits
    with pytest.raises((TypeError, ValueError)):
        ck.conv_block(x, w, b, scale=scale, **kw)
