"""The port's conv and pool variants (taps, pairs, fused, g8, phases, the
hpool epilogue, k_block) against the JAX package's Pallas kernels, on the CPU.

On the CPU each wrapper of ``ops.cuda_kernels`` runs its plain PyTorch
version (the CUDA kernels run only on the card, where ``chip_smoke.py``
holds each one against the same plain version); the Pallas kernels run in
interpret mode, as ``tests/test_pallas.py`` runs them. Inputs are made with
numpy from a seed and handed to both.

Tolerances and why:
- packers: bitwise (they only move and zero-fill values);
- conv fp32: 1e-5 rel / 1e-5 abs. Both accumulate in fp32, in different
  orders (per-tap matmuls here; the TPU kernel's matmul order there);
- conv bf16: one bf16 ulp (2^-7 of the value): both cast one fp32 result;
- pools, hpool + W stage, k_block: bitwise (max is exact; k_block leaves
  each element's sum unchanged);
- the forward at 43x43: the JAX package's gate budgets, fp32 1e-4 abs and
  1e-5 of the max, bf16 2e-2 and int8w 6e-2 of the max.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.ops import pallas_kernels as pk
from cuda_mpi_gpu_cluster_programming_tpu.ops.pallas_model import forward_blocks12_pallas
from cuda_mpi_gpu_cluster_programming_tpu.precision import quantize as jq
from cuda_mpi_gpu_cluster_programming_tpu_torch import configs as tcfg
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet as talex
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import kernel_model as km
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import packing
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import variants as tv

BF16_ULP_REL = 2.0**-7
FP32_ABS, FP32_REL, BF16_REL, INT8W_REL = 1e-4, 1e-5, 2e-2, 6e-2
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# (N, H, W, C, F, K, stride, pad)
CONV_CASES = {
    "conv1_like": (2, 23, 23, 3, 11, 8, 4, 0),
    "conv2_like": (2, 9, 9, 12, 5, 16, 1, 2),
    "even_fq": (2, 21, 21, 5, 8, 8, 4, 1),  # fq = 2: pairs has no leftover tap
}
WRAPPERS = {
    "taps": ck.conv_taps, "pairs": ck.conv_pairs, "fused": ck.conv_im2col,
    # g8 through the model's dispatch: at stride 1 (conv2_like) it runs vcol, as in JAX
    "g8": lambda *a, **kw: km.conv(*a, variant="g8", **kw),
}


def _conv_case(name, dtype, seed=5):
    n, h, w, c, f, k, s, p = CONV_CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((f, f, c, k)) / np.sqrt(f * f * c)).astype(np.float32)
    b = (0.2 * rng.standard_normal(k)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jax_ops = [jnp.asarray(a).astype(jdt) for a in (x, wt, b)]
    torch_ops = [torch.from_numpy(a).to(tdt) for a in (x, wt, b)]
    return jax_ops, torch_ops, dict(stride=s, padding=p)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _assert_close(got, want, dtype):
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP_REL, atol=1e-6)


# ---------------------------------------------------------------- packers ---


@pytest.mark.parametrize("shape, s, hs, ws", [((2, 23, 23, 3), 4, 7, 7), ((1, 13, 13, 5), 1, 15, 14),
                                              ((2, 30, 26, 3), 4, 6, 8)])
def test_space_to_depth_bitwise(shape, s, hs, ws):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(pk._space_to_depth(jnp.asarray(x), s, hs, ws))
    got = packing.space_to_depth(torch.from_numpy(x), s, hs, ws).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("f, s, c, k", [(11, 4, 3, 8), (5, 1, 12, 16), (8, 4, 5, 8)])
def test_weights_to_depth_bitwise(f, s, c, k):
    w = np.random.default_rng(2).standard_normal((f, f, c, k)).astype(np.float32)
    fq = -(-f // s)
    want = np.asarray(pk._weights_to_depth(jnp.asarray(w), s, fq))
    got = packing.weights_to_depth(torch.from_numpy(w), s, fq).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("f, s, c, k", [(11, 4, 3, 8), (5, 2, 3, 4), (7, 3, 2, 5)])
def test_weights_to_phase_depth_bitwise(f, s, c, k):
    w = np.random.default_rng(4).standard_normal((f, f, c, k)).astype(np.float32)
    g, fq8 = 2 * s, -(-(f + s) // (2 * s))
    want = np.asarray(pk._weights_to_phase_depth(jnp.asarray(w), s, g, fq8))
    got = packing.weights_to_phase_depth(torch.from_numpy(w), s, g, fq8).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("shape, s, hp, wp", [((2, 11, 11, 4), 2, 6, 6), ((1, 9, 12, 3), 2, 5, 7),
                                              ((1, 8, 8, 2), 3, 4, 3)])
def test_pool_phases_bitwise(shape, s, hp, wp):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = np.asarray(pk._pool_phases(jnp.asarray(x), s, hp, wp))
    got = packing.pool_phases(torch.from_numpy(x), s, hp, wp).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


# ------------------------------------------------------------- conv bodies ---


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("variant", sorted(WRAPPERS))
def test_conv_variant_matches_pallas(variant, case, dtype):
    (jx, jw, jb), (tx, tw, tb), kw = _conv_case(case, dtype)
    want = pk.conv2d_pallas(jx, jw, jb, relu=True, variant=variant, row_block=64, k_block=0, **kw)
    got = WRAPPERS[variant](tx, tw, tb, relu=True, **kw)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    _assert_close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k_block", [64, 128])
@pytest.mark.parametrize("variant", ["taps", "vcol"])
def test_conv_k_block_matches_pallas(variant, k_block, dtype):
    """conv2-like with K = 256, so both blocks apply (K % kb == 0, K > kb)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 7, 7, 8)).astype(np.float32)
    w = (rng.standard_normal((5, 5, 8, 256)) / np.sqrt(200)).astype(np.float32)
    b = (0.2 * rng.standard_normal(256)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    kw = dict(stride=1, padding=2)
    want = pk.conv2d_pallas(*(jnp.asarray(a).astype(jdt) for a in (x, w, b)), relu=True, variant=variant,
                            row_block=64, k_block=k_block, **kw)
    fn = ck.conv_taps if variant == "taps" else ck.conv2d_bias_relu
    tx, tw, tb = (torch.from_numpy(a).to(tdt) for a in (x, w, b))
    got = fn(tx, tw, tb, k_block=k_block, **kw)
    _assert_close(_np(got), _np(want), dtype)
    assert torch.equal(got, fn(tx, tw, tb, k_block=0, **kw))  # bitwise within the port


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["conv1_like", "conv2_like"])
@pytest.mark.parametrize("variant", ["taps", "vcol"])
def test_conv_hpool_matches_pallas_and_is_bitwise_staged(variant, case, dtype):
    (jx, jw, jb), (tx, tw, tb), kw = _conv_case(case, dtype)
    want = pk.conv2d_pallas(jx, jw, jb, relu=True, variant=variant, row_block=64, k_block=0, hpool=(3, 2), **kw)
    fn = ck.conv_taps if variant == "taps" else ck.conv2d_bias_relu
    got = fn(tx, tw, tb, hpool=(3, 2), **kw)
    assert tuple(got.shape) == want.shape
    _assert_close(_np(got), _np(want), dtype)
    fused = ck.maxpool2d_w(got, window=3, stride=2)
    staged = ck.maxpool2d(fn(tx, tw, tb, **kw), window=3, stride=2)
    assert torch.equal(fused, staged)
    _assert_close(_np(fused), _np(pk.maxpool_pallas_w(want, window=3, stride=2)), dtype)


@pytest.mark.parametrize("f, s, pad, relu", [(11, 4, 0, True), (5, 2, 1, True), (7, 3, 2, False)])
def test_conv_g8_matches_pallas_and_taps(f, s, pad, relu):
    """The JAX package's g8 geometries (conv1-like with an odd output, s=2
    with padding, s=3 without ReLU): the port's g8 kernel against the
    Pallas g8 kernel and against the port's taps, fp32."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 37, 37, 3)).astype(np.float32)
    w = (0.1 * rng.standard_normal((f, f, 3, 16))).astype(np.float32)
    b = np.full(16, 0.1, np.float32)
    kw = dict(stride=s, padding=pad, relu=relu)
    want = pk.conv2d_pallas(*(jnp.asarray(a) for a in (x, w, b)), variant="g8", **kw)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = ck.conv_g8(tx, tw, tb, **kw)
    assert tuple(got.shape) == want.shape
    _assert_close(got.numpy(), _np(want), "fp32")
    _assert_close(got.numpy(), ck.conv_taps(tx, tw, tb, **kw).numpy(), "fp32")


def test_g8_at_stride1_runs_vcol_as_in_jax():
    rng = np.random.default_rng(16)
    tx = torch.from_numpy(rng.standard_normal((2, 9, 9, 3)).astype(np.float32))
    tw = torch.from_numpy((0.1 * rng.standard_normal((3, 3, 3, 8))).astype(np.float32))
    tb = torch.zeros(8)
    got = km.conv(tx, tw, tb, stride=1, padding=1, relu=True, variant="g8", k_block=0)
    assert torch.equal(got, ck.conv2d_bias_relu(tx, tw, tb, stride=1, padding=1))
    with pytest.raises(ValueError, match="no phases to pack"):
        ck.conv_g8(tx, tw, tb, stride=1, padding=1)
    with pytest.raises(ValueError, match="taps/vcol"):
        km.conv(tx, tw, tb, stride=4, padding=0, relu=True, variant="g8", hpool=(3, 2))


def test_hpool_refuses_k_block_and_pairs():
    tx, tw, tb = torch.zeros(1, 7, 7, 8), torch.zeros(5, 5, 8, 256), torch.zeros(256)
    kw = dict(stride=1, padding=2)
    with pytest.raises(ValueError, match="k_block"):
        ck.conv_taps(tx, tw, tb, hpool=(3, 2), k_block=64, **kw)
    with pytest.raises(ValueError, match="taps/vcol"):
        km.conv(tx, tw, tb, relu=True, variant="pairs", hpool=(3, 2), **kw)
    with pytest.raises(ValueError, match="k_block must be one of"):
        ck.conv2d_bias_relu(tx, tw, tb, k_block=32, **kw)


def test_pairs_at_fq1_runs_taps_as_in_jax():
    """F=3, stride 4: fq = 1, nothing to pair; the JAX package runs taps."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 17, 17, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    b = np.zeros(8, np.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = km.conv(tx, tw, tb, stride=4, padding=0, relu=True, variant="pairs")
    assert torch.equal(got, ck.conv_taps(tx, tw, tb, stride=4, padding=0))
    want = pk.conv2d_pallas(*(jnp.asarray(a) for a in (x, w, b)), stride=4, relu=True, variant="pairs")
    _assert_close(got.numpy(), _np(want), "fp32")
    with pytest.raises(ValueError, match="nothing to pair"):
        ck.conv_pairs(tx, tw, tb, stride=4, padding=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_pairs_terms_are_im2col_terms_in_kg_order(case, dtype):
    """What the bitwise pin of conv_pairs.cu to conv_im2col.cu rests on: the
    pairs operand's term kg, in the order ``csrc/conv_sm90.cuh``'s ``Pairs``
    documents (row qh = kg // per_qh; the pairs' 2cs terms from xpair
    column ox + 2p, then the leftover's cs terms from xs column
    ox + fq - 1), and its weight row kg (``Pairs::row``: wpair's row
    qh * pair_terms + j, then wlast's qh * cs + j - pair_terms) are xcol's
    column kg and wmat's row kg, bit for bit: conv1-like (fq 3), conv2-like
    (fq 5) and even fq (2, no leftover)."""
    _, (x, w, _b), kw = _conv_case(case, dtype)
    xs, ws, fq, ho, wo = ck._s2d_operands(x, w, kw["stride"], kw["padding"])
    xpair, wpair, xl, wlast = ck._pairs_operands(xs, ws, fq)
    n, cs, k = x.shape[0], xs.shape[3], w.shape[3]
    pair_terms = (fq // 2) * 2 * cs
    per_qh = pair_terms + (cs if xl is not None else 0)
    assert (xl is None) == (fq % 2 == 0) and fq * per_qh == fq * fq * cs
    cols, rows = [], []
    for kg in range(fq * per_qh):
        qh, j = divmod(kg, per_qh)
        if j < pair_terms:
            p, c = divmod(j, 2 * cs)
            cols.append(xpair[:, qh : qh + ho, 2 * p : 2 * p + wo, c])
            rows.append(wpair.reshape(-1, k)[qh * pair_terms + j])
        else:
            cols.append(xl[:, qh : qh + ho, fq - 1 : fq - 1 + wo, j - pair_terms])
            rows.append(wlast.reshape(-1, k)[qh * cs + j - pair_terms])
    xcol, wmat, _ho, _wo = ck._im2col_operands(x, w, kw["stride"], kw["padding"])
    assert torch.equal(torch.stack(cols, -1).reshape(n * ho * wo, -1), xcol)
    assert torch.equal(torch.stack(rows), wmat)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_packed_launchers_take_the_wrappers_operands(case):
    """``conv_pairs_packed`` and ``conv_im2col_packed`` (the kernels alone,
    as ``chip_smoke.py`` times them) on the operands their wrappers pack
    give the wrappers' results, and refuse operands that do not fit."""
    _, (x, w, b), kw = _conv_case(case, "fp32")
    xs, ws, fq, ho, wo = ck._s2d_operands(x, w, kw["stride"], kw["padding"])
    ops = ck._pairs_operands(xs, ws, fq)
    assert torch.equal(ck.conv_pairs_packed(*ops, b, ho=ho, wo=wo), ck.conv_pairs(x, w, b, **kw))
    xcol, wmat, ho, wo = ck._im2col_operands(x, w, kw["stride"], kw["padding"])
    got = ck.conv_im2col_packed(xcol, wmat, b, n=x.shape[0], ho=ho, wo=wo)
    assert torch.equal(got, ck.conv_im2col(x, w, b, **kw))
    with pytest.raises(ValueError, match="do not make a pairs conv"):
        ck.conv_pairs_packed(*ops, b, ho=ho + fq, wo=wo)
    with pytest.raises(ValueError, match="do not make an im2col GEMM"):
        ck.conv_im2col_packed(xcol, wmat, b, n=x.shape[0], ho=ho + 1, wo=wo)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_taps_terms_are_the_mainloop_conv_terms(case, dtype):
    """What the bitwise pin of conv_taps.cu to conv_pairs.cu and
    conv_im2col.cu rests on: the taps kernel hands ``csrc/conv_sm90.cuh``'s
    ``Conv`` xs as an image and ws as HWIO weights of a stride-1 unpadded
    conv with F = fq. Its term kg of pixel (n, oy, ox), as ``Conv`` reads it
    (fy = kg // (F*C), fx, c), is xs[n, oy + fy, ox + fx, c], every window in
    bounds, and its weight row kg is ws.reshape(-1, K)[kg]: xcol's column kg
    and wmat's row kg, bit for bit."""
    _, (x, w, _b), kw = _conv_case(case, dtype)
    xs, ws, fq, ho, wo = ck._s2d_operands(x, w, kw["stride"], kw["padding"])
    n, cs, k = x.shape[0], xs.shape[3], w.shape[3]
    assert xs.shape[1] >= ho + fq - 1 and xs.shape[2] >= wo + fq - 1
    cols, rows = [], []
    for kg in range(fq * fq * cs):
        fy, rem = divmod(kg, fq * cs)
        fx, c = divmod(rem, cs)
        cols.append(xs[:, fy : fy + ho, fx : fx + wo, c])
        rows.append(ws.reshape(-1, k)[kg])
    xcol, wmat, _ho, _wo = ck._im2col_operands(x, w, kw["stride"], kw["padding"])
    assert torch.equal(torch.stack(cols, -1).reshape(n * ho * wo, -1), xcol)
    assert torch.equal(torch.stack(rows), wmat)


@pytest.mark.parametrize("f, s, pad", [(11, 4, 0), (5, 2, 1), (7, 3, 2)])
def test_g8_phase_columns_rebuild_g8(f, s, pad):
    """conv_g8.cu's one GEMM over the g8 geometries above: the (KG, 4K)
    matrix the CUDA branch builds has column (2ph + pw)K + ch equal to
    w8[ph, pw, ..., ch], bitwise; and a float64 GEMM of xs8's windows
    against it, column (2ph + pw)K + ch of phase pixel (n, a, b) scattered
    to (2a + ph, 2b + pw) and cropped to Ho x Wo (odd at F11/s4), then bias
    and ReLU, is conv_g8_plain within the fp32 tolerance."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 37, 37, 3)).astype(np.float32)
    w = (0.1 * rng.standard_normal((f, f, 3, 16))).astype(np.float32)
    b = (0.2 * rng.standard_normal(16)).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    xs8, wcols, ho, wo = ck._g8_operands(tx, tw, s, pad)
    n, gch, fq8, k = tx.shape[0], xs8.shape[3], wcols.shape[0], 16
    mat = wcols.reshape(fq8 * fq8 * gch, 4 * k)
    w8 = packing.weights_to_phase_depth(tw, s, 2 * s, fq8)
    for ph in range(2):
        for pw in range(2):
            assert torch.equal(mat[:, (2 * ph + pw) * k : (2 * ph + pw + 1) * k], w8[ph, pw].reshape(-1, k))
    ho2, wo2 = -(-ho // 2), -(-wo // 2)
    wins = [xs8[:, qh : qh + ho2, qw : qw + wo2, :] for qh in range(fq8) for qw in range(fq8)]
    acc = torch.cat(wins, -1).double().reshape(n * ho2 * wo2, -1) @ mat.double()
    y = torch.zeros((n, 2 * ho2, 2 * wo2, k), dtype=torch.float64)
    for ph in range(2):
        for pw in range(2):
            y[:, ph::2, pw::2, :] = acc[:, (2 * ph + pw) * k : (2 * ph + pw + 1) * k].reshape(n, ho2, wo2, k)
    want = torch.relu(y[:, :ho, :wo, :] + tb.double())
    _assert_close(ck.conv_g8_plain(tx, tw, tb, stride=s, padding=pad).numpy(), want.numpy(), "fp32")


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_taps_and_g8_packed_launchers_take_the_wrappers_operands(case):
    """``conv_taps_packed`` and ``conv_g8_packed`` (the kernels alone, as
    ``chip_smoke.py`` times them) on the operands their wrappers pack give
    the wrappers' results (taps with its hpool epilogue too; g8 where the
    stride is >= 2), and refuse operands that do not fit."""
    _, (x, w, b), kw = _conv_case(case, "fp32")
    xs, ws, fq, ho, wo = ck._s2d_operands(x, w, kw["stride"], kw["padding"])
    assert torch.equal(ck.conv_taps_packed(xs, ws, b, ho=ho, wo=wo), ck.conv_taps(x, w, b, **kw))
    assert torch.equal(ck.conv_taps_packed(xs, ws, b, ho=ho, wo=wo, hpool=(3, 2)),
                       ck.conv_taps(x, w, b, hpool=(3, 2), **kw))
    with pytest.raises(ValueError, match="do not make a conv"):
        ck.conv_taps_packed(xs, ws, b, ho=ho + 1, wo=wo)
    if kw["stride"] < 2:
        return
    xs8, wcols, ho, wo = ck._g8_operands(x, w, kw["stride"], kw["padding"])
    assert torch.equal(ck.conv_g8_packed(xs8, wcols, b, ho=ho, wo=wo), ck.conv_g8(x, w, b, **kw))
    with pytest.raises(ValueError, match="do not make a conv"):
        ck.conv_g8_packed(xs8, wcols, b, ho=ho + 2, wo=wo)
    with pytest.raises(ValueError, match="do not make a conv"):
        ck.conv_g8_packed(xs8, wcols, b[:-1], ho=ho, wo=wo)


@pytest.mark.parametrize("kernel", ["taps", "g8"])
def test_cuda_taps_and_g8_refuse_packed_dims_from_2_14(kernel, monkeypatch):
    """conv_taps.cu and conv_g8.cu hand the mainloop their packed input as
    its image, whose origins ``csrc/conv_sm90.cuh`` packs into 16-bit
    halves: the CUDA branches of conv_taps and conv_g8 refuse a packed
    height of 2^14 before any launch. The device check answers CUDA here,
    so the CPU tensors take the CUDA branch."""
    monkeypatch.setattr(ck, "_check", lambda name, *tensors: torch.device("cuda"))
    monkeypatch.setattr(ck, "_launch", lambda *a, **kw: pytest.fail("launched past the dims check"))
    w, b = torch.zeros(1, 1, 1, 4), torch.zeros(4)
    if kernel == "taps":  # stride 1, F 1: Hs = H
        got = lambda: ck.conv_taps(torch.zeros(1, 2**14, 2, 1), w, b, stride=1, padding=0)  # noqa: E731
    else:  # stride 2, F 1: Ho = 2^15, so Hs8 = ceil(Ho / 2) = 2^14
        got = lambda: ck.conv_g8(torch.zeros(1, 2**16, 4, 1), w, b, stride=2, padding=0)  # noqa: E731
    with pytest.raises(ValueError, match="below 16384 on CUDA"):
        got()


# ------------------------------------------------------------------- pools ---


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape, window, stride", [((2, 27, 27, 8), 3, 2), ((1, 13, 12, 5), 3, 2),
                                                   ((2, 9, 9, 3), 2, 2), ((1, 8, 8, 4), 3, 1)])
def test_maxpool_phases_bitwise(shape, window, stride, dtype):
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    x[0, 0, 0, 0] = np.nan  # NaN propagates in both
    jdt, tdt = DTYPES[dtype]
    want = pk.maxpool_pallas(jnp.asarray(x).astype(jdt), window=window, stride=stride, variant="phases")
    got = ck.maxpool_phases(torch.from_numpy(x).to(tdt), window=window, stride=stride)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert torch.equal(got.isnan(), ck.maxpool2d(torch.from_numpy(x).to(tdt), window=window, stride=stride).isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ck.maxpool2d(torch.from_numpy(x).to(tdt),
                                                                           window=window, stride=stride)))


def test_maxpool_w_matches_pallas():
    x = np.random.default_rng(9).standard_normal((2, 6, 27, 4)).astype(np.float32)
    want = pk.maxpool_pallas_w(jnp.asarray(x), window=3, stride=2)
    got = ck.maxpool2d_w(torch.from_numpy(x), window=3, stride=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- the whole forward ---

FORWARD_VARIANTS = {
    "taps": dict(conv="taps"),
    "pairs": dict(conv="pairs"),
    "fused": dict(conv="fused"),
    "g8": dict(conv="g8"),
    "phases": dict(pool="phases"),
    "hpool_vcol": dict(fuse="hpool"),
    "kb128": dict(k_block=128),
    "mixed": None,  # a per-layer plan: conv1 taps + phases, conv2 fused
}
ROUTES = {**FORWARD_VARIANTS, "hpool_taps": dict(conv="taps", fuse="hpool")}


def _variants(name, jax_side):
    mod = pk if jax_side else tv
    if ROUTES[name] is None:
        return mod.LayerVariants(
            layers=(("conv1", mod.KernelVariants(conv="taps", pool="phases")),
                    ("conv2", mod.KernelVariants(conv="fused"))),
        )
    return mod.KernelVariants(**ROUTES[name])


def _numpy_case(hw=43, seed=2026):
    rng = np.random.default_rng(seed + hw)
    params = {
        "conv1": {"w": rng.random((11, 11, 3, 96), dtype=np.float32), "b": np.full(96, 0.1, np.float32)},
        "conv2": {"w": rng.random((5, 5, 96, 256), dtype=np.float32), "b": np.full(256, 0.1, np.float32)},
    }
    return params, rng.random((2, hw, hw, 3), dtype=np.float32)


@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8w"])
@pytest.mark.parametrize("name", sorted(FORWARD_VARIANTS))
def test_forward_variant_matches_pallas(name, policy):
    params, x = _numpy_case()
    jgeo = dataclasses.replace(jalex.BLOCKS12, in_height=43, in_width=43)
    tgeo = dataclasses.replace(talex.BLOCKS12, in_height=43, in_width=43)
    jp = {n: {k: jnp.asarray(a) for k, a in p.items()} for n, p in params.items()}
    if policy == "int8w":
        want = jq.forward_blocks12_int8w(jp, jnp.asarray(x), jgeo, variants=_variants(name, True), tier="pallas")
    else:
        jd = DTYPES[policy][0]
        jp = {n: {k: a.astype(jd) for k, a in p.items()} for n, p in jp.items()}
        want = forward_blocks12_pallas(jp, jnp.asarray(x).astype(jd), jgeo, variants=_variants(name, True))
    want = np.asarray(want.astype(jnp.float32))
    fwd = tcfg.build_forward(tcfg.REGISTRY["v3_pallas"], tgeo, policy=policy, variants=_variants(name, False),
                             device="cpu")
    got = fwd(tinit.params_from_jax(params, "cpu"), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *talex.output_shape(tgeo)) and np.isfinite(got).all()
    err, rel = float(np.abs(got - want).max()), float(np.abs(got - want).max() / np.abs(want).max())
    if policy == "fp32":
        assert err <= FP32_ABS and rel <= FP32_REL
    else:
        assert rel <= (BF16_REL if policy == "bf16" else INT8W_REL)


def _counting(monkeypatch):
    """Count the calls of each kernel wrapper (on the CPU they launch
    nothing, so the route is read from the calls)."""
    calls = {}
    for fn in ("conv2d_bias_relu", "conv_taps", "conv_pairs", "conv_im2col", "conv_g8", "maxpool2d",
               "maxpool2d_w", "maxpool_phases", "lrn", "conv_block"):
        orig = getattr(ck, fn)

        def wrapped(*a, _orig=orig, _name=fn, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **kw)

        monkeypatch.setattr(ck, fn, wrapped)
    return calls


@pytest.mark.parametrize(
    "name, policy, want",
    [
        ("taps", "fp32", {"conv_taps": 2, "maxpool2d": 2, "lrn": 1}),
        ("pairs", "bf16", {"conv_pairs": 2, "maxpool2d": 2, "lrn": 1}),
        ("fused", "fp32", {"conv_im2col": 2, "maxpool2d": 2, "lrn": 1}),
        # g8 is conv1's (stride 4); conv2 (stride 1) runs vcol
        ("g8", "bf16", {"conv_g8": 1, "conv2d_bias_relu": 1, "maxpool2d": 2, "lrn": 1}),
        ("phases", "fp32", {"conv2d_bias_relu": 2, "maxpool_phases": 2, "lrn": 1}),
        ("hpool_vcol", "fp32", {"conv2d_bias_relu": 2, "maxpool2d_w": 2, "lrn": 1}),
        ("mixed", "int8w", {"conv_taps": 1, "maxpool_phases": 1, "conv_im2col": 1, "maxpool2d": 1}),
        ("hpool_taps", "int8w", {"conv_taps": 2, "maxpool2d": 2}),  # hpool is no int8w route
    ],
)
def test_route_calls_per_forward(monkeypatch, name, policy, want):
    calls = _counting(monkeypatch)
    params, x = _numpy_case()
    tgeo = dataclasses.replace(talex.BLOCKS12, in_height=43, in_width=43)
    fwd = tcfg.build_forward(tcfg.REGISTRY["v3_pallas"], tgeo, policy=policy, variants=_variants(name, False),
                             device="cpu")
    fwd(tinit.params_from_jax(params, "cpu"), torch.from_numpy(x))
    assert calls == want


def test_hpool_gate_sends_a_refused_geometry_staged(monkeypatch):
    """row_block 32 < conv1's 35 output rows at 143x143: conv1 runs staged,
    conv2 (17 rows) takes the hpool route, as the JAX package's gate does."""
    calls = _counting(monkeypatch)
    tgeo = dataclasses.replace(talex.BLOCKS12, in_height=143, in_width=143)
    params = tinit.init_params_deterministic(tgeo, device="cpu")
    x = tinit.deterministic_input(1, tgeo, device="cpu")
    v = tv.KernelVariants(fuse="hpool", row_block=32)
    out = tcfg.build_forward(tcfg.REGISTRY["v3_pallas"], tgeo, variants=v, device="cpu")(params, x)
    assert calls == {"conv2d_bias_relu": 2, "maxpool2d": 1, "maxpool2d_w": 1, "lrn": 1}
    ref = tcfg.build_forward(tcfg.REGISTRY["v3_pallas"], tgeo, variants=tv.KernelVariants(), device="cpu")(params, x)
    assert torch.equal(out, ref)
