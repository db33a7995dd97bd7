"""The port's hand-written CUDA kernels: wrappers and plain versions.

The kernels (``LAUNCHES`` key: wrapper, source in ``csrc/``, conv variant):

- ``conv2d``: :func:`conv2d_bias_relu`, ``conv2d.cu``, vcol (with the hpool
  epilogue and k_block);
- ``conv_taps``: :func:`conv_taps`, ``conv_taps.cu``, taps (hpool, k_block);
- ``conv_pairs``: :func:`conv_pairs`, ``conv_pairs.cu``, pairs;
- ``conv_im2col``: :func:`conv_im2col`, ``conv_im2col.cu``, fused;
- ``conv_g8``: :func:`conv_g8`, ``conv_g8.cu``, g8 (stride >= 2);
- ``maxpool2d``: :func:`maxpool2d` and its W-only stage :func:`maxpool2d_w`,
  ``maxpool.cu``, the sep2 pool;
- ``maxpool_phases``: :func:`maxpool_phases`, ``maxpool_phases.cu``, the
  phases pool;
- ``lrn``: :func:`lrn`, ``lrn.cu``;
- ``conv_block``: :func:`conv_block`, ``conv_block.cu``, fuse="block".

The five conv kernels share one implicit-GEMM engine
(``csrc/conv_engine.cuh``). Each kernel has:

- a wrapper that checks device, dtype, shape and contiguity, packs the
  operands its variant reads (``ops/packing.py``), allocates its output
  with ``torch.empty`` and launches on the current stream without
  synchronising. A CUDA tensor goes to the kernel or the wrapper raises; a
  CPU tensor goes to the plain version, and only because it lies on the
  CPU. Each launch adds one to ``LAUNCHES[<kernel>]``, and
  :func:`reset_launches` sets every count to 0;
- a plain PyTorch version (``*_plain``) that repeats the kernel's
  arithmetic: the CPU path, and the yardstick ``chip_smoke.py`` holds each
  kernel against on the card.

Dtypes: fp32, or bf16 operands with fp32 accumulation (``conv_block``
also takes int8w: bf16 activations, int8 weights, fp32 scale and bias);
every kernel computes in fp32 and casts once at each store. Sources in ``csrc/``; the
bound, the TPU kernel replaced and the design are in each source's header
and summarised per wrapper below.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, packing, variants
from .shapes import conv_out_dim, pool_out_dim

# Kernel launches since the last reset: a plain integer per kernel.
LAUNCHES = {
    "conv2d": 0, "maxpool2d": 0, "lrn": 0, "conv_block": 0,
    "conv_taps": 0, "conv_pairs": 0, "conv_im2col": 0, "conv_g8": 0, "maxpool_phases": 0,
}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Pooled output rows per block of the conv_block kernel (a band): the 3/2
# pool window shares one conv row between bands, computed twice.
CONV_BLOCK_BAND = 7


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, *tensors: torch.Tensor) -> torch.device:
    first = tensors[0]
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {first.device} and {t.device}")
        if t.dtype not in _SUFFIX or t.dtype != first.dtype:
            raise TypeError(f"{name}: needs all fp32 or all bf16, got {[u.dtype for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
    if first.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {first.device}")
    return first.device


def _launch(kernel: str, entry: str, x: torch.Tensor, *args, suffix: str = "") -> None:
    """Call the library's ``<entry>_<suffix>`` (by default ``x``'s dtype) on
    the current stream of ``x``'s device, raise on a launch error, count
    the launch."""
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn = getattr(lib, f"{entry}_{suffix or _SUFFIX[x.dtype]}")
        _build.check(lib, fn(*args, stream), entry)
    LAUNCHES[kernel] += 1


def _window(x: torch.Tensor, fy: int, fx: int, stride: int, ho: int, wo: int) -> torch.Tensor:
    """The NHWC input pixels that tap (fy, fx) reads for every output."""
    return x[:, fy : fy + stride * (ho - 1) + 1 : stride, fx : fx + stride * (wo - 1) + 1 : stride, :]


# --------------------------------------------------------------------- conv


K_BLOCKS = (0, 64, 128)


def effective_k_block(k_block: int, k: int) -> int:
    """``variants.effective_k_block`` for a k_block the kernels take (0, or
    a multiple of their 32-channel tile: 64, 128); raises for another."""
    if k_block not in K_BLOCKS:
        raise ValueError(f"k_block must be one of {K_BLOCKS}, got {k_block}")
    return variants.effective_k_block(k_block, k)


def _conv_geometry(name: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, padding: int):
    """Check a conv's operands; return ``(device, (n, h, wd, c, f, k, ho, wo))``."""
    dev = _check(name, x, w, b)
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != x.shape[3]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit NHWC/HWIO")
    if b.shape != (w.shape[3],):
        raise ValueError(f"{name}: bias {tuple(b.shape)} for {w.shape[3]} channels")
    n, h, wd, c = x.shape
    f, k = w.shape[0], w.shape[3]
    ho, wo = conv_out_dim(h, f, padding, stride), conv_out_dim(wd, f, padding, stride)
    if min(n, ho, wo, k) <= 0:
        raise ValueError(f"{name}: empty output for x {tuple(x.shape)}, w {tuple(w.shape)}")
    if max(x.numel(), n * ho * wo * k, f * f * c * k) >= 2**31:
        raise ValueError(f"{name}: tensors past 2^31 elements")
    return dev, (n, h, wd, c, f, k, ho, wo)


def _hpool_dims(name: str, ho: int, hpool, k_block: int, n: int):
    """``(pw, ps, hp)`` of an hpool epilogue ((0, 0, 0) without one)."""
    if hpool is None:
        return 0, 0, 0
    pw, ps = hpool
    hp = pool_out_dim(ho, pw, ps)
    if hp <= 0:
        raise ValueError(f"{name}: no {pw}/{ps} pool window fits {ho} conv rows")
    if k_block:
        raise ValueError(f"{name}: the hpool epilogue does not compose with k_block; unset one of them")
    if n > 65535:
        raise ValueError(f"{name}: the hpool epilogue takes a batch of at most 65535")
    return pw, ps, hp


def _epilogue_plain(acc: torch.Tensor, b: torch.Tensor, relu: bool, dtype: torch.dtype, hpool) -> torch.Tensor:
    """The conv epilogue on an fp32 accumulator: fp32 bias, ReLU, one cast,
    then (``hpool``) the H-axis max of the pool in tap order."""
    out = acc + b.float()
    if relu:
        out = torch.relu(out)
    out = out.to(dtype)
    return out if hpool is None else maxpool_rect_plain(out, window=(hpool[0], 1), stride=(hpool[1], 1))


def _conv_acc_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int, padding: int) -> torch.Tensor:
    """The conv's fp32 accumulator (N, Ho, Wo, K): tap by tap over (fy, fx),
    each tap one (pixels, C) x (C, K) matmul on fp32 copies of the operands
    (exact for fp32, bf16 and int8 values)."""
    n, h, wd, _c = x.shape
    f, k = w.shape[0], w.shape[3]
    ho, wo = conv_out_dim(h, f, padding, stride), conv_out_dim(wd, f, padding, stride)
    xf = F.pad(x.float(), (0, 0, padding, padding, padding, padding))
    wf = w.float()
    acc = torch.zeros((n * ho * wo, k), dtype=torch.float32, device=x.device)
    for fy in range(f):
        for fx in range(f):
            acc.addmm_(_window(xf, fy, fx, stride, ho, wo).reshape(n * ho * wo, -1), wf[fy, fx])
    return acc.reshape(n, ho, wo, k)


def conv2d_bias_relu_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
    k_block: int = 0, hpool=None,
) -> torch.Tensor:
    """Plain version of the vcol conv kernel: the fp32 accumulator, then the
    fp32 bias, ReLU and one cast to ``x.dtype`` (then the hpool H max).
    ``k_block`` changes no value."""
    return _epilogue_plain(_conv_acc_plain(x, w, stride=stride, padding=padding), b, relu, x.dtype, hpool)


def conv2d_bias_relu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
    k_block: int = 0, hpool=None,
) -> torch.Tensor:
    """Direct conv (cross-correlation) + bias + optional ReLU: the vcol body.

    ``x`` (N, H, W, C), ``w`` (F, F, C, K) HWIO, ``b`` (K,), all fp32 or
    all bf16 -> (N, Ho, Wo, K) in the same dtype. ``k_block`` (0, 64, 128):
    output channels per block where it applies (:func:`effective_k_block`),
    bitwise the unblocked result. ``hpool=(window, stride)``: also take the
    pool's H-axis max, -> (N, Hp, Wo, K); :func:`maxpool2d_w` finishes it.

    Replaces ``_conv_vcol_kernel`` with ``_conv_epilogue``
    (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py). Bound on
    the H100: FFMA operations (conv1 27 GFLOP, conv2 115 GFLOP at batch
    128; TF32 is out by the fp32 contract). Design (``csrc/conv2d.cu`` on
    the engine of ``csrc/conv_engine.cuh``): an implicit GEMM over (pixels x
    channels) tiles staged through shared memory in 16-term slices, an 8x4
    register tile per thread, fp32 FMAs in the fixed (fy, fx, c) order, and
    the bias/ReLU/cast (and hpool) epilogue fused."""
    dev, (n, h, wd, c, f, k, ho, wo) = _conv_geometry("conv2d_bias_relu", x, w, b, stride, padding)
    kb = effective_k_block(k_block, k)
    pw, ps, hp = _hpool_dims("conv2d_bias_relu", ho, hpool, kb, n)
    if dev.type == "cpu":
        return conv2d_bias_relu_plain(x, w, b, stride=stride, padding=padding, relu=relu, hpool=hpool)
    y = torch.empty((n, hp if pw else ho, wo, k), dtype=x.dtype, device=dev)
    _launch(
        "conv2d", "conv2d_bias_relu", x, x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, h, wd, c, k, f, stride, padding, ho, wo, int(relu), kb, pw, ps, hp,
    )
    return y


def _s2d_operands(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int):
    """The taps/pairs/fused operands: ``(xs, ws, fq, ho, wo)`` with xs
    (N, ho+fq-1, wo+fq-1, s*s*C) and ws (fq, fq, s*s*C, K), contiguous."""
    f = w.shape[0]
    fq = -(-f // stride)
    ho = conv_out_dim(x.shape[1], f, padding, stride)
    wo = conv_out_dim(x.shape[2], f, padding, stride)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    xs = packing.space_to_depth(x, stride, ho + fq - 1, wo + fq - 1).contiguous()
    return xs, packing.weights_to_depth(w, stride, fq).contiguous(), fq, ho, wo


def conv_taps_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
    k_block: int = 0, hpool=None,
) -> torch.Tensor:
    """Plain version of the taps kernel: on the s2d operands, one
    (pixels, s*s*C) x (s*s*C, K) matmul per tap (qh, qw) in that order into
    an fp32 accumulator, then the epilogue."""
    xs, ws, fq, ho, wo = _s2d_operands(x, w, stride, padding)
    n, cs, k = x.shape[0], xs.shape[3], w.shape[3]
    acc = torch.zeros((n * ho * wo, k), dtype=torch.float32, device=x.device)
    for qh in range(fq):
        for qw in range(fq):
            acc.addmm_(xs[:, qh : qh + ho, qw : qw + wo, :].float().reshape(-1, cs), ws[qh, qw].float())
    return _epilogue_plain(acc.reshape(n, ho, wo, k), b, relu, x.dtype, hpool)


def conv_taps(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
    k_block: int = 0, hpool=None,
) -> torch.Tensor:
    """Space-to-depth conv + bias + optional ReLU: the taps body. Arguments
    and result as :func:`conv2d_bias_relu` (``k_block``, ``hpool`` too).

    Replaces ``_conv_kernel`` with ``_conv_epilogue``
    (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py). Bound on
    the H100: FFMA operations (conv1 32 GFLOP with the zero taps past F,
    conv2 115 GFLOP at batch 128). Design (``csrc/conv_taps.cu``): the
    operands packed here (``ops/packing.py``), then the shared implicit
    GEMM reading each qh row's fq*s*s*C terms as one contiguous run, in the
    fixed (qh, qw, channel) order."""
    dev, (n, _h, _wd, _c, _f, k, ho, wo) = _conv_geometry("conv_taps", x, w, b, stride, padding)
    kb = effective_k_block(k_block, k)
    pw, ps, hp = _hpool_dims("conv_taps", ho, hpool, kb, n)
    if dev.type == "cpu":
        return conv_taps_plain(x, w, b, stride=stride, padding=padding, relu=relu, hpool=hpool)
    xs, ws, fq, ho, wo = _s2d_operands(x, w, stride, padding)
    y = torch.empty((n, hp if pw else ho, wo, k), dtype=x.dtype, device=dev)
    _launch(
        "conv_taps", "conv_taps", xs, xs.data_ptr(), ws.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, xs.shape[1], xs.shape[2], xs.shape[3], k, fq, ho, wo, int(relu), kb, pw, ps, hp,
    )
    return y


def _pairs_operands(xs: torch.Tensor, ws: torch.Tensor, fq: int):
    """``(xpair, wpair, xs or None, wlast or None)``: column j's and j+1's
    channels side by side, and the matching taps stacked; the leftover
    operands only for odd fq."""
    xpair = torch.cat([xs[:, :, :-1, :], xs[:, :, 1:, :]], dim=-1).contiguous()
    m = fq // 2
    wpair = torch.cat([ws[:, 0 : 2 * m : 2], ws[:, 1 : 2 * m : 2]], dim=2).contiguous()
    if fq % 2:
        return xpair, wpair, xs, ws[:, fq - 1].contiguous()
    return xpair, wpair, None, None


def conv_pairs_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
) -> torch.Tensor:
    """Plain version of the pairs kernel: per qh, one (pixels, 2*cs) x
    (2*cs, K) matmul per pair of taps left to right, then the leftover tap
    (odd fq), into an fp32 accumulator; then the epilogue."""
    xs, ws, fq, ho, wo = _s2d_operands(x, w, stride, padding)
    xpair, wpair, xl, wlast = _pairs_operands(xs, ws, fq)
    n, k = x.shape[0], w.shape[3]
    acc = torch.zeros((n * ho * wo, k), dtype=torch.float32, device=x.device)
    for qh in range(fq):
        for p in range(fq // 2):
            win = xpair[:, qh : qh + ho, 2 * p : 2 * p + wo, :]
            acc.addmm_(win.float().reshape(n * ho * wo, -1), wpair[qh, p].float())
        if xl is not None:
            win = xl[:, qh : qh + ho, fq - 1 : fq - 1 + wo, :]
            acc.addmm_(win.float().reshape(n * ho * wo, -1), wlast[qh].float())
    return _epilogue_plain(acc.reshape(n, ho, wo, k), b, relu, x.dtype, None)


def conv_pairs(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
) -> torch.Tensor:
    """Paired-tap conv + bias + optional ReLU: the pairs body, for fq =
    ceil(F/stride) >= 2 (at fq = 1 there is nothing to pair: the caller
    runs taps, as the JAX package does). Arguments and result as
    :func:`conv2d_bias_relu` without ``k_block``/``hpool``.

    Replaces ``_conv_pairs_kernel`` and ``_conv_pairs_even_kernel``
    (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py). Bound on
    the H100: FFMA operations, as taps. Design (``csrc/conv_pairs.cu``):
    the pair operands packed here at 2x the input bytes (xpair, wpair; xs
    and wlast for the odd leftover tap, absent for even fq), then the shared
    implicit GEMM in the order qh, pairs left to right, leftover."""
    dev, (n, _h, _wd, _c, f, k, ho, wo) = _conv_geometry("conv_pairs", x, w, b, stride, padding)
    if -(-f // stride) < 2:
        raise ValueError(f"conv_pairs: nothing to pair at F={f}, stride={stride} (fq=1); run taps")
    if dev.type == "cpu":
        return conv_pairs_plain(x, w, b, stride=stride, padding=padding, relu=relu)
    xs, ws, fq, ho, wo = _s2d_operands(x, w, stride, padding)
    xpair, wpair, xl, wlast = _pairs_operands(xs, ws, fq)
    y = torch.empty((n, ho, wo, k), dtype=x.dtype, device=dev)
    _launch(
        "conv_pairs", "conv_pairs", xpair, xpair.data_ptr(), None if xl is None else xl.data_ptr(),
        wpair.data_ptr(), None if wlast is None else wlast.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, xs.shape[1], xs.shape[2], xs.shape[3], k, fq, ho, wo, int(relu),
    )
    return y


def _im2col_operands(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int):
    """``(xcol, wmat, ho, wo)``: the s2d windows of every tap (qh, qw)
    concatenated on the channel axis, (N*ho*wo, fq*fq*s*s*C), and the s2d
    weights as a (fq*fq*s*s*C, K) matrix."""
    xs, ws, fq, ho, wo = _s2d_operands(x, w, stride, padding)
    wins = [xs[:, qh : qh + ho, qw : qw + wo, :] for qh in range(fq) for qw in range(fq)]
    xcol = torch.cat(wins, dim=-1).reshape(-1, fq * fq * xs.shape[3])
    return xcol, ws.reshape(-1, w.shape[3]), ho, wo


def conv_im2col_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
) -> torch.Tensor:
    """Plain version of the im2col kernel: one (pixels, KD) x (KD, K)
    matmul into an fp32 accumulator, then the epilogue."""
    xcol, wmat, ho, wo = _im2col_operands(x, w, stride, padding)
    acc = torch.zeros((xcol.shape[0], w.shape[3]), dtype=torch.float32, device=x.device)
    acc.addmm_(xcol.float(), wmat.float())
    return _epilogue_plain(acc.reshape(x.shape[0], ho, wo, -1), b, relu, x.dtype, None)


def conv_im2col(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
) -> torch.Tensor:
    """im2col + one GEMM + bias + optional ReLU: the fused body. Arguments
    and result as :func:`conv2d_bias_relu` without ``k_block``/``hpool``.

    Replaces ``_conv_fused_kernel`` (cuda_mpi_gpu_cluster_programming_tpu/
    ops/pallas_kernels.py). Bound on the H100: FFMA operations (the xcol
    buffer, 0.67 GB on conv1 and 0.90 GB on conv2 in fp32 at batch 128, adds
    bytes but not the bound). Design (``csrc/conv_im2col.cu``): xcol built
    here with tensor code, as the JAX package does, into ``torch.empty``
    storage; then a tiled (M, KD) x (KD, K) GEMM with the shared epilogue."""
    dev, (n, _h, _wd, _c, _f, k, ho, wo) = _conv_geometry("conv_im2col", x, w, b, stride, padding)
    if dev.type == "cpu":
        return conv_im2col_plain(x, w, b, stride=stride, padding=padding, relu=relu)
    xcol, wmat, ho, wo = _im2col_operands(x, w, stride, padding)
    if xcol.numel() >= 2**31:
        raise ValueError(f"conv_im2col: an im2col buffer of {tuple(xcol.shape)} is past 2^31 elements")
    y = torch.empty((n, ho, wo, k), dtype=x.dtype, device=dev)
    _launch(
        "conv_im2col", "conv_im2col", xcol, xcol.data_ptr(), wmat.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, ho, wo, xcol.shape[1], k, int(relu),
    )
    return y


def _g8_operands(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int):
    """The g8 operands: ``(xs8, w8, fq8, ho, wo)`` with xs8 (N, ho2+fq8-1,
    wo2+fq8-1, g*g*C) packed at g = 2*stride, ho2 = ceil(ho/2), and w8 the
    (2, 2, fq8, fq8, g*g*C, K) phase weight frames, contiguous."""
    f, s = w.shape[0], stride
    g = 2 * s
    fq8 = -(-(f + s) // g)
    ho = conv_out_dim(x.shape[1], f, padding, s)
    wo = conv_out_dim(x.shape[2], f, padding, s)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    xs8 = packing.space_to_depth(x, g, -(-ho // 2) + fq8 - 1, -(-wo // 2) + fq8 - 1).contiguous()
    return xs8, packing.weights_to_phase_depth(w, s, g, fq8).contiguous(), fq8, ho, wo


def conv_g8_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
) -> torch.Tensor:
    """Plain version of the g8 kernel: per output phase (ph, pw), one
    (pixels, g*g*C) x (g*g*C, K) matmul per tap (qh, qw) of the phase's
    weight frame into an fp32 accumulator, the phases interleaved into the
    (N, Ho, Wo, K) accumulator, then the epilogue."""
    xs8, w8, fq8, ho, wo = _g8_operands(x, w, stride, padding)
    n, gch, k = x.shape[0], xs8.shape[3], w.shape[3]
    ho2, wo2 = -(-ho // 2), -(-wo // 2)
    acc = torch.zeros((n, ho2 * 2, wo2 * 2, k), dtype=torch.float32, device=x.device)
    for ph in range(2):
        for pw in range(2):
            part = torch.zeros((n * ho2 * wo2, k), dtype=torch.float32, device=x.device)
            for qh in range(fq8):
                for qw in range(fq8):
                    win = xs8[:, qh : qh + ho2, qw : qw + wo2, :].float().reshape(-1, gch)
                    part.addmm_(win, w8[ph, pw, qh, qw].float())
            acc[:, ph::2, pw::2, :] = part.reshape(n, ho2, wo2, k)
    return _epilogue_plain(acc[:, :ho, :wo, :], b, relu, x.dtype, None)


def conv_g8(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
) -> torch.Tensor:
    """Phase-packed conv + bias + optional ReLU: the g8 body, for stride >=
    2 (at stride 1 there are no phases to pack: the caller runs vcol, as
    the JAX package does). Arguments and result as :func:`conv2d_bias_relu`
    without ``k_block``/``hpool``, which the JAX package's g8 route ignores
    and refuses.

    Replaces ``_conv_g8_kernel`` (cuda_mpi_gpu_cluster_programming_tpu/ops/
    pallas_kernels.py). Bound on the H100: FFMA operations (conv1 59 GFLOP
    at batch 128 with the weight frames' zeros, against vcol's 27). Design
    (``csrc/conv_g8.cu``): the input packed at g = 2*stride (g*g*C
    channels) and the four phase weight frames packed here
    (``ops/packing.py``); then the shared implicit GEMM on a grid with the
    output phase as its third dimension, each block writing its pixels
    straight into the interleaved (N, Ho, Wo, K) output."""
    dev, (n, _h, _wd, _c, _f, k, ho, wo) = _conv_geometry("conv_g8", x, w, b, stride, padding)
    if stride < 2:
        raise ValueError(f"conv_g8: no phases to pack at stride {stride}; run vcol")
    if dev.type == "cpu":
        return conv_g8_plain(x, w, b, stride=stride, padding=padding, relu=relu)
    xs8, w8, fq8, ho, wo = _g8_operands(x, w, stride, padding)
    if xs8.numel() >= 2**31:
        raise ValueError(f"conv_g8: a packed input of {tuple(xs8.shape)} is past 2^31 elements")
    y = torch.empty((n, ho, wo, k), dtype=x.dtype, device=dev)
    _launch(
        "conv_g8", "conv_g8", xs8, xs8.data_ptr(), w8.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, xs8.shape[1], xs8.shape[2], xs8.shape[3], k, fq8, ho, wo, int(relu),
    )
    return y


# --------------------------------------------------------------------- pool


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


def maxpool_rect_plain(x: torch.Tensor, *, window, stride) -> torch.Tensor:
    """Plain version of the pool kernel: NaN-propagating max over the
    window's taps (``window``/``stride``: an int, or (rows, cols)) in (fy,
    fx) order from tap (0, 0), in the input dtype (max is exact)."""
    (wh, ww), (sh, sw) = _pair(window), _pair(stride)
    _n, h, wd, _c = x.shape
    ho, wo = pool_out_dim(h, wh, sh), pool_out_dim(wd, ww, sw)

    def tap(fy, fx):
        return x[:, fy : fy + sh * (ho - 1) + 1 : sh, fx : fx + sw * (wo - 1) + 1 : sw, :]

    out = tap(0, 0)
    for fy in range(wh):
        for fx in range(ww):
            out = torch.maximum(out, tap(fy, fx))
    return out.contiguous()


def maxpool2d_plain(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    return maxpool_rect_plain(x, window=window, stride=stride)


def _pool(x: torch.Tensor, wh: int, ww: int, sh: int, sw: int, name: str) -> torch.Tensor:
    dev = _check(name, x)
    if x.dim() != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not NHWC")
    n, h, wd, c = x.shape
    ho, wo = pool_out_dim(h, wh, sh), pool_out_dim(wd, ww, sw)
    if min(n, ho, wo, c) <= 0:
        raise ValueError(f"{name}: empty output for x {tuple(x.shape)}, window {wh}x{ww}")
    if dev.type == "cpu":
        return maxpool_rect_plain(x, window=(wh, ww), stride=(sh, sw))
    y = torch.empty((n, ho, wo, c), dtype=x.dtype, device=dev)
    _launch("maxpool2d", "maxpool2d", x, x.data_ptr(), y.data_ptr(), n, h, wd, c, wh, ww, sh, sw, ho, wo)
    return y


def maxpool2d(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """VALID ``window`` x ``window`` / ``stride`` max-pool, NHWC, fp32 or bf16.

    Replaces ``_axis_pool_kernel`` behind ``_maxpool_sep2``
    (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py), which the
    TPU launches twice per pool. Bound on the H100: bytes. Design
    (``csrc/maxpool.cu``): one 2-D pass, one thread per output, channels
    fastest so each tap's reads coalesce; bitwise equal to the two passes."""
    return _pool(x, window, window, stride, stride, "maxpool2d")


def maxpool2d_w(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """The W-axis stage of a ``window``/``stride`` max-pool alone (a 1 x
    window pool): what follows a conv whose hpool epilogue took the H-axis
    max. The TPU's ``maxpool_pallas_w`` (``_axis_pool_kernel`` on the
    transposed tensor); here the same ``csrc/maxpool.cu`` kernel as
    :func:`maxpool2d` (counted as ``maxpool2d``) with a rectangular window,
    so hpool conv + this is bitwise conv + :func:`maxpool2d`."""
    return _pool(x, 1, window, 1, stride, "maxpool2d_w")


def maxpool_phases_plain(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """Plain version of the phases kernel: on the phase stack, the max over
    the taps (fy, fx) in order, each tap a unit-stride slice of phase
    (fy%s)*s + fx%s."""
    s = stride
    _n, h, wd, _c = x.shape
    ho, wo = pool_out_dim(h, window, s), pool_out_dim(wd, window, s)
    xph = packing.pool_phases(x, s, ho + (window - 1) // s, wo + (window - 1) // s)

    def tap(fy, fx):
        return xph[(fy % s) * s + fx % s, :, fy // s : fy // s + ho, fx // s : fx // s + wo, :]

    out = tap(0, 0)
    for fy in range(window):
        for fx in range(window):
            out = torch.maximum(out, tap(fy, fx))
    return out.contiguous()


def maxpool_phases(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """VALID ``window`` x ``window`` / ``stride`` max-pool over a stride-phase
    stack: the phases pool body. Bitwise :func:`maxpool2d`.

    Replaces ``_pool_kernel`` behind ``_maxpool_phases``
    (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py). Bound on
    the H100: bytes. Design (``csrc/maxpool_phases.cu``): the (s*s, N, hp,
    wp, C) stack packed here (``ops/packing.py``), then one thread per
    output, channels fastest, tap (fy, fx) read from its phase."""
    dev = _check("maxpool_phases", x)
    if x.dim() != 4:
        raise ValueError(f"maxpool_phases: x {tuple(x.shape)} is not NHWC")
    n, h, wd, c = x.shape
    ho, wo = pool_out_dim(h, window, stride), pool_out_dim(wd, window, stride)
    if min(n, ho, wo, c) <= 0:
        raise ValueError(f"maxpool_phases: empty output for x {tuple(x.shape)}, window {window}")
    if dev.type == "cpu":
        return maxpool_phases_plain(x, window=window, stride=stride)
    hp, wp = ho + (window - 1) // stride, wo + (window - 1) // stride
    xph = packing.pool_phases(x, stride, hp, wp).contiguous()
    y = torch.empty((n, ho, wo, c), dtype=x.dtype, device=dev)
    _launch(
        "maxpool_phases", "maxpool_phases", xph, xph.data_ptr(), y.data_ptr(),
        n, hp, wp, c, window, stride, ho, wo,
    )
    return y


# ---------------------------------------------------------------------- LRN


def _lrn_a(alpha: float, size: int, alpha_over_size: bool) -> float:
    return alpha / size if alpha_over_size else alpha


def lrn_plain(
    x: torch.Tensor, *, size: int, alpha: float, beta: float, k: float, alpha_over_size: bool = False
) -> torch.Tensor:
    """Plain version of the LRN kernel: fp32 throughout, the window sum as
    shifted adds in the kernel's order (channel c-size//2 first; the zero
    padding adds exact zeros), one cast to ``x.dtype``."""
    half = size // 2
    c = x.shape[-1]
    xf = x.float()
    sq = F.pad(xf * xf, (half, half))
    ssum = torch.zeros_like(xf)
    for d in range(2 * half + 1):
        ssum = ssum + sq[..., d : d + c]
    scale = k + _lrn_a(alpha, size, alpha_over_size) * ssum
    return (xf / torch.pow(scale, beta)).to(x.dtype)


def lrn(
    x: torch.Tensor, *, size: int, alpha: float, beta: float, k: float, alpha_over_size: bool = False
) -> torch.Tensor:
    """Cross-channel LRN over the last (channel) axis, fp32 math, output in
    ``x.dtype``: ``x / (k + a * sum of x^2 over the edge-cut window)^beta``
    with ``a = alpha`` or ``alpha/size``.

    Replaces ``_lrn_kernel`` (cuda_mpi_gpu_cluster_programming_tpu/ops/
    pallas_kernels.py). Bound on the H100: bytes. Design (``csrc/lrn.cu``):
    one thread per element reading its channel neighbours (the TPU's banded
    matmul was a lane-slicing workaround), powf and a divide."""
    dev = _check("lrn", x)
    if x.dim() < 1 or x.numel() == 0 or size < 1:
        raise ValueError(f"lrn: x {tuple(x.shape)}, size {size}")
    if dev.type == "cpu":
        return lrn_plain(x, size=size, alpha=alpha, beta=beta, k=k, alpha_over_size=alpha_over_size)
    y = torch.empty_like(x)
    _launch(
        "lrn", "lrn", x, x.data_ptr(), y.data_ptr(), x.numel(), x.shape[-1], size,
        _lrn_a(alpha, size, alpha_over_size), beta, k,
    )
    return y


# --------------------------------------------------------------- fused block


def conv_block_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int,
    pool_window: int, pool_stride: int, lrn=None, scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of the block kernel.

    fp32 and bf16 (``scale`` None): the staged plain chain
    ``conv2d_bias_relu_plain`` -> ``maxpool2d_plain`` (-> ``lrn_plain``),
    so it is bitwise that chain by construction. int8w (``scale`` given):
    the fp32 accumulator of the same per-tap loop, times ``scale``, plus
    the fp32 bias, ReLU, a cast to bf16, the pool, then (block 2) LRN in
    fp32 with an fp32 result."""
    if scale is None:
        out = conv2d_bias_relu_plain(x, w, b, stride=stride, padding=padding, relu=True)
    else:
        acc = _conv_acc_plain(x, w, stride=stride, padding=padding)
        out = torch.relu(acc * scale + b).to(torch.bfloat16)
    out = maxpool2d_plain(out, window=pool_window, stride=pool_stride)
    if lrn is not None:
        out = lrn_plain(
            out if scale is None else out.float(), size=lrn.size, alpha=lrn.alpha, beta=lrn.beta, k=lrn.k,
            alpha_over_size=lrn.alpha_over_size,
        )
    return out


def conv_block(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int,
    pool_window: int, pool_stride: int, lrn=None, scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One fused block: conv (+ int8w rescale) + bias + ReLU + VALID max-pool
    (+ cross-channel LRN when ``lrn``, an object with ``size``, ``alpha``,
    ``beta``, ``k`` and ``alpha_over_size``, is given).

    ``x`` (N, H, W, C) and ``w`` (F, F, C, K) HWIO, ``b`` (K,): all fp32 or
    all bf16 -> output in ``x.dtype``. int8w: ``x`` bf16, ``w`` int8, ``b``
    and ``scale`` (K,) fp32 -> bf16 without LRN, fp32 with it.

    Replaces ``_block_kernel`` (cuda_mpi_gpu_cluster_programming_tpu/ops/
    megakernel.py). Bound on the H100: operations (block 1 27.0 GFLOP,
    block 2 114.7 GFLOP at batch 128). Design (``csrc/conv_block.cu``): a
    block walks a band of pooled rows of one image, computes the conv rows
    each pooled row needs into a ring of 3 rows in shared memory (all
    channels when LRN needs its neighbours), pools (and normalises) from the
    ring and writes once. fp32 and bf16 results are bitwise the staged
    kernel chain's: same FMA order, cast points, max and LRN arithmetic."""
    quant = scale is not None
    if quant:
        dev = _check("conv_block", b, scale)
        _check("conv_block", x)
        if x.dtype != torch.bfloat16 or b.dtype != torch.float32 or w.dtype != torch.int8:
            raise TypeError(f"conv_block int8w: needs bf16 x, int8 w, fp32 b and scale, got "
                            f"{[t.dtype for t in (x, w, b, scale)]}")
        if x.device != dev or w.device != dev or not w.is_contiguous():
            raise ValueError("conv_block int8w: needs contiguous tensors on one device")
    else:
        dev = _check("conv_block", x, w, b)
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv_block: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit NHWC/HWIO")
    k = w.shape[3]
    if b.shape != (k,) or (quant and scale.shape != (k,)):
        raise ValueError(f"conv_block: bias/scale shapes for {k} channels")
    n, h, wd, c = x.shape
    f = w.shape[0]
    ho, wo = conv_out_dim(h, f, padding, stride), conv_out_dim(wd, f, padding, stride)
    hp, wp = pool_out_dim(ho, pool_window, pool_stride), pool_out_dim(wo, pool_window, pool_stride)
    if min(n, hp, wp, k) <= 0:
        raise ValueError(f"conv_block: empty output for x {tuple(x.shape)}, w {tuple(w.shape)}")
    if max(x.numel(), n * ho * wo * k, f * f * c * k) >= 2**31 or n > 65535:
        raise ValueError("conv_block: tensors past 2^31 elements or a batch past 65535")
    kw = dict(stride=stride, padding=padding, pool_window=pool_window, pool_stride=pool_stride)
    if dev.type == "cpu":
        return conv_block_plain(x, w, b, lrn=lrn, scale=scale, **kw)
    out_dtype = (torch.float32 if lrn is not None else torch.bfloat16) if quant else x.dtype
    y = torch.empty((n, hp, wp, k), dtype=out_dtype, device=dev)
    lrn_args = (0, 0, 0.0, 0.0, 0.0)  # has_lrn, size, a, beta, k
    if lrn is not None:
        lrn_args = (1, lrn.size, _lrn_a(lrn.alpha, lrn.size, lrn.alpha_over_size), lrn.beta, lrn.k)
    _launch(
        "conv_block", "conv_block", x, x.data_ptr(), w.data_ptr(), b.data_ptr(),
        scale.data_ptr() if quant else None, y.data_ptr(),
        n, h, wd, c, k, f, stride, padding, ho, wo, pool_window, pool_stride, hp, wp, CONV_BLOCK_BAND, *lrn_args,
        suffix="int8w" if quant else "",
    )
    return y
