"""The port's hand-written CUDA kernels: wrappers and plain versions.

Each kernel has:

- a wrapper (``conv2d_bias_relu``, ``maxpool2d``, ``lrn``, ``conv_block``) that checks
  device, dtype, shape and contiguity, allocates its output with
  ``torch.empty`` and launches on the current stream without
  synchronising. A CUDA tensor goes to the kernel or the wrapper raises; a
  CPU tensor goes to the plain version, and only because it lies on the
  CPU. Each launch adds one to ``LAUNCHES[<kernel>]``;
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

from . import _build
from .shapes import conv_out_dim, pool_out_dim

# Kernel launches since the last reset: a plain integer per kernel.
LAUNCHES = {"conv2d": 0, "maxpool2d": 0, "lrn": 0, "conv_block": 0}

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
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True
) -> torch.Tensor:
    """Plain version of the conv kernel: the fp32 accumulator, then the fp32
    bias, ReLU and one cast to ``x.dtype``."""
    out = _conv_acc_plain(x, w, stride=stride, padding=padding) + b.float()
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype)


def conv2d_bias_relu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True
) -> torch.Tensor:
    """Direct conv (cross-correlation) + bias + optional ReLU.

    ``x`` (N, H, W, C), ``w`` (F, F, C, K) HWIO, ``b`` (K,), all fp32 or
    all bf16 -> (N, Ho, Wo, K) in the same dtype.

    Replaces ``_conv_vcol_kernel`` with ``_conv_epilogue``
    (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py). Bound on
    the H100: FFMA operations (conv1 27 GFLOP, conv2 115 GFLOP at batch
    128; TF32 is out by the fp32 contract). Design (``csrc/conv2d.cu``):
    an implicit GEMM over (pixels x channels) tiles staged through shared
    memory in 16-term slices, an 8x4 register tile per thread, fp32 FMAs in
    the fixed (fy, fx, c) order, and the bias/ReLU/cast epilogue fused."""
    dev = _check("conv2d_bias_relu", x, w, b)
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv2d_bias_relu: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit NHWC/HWIO")
    if b.shape != (w.shape[3],):
        raise ValueError(f"conv2d_bias_relu: bias {tuple(b.shape)} for {w.shape[3]} channels")
    n, h, wd, c = x.shape
    f, k = w.shape[0], w.shape[3]
    ho, wo = conv_out_dim(h, f, padding, stride), conv_out_dim(wd, f, padding, stride)
    if min(n, ho, wo, k) <= 0:
        raise ValueError(f"conv2d_bias_relu: empty output for x {tuple(x.shape)}, w {tuple(w.shape)}")
    if max(x.numel(), n * ho * wo * k, f * f * c * k) >= 2**31:
        raise ValueError("conv2d_bias_relu: tensors past 2^31 elements")
    if dev.type == "cpu":
        return conv2d_bias_relu_plain(x, w, b, stride=stride, padding=padding, relu=relu)
    y = torch.empty((n, ho, wo, k), dtype=x.dtype, device=dev)
    _launch(
        "conv2d", "conv2d_bias_relu", x, x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, h, wd, c, k, f, stride, padding, ho, wo, int(relu),
    )
    return y


# --------------------------------------------------------------------- pool


def maxpool2d_plain(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """Plain version of the pool kernel: NaN-propagating max over the
    window's taps, in the input dtype (max is exact)."""
    _n, h, wd, _c = x.shape
    ho, wo = pool_out_dim(h, window, stride), pool_out_dim(wd, window, stride)
    out = _window(x, 0, 0, stride, ho, wo)
    for fy in range(window):
        for fx in range(window):
            out = torch.maximum(out, _window(x, fy, fx, stride, ho, wo))
    return out.contiguous()


def maxpool2d(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """VALID ``window`` x ``window`` / ``stride`` max-pool, NHWC, fp32 or bf16.

    Replaces ``_axis_pool_kernel`` behind ``_maxpool_sep2``
    (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py), which the
    TPU launches twice per pool. Bound on the H100: bytes. Design
    (``csrc/maxpool.cu``): one 2-D pass, one thread per output, channels
    fastest so each tap's reads coalesce; bitwise equal to the two passes."""
    dev = _check("maxpool2d", x)
    if x.dim() != 4:
        raise ValueError(f"maxpool2d: x {tuple(x.shape)} is not NHWC")
    n, h, wd, c = x.shape
    ho, wo = pool_out_dim(h, window, stride), pool_out_dim(wd, window, stride)
    if min(n, ho, wo, c) <= 0:
        raise ValueError(f"maxpool2d: empty output for x {tuple(x.shape)}, window {window}")
    if dev.type == "cpu":
        return maxpool2d_plain(x, window=window, stride=stride)
    y = torch.empty((n, ho, wo, c), dtype=x.dtype, device=dev)
    _launch("maxpool2d", "maxpool2d", x, x.data_ptr(), y.data_ptr(), n, h, wd, c, window, stride, ho, wo)
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
