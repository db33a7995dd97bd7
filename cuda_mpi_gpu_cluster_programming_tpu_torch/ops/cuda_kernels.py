"""The port's three hand-written CUDA kernels: wrappers and plain versions.

Each kernel has:

- a wrapper (``conv2d_bias_relu``, ``maxpool2d``, ``lrn``) that checks
  device, dtype, shape and contiguity, allocates its output with
  ``torch.empty`` and launches on the current stream without
  synchronising. A CUDA tensor goes to the kernel or the wrapper raises; a
  CPU tensor goes to the plain version, and only because it lies on the
  CPU. Each launch adds one to ``LAUNCHES[<kernel>]``;
- a plain PyTorch version (``*_plain``) that repeats the kernel's
  arithmetic: the CPU path, and the yardstick ``chip_smoke.py`` holds each
  kernel against on the card.

Dtypes: fp32, or bf16 operands with fp32 accumulation; every kernel
computes in fp32 and casts once at its store. Sources in ``csrc/``; the
bound, the TPU kernel replaced and the design are in each source's header
and summarised per wrapper below.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .shapes import conv_out_dim, pool_out_dim

# Kernel launches since the last reset: a plain integer per kernel.
LAUNCHES = {"conv2d": 0, "maxpool2d": 0, "lrn": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def _launch(kernel: str, entry: str, x: torch.Tensor, *args) -> None:
    """Call the library's ``<entry>_<dtype>`` on the current stream of
    ``x``'s device, raise on a launch error, count the launch."""
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn = getattr(lib, f"{entry}_{_SUFFIX[x.dtype]}")
        _build.check(lib, fn(*args, stream), entry)
    LAUNCHES[kernel] += 1


def _window(x: torch.Tensor, fy: int, fx: int, stride: int, ho: int, wo: int) -> torch.Tensor:
    """The NHWC input pixels that tap (fy, fx) reads for every output."""
    return x[:, fy : fy + stride * (ho - 1) + 1 : stride, fx : fx + stride * (wo - 1) + 1 : stride, :]


# --------------------------------------------------------------------- conv


def conv2d_bias_relu_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True
) -> torch.Tensor:
    """Plain version of the conv kernel: fp32 accumulation tap by tap over
    (fy, fx), each tap one (pixels, C) x (C, K) matmul, then the fp32 bias,
    ReLU and one cast to ``x.dtype``."""
    n, h, wd, _c = x.shape
    f, k = w.shape[0], w.shape[3]
    ho, wo = conv_out_dim(h, f, padding, stride), conv_out_dim(wd, f, padding, stride)
    xf = F.pad(x.float(), (0, 0, padding, padding, padding, padding))
    wf = w.float()
    acc = torch.zeros((n * ho * wo, k), dtype=torch.float32, device=x.device)
    for fy in range(f):
        for fx in range(f):
            acc.addmm_(_window(xf, fy, fx, stride, ho, wo).reshape(n * ho * wo, -1), wf[fy, fx])
    out = acc + b.float()
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype).reshape(n, ho, wo, k)


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
