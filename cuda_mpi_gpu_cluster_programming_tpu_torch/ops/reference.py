"""Reference-op tier: the four layer ops as plain PyTorch library calls.

The counterpart of the JAX package's XLA-op tier (``v1_jit``), and the
oracle the kernel tier is held against. Semantics follow the original
course code's serial layers: direct convolution (cross-correlation) with
symmetric zero padding, ReLU, VALID max-pool, and cross-channel LRN with
an edge-truncated window, in the divide form. Tensors are NHWC and weights
HWIO at every boundary; inside, the ops view them as NCHW/OIHW (an NHWC
tensor seen as NCHW has channels-last strides, which cuDNN takes as is).

Every op computes in its input's dtype unless told otherwise. On CUDA,
fp32 convolutions are true fp32 only when cuDNN's TF32 switch is off:
:func:`true_fp32` turns it off, and ``configs.build_forward`` calls it
before this tier runs under a policy that accumulates in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def true_fp32(device: torch.device) -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls when
    ``device`` is a GPU (the JAX package's ``Precision.HIGHEST``)."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` for ``(N, in) x (in, out)``: the product and the bias
    add are two operations, each rounded to the operands' dtype, as JAX
    computes ``x @ w + b`` (``addmm`` would round once, an ulp away in
    bf16). On the GPU, cuBLAS reduces a bf16 product in fp32 (its split-K
    partials may otherwise be summed in bf16), as the TPU's MXU does: the
    switch is turned off for this product alone and set back after it, so
    no other matmul of the process sees it changed."""
    if not x.is_cuda:
        return torch.matmul(x, w) + b
    flags = torch.backends.cuda.matmul
    was = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        y = torch.matmul(x, w)
    finally:
        flags.allow_bf16_reduced_precision_reduction = was
    return y + b


def conv2d(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int,
    preferred_element_type: torch.dtype | None = None,
) -> torch.Tensor:
    """``x`` (N, H, W, C), ``w`` (F, F, C, K), ``b`` (K,) -> (N, Ho, Wo, K).

    ``preferred_element_type`` is the accumulation and output dtype (the
    JAX reference's argument of the same name); by default ``x.dtype``.
    With bf16 operands and an fp32 accumulator the function is: fp32
    products of the bf16-valued operands, summed in fp32. ``F.conv2d`` on
    bf16 tensors returns bf16, which is a different function, so here the
    operands are first copied exactly to fp32 (every bf16 value is an fp32
    value). On those copies, with TF32 off, fp32 ``F.conv2d`` is the same
    function: every bf16 x bf16 product (8-bit significands) is exact in
    fp32's 24 bits, and the sums are fp32. int8 weights widen exactly too.
    The bias is added after the convolution, in the output dtype, as the
    JAX reference does.

    On the CPU an fp32 convolution runs PyTorch's GEMM convolution (im2col
    and one matmul, ``aten.thnn_conv2d``), not oneDNN's, which ``F.conv2d``
    picks by default there: oneDNN sums each output's terms in an order that
    depends on its thread count, 9.7e-5 to 2.5e-4 off XLA's CPU convolution
    at outputs of order 20, where the GEMM path is within 2e-5. The choice is
    made at this call, so it changes no process-wide switch."""
    acc = preferred_element_type or x.dtype
    xc, wc = x.permute(0, 3, 1, 2).to(acc), w.permute(3, 2, 0, 1).to(acc)
    if xc.device.type == "cpu" and acc == torch.float32:
        out = torch.ops.aten.thnn_conv2d(xc, wc, list(wc.shape[2:]), None, [stride, stride], [padding, padding])
    else:
        out = F.conv2d(xc, wc, stride=stride, padding=padding)
    out = out.permute(0, 2, 3, 1)
    return out + b.to(out.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max(0, x) as ``jnp.maximum(x, 0)``: NaN stays NaN, -0.0
    becomes +0.0 (``torch.relu`` keeps -0.0; ``F.threshold`` replaces every
    value not above 0)."""
    return F.threshold(x, 0.0, 0.0)


def maxpool(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """VALID ``window`` x ``window`` max-pool with the given stride, with
    ``lax.reduce_window``'s max: +0.0 over -0.0.

    ``F.max_pool2d`` may return either zero of a window whose max is zero.
    Such a window holds no positive value and no NaN, so it holds a +0.0
    exactly when one of its sign bits is clear: the window sums of
    ``copysign(1, x)`` (exact: at most 256 terms of +-1 in bf16, any number
    in fp32) say which, and their zero results become +0.0 (a window of
    -0.0s keeps -0.0). A pool of ReLU's output takes :func:`relu_maxpool`,
    which needs none of this."""
    xc = x.permute(0, 3, 1, 2)
    y = F.max_pool2d(xc, window, stride)
    signs = xc if window * window <= 256 else xc.float()
    signs = torch.copysign(torch.ones((), dtype=signs.dtype, device=x.device), signs)
    plus0 = F.avg_pool2d(signs, window, stride, divisor_override=1) > -window * window
    y = torch.where((y == 0) & plus0, torch.zeros((), dtype=y.dtype, device=y.device), y)
    return y.permute(0, 2, 3, 1)


def relu_maxpool(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """``maxpool(relu(x))``, bitwise, at the cost of ``F.max_pool2d`` alone.

    Both are monotone, so the pool goes first and :func:`relu` takes the
    pooled tensor: every max that is not above 0, of either sign, becomes
    +0.0, as every zero of ``relu(x)`` is; a NaN stays NaN."""
    return relu(F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1))


def lrn(
    x: torch.Tensor,
    *,
    size: int,
    alpha: float,
    beta: float,
    k: float,
    alpha_over_size: bool = False,
) -> torch.Tensor:
    """Cross-channel LRN over the last axis.

    ``out[c] = x[c] / (k + a * sum_{j in win(c)} x[j]^2) ** beta`` with
    ``a = alpha/size`` when ``alpha_over_size`` else ``a = alpha``, and
    ``win(c) = [max(0, c-size//2), min(C-1, c+size//2)]``: truncated at
    the channel edges, not renormalised by the count. Both ``a`` forms
    exist because the original course code's CPU layers use ``alpha/N``
    and its CUDA kernels ``alpha``; the default is the CUDA form."""
    half = size // 2
    c = x.shape[-1]
    sq = F.pad(x * x, (half, half))
    ssum = sq[..., 0:c]
    for d in range(1, 2 * half + 1):
        ssum = ssum + sq[..., d : d + c]
    a = alpha / size if alpha_over_size else alpha
    scale = k + a * ssum
    return x / scale**beta
