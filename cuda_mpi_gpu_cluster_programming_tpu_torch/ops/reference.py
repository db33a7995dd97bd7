"""Reference-op tier: the four layer ops as plain PyTorch library calls.

The counterpart of the JAX package's XLA-op tier (``v1_jit``), and the
oracle the kernel tier is held against. Semantics follow the original
course code's serial layers: direct convolution (cross-correlation) with
symmetric zero padding, ReLU, VALID max-pool, and cross-channel LRN with
an edge-truncated window, in the divide form. Tensors are NHWC and weights
HWIO at every boundary; inside, the ops view them as NCHW/OIHW (an NHWC
tensor seen as NCHW has channels-last strides, which cuDNN takes as is).

Every op computes in its input's dtype. On CUDA, fp32 convolutions are
true fp32 only when cuDNN's TF32 switch is off: the fp32 policy in
``configs.build_forward`` turns it off before this tier runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int) -> torch.Tensor:
    """``x`` (N, H, W, C), ``w`` (F, F, C, K), ``b`` (K,) -> (N, Ho, Wo, K).

    The bias is added after the convolution, in the output dtype, as the
    JAX reference does."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=padding)
    out = out.permute(0, 2, 3, 1)
    return out + b.to(out.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max(0, x); NaN stays NaN."""
    return torch.relu(x)


def maxpool(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """VALID ``window`` x ``window`` max-pool with the given stride."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


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
