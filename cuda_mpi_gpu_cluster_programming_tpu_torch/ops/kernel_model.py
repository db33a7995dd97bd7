"""Blocks 1-2 forward pass on the CUDA kernel tier (``v3_pallas``).

Five launches per forward: conv1+bias+ReLU, pool1, conv2+bias+ReLU, pool2,
LRN2. The counterpart of the JAX package's ``forward_blocks12_pallas`` on
its default (``fuse="none"``) route, whose two-pass TPU pools take seven.
"""

from __future__ import annotations

import torch

from ..models.alexnet import BLOCKS12, Blocks12Config, ConvSpec, LrnSpec, PoolSpec
from . import cuda_kernels as ck


def _conv_then_pool(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, cspec: ConvSpec, pspec: PoolSpec,
    lrn: LrnSpec | None = None,
) -> torch.Tensor:
    """One block: conv (+bias, ReLU) kernel, pool kernel, then the LRN
    kernel when the block ends in one."""
    y = ck.conv2d_bias_relu(x, w, b, stride=cspec.stride, padding=cspec.padding, relu=True)
    out = ck.maxpool2d(y, window=pspec.window, stride=pspec.stride)
    if lrn is not None:
        out = ck.lrn(
            out, size=lrn.size, alpha=lrn.alpha, beta=lrn.beta, k=lrn.k,
            alpha_over_size=lrn.alpha_over_size,
        )
    return out


def forward_blocks12_kernels(params, x: torch.Tensor, cfg: Blocks12Config = BLOCKS12) -> torch.Tensor:
    """``x`` NHWC (contiguous), params ``{"conv1": {"w","b"}, "conv2": ...}``
    with HWIO weights, all in one dtype (fp32 or bf16)."""
    x = _conv_then_pool(x, params["conv1"]["w"], params["conv1"]["b"], cfg.conv1, cfg.pool1)
    return _conv_then_pool(x, params["conv2"]["w"], params["conv2"]["b"], cfg.conv2, cfg.pool2, lrn=cfg.lrn2)
