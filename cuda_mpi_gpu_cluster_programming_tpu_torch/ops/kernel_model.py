"""Blocks 1-2 forward pass on the CUDA kernel tier (``v3_pallas``).

The counterpart of the JAX package's ``forward_blocks12_pallas``. Two
routes, chosen per layer by its ``KernelVariants``:

- ``fuse="none"`` (default): five launches per forward, conv1+bias+ReLU,
  pool1, conv2+bias+ReLU, pool2, LRN2 (the TPU's two-pass pools take seven);
- ``fuse="block"``: one ``conv_block`` launch per block where
  ``megakernel.block_fusible_reason`` allows it, two per forward; bitwise
  the staged route's output in fp32 and bf16.
"""

from __future__ import annotations

import torch

from ..models.alexnet import BLOCKS12, Blocks12Config, ConvSpec, LrnSpec, PoolSpec
from . import cuda_kernels as ck
from . import megakernel as mk
from .shapes import conv_out_dim
from .variants import KernelVariants, LayerVariants, require_ported


def _layer_variants(v: KernelVariants | LayerVariants, name: str) -> KernelVariants:
    """One layer's knobs from either a global set or a per-layer plan."""
    return v.for_layer(name) if isinstance(v, LayerVariants) else v


def _conv_then_pool(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, cspec: ConvSpec, pspec: PoolSpec,
    v: KernelVariants, lrn: LrnSpec | None = None,
) -> torch.Tensor:
    """One block, the one place that decides whether it runs fused:
    ``fuse="block"`` and a geometry the gate accepts take the ``conv_block``
    kernel (with ``lrn`` folded in); otherwise the conv (+bias, ReLU)
    kernel, the pool kernel, then the LRN kernel when ``lrn`` is given."""
    require_ported(v)
    ho = conv_out_dim(x.shape[1], cspec.filter_size, cspec.padding, cspec.stride)
    if v.fuse == "block" and not mk.block_fusible_reason(
        variant=v.conv, row_block=v.row_block, k_block=v.k_block,
        pool=v.pool, out_h=ho, pool_window=pspec.window,
    ):
        return mk.conv_block(
            x, w, b, stride=cspec.stride, padding=cspec.padding,
            pool_window=pspec.window, pool_stride=pspec.stride,
            lrn=lrn, variant=v.conv, row_block=v.row_block,
        )
    y = ck.conv2d_bias_relu(x, w, b, stride=cspec.stride, padding=cspec.padding, relu=True)
    out = ck.maxpool2d(y, window=pspec.window, stride=pspec.stride)
    if lrn is not None:
        out = ck.lrn(
            out, size=lrn.size, alpha=lrn.alpha, beta=lrn.beta, k=lrn.k,
            alpha_over_size=lrn.alpha_over_size,
        )
    return out


def forward_blocks12_kernels(
    params, x: torch.Tensor, cfg: Blocks12Config = BLOCKS12,
    variants: KernelVariants | LayerVariants | None = None,
) -> torch.Tensor:
    """``x`` NHWC (contiguous), params ``{"conv1": {"w","b"}, "conv2": ...}``
    with HWIO weights, all in one dtype (fp32 or bf16). ``variants``: one
    ``KernelVariants`` for both layers or a per-layer ``LayerVariants``;
    None reads the environment now (``KernelVariants.resolve()``)."""
    v = variants if variants is not None else KernelVariants.resolve()
    x = _conv_then_pool(
        x, params["conv1"]["w"], params["conv1"]["b"], cfg.conv1, cfg.pool1, _layer_variants(v, "conv1")
    )
    # Block 2's trailing LRN rides the handoff so fuse="block" folds it in.
    return _conv_then_pool(
        x, params["conv2"]["w"], params["conv2"]["b"], cfg.conv2, cfg.pool2, _layer_variants(v, "conv2"),
        lrn=cfg.lrn2,
    )
