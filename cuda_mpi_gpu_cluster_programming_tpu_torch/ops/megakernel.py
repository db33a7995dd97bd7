"""Fused blocks: one kernel launch per Blocks 1-2 block.

The counterpart of the JAX package's ``ops/megakernel.py``. Block 1 is
Conv1 -> ReLU -> Pool1 and block 2 is Conv2 -> ReLU -> Pool2 -> LRN2; each
runs as ONE launch of the ``conv_block`` CUDA kernel (``csrc/conv_block.cu``),
which reads the block's input and params once and writes its output once:
the interior activations never reach device memory.

Numerics: fp32 and bf16 are bitwise the port's staged kernel chain (same
FMA order, same cast points). int8w rescales the uncast fp32 accumulator,
which the staged chain cannot do (its conv kernel writes bf16 before the
host rescale), so int8w is held to the int8w budget, not bitwise.
"""

from __future__ import annotations

import torch

from . import cuda_kernels as ck
from .shapes import conv_out_dim
from .variants import ROW_BLOCK


def block_fusible_reason(
    *,
    variant: str,
    row_block: int,
    k_block: int,
    pool: str,
    out_h: int,
    pool_window: int,
) -> str:
    """Why ``fuse="block"`` cannot lower for this knob/geometry set
    ('' = it can). The ONE gate the model builder
    (``pallas_model._conv_then_pool``), the tuner's candidate space
    (``tuning.space.prune_reason``), and the kernel wrapper all consult,
    so the three cannot drift."""
    if pool_window <= 0:
        return "block fusion needs an adjacent pool"
    if variant not in ("taps", "vcol"):
        return f"block fusion supports taps/vcol only (conv={variant})"
    if pool != "sep2":
        return (
            "block fusion pools in-kernel via the sep2 phase split "
            "(pool=phases excluded)"
        )
    if row_block < out_h:
        return (
            f"block fusion needs the whole image per program "
            f"(row_block {row_block} < ho {out_h})"
        )
    if k_block:
        return "block fusion does not compose with k_block (no K grid dim)"
    return ""


def conv_block(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    stride: int,
    padding: int,
    pool_window: int,
    pool_stride: int,
    lrn=None,
    scale: torch.Tensor | None = None,
    variant: str | None = None,
    row_block: int | None = None,
) -> torch.Tensor:
    """One fused block: conv(+bias+ReLU) -> max-pool (-> LRN) in one launch.

    ``x`` (N, H, W, C), ``w`` (F, F, C, K) HWIO. ``lrn``: an ``LrnSpec``
    (or None) folding the block's trailing LRN into the same launch.
    ``scale``: the int8w per-channel rescale, between accumulation and
    bias (``w`` then holds the int8 values). Output dtype: ``x.dtype`` for
    fp32/bf16; for int8w bf16 (no LRN) or fp32 (after the LRN), the staged
    quantized chain's boundary dtypes. ``variant``/``row_block`` are the
    knobs the gate judges (defaults vcol, 64); a geometry the gate refuses
    raises ``ValueError``, never runs another route."""
    ho = conv_out_dim(x.shape[1], w.shape[0], padding, stride)
    why = block_fusible_reason(
        variant=variant if variant is not None else "vcol",
        row_block=row_block if row_block is not None else ROW_BLOCK,
        k_block=0, pool="sep2", out_h=ho, pool_window=pool_window,
    )
    if why:
        raise ValueError(why)
    return ck.conv_block(
        x, w, b, stride=stride, padding=padding, pool_window=pool_window,
        pool_stride=pool_stride, lrn=lrn, scale=scale,
    )


def int8w_conv_block(
    x: torch.Tensor,
    q: torch.Tensor,
    scale: torch.Tensor,
    b: torch.Tensor,
    *,
    stride: int,
    padding: int,
    pool_window: int,
    pool_stride: int,
    lrn=None,
    variant: str | None = None,
    row_block: int | None = None,
) -> torch.Tensor:
    """The dequant-free int8w block: bf16 activations, the int8 weights
    ``q`` widened exactly in the kernel, fp32 accumulation, the per-channel
    ``scale`` on the uncast accumulator, then fp32 bias, ReLU and bf16."""
    return conv_block(
        x.to(torch.bfloat16), q, b.float(), stride=stride, padding=padding,
        pool_window=pool_window, pool_stride=pool_stride, lrn=lrn,
        scale=scale.float(), variant=variant, row_block=row_block,
    )
