"""Forward passes on the CUDA kernel tier: Blocks 1-2 (``v3_pallas``) and
full AlexNet (``v6_full_pallas``, :func:`forward_alexnet_kernels`).

The counterpart of the JAX package's ``forward_blocks12_pallas``. Each
block (conv -> pool, plus block 2's LRN) goes through
:func:`_conv_then_pool`, which picks the route from the layer's
``KernelVariants``:

- ``fuse="block"``: one ``conv_block`` launch per block where
  ``megakernel.block_fusible_reason`` allows it; bitwise the staged route's
  output in fp32 and bf16;
- ``fuse="hpool"`` with a taps/vcol conv, the sep2 pool, a whole image per
  program and no k_block: the conv kernel takes the pool's H-axis max in
  its epilogue, then the pool's W stage; bitwise the staged route;
- otherwise staged: the conv of ``v.conv`` (taps, pairs, fused, vcol or
  g8, with ``v.k_block``), the pool of ``v.pool`` (sep2 or phases), then LRN.
  With the defaults that is five launches per forward (the TPU's two-pass
  pools take seven).
"""

from __future__ import annotations

import torch

from ..models.alexnet import BLOCKS12, Blocks12Config, ConvSpec, LrnSpec, PoolSpec
from ..models.alexnet_full import ALEXNET, fc_head
from . import cuda_kernels as ck
from . import megakernel as mk
from .shapes import conv_out_dim
from .variants import KernelVariants, LayerVariants


def _layer_variants(v: KernelVariants | LayerVariants, name: str) -> KernelVariants:
    """One layer's knobs from either a global set or a per-layer plan."""
    return v.for_layer(name) if isinstance(v, LayerVariants) else v


def conv(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool,
    variant: str, k_block: int = 0, hpool=None, padding_w=None,
) -> torch.Tensor:
    """The conv kernel of one variant, as the JAX package's
    ``conv2d_pallas(variant=...)`` lowers it: k_block and hpool reach the
    taps/vcol bodies only (pairs, fused and g8 ignore k_block and refuse
    hpool), pairs at fq = ceil(F/stride) < 2 runs taps (nothing to pair)
    and g8 at stride 1 runs vcol (no phases to pack). ``padding`` pads H,
    ``padding_w`` W (default ``padding``): the row-sharded tier runs
    ``padding=0, padding_w=P`` (``conv2d_pallas_hvalid``)."""
    if variant not in ("taps", "pairs", "fused", "vcol", "g8"):
        raise ValueError(f"unknown conv variant {variant!r}")
    if hpool is not None and variant not in ("taps", "vcol"):
        raise ValueError(f"hpool fusion supports the taps/vcol lowering only, got {variant!r}")
    kw = dict(stride=stride, padding=padding, relu=relu, padding_w=padding_w)
    if variant == "g8" and stride >= 2:
        return ck.conv_g8(x, w, b, **kw)
    if variant in ("vcol", "g8"):
        return ck.conv2d_bias_relu(x, w, b, k_block=k_block, hpool=hpool, **kw)
    if variant == "fused":
        return ck.conv_im2col(x, w, b, **kw)
    if variant == "pairs" and -(-w.shape[0] // stride) >= 2:
        return ck.conv_pairs(x, w, b, **kw)
    return ck.conv_taps(x, w, b, k_block=k_block, hpool=hpool, **kw)


def pool(x: torch.Tensor, *, window: int, stride: int, variant: str) -> torch.Tensor:
    """The max-pool kernel of one variant: sep2 (``maxpool2d``, one 2-D
    pass) or phases (``maxpool_phases``); bitwise the same."""
    if variant == "phases":
        return ck.maxpool_phases(x, window=window, stride=stride)
    if variant == "sep2":
        return ck.maxpool2d(x, window=window, stride=stride)
    raise ValueError(f"unknown pool variant {variant!r}")


def _conv_then_pool(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, cspec: ConvSpec, pspec: PoolSpec,
    v: KernelVariants, lrn: LrnSpec | None = None,
) -> torch.Tensor:
    """One block, the one place that decides its route, with the JAX
    package's gates in the same order: ``fuse="block"`` where the gate
    accepts the geometry (with ``lrn`` folded in); else ``fuse="hpool"``
    with a taps/vcol conv, the sep2 pool, a whole image per program
    (``row_block >= ho``) and no k_block; else the staged conv of ``v.conv`` and pool
    of ``v.pool``. A staged or hpool route runs the LRN kernel after, when
    ``lrn`` is given."""
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
    kw = dict(stride=cspec.stride, padding=cspec.padding, relu=True, variant=v.conv)
    if (v.fuse == "hpool" and v.conv in ("taps", "vcol") and v.pool == "sep2"
            and v.row_block >= ho and v.k_block == 0):
        y = conv(x, w, b, hpool=(pspec.window, pspec.stride), **kw)
        out = ck.maxpool2d_w(y, window=pspec.window, stride=pspec.stride)
    else:
        y = conv(x, w, b, k_block=v.k_block, **kw)
        out = pool(y, window=pspec.window, stride=pspec.stride, variant=v.pool)
    if lrn is not None:
        out = ck.lrn(
            out, size=lrn.size, alpha=lrn.alpha, beta=lrn.beta, k=lrn.k,
            alpha_over_size=lrn.alpha_over_size,
        )
    return out


def forward_spatial_kernels(
    params, x: torch.Tensor, cfg=BLOCKS12, variants: KernelVariants | LayerVariants | None = None,
) -> torch.Tensor:
    """``cfg``'s layer chain on the kernel tier (Blocks 1-2, or full
    AlexNet's conv1..pool5): the JAX package's ``forward_alexnet_pallas``
    chain walker. A conv followed by a pool (conv1, conv2, conv5) goes
    through :func:`_conv_then_pool` with the pool, and an LRN after it,
    folded into its block, so the ``fuse`` gates stay one implementation;
    any other conv (conv3, conv4) through :func:`conv` with the layer's own
    knobs, bias and ReLU in its epilogue. ``variants``: one
    ``KernelVariants`` for every layer or a per-layer ``LayerVariants``;
    None reads the environment now (``KernelVariants.resolve()``)."""
    v = variants if variants is not None else KernelVariants.resolve()
    chain = list(cfg.layer_chain())
    consumed: set = set()  # the pools and LRNs a block took
    for idx, (name, spec) in enumerate(chain):
        if idx in consumed:
            continue
        lv = _layer_variants(v, name)
        nxt = chain[idx + 1][1] if idx + 1 < len(chain) else None
        if isinstance(spec, ConvSpec) and isinstance(nxt, PoolSpec):
            nxt2 = chain[idx + 2][1] if idx + 2 < len(chain) else None
            lrn = nxt2 if isinstance(nxt2, LrnSpec) else None
            x = _conv_then_pool(x, params[name]["w"], params[name]["b"], spec, nxt, lv, lrn=lrn)
            consumed.update((idx + 1, idx + 2) if lrn is not None else (idx + 1,))
        elif isinstance(spec, ConvSpec):
            x = conv(x, params[name]["w"], params[name]["b"], stride=spec.stride, padding=spec.padding, relu=True,
                     variant=lv.conv, k_block=lv.k_block)
        elif isinstance(spec, PoolSpec):
            x = pool(x, window=spec.window, stride=spec.stride, variant=lv.pool)
        elif isinstance(spec, LrnSpec):
            x = ck.lrn(x, size=spec.size, alpha=spec.alpha, beta=spec.beta, k=spec.k,
                       alpha_over_size=spec.alpha_over_size)
    return x


def forward_blocks12_kernels(
    params, x: torch.Tensor, cfg: Blocks12Config = BLOCKS12,
    variants: KernelVariants | LayerVariants | None = None,
) -> torch.Tensor:
    """``x`` NHWC (contiguous), params ``{"conv1": {"w","b"}, "conv2": ...}``
    with HWIO weights, all in one dtype (fp32 or bf16): two blocks, block
    2's trailing LRN riding its handoff so ``fuse="block"`` folds it in.
    ``variants`` as in :func:`forward_spatial_kernels`."""
    return forward_spatial_kernels(params, x, cfg, variants)


def forward_alexnet_kernels(
    params, x: torch.Tensor, cfg=ALEXNET, variants: KernelVariants | LayerVariants | None = None,
) -> torch.Tensor:
    """Full AlexNet on the kernel tier (``v6_full_pallas``): conv1..pool5
    through :func:`forward_spatial_kernels`, then the FC head
    (``torch.matmul``)."""
    return fc_head(params, forward_spatial_kernels(params, x, cfg, variants), cfg)
