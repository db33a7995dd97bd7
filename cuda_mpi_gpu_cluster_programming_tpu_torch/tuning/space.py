"""Legal candidate space of the kernel autotuner.

The JAX package's ``tuning/space.py`` over the port's kernels. One conv
layer (plus the pool it feeds, when adjacent) is the tuning unit, exactly
the granularity ``ops.kernel_model._conv_then_pool`` lowers at. The space
is the cartesian product of every ``KernelVariants`` knob, PRUNED to
combinations that can run and DEDUPED to distinct effective lowerings, so
the sweep never spends timing budget on a candidate the port would reject,
silently degrade (a geometry-dropped k_block) or alias.

Two differences from the JAX package's space, each for a reason:

- the TPU's lane rule (a k_block that is not a multiple of 128 cannot
  lower on hardware) is no rule for the CUDA kernels, so ``k_block=64`` is
  a legal candidate (on conv2: K = 256);
- :func:`_effective_signature` leaves ``row_block`` out: the CUDA kernels
  tile on their own, and only the hpool and block gates read it, which
  :func:`prune_reason` already holds to a whole image per program. Row
  blocks that give the same lowering are pruned as a "duplicate effective
  lowering" and never timed: one staged candidate per (conv, pool,
  k_block), where the JAX package times one per row block.

Every other prune string is the JAX package's word for word. Every prune is
attributable: ``prune_reason`` returns WHY a combo is out, and
``candidate_space`` reports each drop to ``on_prune``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Tuple

from ..ops.megakernel import block_fusible_reason
from ..ops.variants import KernelVariants

# Knob domains: the environment interface's allowed sets (ops.variants).
CONV_VARIANTS = ("taps", "pairs", "fused", "vcol", "g8")
POOL_VARIANTS = ("sep2", "phases")
ROW_BLOCKS = (8, 16, 32, 64)
K_BLOCKS = (0, 64, 128)
FUSES = ("none", "hpool", "block")


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """One conv layer's tuning-relevant geometry (+ its trailing pool)."""

    name: str
    filter_size: int
    stride: int
    padding: int
    in_channels: int
    out_channels: int
    in_h: int
    in_w: int
    pool_window: int = 0  # 0 = no adjacent pool
    pool_stride: int = 0
    # The LRN trailing the pool, when the model has one: (size, alpha,
    # beta, k, alpha_over_size), () = none. Part of the tuning unit because
    # fuse="block" folds it into the block kernel, so the timer runs it for
    # staged candidates too and both compare equal work.
    lrn: tuple = ()

    @property
    def out_h(self) -> int:
        return (self.in_h - self.filter_size + 2 * self.padding) // self.stride + 1

    @property
    def fq(self) -> int:
        return -(-self.filter_size // self.stride)  # ceil(F/S): taps per axis

    @property
    def has_pool(self) -> bool:
        return self.pool_window > 0

    def describe(self) -> str:
        pool = f" pool={self.pool_window}/{self.pool_stride}" if self.has_pool else ""
        return (
            f"{self.name}: {self.filter_size}x{self.filter_size}s{self.stride}"
            f"p{self.padding} K={self.out_channels} "
            f"in={self.in_h}x{self.in_w}x{self.in_channels}{pool}"
        )


def conv_geometries(model_cfg) -> List[ConvGeometry]:
    """The model's conv layers with their input dims and trailing pools,
    from the shared ``models.alexnet.layer_dims`` traversal."""
    from ..models.alexnet import ConvSpec, LrnSpec, PoolSpec, layer_dims

    chain = list(layer_dims(model_cfg))
    out: List[ConvGeometry] = []
    for i, (name, spec, (hi, wi, ci), _o) in enumerate(chain):
        if not isinstance(spec, ConvSpec):
            continue
        pw = ps = 0
        lrn: tuple = ()
        if i + 1 < len(chain) and isinstance(chain[i + 1][1], PoolSpec):
            nxt = chain[i + 1][1]
            pw, ps = nxt.window, nxt.stride
            if i + 2 < len(chain) and isinstance(chain[i + 2][1], LrnSpec):
                n = chain[i + 2][1]
                lrn = (n.size, n.alpha, n.beta, n.k, n.alpha_over_size)
        out.append(ConvGeometry(
            name=name, filter_size=spec.filter_size, stride=spec.stride, padding=spec.padding,
            in_channels=ci, out_channels=spec.out_channels, in_h=hi, in_w=wi,
            pool_window=pw, pool_stride=ps, lrn=lrn,
        ))
    return out


def prune_reason(v: KernelVariants, g: ConvGeometry, *, dtype: str = "fp32") -> str:
    """Why this combo is out of the sweep ('' = legal). Mirrors the gates of
    ``ops.kernel_model`` and the conv wrappers: a candidate this accepts
    runs the variant it claims. ``dtype`` is the sweep's precision policy:
    int8w runs the conv with its bias/ReLU epilogue off (the per-channel
    rescale lands between accumulation and bias, ``precision.quantize``),
    so hpool is not a legal candidate there; fuse="block" is (the block
    kernel rescales in its own epilogue)."""
    if v.fuse == "hpool" and dtype == "int8w":
        return (
            "hpool fusion needs the in-kernel bias/ReLU epilogue; int8w "
            "applies bias after the per-channel rescale (precision.quantize)"
        )
    if v.conv == "pairs" and g.fq < 2:
        return f"pairs degenerates to taps at fq={g.fq} (nothing to pair)"
    if v.conv == "g8" and g.stride < 2:
        return "g8 falls back to vcol at stride 1 (phase packing needs s>=2)"
    if v.k_block:
        if v.conv not in ("taps", "vcol"):
            return f"k_block applies to the taps/vcol path only (conv={v.conv})"
        if not (g.out_channels % v.k_block == 0 and g.out_channels > v.k_block):
            return (
                f"k_block={v.k_block} dropped at K={g.out_channels} "
                "(runs unblocked — duplicate of kb=0)"
            )
    if v.fuse == "hpool":
        if not g.has_pool:
            return "hpool fusion needs an adjacent pool"
        if v.conv not in ("taps", "vcol"):
            return f"hpool fusion supports taps/vcol only (conv={v.conv})"
        if v.pool != "sep2":
            return "hpool fusion is the sep2 pool's H stage (pool=phases excluded)"
        if v.row_block < g.out_h:
            return (
                f"hpool fusion needs the whole image per program "
                f"(row_block {v.row_block} < ho {g.out_h})"
            )
        if v.k_block:
            return "hpool fusion does not compose with k_block"
    if v.fuse == "block":
        # One gate for builder, wrapper and sweep (ops.megakernel).
        why = block_fusible_reason(
            variant=v.conv, row_block=v.row_block, k_block=v.k_block,
            pool=v.pool, out_h=g.out_h, pool_window=g.pool_window,
        )
        if why:
            return why
    return ""


def _effective_signature(v: KernelVariants, g: ConvGeometry) -> tuple:
    """What actually runs: no kernel reads the row block (the hpool and
    block gates that do have passed :func:`prune_reason` with a whole image
    per program), and the pool knob is moot without an adjacent pool."""
    return (v.conv, v.pool if g.has_pool else "-", v.k_block, v.fuse)


def candidate_space(
    g: ConvGeometry,
    *,
    dtype: str = "fp32",
    on_prune: Optional[Callable[[KernelVariants, str], None]] = None,
) -> List[KernelVariants]:
    """Every legal, effectively-distinct candidate for this layer, each
    bound to the layer's K so logs and plans are self-labelling. ``dtype``:
    the sweep's precision policy (see :func:`prune_reason`)."""
    seen: set = set()
    out: List[KernelVariants] = []
    for conv, pool, rb, kb, fuse in itertools.product(
        CONV_VARIANTS, POOL_VARIANTS, ROW_BLOCKS, K_BLOCKS, FUSES
    ):
        v = KernelVariants(
            conv=conv, pool=pool, row_block=rb, k_block=kb, fuse=fuse,
            k_channels=g.out_channels,
        )
        why = prune_reason(v, g, dtype=dtype)
        if not why:
            sig = _effective_signature(v, g)
            if sig in seen:
                why = f"duplicate effective lowering {sig}"
            else:
                seen.add(sig)
                out.append(v)
                continue
        if on_prune is not None:
            on_prune(v, why)
    return out


def layer_tuning_units(model_cfg) -> List[Tuple[str, ConvGeometry]]:
    """(layer_name, geometry) pairs in chain order: the sweep's work list."""
    return [(g.name, g) for g in conv_geometries(model_cfg)]
