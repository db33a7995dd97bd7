"""Per-stage latency attribution for the Blocks 1-2 forward.

The JAX package's ``observability/stages.py`` for PyTorch. A bench row
reports one ``per_pass_ms``; this module splits it across the stage
boundaries the sentinel taps name (conv1, pool1, conv2, pool2, lrn2; a
conv stage includes its ReLU), or across the two blocks of a fused
(``fuse="block"``) pass.

Method: **timed prefix re-execution, off the timed path**. The measured
forward is never instrumented. :func:`attribute_stages` runs the staged
chain as five *prefixes* (conv1; conv1+pool1; ...; the full chain), times
each with the headline's amortized estimator (``utils/timing.py``), and
attributes ``stage_k = t(prefix_k) - t(prefix_{k-1})``. The differences
telescope, so the stages sum to the measured full-chain time; a
noise-negative difference clamps to zero and the stages then renormalize
onto the total (:func:`telescope`, the JAX package's arithmetic). Timing
each stage alone (``utils.profiling.layer_breakdown``) cannot promise that
sum.

The prefixes are cut from the pass the row measured: fp32 with TF32 off on
the GPU and bf16 with params and input cast, as ``configs.build_forward``
runs them (``utils.profiling.cast_for_compute``); the kernels tier launches
the staged pass's kernels (conv2d 2, maxpool2d 2, lrn 1 for the full
prefix under the default variants), ``fuse="block"`` one ``conv_block`` a
block.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Sequence, Tuple

import torch

from ..models.alexnet import BLOCKS12
from .trace import off_timed_path, span

# The sentinel tap boundaries; conv stages include their ReLU.
SENTINEL_STAGES = ("conv1", "pool1", "conv2", "pool2", "lrn2")
BLOCK_STAGES = ("block1", "block2")

StageList = List[Tuple[str, Callable]]


def sentinel_stage_fns(cfg=None, tier: str = "reference") -> StageList:
    """``(name, fn)`` per sentinel stage on ``tier`` (reference|kernels);
    each fn maps the previous stage's output to this stage's output."""
    from ..utils.profiling import _tier_ops

    cfg = cfg if cfg is not None else BLOCKS12
    conv, pool, lrn, _fused = _tier_ops(tier)
    return [
        ("conv1", functools.partial(conv, name="conv1", spec=cfg.conv1, relu=True)),
        ("pool1", functools.partial(pool, spec=cfg.pool1)),
        ("conv2", functools.partial(conv, name="conv2", spec=cfg.conv2, relu=True)),
        ("pool2", functools.partial(pool, spec=cfg.pool2)),
        ("lrn2", functools.partial(lrn, spec=cfg.lrn2)),
    ]


def block_stage_fns(cfg=None, variants=None) -> StageList:
    """``(block, fn)`` for the two fused blocks: one ``conv_block`` launch
    each (block 2 folds in the LRN). ``variants`` (a ``KernelVariants`` or
    per-layer ``LayerVariants``; default the code defaults) gives each
    block's conv body (taps or vcol) and row block, as the JAX package's
    ``attribute_blocks`` reads them."""
    from ..ops import megakernel as mk
    from ..ops.kernel_model import _layer_variants
    from ..ops.shapes import conv_out_dim
    from ..ops.variants import KernelVariants

    cfg = cfg if cfg is not None else BLOCKS12
    v = variants if variants is not None else KernelVariants()

    def block(p, cur, *, name, cspec, pspec, lrn):
        lv = _layer_variants(v, name)
        ho = conv_out_dim(cur.shape[1], cspec.filter_size, cspec.padding, cspec.stride)
        return mk.conv_block(
            cur, p[name]["w"], p[name]["b"], stride=cspec.stride, padding=cspec.padding,
            pool_window=pspec.window, pool_stride=pspec.stride, lrn=lrn,
            variant=lv.conv if lv.conv in ("taps", "vcol") else "vcol", row_block=max(lv.row_block, ho),
        )

    return [
        ("block1", functools.partial(block, name="conv1", cspec=cfg.conv1, pspec=cfg.pool1, lrn=None)),
        ("block2", functools.partial(block, name="conv2", cspec=cfg.conv2, pspec=cfg.pool2, lrn=cfg.lrn2)),
    ]


def stage_prefix(stage_list: StageList, k: int) -> Callable:
    """The first ``k`` stages as one ``(params, x) -> out`` function."""
    fns = [fn for _n, fn in stage_list[:k]]

    @torch.inference_mode()
    def run(p, xin):
        cur = xin
        for fn in fns:
            cur = fn(p, cur)
        return cur

    return run


def telescope(names: Sequence[str], prefix_ms: Sequence[float]) -> Tuple[Tuple[str, float], ...]:
    """Per-stage ms from the prefix times: ``t_k - t_{k-1}``, clamped at 0;
    when a clamp left the sum off the full-chain time, every stage scales
    onto it, so the stages sum to ``prefix_ms[-1]``."""
    stages: List[Tuple[str, float]] = []
    prev = 0.0
    for name, t in zip(names, prefix_ms):
        stages.append((name, max(0.0, t - prev)))
        prev = t
    clamped_sum = sum(ms for _n, ms in stages)
    if clamped_sum > 0 and abs(clamped_sum - prefix_ms[-1]) > 1e-12:
        scale = prefix_ms[-1] / clamped_sum
        stages = [(name, ms * scale) for name, ms in stages]
    return tuple(stages)


@dataclasses.dataclass(frozen=True)
class StageAttribution:
    """One attribution pass: per-stage ms (telescoped prefix differences),
    the raw prefix times, and the full-chain total the stages sum to.
    ``granularity``: "stage" (the five sentinel boundaries) or "block"
    (block1/block2 of a ``fuse="block"`` pass, which has no interior
    boundary to time)."""

    stages: Tuple[Tuple[str, float], ...]  # (name, attributed ms), in order
    prefix_ms: Tuple[float, ...]  # t(prefix_1) .. t(prefix_n) == total
    total_ms: float
    batch: int
    tier: str
    compute: str
    granularity: str = "stage"

    @property
    def stage_sum_ms(self) -> float:
        return sum(ms for _n, ms in self.stages)

    def to_obj(self) -> dict:
        """The bench row's ``breakdown`` sub-object."""
        return {
            "stages": {name: round(ms, 4) for name, ms in self.stages},
            "stage_sum_ms": round(self.stage_sum_ms, 4),
            "total_ms": round(self.total_ms, 4),
            "method": "prefix-diff" if self.granularity == "stage" else "prefix-diff/megakernel-blocks",
            "tier": self.tier,
            "compute": self.compute,
            "batch": self.batch,
            "granularity": self.granularity,
        }


def _prefix_times(stage_list: StageList, params, x, repeats: int, warmup: int) -> List[float]:
    from ..utils.timing import amortized_stats

    n_small = max(1, warmup)
    return [
        amortized_stats(stage_prefix(stage_list, k), params, x,
                        n_small=n_small, n_large=n_small + max(1, repeats)).per_call_ms
        for k in range(1, len(stage_list) + 1)
    ]


@off_timed_path
def attribute_stages(
    params, x, cfg=None, *, tier: str = "reference", compute: str = "fp32", repeats: int = 3, warmup: int = 1,
) -> StageAttribution:
    """Time the staged Blocks 1-2 chain on ``tier`` and attribute per-stage
    ms. ``compute`` is fp32 or bf16; the int8w lowering has no staged-chain
    analogue and raises, so a caller degrades visibly instead of labelling
    fp32 numbers int8w."""
    from ..utils.profiling import cast_for_compute

    if compute not in ("fp32", "bf16"):
        raise ValueError(f"stage attribution supports fp32|bf16, got {compute!r} "
                         "(the int8w lowering has no staged-chain analogue)")
    params, x = cast_for_compute(params, x, compute)
    stage_list = sentinel_stage_fns(cfg, tier=tier)
    with span("stages.attribute", tier=tier, compute=compute, batch=int(x.shape[0])):
        prefix_ms = _prefix_times(stage_list, params, x, repeats, warmup)
    return StageAttribution(
        stages=telescope([n for n, _f in stage_list], prefix_ms), prefix_ms=tuple(prefix_ms),
        total_ms=prefix_ms[-1], batch=int(x.shape[0]), tier=tier, compute=compute,
    )


@off_timed_path
def attribute_blocks(
    params, x, cfg=None, *, compute: str = "fp32", variants=None, repeats: int = 3, warmup: int = 1,
) -> StageAttribution:
    """Block-granularity attribution for a ``fuse="block"`` pass: the same
    telescoped prefix differences over block1 and block1+block2, the only
    boundaries a fused pass has. The result says ``granularity="block"``,
    so nothing reads it as a per-stage split. fp32|bf16 only."""
    from ..utils.profiling import cast_for_compute

    if compute not in ("fp32", "bf16"):
        raise ValueError(f"block attribution supports fp32|bf16, got {compute!r} "
                         "(the int8w fused pass rides the quantized bench path)")
    params, x = cast_for_compute(params, x, compute)
    stage_list = block_stage_fns(cfg, variants)
    with span("stages.attribute_blocks", compute=compute, batch=int(x.shape[0])):
        prefix_ms = _prefix_times(stage_list, params, x, repeats, warmup)
    return StageAttribution(
        stages=telescope(BLOCK_STAGES, prefix_ms), prefix_ms=tuple(prefix_ms), total_ms=prefix_ms[-1],
        batch=int(x.shape[0]), tier="kernels", compute=compute, granularity="block",
    )
