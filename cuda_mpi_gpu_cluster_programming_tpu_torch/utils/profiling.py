"""Profiling: per-layer breakdown, named ranges, and trace capture.

The JAX package's ``utils/profiling.py`` for PyTorch on the GPU:

- :func:`stage_fns` — a model's layer chain as ``(name, fn)`` stages
  on either op tier: ``reference`` (the library ops of ``v1_jit``) or
  ``kernels`` (the hand-written CUDA kernels of ``v3_pallas``, launched as
  the staged pass launches them).
- :func:`forward_annotated` — the pass with a ``torch.profiler``
  ``record_function`` and, on the GPU, an NVTX range around every layer,
  so a trace attributes device time per layer.
- :func:`layer_breakdown` — fenced per-layer timing, each layer on its
  actual input (``run --breakdown``).
- :func:`trace` — ``torch.profiler`` over the enclosed region, written as
  a Chrome trace into a directory (``run --profile DIR``).

Both walk Blocks 1-2 (``Blocks12Config``) and full AlexNet
(``AlexNetConfig``: conv1..pool5, then fc6, fc7 and fc8).
"""

from __future__ import annotations

import contextlib
import functools
from pathlib import Path
from typing import Callable, List, Tuple

import torch

from ..models.alexnet import BLOCKS12, ConvSpec, LrnSpec, Params, PoolSpec
from ..models.init import params_to
from ..ops import reference as ops
from ..ops.reference import true_fp32
from .timing import amortized_stats

TRACE_FILE = "trace.json"


def cast_for_compute(params: Params, x: torch.Tensor, compute: str) -> Tuple[Params, torch.Tensor]:
    """``params`` and ``x`` as ``configs.build_forward`` runs a ``compute``
    policy: fp32 with TF32 turned off on the GPU (cuDNN otherwise takes its
    fp32 convolutions to TF32, and a stage would not time the pass it is cut
    from), bf16 with params and input cast to bf16. The int8w lowering has
    no staged chain and raises."""
    if compute == "bf16":
        return params_to(params, dtype=torch.bfloat16), x.to(torch.bfloat16)
    if compute != "fp32":
        raise ValueError(f"unknown compute mode {compute!r} (fp32|bf16)")
    true_fp32(x.device)
    return params, x


def _tier_ops(tier: str):
    """``(conv, pool, lrn, fused_relu)`` stage ops for one tier. Each op
    takes ``(params, x, *, ...spec kwargs)``.

    ``reference``: ``ops/reference.py``. Its pool is ``relu_maxpool``: the
    pool's input is a ReLU output at every tap, where ``relu_maxpool`` is
    ``maxpool`` bitwise at ``F.max_pool2d``'s cost, as ``forward_blocks12``
    runs it. ``kernels``: ``ops/kernel_model.conv`` (bias and ReLU in the
    conv's epilogue) and ``pool`` under the ``TPU_FRAMEWORK_*`` variants
    resolved now, and ``cuda_kernels.lrn``: the staged pass's launches."""
    if tier == "reference":
        def conv(p, x, *, name, spec, relu):
            out = ops.conv2d(x, p[name]["w"], p[name]["b"], stride=spec.stride, padding=spec.padding)
            return ops.relu(out) if relu else out

        def pool(p, x, *, spec):
            return ops.relu_maxpool(x, window=spec.window, stride=spec.stride)

        def lrn(p, x, *, spec):
            return ops.lrn(x, size=spec.size, alpha=spec.alpha, beta=spec.beta, k=spec.k,
                           alpha_over_size=spec.alpha_over_size)

        return conv, pool, lrn, False
    if tier == "kernels":
        from ..ops import cuda_kernels as ck
        from ..ops import kernel_model as km
        from ..ops.variants import KernelVariants

        kv = KernelVariants.resolve()

        def conv(p, x, *, name, spec, relu):
            return km.conv(x, p[name]["w"], p[name]["b"], stride=spec.stride, padding=spec.padding,
                           relu=relu, variant=kv.conv, k_block=kv.k_block)

        def pool(p, x, *, spec):
            return km.pool(x, window=spec.window, stride=spec.stride, variant=kv.pool)

        def lrn(p, x, *, spec):
            return ck.lrn(x, size=spec.size, alpha=spec.alpha, beta=spec.beta, k=spec.k,
                          alpha_over_size=spec.alpha_over_size)

        return conv, pool, lrn, True
    raise ValueError(f"tier must be reference|kernels, got {tier!r}")


def _fc_stage(name: str, relu: bool):
    def fn(p, x):
        out = ops.linear(x.reshape(x.shape[0], -1), p[name]["w"], p[name]["b"])
        return ops.relu(out) if relu else out

    return fn


def stage_fns(cfg=BLOCKS12, tier: str = "reference") -> List[Tuple[str, Callable[[Params, torch.Tensor], torch.Tensor]]]:
    """``(name, fn)`` per layer; each fn maps that layer's input to its
    output. One walk of ``cfg``'s layer chain, named as the JAX package
    names it. For a ``Blocks12Config`` the reference tier has ReLU as a
    stage of its own (the course code's 7-layer chain); the kernels tier
    fuses it into each conv (the kernel's epilogue), 5 stages, as
    ``forward_blocks12_kernels``. For an ``AlexNetConfig`` both tiers fuse
    ReLU into each conv stage (as ``forward_spatial``): conv1 .. pool5, then
    fc6, fc7 and fc8 (the FC head's matmuls on both tiers)."""
    conv, pool, lrn, fused_relu = _tier_ops(tier)
    full = cfg.family == "alexnet_full"
    stages = []
    for name, spec in cfg.layer_chain():
        if isinstance(spec, ConvSpec) and (full or fused_relu):
            stages.append((name if full else f"{name}+relu", functools.partial(conv, name=name, spec=spec, relu=True)))
        elif isinstance(spec, ConvSpec):
            stages.append((name, functools.partial(conv, name=name, spec=spec, relu=False)))
            stages.append((name.replace("conv", "relu"), lambda p, x: ops.relu(x)))
        elif isinstance(spec, PoolSpec):
            stages.append((name, functools.partial(pool, spec=spec)))
        elif isinstance(spec, LrnSpec):
            stages.append((name, functools.partial(lrn, spec=spec)))
    if full:
        stages += [("fc6", _fc_stage("fc6", True)), ("fc7", _fc_stage("fc7", True)), ("fc8", _fc_stage("fc8", False))]
    return stages


@torch.inference_mode()
def forward_annotated(params: Params, x: torch.Tensor, cfg=BLOCKS12, tier: str = "reference") -> torch.Tensor:
    """The pass with a ``record_function`` range per layer (and an NVTX
    range on the GPU), for traces."""
    for name, fn in stage_fns(cfg, tier=tier):
        with contextlib.ExitStack() as ranges:
            ranges.enter_context(torch.profiler.record_function(name))
            if x.is_cuda:
                ranges.enter_context(torch.cuda.nvtx.range(name))
            x = fn(params, x)
    return x


def layer_breakdown(
    params: Params,
    x: torch.Tensor,
    cfg=BLOCKS12,
    repeats: int = 10,
    warmup: int = 3,
    compute: str = "fp32",
    tier: str = "reference",
) -> List[Tuple[str, float, Tuple[int, ...]]]:
    """Fenced per-layer timing: ``[(layer, ms, output_shape), ...]``.

    Each layer is timed on its actual input (the previous layer's output,
    computed once outside the timed region) with the headline's amortized
    estimator. ``compute`` casts as :func:`cast_for_compute` does. Layers
    timed alone do not sum to the pass; ``observability.stages`` gives the
    split that does."""
    params, x = cast_for_compute(params, x, compute)
    rows: List[Tuple[str, float, Tuple[int, ...]]] = []
    cur = x
    for name, fn in stage_fns(cfg, tier=tier):
        run = torch.inference_mode()(fn)
        ms = amortized_stats(
            run, params, cur, n_small=max(1, warmup), n_large=max(1, warmup) + max(1, repeats),
        ).per_call_ms
        cur = run(params, cur)
        rows.append((name, ms, tuple(cur.shape)))
    return rows


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region (host and,
    with a GPU, device activity) into ``log_dir/trace.json``, a Chrome
    trace (``chrome://tracing``, Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / TRACE_FILE))
