"""The kernel autotuner: sweep, time, pick, persist.

The JAX package's ``tuning/autotune.py`` over the port's CUDA kernels. Per
conv layer (the ``_conv_then_pool`` lowering unit) the sweep times every
legal ``KernelVariants`` candidate with the port's chained-timing estimator
(``utils.timing.amortized_stats``: short and long fenced chains, median of
their differences) and persists the winners as a ``TunePlan`` keyed by
(device kind, geometry, batch, dtype, code revision).

Resilience: the whole sweep runs under a ``Deadline`` and every candidate is
a chaos-injectable ``kernel_compile`` site. A candidate that raises is
recorded as failed and skipped; a layer whose candidates ALL fail, or that
the deadline cuts off, degrades to the DEFAULT variants, and the plan says
so in ``degraded`` and the per-layer stats. (``chip_smoke.py`` fails a run
whose plan records any failed candidate, so a broken kernel cannot hide in
the sweep on the card.)
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from ..observability.trace import span as obs_span
from ..ops.variants import KernelVariants
from ..resilience import chaos
from ..resilience.policy import Deadline
from .plan import (
    TunePlan,
    code_rev,
    load_plan,
    load_policy,
    save_plan,
    save_policy,
    shape_key,
)
from .plan import device_kind as _device_kind
from .space import ConvGeometry, _effective_signature, candidate_space, layer_tuning_units

# The dtype dimension of the sweep: precision policy names, reference floor
# first (also the deterministic tie-break order).
DTYPES = ("fp32", "bf16", "int8w")

# timer(geometry, variants, dtype, batch, repeats, warmup) -> (ms, ci95, n).
# Injectable so the CPU tests sweep deterministically without timing.
Timer = Callable[[ConvGeometry, KernelVariants, str, int, int, int], Tuple[float, float, int]]


@torch.inference_mode()
def _default_timer(
    g: ConvGeometry, v: KernelVariants, dtype: str, batch: int, repeats: int, warmup: int, *, device="cuda",
) -> Tuple[float, float, int]:
    """Time one candidate on ``device`` through the production lowering
    (``_conv_then_pool``, or ``int8w_conv_then_pool`` for int8w: the gates
    the model forward runs), on the JAX package's constant inputs: input
    1.0, weights 0.01 (int8w: int8 ones with scale 0.01), bias 0."""
    from ..models.alexnet import ConvSpec, LrnSpec, PoolSpec
    from ..ops import kernel_model as km
    from ..utils.timing import amortized_stats

    cspec = ConvSpec(g.out_channels, g.filter_size, g.stride, g.padding)
    pspec = PoolSpec(g.pool_window, g.pool_stride) if g.has_pool else None
    # The block's trailing LRN is timed for EVERY candidate (fused ones fold
    # it in, staged ones launch it after), so both compare equal work.
    lrn = LrnSpec(*g.lrn) if g.lrn else None
    n_small = max(1, warmup)
    wshape = (g.filter_size, g.filter_size, g.in_channels, g.out_channels)
    if dtype == "int8w":
        from ..precision.quantize import int8w_conv, int8w_conv_then_pool

        x = torch.full((batch, g.in_h, g.in_w, g.in_channels), 1.0, dtype=torch.bfloat16, device=device)
        q = torch.ones(wshape, dtype=torch.int8, device=device)
        s = torch.full((g.out_channels,), 0.01, dtype=torch.float32, device=device)
        b = torch.zeros((g.out_channels,), dtype=torch.float32, device=device)
        if pspec is not None:
            def fn(x, q, s, b):
                return int8w_conv_then_pool(x, q, s, b, cspec, pspec, v, tier="kernels", lrn=lrn)
        else:
            def fn(x, q, s, b):
                return int8w_conv(x, q, s, b, stride=g.stride, padding=g.padding, tier="kernels", variants=v)
        args = (x, q, s, b)
    else:
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        x = torch.full((batch, g.in_h, g.in_w, g.in_channels), 1.0, dtype=dt, device=device)
        w = torch.full(wshape, 0.01, dtype=dt, device=device)
        b = torch.zeros((g.out_channels,), dtype=dt, device=device)
        if pspec is not None:
            def fn(x, w, b):
                return km._conv_then_pool(x, w, b, cspec, pspec, v, lrn=lrn)
        else:
            fn = functools.partial(
                km.conv, stride=g.stride, padding=g.padding, relu=True, variant=v.conv, k_block=v.k_block,
            )
        args = (x, w, b)
    st = amortized_stats(fn, *args, n_small=n_small, n_large=n_small + max(1, repeats), min_samples=2, max_samples=4)
    return st.per_call_ms, st.ci95_ms, st.n_samples


def tune_layer(
    g: ConvGeometry,
    *,
    dtype: str,
    batch: int,
    deadline: Deadline,
    repeats: int,
    warmup: int,
    timer: Timer,
    log: Callable[[str], None],
    block_screen: str = "",
) -> Tuple[KernelVariants, dict, str]:
    """Sweep one layer; returns (winner, stats, degraded_reason).

    ``block_screen``: a non-empty string prunes every ``fuse="block"``
    candidate with that reason BEFORE timing (the dtype sweep passes the
    gate's block-screen failure here), attributable in ``pruned_reasons``
    like a geometry prune."""
    default = KernelVariants().bind(g.out_channels)
    pruned: list = []
    cands = candidate_space(g, dtype=dtype, on_prune=lambda v, why: pruned.append(why))
    if block_screen:
        kept = []
        for v in cands:
            if v.fuse == "block":
                pruned.append(block_screen)
            else:
                kept.append(v)
        cands = kept
    ch = chaos.active()
    timed: list = []   # (ms, ci95, n, variants)
    failed: list = []  # (variants, cause)
    cut = ""
    for v in cands:
        if deadline.expired:
            cut = f"deadline expired after {len(timed) + len(failed)}/{len(cands)} candidates"
            break
        try:
            if ch is not None:
                ch.maybe_raise("kernel_compile", f"tune {g.name} [{v.label()}]")
            with obs_span("tune.candidate", layer=g.name, variant=v.label(), dtype=dtype) as sp:
                ms, ci, n = timer(g, v, dtype, batch, repeats, warmup)
                if sp is not None:
                    sp.set(ms=round(ms, 4), ci95_ms=round(ci, 4), n=n)
            timed.append((ms, ci, n, v))
            log(f"tune {g.name}: {v.label()} -> {ms:.3f} ms (ci95 {ci:.3f}, n={n})")
        except Exception as e:  # noqa: BLE001 — a broken candidate must not kill the sweep; it is recorded
            cause = f"{type(e).__name__}: {e}"[:120]
            failed.append((v, cause))
            log(f"tune {g.name}: {v.label()} FAILED ({cause})")
    reasons: dict = {}
    for why in pruned:
        reasons[why] = reasons.get(why, 0) + 1
    stats = {
        "geometry": g.describe(),
        "candidates": len(cands),
        "pruned": len(pruned),
        "pruned_reasons": reasons,
        "timed": len(timed),
        "failed": len(failed),
    }
    if failed:
        stats["failures"] = {v.label(): cause for v, cause in failed}
    if not timed:
        reason = cut or (f"all {len(cands)} candidates failed" if failed else "no legal candidates")
        stats["degraded"] = reason
        log(f"tune {g.name}: DEGRADED to defaults ({reason})")
        return default, stats, reason
    best_ms, best_ci, best_n, winner = min(timed, key=lambda t: t[0])
    stats.update(best_ms=round(best_ms, 4), best_ci95_ms=round(best_ci, 4), best_n=best_n)
    # The default lowering's time, matched by effective signature.
    dsig = _effective_signature(default, g)
    for ms, _ci, _n, v in timed:
        if _effective_signature(v, g) == dsig:
            stats["default_ms"] = round(ms, 4)
            break
    if cut:
        stats["degraded"] = cut  # partial sweep: the winner stands, but say so
    log(
        f"tune {g.name}: winner {winner.label()} at {best_ms:.3f} ms"
        + (f" (default {stats['default_ms']:.3f} ms)" if "default_ms" in stats else "")
    )
    return winner, stats, cut


def autotune_model(
    model_cfg,
    *,
    dtype: str,
    batch: int,
    deadline: Optional[Deadline] = None,
    repeats: int = 5,
    warmup: int = 2,
    timer: Optional[Timer] = None,
    log: Callable[[str], None] = print,
    device="cuda",
    device_kind: Optional[str] = None,
    block_screen: str = "",
) -> TunePlan:
    """Sweep every conv layer of ``model_cfg`` on ``device`` and return the
    TunePlan."""
    deadline = deadline or Deadline.after(None)
    timer = timer or functools.partial(_default_timer, device=device)
    device_kind = device_kind or _device_kind(device)
    layers: list = []
    stats: dict = {}
    notes: list = []
    for name, g in layer_tuning_units(model_cfg):
        if deadline.expired:
            # Degrade, don't wedge: the remaining layers get the defaults.
            layers.append((name, KernelVariants().bind(g.out_channels)))
            stats[name] = {"geometry": g.describe(), "degraded": "deadline expired before sweep"}
            notes.append(f"{name}: deadline expired before sweep")
            continue
        with obs_span("tune.layer", layer=name, dtype=dtype, batch=batch):
            winner, lstats, degraded = tune_layer(
                g, dtype=dtype, batch=batch, deadline=deadline, repeats=repeats, warmup=warmup,
                timer=timer, log=log, block_screen=block_screen,
            )
        layers.append((name, winner))
        stats[name] = lstats
        if degraded:
            notes.append(f"{name}: {degraded}")
    return TunePlan(
        device_kind=device_kind, shape_key=shape_key(model_cfg), batch=batch, dtype=dtype,
        code_rev=code_rev(), layers=tuple(layers), stats=stats, degraded="; ".join(notes),
    )


def autotune(
    path,
    model_cfg,
    *,
    dtype: str,
    batch: int,
    force: bool = False,
    deadline: Optional[Deadline] = None,
    repeats: int = 5,
    warmup: int = 2,
    timer: Optional[Timer] = None,
    log: Callable[[str], None] = print,
    device="cuda",
    device_kind: Optional[str] = None,
    block_screen: str = "",
) -> Tuple[TunePlan, bool]:
    """Cached sweep: a fresh on-disk plan for this exact point (same device,
    geometry, batch, dtype, code revision) short-circuits the whole sweep,
    ``(plan, True)``. Otherwise sweep, persist, ``(plan, False)``."""
    device_kind = device_kind or _device_kind(device)
    if not force:
        cached = load_plan(
            path, device_kind=device_kind, model_cfg=model_cfg, dtype=dtype, batch=batch, match_any_batch=False,
        )
        if cached is not None:
            return cached, True
    plan = autotune_model(
        model_cfg, dtype=dtype, batch=batch, deadline=deadline, repeats=repeats, warmup=warmup,
        timer=timer, log=log, device=device, device_kind=device_kind, block_screen=block_screen,
    )
    save_plan(plan, path)
    return plan, False


# --------------------------------------------------------- dtype sweep ----


@dataclasses.dataclass
class PrecisionResult:
    """Outcome of one dtype-swept autotune: per-dtype kernel plans, the
    winning policy, and the attributable fate of every pruned dtype."""

    winner: str
    plans: Dict[str, TunePlan]
    pruned: Dict[str, str]  # dtype -> gate reason (journaled)
    gates: Dict[str, dict]  # dtype -> GateResult.to_obj()
    cached: bool = False

    @property
    def plan(self) -> Optional[TunePlan]:
        return self.plans.get(self.winner)

    def summary(self) -> str:
        parts = []
        for dt in DTYPES:
            if dt in self.pruned:
                parts.append(f"{dt}=gate-pruned")
            elif dt in self.plans:
                s = _plan_score(self.plans[dt])
                label = f"{s:.3f}ms" if s != float("inf") else "degraded"
                parts.append(f"{dt}={label}" + (" *" if dt == self.winner else ""))
        return " ".join(parts)


def _plan_score(plan: TunePlan) -> float:
    """Total best-candidate time across the plan's layers: the number the
    dtype race is decided on. A layer without a timed winner makes the whole
    dtype unscoreable (inf): an untimed dtype must not win."""
    total = 0.0
    for name, _v in plan.layers:
        ms = plan.stats.get(name, {}).get("best_ms")
        if not isinstance(ms, (int, float)):
            return float("inf")
        total += ms
    return total


class AllDtypesPruned(RuntimeError):
    """:func:`autotune_precision` found no dtype that passed its gate."""


def autotune_precision(
    path,
    model_cfg,
    *,
    batch: int,
    dtypes: Tuple[str, ...] = DTYPES,
    force: bool = False,
    deadline: Optional[Deadline] = None,
    repeats: int = 5,
    warmup: int = 2,
    timer: Optional[Timer] = None,
    log: Callable[[str], None] = print,
    device="cuda",
    device_kind: Optional[str] = None,
    gate=None,
    gate_journal: str = "",
    gate_batch: int = 2,
    seed: int = 0,
) -> PrecisionResult:
    """ONE sweep covering {fp32, bf16, int8w} x kernel variants per conv
    layer.

    Per dtype: the :class:`~..precision.gate.ToleranceGate` (journaled,
    preflighted) first screens the dtype against the fp32 oracle on params
    and input drawn from ``seed``; a failure prunes the WHOLE dtype with an
    attributable reason before any timing. A second screen at block
    granularity prunes only the dtype's ``fuse="block"`` candidates when the
    fused blocks fail it. Surviving dtypes get the full per-layer sweep
    (:func:`autotune`, each dtype's plan under its own key). The winner is
    the dtype with the lowest summed best-candidate time; its policy record
    is saved beside the plans (``plan.save_policy``).

    Blocks 1-2 geometries only (the gate's staged oracle is the Blocks 1-2
    chain); full-AlexNet callers use the single-dtype :func:`autotune`."""
    if model_cfg.family != "blocks12":
        raise ValueError(
            "dtype-swept autotune supports Blocks 1-2 configs only "
            "(the tolerance gate screens the Blocks 1-2 staged oracle); "
            "use autotune(dtype=...) for alexnet_full"
        )
    unknown = [dt for dt in dtypes if dt not in DTYPES]
    if unknown:
        raise ValueError(f"unknown sweep dtypes {unknown} (valid: {DTYPES})")
    device_kind = device_kind or _device_kind(device)

    # Cache: a fresh policy record covering the SAME dtype set, plus a fresh
    # plan per surviving dtype, short-circuits gate and sweep alike.
    if not force:
        rec = load_policy(path, device_kind=device_kind, model_cfg=model_cfg, batch=batch, match_any_batch=False)
        if rec is not None and set(rec.get("swept", [])) == set(dtypes):
            plans = {}
            complete = True
            for dt in dtypes:
                if dt in rec.get("pruned", {}):
                    continue
                cached_plan = load_plan(
                    path, device_kind=device_kind, model_cfg=model_cfg, dtype=dt, batch=batch,
                    match_any_batch=False,
                )
                if cached_plan is None:
                    complete = False
                    break
                plans[dt] = cached_plan
            if complete and rec.get("dtype") in plans:
                return PrecisionResult(
                    winner=rec["dtype"], plans=plans, pruned=dict(rec.get("pruned", {})),
                    gates=dict(rec.get("gates", {})), cached=True,
                )

    if gate is None:
        from ..precision.gate import ToleranceGate
        from ..resilience.journal import Journal

        jpath = gate_journal or str(Path(path).with_name(Path(path).stem + "_gate.jsonl"))
        gate = ToleranceGate(journal=Journal(jpath))

    # Gate inputs from the seeded init stream (a constant init is degenerate
    # for per-channel scales: every channel identical).
    from ..models.init import init_params_random, random_input

    gen = torch.Generator().manual_seed(seed)
    params = init_params_random(gen, model_cfg, device=device)
    x = random_input(gen, gate_batch, model_cfg, device=device)

    sk = shape_key(model_cfg)
    plans: Dict[str, TunePlan] = {}
    pruned: Dict[str, str] = {}
    gates: Dict[str, dict] = {}
    inner_cached: list = []
    for dt in dtypes:
        with obs_span("tune.gate", dtype=dt):
            res = gate.screen(dt, params, x, model_cfg, key=f"gate:{dt}|{device_kind}|{sk}|b{batch}")
        gates[dt] = res.to_obj()
        if not res.passed:
            # fp32 failing means the ORACLE CHAIN is broken: pruned like any
            # other dtype, with an attributable reason.
            pruned[dt] = res.reason()
            log(f"tune dtype {dt}: GATE-PRUNED ({res.reason()})")
            continue
        log(f"tune dtype {dt}: gate pass (margin {res.margin:.3f}, worst stage {res.worst_stage or '-'})")
        block_screen = ""
        if hasattr(gate, "screen_blocks"):
            with obs_span("tune.gate_blocks", dtype=dt):
                bres = gate.screen_blocks(dt, params, x, model_cfg, key=f"gate-blocks:{dt}|{device_kind}|{sk}|b{batch}")
            if not bres.passed:
                block_screen = f"fuse=block gate-pruned for {dt}: {bres.reason()}"
                log(f"tune dtype {dt}: megakernel {block_screen}")
            else:
                log(f"tune dtype {dt}: megakernel block gate pass (margin {bres.margin:.3f})")
        plan, was_cached = autotune(
            path, model_cfg, dtype=dt, batch=batch, force=force, deadline=deadline, repeats=repeats,
            warmup=warmup, timer=timer, log=log, device=device, device_kind=device_kind, block_screen=block_screen,
        )
        plans[dt] = plan
        inner_cached.append(was_cached)
        log(f"tune dtype {dt}: plan {'cache' if was_cached else 'swept'} hash={plan.plan_hash()}")

    if not plans:
        raise AllDtypesPruned(
            "every sweep dtype was gate-pruned: " + "; ".join(f"{d}: {r}" for d, r in pruned.items())
        )
    scores = {dt: _plan_score(p) for dt, p in plans.items()}
    finite = {dt: s for dt, s in scores.items() if s != float("inf")}
    if finite:
        winner = min(finite, key=lambda dt: (finite[dt], DTYPES.index(dt)))
    else:
        # Nothing timed anywhere (deadline/chaos): the reference floor stands.
        winner = "fp32" if "fp32" in plans else next(iter(plans))
    if len(dtypes) > 1:
        # A pinned (single-dtype) sweep must not overwrite the full sweep's
        # policy record with a race it never ran.
        save_policy(
            path, device_kind=device_kind, model_cfg=model_cfg, batch=batch,
            dtype=winner, swept=dtypes, pruned=pruned, gates=gates,
        )
    result = PrecisionResult(
        winner=winner, plans=plans, pruned=pruned, gates=gates,
        cached=bool(inner_cached) and all(inner_cached) and not force,
    )
    log(f"tune dtype winner: {winner} ({result.summary()})")
    return result
