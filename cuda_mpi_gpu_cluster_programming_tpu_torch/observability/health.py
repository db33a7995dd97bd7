"""Fleet health over the journal alone: incident MTTR decomposition,
availability and SLO attainment, and compile-cost attribution.

The JAX package's ``observability/health.py``. Any recorded run (serve,
route, train, bench, replay) folds into one :class:`HealthReport`:

- **Compile events**: the one instrumentation point every warmup shares
  (the supervisor's first calls, the server's warmup and re-warm, and
  ``configs.build_forward``'s first calls when an observer is installed,
  :func:`observed_first_calls`). In the port the unit "compiled" once per
  shape is a serving bucket's CUDA graph (``utils.cuda_graphs``) or a
  forward's first call (the kernel library's load, cuDNN's algorithm
  choice), so a record's ``ms`` is the wall time of that first call with
  the device fenced. ``xla_flops`` and ``xla_bytes`` keep the JAX record's
  keys and are ``null``: the port has no compiler cost model to ask (the JAX
  module's ``xla_cost_analysis`` has no counterpart), and null is how the
  JAX package records "no cost analysis", so the flops cross-check
  (:func:`_flops_check`) reports ``unavailable``.
- **Incidents** (:func:`incidents_from_records`): trips (trip -> degrade ->
  compile/rewarm -> reshard -> replay), grow-backs (probation -> spot_check
  -> compile -> promote), the router's backend-down windows (detect ->
  drain -> redirect -> readmit) and, in the fleet fold, drains. Each
  incident's phases sum to its wall time by construction
  (:func:`_clamped_phases`); a journal with no ``compile_event`` reports
  the compile phase as None (unattributed), never as 0.
- **Availability and SLO attainment**: a device-seconds capacity timeline
  from ``mesh_shrink``/``sup_promote`` (:func:`capacity_timeline`), each
  class's served/shed/failed against its ``SLOClass`` budget with its
  error-budget burn (:func:`slo_attainment`), the serving controller's
  actions (:func:`controller_summary`) and the fleet control plane's
  (:func:`fleet_summary`).

``python -m cuda_mpi_gpu_cluster_programming_tpu_torch.observability health
--journal J [--json] [--fail-on-budget-burn]`` renders the report (exit 3
on a blown budget). Standard library and ``serving.slo`` at import time:
torch is imported only inside :func:`observed_first_calls`' fence.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..serving.slo import SLOClass, SLOPolicy
from .trace import off_timed_path

# The JAX package's agreement tolerance between a compiler's flops count and
# the analytic ledger (its cost model bills pools and LRN another way). The
# port records no compiler count, so its own checks report "unavailable";
# the tolerance stays for journals recorded by the JAX package.
FLOPS_RTOL = 0.5
# Each class is operated against its p99 target (slo.SLOClass.slo_ms):
# the error budget is the 1% of completed requests allowed to violate.
# burn = violation share / ERROR_BUDGET; burn > 1.0 is a blown budget.
ERROR_BUDGET = 0.01

# The trip-incident phase order (rendered and exported in this order; the
# phases tile the incident wall time exactly).
TRIP_PHASES = ("detect", "degrade", "compile", "rewarm", "reshard", "replay")
GROWBACK_PHASES = ("probation", "spot_check", "compile", "promote")
# Router backend-down incidents (serving.router): the probes notice a dead
# host (detect), in-flight traffic drains into failures and redirects (drain,
# the remainder phase), later traffic redirects away (redirect), and the
# restarted backend waits out probation (readmit).
BACKEND_DOWN_PHASES = ("detect", "drain", "redirect", "readmit")
# Fleet-drain incidents (serving.fleet_controller): sustained burn is
# observed for drain_after_s (detect), the backend sits drained with its
# home traffic spilled (drain, the remainder phase), and the LIFO readmit
# flips it back (readmit). The phases sum to the incident wall
# (_clamped_phases).
FLEET_DRAIN_PHASES = ("detect", "drain", "readmit")

_DTYPE_TO_LEDGER = {"float32": "fp32", "fp32": "fp32", "bfloat16": "bf16", "bf16": "bf16"}


@off_timed_path
def compile_event(
    *,
    site: str,
    entry: str,
    shape: Sequence[int],
    dtype: str,
    ms: float,
    cache_hit: bool,
    n_shards: int = 1,
) -> dict:
    """One ``compile_event`` payload: the call site, the config (``entry``),
    the input shape and its batch, the precision policy, the measured wall
    ms of the first call at this shape, and whether the shape was already
    warm (``cache_hit``). ``xla_flops``/``xla_bytes`` are null."""
    shape = [int(d) for d in shape]
    return {
        "site": site,
        "entry": entry,
        "shape": shape,
        "batch": shape[0] if shape else 0,
        "dtype": str(dtype),
        "n_shards": max(1, int(n_shards)),
        "ms": round(float(ms), 3),
        "cache_hit": bool(cache_hit),
        "xla_flops": None,
        "xla_bytes": None,
    }


@off_timed_path
def journal_compile_event(journal, rec: dict) -> None:
    """Append one :func:`compile_event` payload to a journal (no-op without
    one), with the open span's correlation ids, so an exported timeline puts
    each capture inside the warmup span that paid for it."""
    if journal is None:
        return
    from .trace import current_ids

    journal.append(
        "compile_event",
        key=f"compile:{rec['site']}:{rec['entry']}:b{rec['batch']}",
        **{**current_ids(), **rec},
    )


# The process-wide compile observer: None until a caller installs one.
_COMPILE_OBSERVER: Optional[Callable[[dict], None]] = None


def set_compile_observer(cb: Optional[Callable[[dict], None]]) -> Optional[Callable[[dict], None]]:
    """Install the process-wide compile observer (None uninstalls); returns
    the previous one so a caller can restore it."""
    global _COMPILE_OBSERVER
    prev, _COMPILE_OBSERVER = _COMPILE_OBSERVER, cb
    return prev


def get_compile_observer() -> Optional[Callable[[dict], None]]:
    return _COMPILE_OBSERVER


def journal_compile_observer(journal) -> Callable[[dict], None]:
    """An observer that journals every event it is given."""

    def _observe(rec: dict) -> None:
        journal_compile_event(journal, rec)

    return _observe


def observed_first_calls(fn, *, site: str, entry: str, dtype: str, n_shards: int = 1):
    """Wrap a ``(params, x) -> out`` forward so the first call per input
    shape is timed, the device fenced, and reported to the installed
    compile observer as a ``compile_event``. Applied only when an observer
    is installed at build time (``configs.build_forward`` checks); every
    other build keeps the bare callable."""
    seen: set = set()

    def wrapped(params, x):
        shape = tuple(int(d) for d in getattr(x, "shape", ()))
        if shape in seen:
            return fn(params, x)
        t0 = time.perf_counter()
        out = fn(params, x)
        _fence(out)
        ms = (time.perf_counter() - t0) * 1e3
        seen.add(shape)
        _report_first_call(site=site, entry=entry, shape=shape, dtype=dtype, ms=ms, n_shards=n_shards)
        return out

    wrapped.__wrapped__ = fn
    return wrapped


def _fence(out) -> None:
    """Wait for the device that computed ``out``."""
    import torch

    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


@off_timed_path
def _report_first_call(*, site, entry, shape, dtype, ms, n_shards) -> None:
    obs = get_compile_observer()
    if obs is None:
        return
    obs(compile_event(site=site, entry=entry, shape=shape, dtype=dtype, ms=ms, cache_hit=False, n_shards=n_shards))


# --------------------------------------------------------------------------
# SLO attainment and the serving controller's actions


def _percentile(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank (the loadgen/metrics estimator: one convention across
    the package, so percentiles cross-check exactly)."""
    if not xs:
        return None
    ys = sorted(xs)
    rank = max(1, int(round(q / 100.0 * len(ys) + 0.5)))
    return ys[min(rank, len(ys)) - 1]


@dataclasses.dataclass
class ClassHealth:
    """One request class's served/shed/failed accounting against its
    :class:`~..serving.slo.SLOClass` budget."""

    name: str
    slo_ms: float  # 0 = unbounded (never burns)
    offered: int
    ok: int
    shed: int
    failed: int
    rejected: int
    p99_ms: Optional[float]
    violations: int
    burn: Optional[float]  # violation share / ERROR_BUDGET; None: unbounded

    @property
    def blown(self) -> bool:
        return self.burn is not None and self.burn > 1.0

    def to_obj(self) -> dict:
        return {
            "class": self.name,
            "slo_ms": self.slo_ms,
            "offered": self.offered,
            "ok": self.ok,
            "shed": self.shed,
            "failed": self.failed,
            "rejected": self.rejected,
            "p99_ms": self.p99_ms,
            "violations": self.violations,
            "error_budget": ERROR_BUDGET,
            "burn": (round(self.burn, 3) if self.burn is not None else None),
            "blown": self.blown,
        }

    def render(self) -> str:
        name = self.name or "(default)"
        slo = f"slo={self.slo_ms:.0f}ms" if self.slo_ms else "slo=unbounded"
        p99 = f"{self.p99_ms:.1f}ms" if self.p99_ms is not None else "n/a"
        burn = (
            f"burn={self.burn:.2f}x{' BLOWN' if self.blown else ''}"
            if self.burn is not None
            else "burn=n/a"
        )
        return (
            f"{name:<14s} {slo:<14s} p99={p99:<9s} ok={self.ok} "
            f"shed={self.shed} failed={self.failed} "
            f"rejected={self.rejected} violations={self.violations} {burn}"
        )


def slo_attainment(records: List[dict]) -> List[ClassHealth]:
    """Per-class attainment from the journal alone: offered from
    ``serve_submit``, completions and latencies from ``serve_batch``
    (``req_cls``/``req_lat_ms``), sheds from ``serve_shed``, failures from
    ``serve_fail``, budgets from the ``serve_config`` SLO policy.
    Violations = sheds + failures + completions over the class p99 target;
    burn ranks classes worst-first. Admission rejections (``admitted``
    false) are counted apart: a refused request never entered the service
    and burns no serving budget."""
    pol: Optional[SLOPolicy] = None
    for r in records:
        if r.get("kind") == "serve_config" and isinstance(r.get("slo"), dict):
            pol = SLOPolicy.from_obj(r["slo"])
    offered: Dict[str, int] = {}
    rejected: Dict[str, int] = {}
    lat: Dict[str, List[float]] = {}
    shed: Dict[str, int] = {}
    failed: Dict[str, int] = {}
    saw_submit = False
    for r in records:
        k = r.get("kind")
        if k == "serve_submit":
            saw_submit = True
            cls = str(r.get("cls") or "")
            if r.get("admitted", True):
                offered[cls] = offered.get(cls, 0) + 1
            else:
                rejected[cls] = rejected.get(cls, 0) + 1
        elif k == "serve_batch":
            cls_map = r.get("req_cls") or {}
            for rid, ms in (r.get("req_lat_ms") or {}).items():
                cls = str(cls_map.get(rid, ""))
                lat.setdefault(cls, []).append(float(ms))
        elif k == "serve_shed":
            cls = str(r.get("cls") or "")
            shed[cls] = shed.get(cls, 0) + 1
        elif k == "serve_fail":
            for cls in (r.get("req_cls") or {}).values():
                failed[str(cls)] = failed.get(str(cls), 0) + 1
    names = set(offered) | set(rejected) | set(lat) | set(shed) | set(failed)
    if pol is not None:
        names |= set(pol.classes)
    out: List[ClassHealth] = []
    for name in sorted(names):
        cls_obj = pol.class_for(name) if pol is not None else SLOClass(name, 0.0)
        ls = lat.get(name, [])
        n_ok, n_shed, n_failed = len(ls), shed.get(name, 0), failed.get(name, 0)
        completed = n_ok + n_shed + n_failed
        slo_ms = float(cls_obj.slo_ms or 0.0)
        late = sum(1 for v in ls if slo_ms and v > slo_ms)
        violations = late + n_shed + n_failed
        burn = (
            (violations / completed) / ERROR_BUDGET
            if slo_ms and completed
            else (0.0 if slo_ms else None)
        )
        out.append(
            ClassHealth(
                name=name,
                slo_ms=slo_ms,
                offered=offered.get(name, 0) if saw_submit else completed,
                ok=n_ok,
                shed=n_shed,
                failed=n_failed,
                rejected=rejected.get(name, 0),
                p99_ms=_percentile(ls, 99),
                violations=violations,
                burn=burn,
            )
        )
    out.sort(key=lambda c: (c.burn is not None, c.burn or 0.0), reverse=True)
    return out


def controller_summary(records: List[dict]) -> dict:
    """Fold ``controller_action`` records into a did-it-help view: action
    counts by kind (escalations, reversals, refusals), and the per-class
    error-budget burn split at the FIRST actuated action: burn over the
    outcomes journaled before the controller touched anything against burn
    after. Serve records carry no timestamps; journal append order is the
    time axis, so "after" is everything from that action's position on,
    with the ``serve_config`` header (the SLO budgets both halves are priced
    against) put in front of it. Empty dict when the journal has no
    controller records."""
    actions = [(i, r) for i, r in enumerate(records) if r.get("kind") == "controller_action"]
    if not actions:
        return {}
    by_kind: Dict[str, int] = {}
    refused = reversals = 0
    for _, r in actions:
        kind = str(r.get("action") or "?")
        by_kind[kind] = by_kind.get(kind, 0) + 1
        if not r.get("actuated", True):
            refused += 1
        elif r.get("reversal"):
            reversals += 1
    out: dict = {"actions": by_kind, "total": len(actions), "refused": refused, "reversals": reversals}
    first = next((i for i, r in actions if r.get("actuated", True)), None)
    if first is not None:
        header = [r for r in records[:first] if r.get("kind") == "serve_config"]

        def burns(rs: List[dict]) -> Dict[str, Optional[float]]:
            return {c.name: (round(c.burn, 3) if c.burn is not None else None) for c in slo_attainment(rs)}

        out["burn_before"] = burns(records[:first])
        out["burn_after"] = burns(header + records[first:])
    return out


# --------------------------------------------------------------------------
# incidents


def _fmt_phases(phases: Dict[str, Optional[float]]) -> str:
    return " ".join(f"{k}={'unattributed' if v is None else format(v, '.1f')}" for k, v in phases.items())


@dataclasses.dataclass
class Incident:
    """One folded incident: a trip, a grow-back, a router backend-down
    window (:func:`incidents_from_records`) or a fleet drain
    (:func:`fleet_summary`). ``phases`` maps phase name to exclusive ms; the
    values sum to ``wall_ms`` by construction, with ``None`` meaning
    *unattributed* (a journal without ``compile_event`` records; the sum
    then holds over the attributed phases)."""

    kind: str  # "trip" | "growback" | "backend_down" | "fleet_drain"
    index: int
    entry: str  # rung tripped on / promoted to, or the backend
    cause: str
    wall_ms: float
    phases: Dict[str, Optional[float]]
    t0_ms: Optional[float] = None  # tracer-epoch start (None: span-less)
    trace_id: str = ""

    @property
    def phase_sum_ms(self) -> float:
        return sum(v for v in self.phases.values() if v is not None)

    def to_obj(self) -> dict:
        return {
            "kind": self.kind,
            "index": self.index,
            "entry": self.entry,
            "cause": self.cause,
            "wall_ms": round(self.wall_ms, 3),
            "phases": {k: (round(v, 3) if v is not None else None) for k, v in self.phases.items()},
            "t0_ms": self.t0_ms,
        }

    def render(self) -> str:
        if self.kind == "trip":
            head = f"trip {self.cause} @{self.entry}"
        elif self.kind == "backend_down":
            head = f"backend_down {self.entry} ({self.cause})"
        elif self.kind == "fleet_drain":
            head = f"fleet_drain {self.entry} ({self.cause})"
        else:
            head = f"growback -> {self.entry}"
        return f"#{self.index} {head} wall={self.wall_ms:.1f}ms  {_fmt_phases(self.phases)}"


def _clamped_phases(
    wall: float, order: Sequence[str], raw: Dict[str, Optional[float]], remainder: str,
) -> Dict[str, Optional[float]]:
    """Exclusive phases that sum EXACTLY to ``wall``: the ``remainder``
    phase absorbs the unattributed rest; when attributed time exceeds the
    wall (cross-clock rounding), every phase scales proportionally so the
    identity survives instead of going negative."""
    attributed = sum(v for v in raw.values() if v is not None)
    if attributed > wall and attributed > 0.0:
        scale = wall / attributed
        raw = {k: (v * scale if v is not None else None) for k, v in raw.items()}
        rest = 0.0
    else:
        rest = wall - attributed
    phases: Dict[str, Optional[float]] = {}
    for name in order:
        phases[name] = rest if name == remainder else raw.get(name)
    return phases


def fleet_summary(records: List[dict]) -> dict:
    """Fold the fleet control plane's trail: ``fleet_action`` and
    ``fleet_refusal`` counts by action, the most backends degraded at once
    (walked from the ``router_probe`` scrape trail: each backend's
    last-seen ladder level, the largest count of nonzero levels at any
    probe), and each drain (a ``drain`` action paired with its backend's
    next ``readmit``) as an :class:`Incident` whose detect, drain and
    readmit phases sum to the drain wall. An empty dict when the journal
    has no fleet-control records."""
    acts = [r for r in records if r.get("kind") in ("fleet_action", "fleet_refusal")]
    probes = [r for r in records if r.get("kind") == "router_probe"]
    if not acts and not probes:
        return {}
    by_kind: Dict[str, int] = {}
    refusals = 0
    for r in acts:
        name = str(r.get("action") or "?")
        by_kind[name] = by_kind.get(name, 0) + 1
        if r.get("kind") == "fleet_refusal":
            refusals += 1
    levels: Dict[str, int] = {}
    max_deg = 0
    for r in probes:
        lvl = r.get("level")
        levels[str(r.get("backend") or "")] = int(lvl) if isinstance(lvl, int) else 0
        max_deg = max(max_deg, sum(1 for v in levels.values() if v > 0))
    drains: List[Incident] = []
    open_drain: Dict[str, dict] = {}
    for r in acts:
        if r.get("kind") != "fleet_action" or not r.get("actuated", True):
            continue
        tgt = str(r.get("target") or "")
        if r.get("action") == "drain":
            open_drain.setdefault(tgt, r)
        elif r.get("action") == "readmit" and tgt in open_drain:
            d = open_drain.pop(tgt)
            detect = float((d.get("evidence") or {}).get("detect_ms") or 0.0)
            t_drain = float(d.get("t_ms") or 0.0)
            t_up = float(r.get("t_ms") or 0.0)
            t0 = max(0.0, t_drain - detect)
            wall = max(0.0, t_up - t0)
            raw: Dict[str, Optional[float]] = {"detect": min(detect, wall), "readmit": float(r.get("ms") or 0.0)}
            drains.append(Incident(
                kind="fleet_drain", index=len(drains) + 1, entry=tgt, cause=str(d.get("cause") or "drain"),
                wall_ms=wall, phases=_clamped_phases(wall, FLEET_DRAIN_PHASES, raw, "drain"), t0_ms=t0,
            ))
    return {
        "actions": by_kind,
        "total": len(acts),
        "refusals": refusals,
        "max_simultaneous_degraded": max_deg,
        "drains": [d.to_obj() for d in drains],
    }


def _span_tree(spans: List[dict]) -> Dict[str, List[dict]]:
    kids: Dict[str, List[dict]] = {}
    for s in spans:
        pid = s.get("parent_id") or ""
        if pid:
            kids.setdefault(pid, []).append(s)
    return kids


def _subtree(root: dict, kids) -> List[dict]:
    out, frontier = [root], [root]
    while frontier:
        nxt = []
        for s in frontier:
            for c in kids.get(s.get("span_id") or "", ()):
                out.append(c)
                nxt.append(c)
        frontier = nxt
    return out


def _dur(spans: List[dict], name: str) -> float:
    return sum(float(s.get("dur_ms") or 0.0) for s in spans if s.get("name") == name)


def incidents_from_records(records: List[dict]) -> List[Incident]:
    """Fold a journal's trail into :class:`Incident` objects.

    With span records (a traced run) the ``sup.trip``/``sup.recover`` span
    trees give each incident's wall time, and their children
    (``sup.degrade`` over ``serve.rewarm``, ``sup.replay`` over
    ``sup.reshard``, ``sup.promote``) the exclusive phase times. Compile
    time comes from the ``compile_event`` records between the trip record
    and its recovery record (``sup_ok``/``sup_step``) in append order; a
    journal with no ``compile_event`` at all reports the phase as None.
    Span-less journals fall back to the attributed ms fields alone
    (``serve_rewarm.ms``, ``sup_promote.ms``, probation ``ms``): the wall
    is then the phase sum and ``detect`` zero. Router backend-down windows
    open at a transition to ``down`` and close at the backend's readmission
    to ``up``, starting ``detect_ms`` before the down verdict."""
    spans = [r for r in records if r.get("kind") == "span"]
    kids = _span_tree(spans)
    has_ce = any(r.get("kind") == "compile_event" for r in records)

    trip_spans = sorted((s for s in spans if s.get("name") == "sup.trip"), key=lambda s: float(s.get("t0_ms") or 0.0))
    recover_spans = sorted((s for s in spans if s.get("name") == "sup.recover"),
                           key=lambda s: float(s.get("t0_ms") or 0.0))
    # committed recoveries only: a refused candidate leaves a sup.recover span with no sup.promote child
    committed = [s for s in recover_spans if any(c.get("name") == "sup.promote" for c in _subtree(s, kids))]

    trip_recs = [(i, r) for i, r in enumerate(records) if r.get("kind") == "sup_trip"]
    promote_recs = [(i, r) for i, r in enumerate(records) if r.get("kind") == "sup_promote"]
    ce_recs = [(i, r) for i, r in enumerate(records) if r.get("kind") == "compile_event"]
    pass_recs = [(i, r) for i, r in enumerate(records)
                 if r.get("kind") == "mesh_probation" and r.get("event") == "pass"]

    def _ce_ms(lo: int, hi: int) -> float:
        return sum(float(r.get("ms") or 0.0) for i, r in ce_recs if lo < i < hi)

    incidents: List[Incident] = []

    # trips
    end_kinds = ("sup_ok", "sup_step", "sup_trip")
    for n, (idx, rec) in enumerate(trip_recs):
        hi = next((i for i, r in enumerate(records) if i > idx and r.get("kind") in end_kinds), len(records))
        compile_p: Optional[float] = _ce_ms(idx, hi) if has_ce else None
        c = compile_p or 0.0
        sp = trip_spans[n] if n < len(trip_spans) else None
        if sp is not None:
            sub = _subtree(sp, kids)
            wall = float(sp.get("dur_ms") or 0.0)
            rewarm_s = _dur(sub, "serve.rewarm")
            reshard_s = _dur(sub, "sup.reshard")
            raw = {
                "degrade": max(0.0, _dur(sub, "sup.degrade") - rewarm_s),
                "compile": compile_p,
                "rewarm": max(0.0, rewarm_s - min(c, rewarm_s)),
                "reshard": reshard_s,
                "replay": max(0.0, _dur(sub, "sup.replay") - reshard_s),
            }
            t0: Optional[float] = float(sp.get("t0_ms") or 0.0)
            trace_id = str(sp.get("trace_id") or "")
        else:
            rewarm_s = sum(float(r.get("ms") or 0.0) for i, r in enumerate(records)
                           if idx < i < hi and r.get("kind") == "serve_rewarm")
            raw = {"degrade": 0.0, "compile": compile_p, "rewarm": max(0.0, rewarm_s - min(c, rewarm_s)),
                   "reshard": 0.0, "replay": 0.0}
            wall = sum(v for v in raw.values() if v is not None)
            t0, trace_id = None, ""
        incidents.append(Incident(
            kind="trip", index=len(incidents) + 1, entry=str(rec.get("entry") or ""),
            cause=str(rec.get("sdc_kind") or rec.get("cause") or "trip"), wall_ms=wall,
            phases=_clamped_phases(wall, TRIP_PHASES, raw, "detect"), t0_ms=t0, trace_id=trace_id,
        ))

    # grow-backs
    used_pass: set = set()
    for n, (idx, rec) in enumerate(promote_recs):
        # the probation the heal waited out: the latest unconsumed "pass" record before this promotion
        prob_ms, prob_idx = 0.0, None
        for i, r in pass_recs:
            if i < idx and i not in used_pass:
                prob_ms, prob_idx = float(r.get("ms") or 0.0), i
        if prob_idx is not None:
            used_pass.add(prob_idx)
        compile_p = _ce_ms(prob_idx if prob_idx is not None else -1, idx + 1) if has_ce else None
        c = compile_p or 0.0
        sp = committed[n] if n < len(committed) else None
        if sp is not None:
            promote_s = _dur(_subtree(sp, kids), "sup.promote")
            wall = prob_ms + float(sp.get("dur_ms") or 0.0)
            # the incident starts when its probation started, so an exported parent covers both to scale
            t0 = max(0.0, float(sp.get("t0_ms") or 0.0) - prob_ms)
            trace_id = str(sp.get("trace_id") or "")
        else:
            promote_s = float(rec.get("ms") or 0.0)
            wall = None
            t0, trace_id = None, ""
        raw = {"probation": prob_ms, "compile": compile_p, "promote": max(0.0, promote_s - min(c, promote_s))}
        if wall is None:
            wall = sum(v for v in raw.values() if v is not None)
        incidents.append(Incident(
            kind="growback", index=len(incidents) + 1, entry=str(rec.get("to") or ""),
            cause=f"promote {rec.get('frm', '?')} -> {rec.get('to', '?')}", wall_ms=wall,
            phases=_clamped_phases(wall, GROWBACK_PHASES, raw, "spot_check"), t0_ms=t0, trace_id=trace_id,
        ))

    # router backend-down windows: an endpoint replacement journals frm == to and is no transition; a backend
    # still down at the journal's end is an open outage, not an incident
    state_recs = [(i, r) for i, r in enumerate(records)
                  if r.get("kind") == "router_backend_state" and r.get("frm") != r.get("to")]
    redirect_recs = [(i, r) for i, r in enumerate(records) if r.get("kind") == "router_redirect"]
    open_down: Dict[str, Tuple[int, dict]] = {}
    for i, r in state_recs:
        b = str(r.get("backend") or "")
        if r.get("to") == "down":
            open_down.setdefault(b, (i, r))
        elif r.get("to") == "up" and b in open_down:
            oi, orec = open_down.pop(b)
            detect = float(orec.get("detect_ms") or 0.0)
            t_down = float(orec.get("t_ms") or 0.0)
            t0 = max(0.0, t_down - detect)
            wall = max(0.0, float(r.get("t_ms") or 0.0) - t0)
            red_ts = [float(rr.get("t_ms") or 0.0) for j, rr in redirect_recs if oi < j < i and rr.get("frm") == b]
            raw = {
                "detect": detect,
                "redirect": max(0.0, max(red_ts) - t_down) if red_ts else 0.0,
                "readmit": float(r.get("probation_ms") or 0.0),
            }
            incidents.append(Incident(
                kind="backend_down", index=len(incidents) + 1, entry=b,
                cause=str(orec.get("reason") or "probe_failed"), wall_ms=wall,
                phases=_clamped_phases(wall, BACKEND_DOWN_PHASES, raw, "drain"), t0_ms=t0,
            ))
    return incidents


# --------------------------------------------------------------------------
# availability (the device-seconds capacity timeline)


def capacity_timeline(records: List[dict]) -> Tuple[Optional[int], float, List[Tuple[float, int]]]:
    """``(initial_devices, duration_ms, [(t_ms, devices), ...])``. The
    serve epoch's ``t_ms``-bearing records (``serve_submit``,
    ``serve_gauges``, ``mem_snapshot``) are the clock: each capacity change
    (``mesh_shrink``, ``sup_promote``) is timed at the nearest preceding
    ``t_ms``. A journal without a serve epoch has a zero duration."""
    t = 0.0
    dev0: Optional[int] = None
    segs: List[Tuple[float, int]] = []
    for r in records:
        k = r.get("kind")
        if k in ("serve_submit", "serve_gauges", "mem_snapshot"):
            tm = r.get("t_ms")
            if isinstance(tm, (int, float)):
                t = max(t, float(tm))
        elif k == "serve_config":
            d = r.get("devices")
            if dev0 is None and isinstance(d, int) and d > 0:
                dev0 = d
                segs.append((0.0, d))
        elif k == "mesh_shrink":
            before = r.get("before")
            if dev0 is None and isinstance(before, int) and before > 0:
                dev0 = before
                segs.append((0.0, before))
            after = r.get("after")
            if isinstance(after, int):
                segs.append((t, after))
        elif k == "sup_promote":
            d = r.get("devices")
            if isinstance(d, int) and d > 0:
                if dev0 is None:
                    dev0 = d
                    segs.append((0.0, d))
                segs.append((t, d))
    return dev0, t, segs


def availability_from_records(records: List[dict]) -> Tuple[Optional[float], Optional[float], Optional[int], float]:
    """``(availability, delivered_device_ms, initial_devices,
    duration_ms)``: delivered device time over the capacity timeline
    against the whole fleet's; None without a capacity signal or a serve
    epoch to time it."""
    dev0, dur, segs = capacity_timeline(records)
    if dev0 is None or dur <= 0.0:
        return None, None, dev0, dur
    delivered = 0.0
    cur, last = dev0, 0.0
    for tm, dev in segs:
        tm = min(max(tm, 0.0), dur)
        delivered += cur * (tm - last)
        cur, last = dev, tm
    delivered += cur * (dur - last)
    return delivered / (dev0 * dur), delivered, dev0, dur


# --------------------------------------------------------------------------
# compile-cost attribution and the flops cross-check


def compile_attribution(records: List[dict]) -> dict:
    """Fold the ``compile_event`` trail: compiles and ms per (site, entry,
    shape, dtype), the totals, and the flops cross-check of each row
    (:func:`_flops_check`). ``unattributed`` is True for a journal with no
    ``compile_event``: compile time is then unknown, not zero."""
    evs = [r for r in records if r.get("kind") == "compile_event"]
    groups: Dict[tuple, dict] = {}
    for r in evs:
        key = (str(r.get("site") or ""), str(r.get("entry") or ""), tuple(r.get("shape") or ()),
               str(r.get("dtype") or ""))
        g = groups.setdefault(key, {
            "site": key[0], "entry": key[1], "shape": list(key[2]), "dtype": key[3],
            "n_shards": max(1, int(r.get("n_shards") or 1)), "compiles": 0, "cache_hits": 0, "ms": 0.0,
            "xla_flops": None, "xla_bytes": None,
        })
        if r.get("cache_hit"):
            g["cache_hits"] += 1
        else:
            g["compiles"] += 1
            g["ms"] += float(r.get("ms") or 0.0)
        for f in ("xla_flops", "xla_bytes"):
            if g[f] is None and isinstance(r.get(f), (int, float)):
                g[f] = float(r[f])
    rows = [{**g, "ms": round(g["ms"], 3)} for g in groups.values()]
    rows.sort(key=lambda g: g["ms"], reverse=True)
    checks = [_flops_check(g) for g in rows]
    return {
        "unattributed": not evs,
        "events": len(evs),
        "total_ms": round(sum(float(r.get("ms") or 0.0) for r in evs if not r.get("cache_hit")), 3),
        "tolerance": FLOPS_RTOL,
        "rows": rows,
        "flops_checks": [c for c in checks if c is not None],
    }


def _flops_check(g: dict) -> Optional[dict]:
    """One row's compiler-vs-ledger verdict from the row's own shape:
    ``agree`` (within :data:`FLOPS_RTOL` of ``roofline.pass_ledger``),
    ``diverges``, or ``unavailable`` (no compiler count, which is every
    row the port records, or a geometry the ledger cannot model)."""
    shape = g.get("shape") or []
    base = {"entry": g["entry"], "shape": shape, "dtype": g["dtype"], "xla_flops": g["xla_flops"],
            "ledger_flops": None, "ratio": None, "tolerance": FLOPS_RTOL}
    if g["xla_flops"] is None:
        return {**base, "verdict": "unavailable"}
    ledger_dtype = _DTYPE_TO_LEDGER.get(g["dtype"])
    if len(shape) != 4 or ledger_dtype is None:
        return {**base, "verdict": "unavailable"}
    try:
        from ..models.alexnet import BLOCKS12
        from .roofline import pass_ledger

        cfg = dataclasses.replace(BLOCKS12, in_height=int(shape[1]), in_width=int(shape[2]))
        ledger = sum(s.flops for s in pass_ledger(cfg=cfg, dtype=ledger_dtype, batch=int(shape[0])))
    except Exception:  # noqa: BLE001 — an unmodelable geometry degrades visibly
        return {**base, "verdict": "unavailable"}
    if not ledger:
        return {**base, "verdict": "unavailable"}
    # a partitioned program's count may be per shard: compare under both conventions, keep the closer, report it
    n_sh = max(1, int(g.get("n_shards") or 1))
    best_scale, best_err = 1, abs(g["xla_flops"] - ledger) / ledger
    if n_sh > 1:
        err = abs(g["xla_flops"] * n_sh - ledger) / ledger
        if err < best_err:
            best_scale, best_err = n_sh, err
    return {
        **base,
        "ledger_flops": float(ledger),
        "shard_scale": best_scale,
        "ratio": round(g["xla_flops"] * best_scale / ledger, 4),
        "verdict": "agree" if best_err <= FLOPS_RTOL else "diverges",
    }


# --------------------------------------------------------------------------
# the report


@dataclasses.dataclass
class HealthReport:
    """The folded health of one journal (or a directory of them):
    incidents, availability, ranked SLO attainment, flap and quarantine
    counts, compile attribution, and the controller and fleet folds (absent
    from :meth:`to_obj` when empty, as in the JAX package)."""

    incidents: List[Incident]
    classes: List[ClassHealth]
    availability: Optional[float]
    delivered_device_ms: Optional[float]
    devices: Optional[int]
    duration_ms: float
    flaps: int
    quarantines: int
    probation_enters: int
    probation_passes: int
    compile: dict
    n_records: int
    controller: dict = dataclasses.field(default_factory=dict)
    fleet: dict = dataclasses.field(default_factory=dict)

    @property
    def trips(self) -> List[Incident]:
        return [i for i in self.incidents if i.kind == "trip"]

    @property
    def mttr_ms(self) -> Optional[float]:
        ts = self.trips
        return sum(i.wall_ms for i in ts) / len(ts) if ts else None

    @property
    def worst_burn(self) -> Optional[float]:
        burns = [c.burn for c in self.classes if c.burn is not None]
        return max(burns) if burns else None

    @property
    def budget_blown(self) -> bool:
        return any(c.blown for c in self.classes)

    def to_obj(self) -> dict:
        return {
            "n_records": self.n_records,
            "incidents": [i.to_obj() for i in self.incidents],
            "mttr_ms": round(self.mttr_ms, 3) if self.mttr_ms is not None else None,
            "availability": round(self.availability, 6) if self.availability is not None else None,
            "devices": self.devices,
            "duration_ms": round(self.duration_ms, 3),
            "delivered_device_ms": (round(self.delivered_device_ms, 3)
                                    if self.delivered_device_ms is not None else None),
            "flaps": self.flaps,
            "quarantines": self.quarantines,
            "probation_enters": self.probation_enters,
            "probation_passes": self.probation_passes,
            "classes": [c.to_obj() for c in self.classes],
            "worst_burn": round(self.worst_burn, 3) if self.worst_burn is not None else None,
            "budget_blown": self.budget_blown,
            "compile": self.compile,
            **({"controller": self.controller} if self.controller else {}),
            **({"fleet": self.fleet} if self.fleet else {}),
        }

    def summary_line(self) -> str:
        """One machine-parseable line for the run and train CLIs (``Health: ...``)."""
        avail = f"{self.availability * 100:.2f}%" if self.availability is not None else "n/a"
        mttr = f"{self.mttr_ms:.1f}" if self.mttr_ms is not None else "n/a"
        burn = f"{self.worst_burn:.2f}x" if self.worst_burn is not None else "n/a"
        comp = "unattributed" if self.compile.get("unattributed") else f"{self.compile.get('total_ms', 0.0):.1f}"
        return (f"incidents={len(self.incidents)} mttr_ms={mttr} availability={avail} worst_burn={burn} "
                f"compile_ms={comp} budget_blown={self.budget_blown}")

    def render(self) -> str:
        lines = [f"Fleet health: {self.summary_line()}"]
        if self.devices is not None and self.duration_ms > 0:
            lines.append(f"  capacity: {self.devices} devices over {self.duration_ms / 1e3:.2f}s; flaps={self.flaps} "
                         f"quarantines={self.quarantines} probation={self.probation_passes}/{self.probation_enters} "
                         "passed")
        if self.incidents:
            lines.append("Incidents (phase decomposition sums to wall time):")
            lines.extend(f"  {inc.render()}" for inc in self.incidents)
        else:
            lines.append("Incidents: none")
        if self.classes:
            lines.append(f"SLO attainment (ranked by error-budget burn; budget = {ERROR_BUDGET:.0%} of completed):")
            lines.extend(f"  {c.render()}" for c in self.classes)
        if self.controller:
            ctl = self.controller
            acts = ",".join(f"{k}={v}" for k, v in sorted(ctl["actions"].items()))
            lines.append(f"Autopilot: {ctl['total']} action(s) ({acts}); refused={ctl['refused']} "
                         f"reversals={ctl['reversals']}")
            if "burn_after" in ctl:

                def fmt(v):
                    return f"{v:.2f}x" if v is not None else "n/a"

                before = ctl.get("burn_before") or {}
                for name in sorted(set(before) | set(ctl["burn_after"])):
                    lines.append(f"  burn {name or '(default)'}: {fmt(before.get(name))} before first action -> "
                                 f"{fmt(ctl['burn_after'].get(name))} after")
        if self.fleet:
            fl = self.fleet
            acts = ",".join(f"{k}={v}" for k, v in sorted(fl["actions"].items())) or "none"
            lines.append(f"Fleet control: {fl['total']} action(s) ({acts}); refusals={fl['refusals']} "
                         f"max_degraded={fl['max_simultaneous_degraded']}")
            for d in fl["drains"]:
                lines.append(f"  drain {d['entry']} ({d['cause']}) wall={d['wall_ms']:.1f}ms  "
                             f"{_fmt_phases(d['phases'])}")
        comp = self.compile
        if comp.get("unattributed"):
            lines.append("Compile attribution: unattributed (journal predates compile_event records — compile time "
                         "is unknown, not zero)")
        else:
            lines.append(f"Compile attribution: {comp['events']} event(s), {comp['total_ms']:.1f} ms compiling "
                         f"(XLA-vs-ledger tolerance ±{comp['tolerance']:.0%}):")
            for g in comp["rows"]:
                lines.append(f"  {g['site']:<10s} {g['entry']:<22s} shape={tuple(g['shape'])} {g['dtype']} "
                             f"compiles={g['compiles']} hits={g['cache_hits']} ms={g['ms']:.1f}")
            for c in comp["flops_checks"]:
                if c["verdict"] == "unavailable":
                    lines.append(f"  flops-check {c['entry']} shape={tuple(c['shape'])}: unavailable "
                                 "(no XLA cost analysis on this backend)")
                else:
                    lines.append(f"  flops-check {c['entry']} shape={tuple(c['shape'])}: xla={c['xla_flops']:.3e} "
                                 f"ledger={c['ledger_flops']:.3e} ratio={c['ratio']:.3f} -> {c['verdict']}")
        return "\n".join(lines)


def _quarantine(r: dict) -> bool:
    return r.get("kind") == "mesh_quarantine" or (
        r.get("kind") == "router_backend_state" and r.get("to") == "quarantined")


def health_from_records(records: List[dict]) -> HealthReport:
    """Any journal's records (serve, route, train, bench, replay) folded
    into a :class:`HealthReport`. The router's backend hysteresis counts in
    the same flap, quarantine and probation counters as the elastic pool's
    device records."""
    availability, delivered, devices, duration = availability_from_records(records)
    return HealthReport(
        incidents=incidents_from_records(records),
        classes=slo_attainment(records),
        availability=availability,
        delivered_device_ms=delivered,
        devices=devices,
        duration_ms=duration,
        flaps=sum(int(r.get("flaps") or 0) for r in records if _quarantine(r)),
        quarantines=sum(1 for r in records if _quarantine(r)),
        probation_enters=sum(
            1 for r in records
            if (r.get("kind") == "mesh_probation" and r.get("event") == "enter")
            or (r.get("kind") == "router_backend_state" and r.get("to") == "probation")),
        probation_passes=sum(
            1 for r in records
            if (r.get("kind") == "mesh_probation" and r.get("event") == "pass")
            or (r.get("kind") == "router_backend_state" and r.get("to") == "up" and r.get("reason") == "readmit")),
        compile=compile_attribution(records),
        n_records=len(records),
        controller=controller_summary(records),
        fleet=fleet_summary(records),
    )


def health_from_journal(path) -> HealthReport:
    """A ``.jsonl`` journal (or a directory of them) loaded and folded."""
    from .export import load_records

    return health_from_records(load_records(path))
