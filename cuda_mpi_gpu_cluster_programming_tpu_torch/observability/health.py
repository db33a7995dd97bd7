"""Compile-event journaling: the one instrumentation point of every warmup.

The first part of the JAX package's ``observability/health.py``: the
``compile_event`` record a compiling call site journals, and the
process-wide observer hook. In the port the unit that is "compiled" once
per shape is a serving bucket's CUDA graph (``utils.cuda_graphs``), so a
record's ``ms`` is the wall time of that bucket's first call: its warm
calls, the capture and one fenced replay on the card, the first call on
the CPU. ``xla_flops`` and ``xla_bytes`` keep the JAX record's keys and are
``null``: no compiler cost model stands behind a captured graph, and null
is how the JAX package records "no cost analysis" too.

The second part is the per-class SLO attainment fold the serving
controller is judged by: ``ERROR_BUDGET``, :class:`ClassHealth`,
:func:`slo_attainment` (one class's burn of its error budget, from the
journal alone) and :func:`controller_summary` (the controller's actions,
and each class's burn before and after its first one), the JAX module's
own functions. The other journal folds (incidents, capacity, availability,
compile attribution, ``HealthReport`` and ``health_from_journal``) wait for
ROADMAP Queue 1 item 8. Standard library only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from ..serving.slo import SLOClass, SLOPolicy
from .trace import off_timed_path

# Each class is operated against its p99 target (slo.SLOClass.slo_ms):
# the error budget is the 1% of completed requests allowed to violate.
# burn = violation share / ERROR_BUDGET; burn > 1.0 is a blown budget.
ERROR_BUDGET = 0.01


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
