"""The serving controller: a journaled closed loop over one inference server.

The JAX package's ``serving/controller.py``. :class:`AutopilotController`
is evaluated between batches from the dispatch loop's off-timed-path
observation cadence (beside ``_observe_queue``/``_observe_resources``),
folds the ``observability.health`` ``ERROR_BUDGET`` arithmetic
incrementally over the live outcome stream (a sliding window per class,
never a journal scan), and walks a fixed **pressure ladder** of reversible
actions when the protected class's budget burns or the queue wait nears
the saturation knee:

1. ``tighten_admission``: shed **bulk** first, then **batch**, by
   installing a tightened :class:`~.slo.SLOPolicy` on the queue's pop-time
   path (:meth:`SLOPolicy.tightened`). Interactive is never touched.
2. ``narrow_buckets``: drop the largest bucket (the server releases its
   CUDA graph), so wide work stops taking dispatch slots and over-wide
   requests are rejected at the door. Rung 1 always comes first, so a wide
   request already queued is shed by the tightened admission policy rather
   than stranded.
3. ``downshift_dtype``: bf16 -> int8w, **only** after a journaled
   :class:`~..precision.gate.ToleranceGate` screen on the server's device
   passes (``gate_pass``); the server then rebuilds its forward and
   captures every bucket's graph again before its next dispatch. A failed
   screen journals the refusal (``downshift_refused`` beside the gate's own
   ``gate_fail``) and the rung is skipped, never silently adopted.

The JAX ladder's fourth rung, ``degrade_capacity``, asks the elastic
supervisor for one rung down; the port's server has no supervisor yet
(``server.sup`` is None, ROADMAP Queue 1 item 8), so :meth:`_rungs` leaves
it out, as the JAX controller does for an unsupervised server.

Every transition journals one ``controller_action`` record with its
**evidence** (the signal values, the thresholds they crossed, and the
cooldown/dwell state that admitted the action). Every action has
hysteresis: ``cooldown_s`` between consecutive actions and ``min_dwell_s``
at a level before de-escalating, so a noisy signal cannot make the server
oscillate. De-escalation reverses the ladder strictly LIFO, one rung per
evaluation, and every reversal is journaled too. The controller is inert
without an SLO policy (no classes: no burn, no knee) and journals nothing
on a calm trace.

Threading: every hook runs on the dispatch thread (``note_*`` from the
completion helpers, ``evaluate`` from the observation cadence), so the
state needs no lock; the HTTP front end reads :meth:`state_obj` snapshots
from its own threads (atomic attribute reads). Standard library at import;
torch is reached only through the server's actuators and the gate.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..observability.trace import off_timed_path
from .slo import SLOPolicy


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """The autopilot's knobs (all hysteresis/threshold state in one
    journal-round-trippable place — ``serve_config`` carries
    :meth:`to_obj` so a replay rebuilds the exact controller)."""

    # -- cadence & signal fold
    eval_s: float = 0.25  # evaluation cadence off the dispatch loop
    window: int = 128  # per-class sliding window of recent outcomes
    min_completed: int = 20  # outcomes before a class's burn is trusted
    # -- thresholds
    burn_high: float = 1.0  # escalate when protected burn >= this
    burn_low: float = 0.25  # de-escalate only when burn <= this
    knee_frac: float = 0.7  # escalate when oldest wait >= frac * knee
    knee_release_frac: float = 0.35  # de-escalate only below this
    # -- hysteresis (the ElasticPool anti-flap discipline)
    min_dwell_s: float = 1.0  # min time at a level before de-escalating
    cooldown_s: float = 1.0  # min time between consecutive actions
    # -- ladder shape
    protected_cls: str = "interactive"  # the class the ladder defends
    shed_order: Tuple[str, ...] = ("bulk", "batch")  # tighten order
    tighten_factor: float = 0.5  # finite shed cuts scale by this
    downshift_to: str = "int8w"  # dtype rung target
    enable_admission: bool = True
    enable_buckets: bool = True
    enable_dtype: bool = True
    enable_degrade: bool = True

    def to_obj(self) -> dict:
        obj = dataclasses.asdict(self)
        obj["shed_order"] = list(self.shed_order)
        return obj

    @staticmethod
    def from_obj(obj: dict) -> "ControllerConfig":
        """Inverse of :meth:`to_obj` — the ``serve_config`` round-trip
        ``observability.replay`` rebuilds a recorded controller from.
        Unknown keys are ignored (newer journals replay on older code)."""
        fields = {f.name for f in dataclasses.fields(ControllerConfig)}
        kw = {k: v for k, v in (obj or {}).items() if k in fields}
        if "shed_order" in kw:
            kw["shed_order"] = tuple(str(c) for c in kw["shed_order"])
        return ControllerConfig(**kw)


@dataclasses.dataclass
class ControllerSignals:
    """One evaluation's inputs — journaled verbatim as action evidence."""

    burn: Dict[str, Optional[float]]  # per-class windowed burn (None: n/a)
    completed: Dict[str, int]  # window occupancy per class
    depth: int
    pending_images: int
    oldest_wait_ms: float
    knee_ms: Optional[float]  # tightest finite shed cut (None: no knee)
    pool_alive: Optional[int]  # supervised pool size (None: unsupervised)

    def to_obj(self) -> dict:
        return {
            "burn": {
                k: (round(v, 3) if v is not None else None)
                for k, v in self.burn.items()
            },
            "completed": dict(self.completed),
            "depth": self.depth,
            "pending_images": self.pending_images,
            "oldest_wait_ms": round(self.oldest_wait_ms, 3),
            "knee_ms": self.knee_ms,
            "pool_alive": self.pool_alive,
        }


class AutopilotController:
    """Closed-loop graceful degradation over one :class:`InferenceServer`.

    Owns no thread and no timer: the server's dispatch loop calls
    :meth:`evaluate` between batches and the completion helpers feed
    :meth:`note_ok`/:meth:`note_shed`/:meth:`note_fail`: the controller
    is a pure fold over signals the server already produces.
    """

    def __init__(self, server, cfg: Optional[ControllerConfig] = None):
        self.server = server
        self.cfg = cfg or ControllerConfig()
        # The BASE SLO policy burn is measured against — actuation swaps
        # the queue's live policy, never the product targets.
        self.base_slo: Optional[SLOPolicy] = server.cfg.slo
        # Per-class sliding windows of violation flags (1 = late/shed/
        # failed, 0 = met SLO): the health module's burn math, folded live:
        # burn = (violations / completed) / ERROR_BUDGET over the window.
        self._win: Dict[str, Deque[int]] = {}
        # LIFO of applied rungs: (rung index, action name, target, undo).
        self._applied: List[Tuple[int, str, str, Any]] = []
        self._next_rung = 0
        self._blocked: set = set()  # refused rungs (e.g. gate-failed dtype)
        self._last_eval = 0.0
        self._last_action_t: Optional[float] = None
        self._level_enter_t: Optional[float] = None
        self._last_action: Optional[dict] = None
        self._seq = 0
        self.action_counts: Dict[str, int] = {}
        # The last evaluated signal set is cached so /healthz publishes
        # the controller's own verdict (overloaded/calm and the burn it was
        # judged on). Outcome counting is a plain counter: the note_* hot
        # path takes no clock reads.
        self._sig_cache: Optional[ControllerSignals] = None
        self._sig_t: Optional[float] = None
        self._n_outcomes = 0
        self._n_seen_outcomes = 0
        self._last_outcome_t: Optional[float] = None

    # ------------------------------------------------------------- signals

    def note_ok(self, cls: str, latency_ms: float) -> None:
        slo_ms = self._slo_ms(cls)
        self._window(cls).append(
            1 if (slo_ms and latency_ms > slo_ms) else 0
        )
        self._n_outcomes += 1

    def note_shed(self, cls: str) -> None:
        self._window(cls).append(1)
        self._n_outcomes += 1

    def note_fail(self, cls: str) -> None:
        self._window(cls).append(1)
        self._n_outcomes += 1

    def _window(self, cls: str) -> Deque[int]:
        w = self._win.get(cls)
        if w is None:
            w = self._win[cls] = collections.deque(maxlen=self.cfg.window)
        return w

    def _slo_ms(self, cls: str) -> float:
        if self.base_slo is None:
            return 0.0
        return float(self.base_slo.class_for(cls).slo_ms or 0.0)

    def burn(self, cls: str) -> Optional[float]:
        """The class's windowed error-budget burn — the same math as
        :func:`observability.health.slo_attainment` (violation share over
        completed, divided by ``ERROR_BUDGET``) over the last ``window``
        outcomes; None for unbounded classes or a window still shorter
        than ``min_completed`` (a burn estimated from three requests is
        noise, and noise must not actuate)."""
        from ..observability.health import ERROR_BUDGET

        if not self._slo_ms(cls):
            return None
        w = self._win.get(cls)
        if w is None or len(w) < self.cfg.min_completed:
            return None
        return (sum(w) / len(w)) / ERROR_BUDGET

    def signals(self) -> ControllerSignals:
        qs = self.server.queue.stats()
        knee = None
        if self.base_slo is not None:
            cuts = [
                c.shed_cut_ms
                for c in self.base_slo.classes.values()
                if c.shed_cut_ms
            ]
            if cuts:
                knee = min(cuts)
        return ControllerSignals(
            burn={cls: self.burn(cls) for cls in sorted(self._win)},
            completed={cls: len(w) for cls, w in sorted(self._win.items())},
            depth=qs.depth,
            pending_images=qs.pending_images,
            oldest_wait_ms=qs.oldest_wait_ms,
            knee_ms=knee,
            pool_alive=(
                self.server.sup.pool.n_alive
                if self.server.sup is not None
                else None
            ),
        )

    def _overloaded(self, sig: ControllerSignals) -> bool:
        b = sig.burn.get(self.cfg.protected_cls)
        if b is not None and b >= self.cfg.burn_high:
            return True
        return bool(
            sig.knee_ms
            and sig.oldest_wait_ms >= self.cfg.knee_frac * sig.knee_ms
        )

    def _calm(self, sig: ControllerSignals) -> bool:
        b = sig.burn.get(self.cfg.protected_cls)
        if b is not None and b > self.cfg.burn_low:
            return False
        return not (
            sig.knee_ms
            and sig.oldest_wait_ms > self.cfg.knee_release_frac * sig.knee_ms
        )

    # -------------------------------------------------------------- ladder

    def _rungs(self) -> List[Tuple[str, str]]:
        """The pressure ladder available to THIS server, in escalation
        order. Availability is structural (the port's server is
        unsupervised: it has no capacity rung); refusals discovered at
        actuation time land in ``_blocked`` instead."""
        cfg, srv = self.cfg, self.server
        rungs: List[Tuple[str, str]] = []
        if cfg.enable_admission and self.base_slo is not None:
            for cls in cfg.shed_order:
                if cls in self.base_slo.classes and cls != cfg.protected_cls:
                    rungs.append(("tighten_admission", cls))
        if cfg.enable_buckets:
            rungs.append(("narrow_buckets", ""))
        if cfg.enable_dtype and srv.sup is None:
            if srv.cfg.compute != cfg.downshift_to:
                rungs.append(("downshift_dtype", cfg.downshift_to))
        # degrade_capacity (enable_degrade) needs a supervised server: item 8
        return rungs

    @property
    def level(self) -> int:
        return len(self._applied)

    @property
    def mode(self) -> str:
        return "degraded" if self._applied else "steady"

    # ---------------------------------------------------------- evaluation

    @off_timed_path
    def evaluate(self, now: Optional[float] = None) -> Optional[dict]:
        """One control decision, throttled to ``eval_s`` — called from
        the dispatch loop's observation cadence. Returns the journaled
        action record when a transition fired, else None. ``now`` is
        injectable so the hysteresis drills test dwell/cooldown without
        sleeping."""
        if now is None:
            now = time.monotonic()
        if self.base_slo is None:  # no classes ⇒ no burn, no knee: inert
            return None
        if now - self._last_eval < self.cfg.eval_s:
            return None
        self._last_eval = now
        sig = self.signals()
        self._sig_cache, self._sig_t = sig, now
        if self._n_outcomes != self._n_seen_outcomes:
            self._n_seen_outcomes = self._n_outcomes
            self._last_outcome_t = now
        if self._overloaded(sig):
            if not self._cooled(now):
                return None
            return self._escalate(sig, now)
        if self._applied and self._calm(sig):
            if not self._cooled(now) or not self._dwelled(now):
                return None
            return self._deescalate(sig, now)
        return None

    def _cooled(self, now: float) -> bool:
        return (
            self._last_action_t is None
            or now - self._last_action_t >= self.cfg.cooldown_s
        )

    def _dwelled(self, now: float) -> bool:
        return (
            self._level_enter_t is None
            or now - self._level_enter_t >= self.cfg.min_dwell_s
        )

    def _escalate(self, sig: ControllerSignals, now: float) -> Optional[dict]:
        rungs = self._rungs()
        i = self._next_rung
        while i < len(rungs):
            action, target = rungs[i]
            if (action, target) in self._blocked:
                i += 1
                continue
            t0 = time.perf_counter()
            try:
                undo, extra = self._apply(action, target)
            except Exception as e:  # noqa — a rung that cannot actuate is
                # refused attributably and skipped, never retried blind.
                self._blocked.add((action, target))
                self._journal_action(
                    f"{action.split('_')[0]}_refused", target, sig, now,
                    actuated=False, reversal=False,
                    ms=(time.perf_counter() - t0) * 1e3,
                    cause=f"{type(e).__name__}: {e}"[:200],
                )
                i += 1
                continue
            if undo is None:
                # Screened and refused (e.g. gate-failed dtype): journaled
                # by _apply via ``extra``; block the rung and move on.
                self._blocked.add((action, target))
                self._journal_action(
                    f"{action.split('_')[0]}_refused", target, sig, now,
                    actuated=False, reversal=False,
                    ms=(time.perf_counter() - t0) * 1e3, **extra,
                )
                i += 1
                continue
            self._applied.append((i, action, target, undo))
            self._next_rung = i + 1
            rec = self._journal_action(
                action, target, sig, now, actuated=True, reversal=False,
                ms=(time.perf_counter() - t0) * 1e3, **extra,
            )
            self._last_action_t = now
            self._level_enter_t = now
            return rec
        return None  # ladder exhausted (or every remaining rung refused)

    def _deescalate(self, sig: ControllerSignals, now: float) -> Optional[dict]:
        i, action, target, undo = self._applied[-1]
        t0 = time.perf_counter()
        reverse = _REVERSALS[action]
        try:
            ok, extra = self._unapply(action, target, undo)
        except Exception as e:  # noqa — a reversal that fails keeps the
            # rung applied (degraded-but-stable beats a half-reversal).
            ok, extra = False, {"cause": f"{type(e).__name__}: {e}"[:200]}
        ms = (time.perf_counter() - t0) * 1e3
        if not ok:
            rec = self._journal_action(
                f"{reverse.split('_')[0]}_refused", target, sig, now,
                actuated=False, reversal=True, ms=ms, **extra,
            )
            self._last_action_t = now  # cooldown a refused reversal too
            return rec
        self._applied.pop()
        self._next_rung = i
        rec = self._journal_action(
            reverse, target, sig, now, actuated=True, reversal=True,
            ms=ms, **extra,
        )
        self._last_action_t = now
        self._level_enter_t = now
        return rec

    # ------------------------------------------------------------ actuators

    @off_timed_path
    def _apply(self, action: str, target: str):
        """Actuate one rung through the server's hooks. Returns
        ``(undo, extra)`` — ``undo`` is what the reversal needs (None =
        screened and refused; ``extra`` then carries the cause)."""
        srv = self.server
        if action == "tighten_admission":
            prev = srv.queue.slo
            pol = prev or self.base_slo
            # The tightened cut must land BELOW the protected class's
            # budget, not merely at it: the admission queue's wait is
            # shared across classes, so with equal cuts everyone sheds
            # at the same wait and the protected class gains nothing.
            # At tighten_factor x the protected budget the queue
            # equilibrates where the tightened class starts shedding —
            # leaving the protected class's arrivals a wait comfortably
            # inside its own SLO.
            protected_cut = pol.class_for(
                self.cfg.protected_cls
            ).shed_cut_ms or (self.signals().knee_ms or 0.0)
            cut = protected_cut * self.cfg.tighten_factor
            own_cut = pol.class_for(target).shed_cut_ms
            if own_cut:
                cut = min(own_cut, cut)  # only ever tighten
            if not cut:
                return None, {"cause": "no finite cut derivable"}
            srv.apply_slo_policy(
                (prev or self.base_slo).tightened(target, cut)
            )
            return prev, {"shed_wait_ms": round(cut, 3)}
        if action == "narrow_buckets":
            prev = srv.buckets
            if len(prev) < 2:
                return None, {"cause": "bucket set already minimal"}
            srv.apply_buckets(prev[:-1])
            return prev, {"buckets": list(srv.buckets)}
        if action == "downshift_dtype":
            res = self._screen_dtype(target)
            if not res.passed:
                return None, {
                    "cause": f"gate refused: {res.reason()}"[:200],
                    "gate_margin": _finite(res.margin),
                }
            srv.apply_compute(target)
            return srv.cfg.compute, {
                "gate_margin": _finite(res.margin),
                "frm": srv.cfg.compute,
            }
        raise ValueError(f"unknown rung {action!r}")

    @off_timed_path
    def _unapply(self, action: str, target: str, undo) -> Tuple[bool, dict]:
        srv = self.server
        if action == "tighten_admission":
            srv.apply_slo_policy(undo)
            return True, {}
        if action == "narrow_buckets":
            srv.apply_buckets(undo)
            return True, {"buckets": list(srv.buckets)}
        if action == "downshift_dtype":
            srv.apply_compute(undo)
            return True, {"to": undo}
        raise ValueError(f"unknown rung {action!r}")

    @off_timed_path
    def _screen_dtype(self, compute: str):
        """ToleranceGate screen of the downshift candidate against the
        fp32 oracle on the sentinel input, on the server's device (the
        oracle preflight included): the no-silent-adoption contract the
        autotuner screens under too. Pass and fail journal through the
        gate itself (``gate_pass``/``gate_fail`` with this key)."""
        from ..models.init import deterministic_input
        from ..precision.gate import ToleranceGate

        srv = self.server
        gate = ToleranceGate(journal=srv.journal)
        return gate.screen(
            compute,
            srv._params,
            deterministic_input(1, srv._model_cfg(), device=srv.device),
            model_cfg=srv._model_cfg(),
            key=f"controller:{compute}",
        )

    # ------------------------------------------------------------ reporting

    @off_timed_path
    def _journal_action(
        self,
        action: str,
        target: str,
        sig: ControllerSignals,
        now: float,
        *,
        actuated: bool,
        reversal: bool,
        ms: float,
        **extra,
    ) -> dict:
        self._seq += 1
        cfg = self.cfg
        rec = {
            "action": action,
            "target": target,
            "actuated": actuated,
            "reversal": reversal,
            "level": self.level,
            "ms": round(ms, 3),
            "evidence": {
                **sig.to_obj(),
                "burn_high": cfg.burn_high,
                "burn_low": cfg.burn_low,
                "knee_frac": cfg.knee_frac,
                "cooldown_s": cfg.cooldown_s,
                "min_dwell_s": cfg.min_dwell_s,
                "since_last_action_s": (
                    round(now - self._last_action_t, 3)
                    if self._last_action_t is not None
                    else None
                ),
                "dwell_s": (
                    round(now - self._level_enter_t, 3)
                    if self._level_enter_t is not None
                    else None
                ),
            },
            **extra,
        }
        self.action_counts[action] = self.action_counts.get(action, 0) + 1
        self._last_action = {**rec, "t": now}
        from ..observability.metrics import registry as metrics_registry

        metrics_registry().counter("serve.controller_actions").inc()
        self.server._journal(
            "controller_action", key=f"ctl:{self._seq}", **rec
        )
        return rec

    def state_obj(self, now: Optional[float] = None) -> dict:
        """Cross-thread state snapshot for ``/healthz``/``/stats``: a probe
        sees degraded-but-healthy instead of inferring it from latency."""
        if now is None:
            now = time.monotonic()
        last = None
        if self._last_action is not None:
            last = {
                k: self._last_action[k]
                for k in ("action", "target", "actuated", "reversal", "level")
            }
            last["age_s"] = round(now - self._last_action["t"], 3)
        # The controller's own verdict over its last evaluated signals
        # (what a fleet controller arbitrates on). None until the first
        # evaluation, or with no SLO policy.
        sig, sig_t = self._sig_cache, self._sig_t
        intent = None
        if sig is not None and sig_t is not None:
            b = sig.burn.get(self.cfg.protected_cls)
            intent = {
                "overloaded": self._overloaded(sig),
                "calm": self._calm(sig),
                "burn": round(b, 3) if b is not None else None,
                "depth": sig.depth,
                "oldest_wait_ms": round(sig.oldest_wait_ms, 3),
                "age_s": round(now - sig_t, 3),
                "idle_s": (
                    round(now - self._last_outcome_t, 3)
                    if self._last_outcome_t is not None
                    else None
                ),
            }
        return {
            "mode": self.mode,
            "level": self.level,
            "rung": self._applied[-1][1] if self._applied else None,
            "overrides": [
                {"action": a, "target": t} for _, a, t, _ in self._applied
            ],
            "last_action": last,
            "actions": dict(self.action_counts),
            "intent": intent,
        }

    def summary(self) -> str:
        """One machine-parseable line (run CLI: ``Controller: ...``)."""
        acts = ",".join(
            f"{k}={v}" for k, v in sorted(self.action_counts.items())
        ) or "none"
        return f"mode={self.mode} level={self.level} actions={acts}"


# Escalation -> reversal action names (the journal's vocabulary).
_REVERSALS = {
    "tighten_admission": "relax_admission",
    "narrow_buckets": "widen_buckets",
    "downshift_dtype": "upshift_dtype",
    "degrade_capacity": "promote_capacity",
}


def _finite(v: float) -> Optional[float]:
    """JSON-safe margin (the gate reports -inf on an oracle fault)."""
    return round(v, 6) if v == v and abs(v) != float("inf") else None
