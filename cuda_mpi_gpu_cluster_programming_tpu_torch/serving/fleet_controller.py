"""Fleet control plane: cross-backend arbitration over the router.

The JAX package's ``serving/fleet_controller.py``, copied: the same knobs,
actions, evidence and journal vocabulary (``fleet_action``,
``fleet_refusal``), so one scripted trail journals the same actions in both
packages. The serving controller (``serving/controller.py``) closes the
loop *inside* one backend, and the :class:`~.router.FleetRouter` probes
every backend's ``/healthz``. Without a tier across backends, every
backend's controller walks its degrade ladder on its own under correlated
pressure, and the whole fleet degrades at once: the failure a fleet exists
to prevent.

``FleetController`` is evaluated from the router's probe cadence and owns
**no thread**. Each ``probe_once()`` sweep scrapes every backend's
controller state (ladder rung, protected burn, queue depth, intent) into
the router's ``BackendSlot``s, then calls ``evaluate()``, which folds that
fleet view and the router's per-class accounting into journaled actions:

  staggered downshift tokens
      At most ``max_concurrent_degraded`` backends may hold a non-top ladder
      rung at once. A backend degrading past its token gets a journaled
      ``fleet_refusal`` and is drained instead: the router redirects its
      home traffic through its spillover path while probes continue.

  drain-vs-shed arbitration
      A backend whose protected burn stays >= ``drain_burn_high`` for
      ``drain_after_s`` is drained rather than left shedding. Re-admission
      is strict LIFO (last drained, first back) once the backend's
      controller reports grow-back: an empty queue and an intent that is
      not overloaded. Burn is deliberately NOT the readmit key: a drained
      backend gets no traffic, so its sliding burn window freezes at the
      value it had before the drain.

  forecast pre-actuation
      The realized arrival rate (sampled from the router's offered
      counters) is least-squares fit against the diurnal basis of
      ``traffic.shaped_arrivals``. When the *forecast* burn (predicted rate
      over fleet capacity) crests ``forecast_burn_high``, the fleet
      pre-sheds the deferrable classes at the router (429, counted
      ``rejected`` on both ledgers) and releases its drains before the
      crest; every forecast-driven action journals its predicted and
      realized evidence.

Every action or refusal is ONE ``fleet_action`` / ``fleet_refusal`` record
with its full evidence, as ``controller_action`` is for the serving
controller. The records go through the router's journal;
``observability.health.fleet_summary`` folds them.

Standard library only (it runs on the router's probe thread).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from ..observability.metrics import registry as _metrics
from ..observability.trace import off_timed_path

__all__ = [
    "FleetControllerConfig",
    "FleetController",
    "fit_diurnal",
    "predict_rate",
]


# ------------------------------------------------------------ forecast ---


def fit_diurnal(
    samples: Sequence[Tuple[float, float]], period_s: float
) -> Optional[Dict[str, float]]:
    """Least-squares fit of ``(t_s, rate_rps)`` samples against the diurnal
    basis used by ``traffic.shaped_arrivals``:

        r(t) = base + amp * sin(2*pi*t/period + phase)

    The phase is free because the fleet does not know when the load started
    (the shaped trace is phased to begin at the trough; the controller's
    clock is not).  Fit is the classical linearisation r = a + b*sin(wt) +
    c*cos(wt) with amp = hypot(b, c), solved by Gaussian elimination on the
    3x3 normal equations.  Returns ``{"base","amp","phase","period_s","n",
    "rmse"}`` or None when under-determined/degenerate.
    """
    pts = [(float(t), float(r)) for t, r in samples]
    if len(pts) < 3 or period_s <= 0.0:
        return None
    w = 2.0 * math.pi / period_s
    # Normal equations A x = y over basis [1, sin(wt), cos(wt)].
    a = [[0.0] * 3 for _ in range(3)]
    y = [0.0, 0.0, 0.0]
    for t, r in pts:
        row = (1.0, math.sin(w * t), math.cos(w * t))
        for i in range(3):
            y[i] += row[i] * r
            for j in range(3):
                a[i][j] += row[i] * row[j]
    # Gaussian elimination with partial pivoting.
    m = [a[i] + [y[i]] for i in range(3)]
    for col in range(3):
        piv = max(range(col, 3), key=lambda i: abs(m[i][col]))
        if abs(m[piv][col]) < 1e-9:
            return None
        m[col], m[piv] = m[piv], m[col]
        for i in range(3):
            if i == col:
                continue
            f = m[i][col] / m[col][col]
            for j in range(col, 4):
                m[i][j] -= f * m[col][j]
    base, b, c = (m[i][3] / m[i][i] for i in range(3))
    amp = math.hypot(b, c)
    phase = math.atan2(c, b)
    sq = 0.0
    for t, r in pts:
        sq += (base + b * math.sin(w * t) + c * math.cos(w * t) - r) ** 2
    return {
        "base": base,
        "amp": amp,
        "phase": phase,
        "period_s": float(period_s),
        "n": float(len(pts)),
        "rmse": math.sqrt(sq / len(pts)),
    }


def predict_rate(fit: Dict[str, float], t_s: float) -> float:
    """Evaluate a ``fit_diurnal`` fit at time ``t_s`` (same clock as the
    samples it was fit on)."""
    w = 2.0 * math.pi / fit["period_s"]
    return fit["base"] + fit["amp"] * math.sin(w * t_s + fit["phase"])


# -------------------------------------------------------------- config ---


@dataclasses.dataclass(frozen=True)
class FleetControllerConfig:
    """Knobs for the fleet control plane.  Mirrors ``ControllerConfig``'s
    to_obj/from_obj contract so it rides inside ``RouterConfig`` payloads."""

    # Evaluation cadence (seconds of router clock between folds; the router
    # calls evaluate() every probe sweep and this throttles it).
    eval_s: float = 0.25
    # (a) staggered downshift tokens.
    max_concurrent_degraded: int = 1
    token_cooldown_s: float = 1.0  # per-backend fleet_refusal re-journal gap
    # (b) drain-vs-shed arbitration.
    drain_burn_high: float = 1.0  # protected burn that arms the drain timer
    drain_after_s: float = 2.0  # sustained-burn dwell before draining
    drain_min_s: float = 1.0  # minimum drain dwell before readmit
    max_drained: int = 1  # at most this many drained at once
    min_active: int = 1  # never drain below this many routable backends
    # (c) forecast pre-actuation (off until period + capacity are known).
    forecast: bool = True
    forecast_period_s: Optional[float] = None  # diurnal period to fit
    forecast_horizon_s: float = 1.0  # how far ahead to act
    forecast_capacity_rps: Optional[float] = None  # fleet-wide sustainable rps
    forecast_min_samples: int = 6
    forecast_window: int = 240  # rate samples kept for the fit
    forecast_burn_high: float = 0.95  # predicted rate/capacity that presheds
    forecast_burn_low: float = 0.55  # predicted burn that relaxes preshed
    preshed_min_s: float = 1.0  # minimum preshed dwell before release
    preshed_classes: Tuple[str, ...] = ("bulk", "batch")
    protected_cls: str = "interactive"

    def to_obj(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["preshed_classes"] = list(self.preshed_classes)
        return d

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "FleetControllerConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in obj.items() if k in fields}
        if "preshed_classes" in kw:
            kw["preshed_classes"] = tuple(kw["preshed_classes"])
        return cls(**kw)


# ---------------------------------------------------------- fleet view ---


@dataclasses.dataclass
class _BackendView:
    """One backend's scraped state, snapshotted under the router lock."""

    index: int
    name: str
    state: str
    drained: bool
    level: int  # ladder rung depth (0 = top / undegraded)
    mode: Optional[str]
    burn: Optional[float]  # protected-class burn scraped from intent
    overloaded: Optional[bool]
    depth: Optional[int]  # queue depth scraped from /healthz


class FleetController:
    """Cross-backend arbitration evaluated from the router's probe cadence.

    Owns no thread: the router calls :meth:`evaluate` at the tail of every
    ``probe_once()`` sweep (and tests call it directly with an injectable
    ``now=``).  All actuation goes through the router (``set_drained`` /
    ``set_preshed``); all evidence goes through the router's journal as
    ``fleet_action`` / ``fleet_refusal`` records keyed ``fleet:<seq>``.
    """

    def __init__(self, router, cfg: Optional[FleetControllerConfig] = None):
        self.router = router
        self.cfg = cfg or FleetControllerConfig()
        self._lock_free = True  # evaluate() runs on the probe thread only
        self._seq = 0
        self._last_eval: Optional[float] = None
        # (a) tokens: backend indices currently granted a degraded rung,
        # in grant order.
        self._tokens: List[int] = []
        self._refused_t: Dict[int, float] = {}
        # (b) drain stack (LIFO: last drained is first readmitted).
        self._drained: List[int] = []
        self._drain_t: Dict[int, float] = {}
        self._burn_high_since: Dict[int, float] = {}
        self._drain_refused_t: Dict[int, float] = {}
        # (c) forecast state.
        self._samples: Deque[Tuple[float, float]] = deque(
            maxlen=max(8, int(self.cfg.forecast_window))
        )
        self._last_offered: Optional[int] = None
        self._capacity_rps: Optional[float] = self.cfg.forecast_capacity_rps
        self._preshed_active = False
        self._preshed_entry: Dict[str, float] = {}
        self._preshed_peak_rps = 0.0
        self.action_counts: Dict[str, int] = {}

    # ------------------------------------------------------- operator ---

    def set_capacity_rps(self, rps: Optional[float]) -> None:
        """Operator input: fleet-wide sustainable request rate used as the
        forecast-burn denominator (e.g. from ``bench.saturating_rate``).
        Not journaled itself — it is recorded as evidence on every forecast
        action it feeds."""
        self._capacity_rps = None if rps is None else float(rps)

    # ------------------------------------------------------- evaluate ---

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Fold the scraped fleet view into actions.  Returns the records
        journaled this step (empty when throttled or nothing to do)."""
        if now is None:
            now = time.monotonic()
        if (
            self._last_eval is not None
            and now - self._last_eval < self.cfg.eval_s
        ):
            return []
        prev = self._last_eval
        self._last_eval = now
        views = self._snapshot()
        if prev is not None and now > prev:
            self._sample_rate(now, now - prev)
        recs: List[Dict[str, Any]] = []
        recs += self._forecast_step(now)
        recs += self._token_step(views, now)
        recs += self._drain_step(views, now)
        recs += self._readmit_step(views, now)
        return recs

    def _snapshot(self) -> List[_BackendView]:
        r = self.router
        with r._lock:
            return [
                _BackendView(
                    index=i,
                    name=s.name,
                    state=s.state,
                    drained=s.drained,
                    level=int(s.ctl_level or 0),
                    mode=s.ctl_mode,
                    burn=s.ctl_burn,
                    overloaded=s.ctl_overloaded,
                    depth=s.queue_depth,
                )
                for i, s in enumerate(r.slots)
            ]

    # ------------------------------------------------------ (a) tokens ---

    def _token_step(
        self, views: List[_BackendView], now: float
    ) -> List[Dict[str, Any]]:
        cfg, recs = self.cfg, []
        by_index = {v.index: v for v in views}
        # Release tokens whose holder climbed back to the top rung (or left
        # the routable pool — its degradation no longer gates the fleet).
        for i in list(self._tokens):
            v = by_index.get(i)
            if v is None or (v.level == 0 and not v.drained):
                self._tokens.remove(i)
                self._refused_t.pop(i, None)
                recs.append(
                    self._journal(
                        "fleet_action", "token_release",
                        v.name if v else str(i), now,
                        actuated=True, reversal=True, views=views,
                        evidence={"holders_after": self._token_names()},
                    )
                )
        # Grant tokens to degraded backends, oldest degradation first
        # (stable index order is fine: the probe sweep is index-ordered).
        for v in views:
            wants = v.level > 0 or bool(v.overloaded)
            if not wants or v.drained or v.index in self._tokens:
                continue
            if len(self._tokens) < cfg.max_concurrent_degraded:
                self._tokens.append(v.index)
                recs.append(
                    self._journal(
                        "fleet_action", "token_grant", v.name, now,
                        actuated=True, reversal=False, views=views,
                        evidence={
                            "level": v.level,
                            "burn": v.burn,
                            "holders_after": self._token_names(),
                        },
                    )
                )
                continue
            # Token budget exhausted: journaled refusal (throttled per
            # backend) and the router redirects load off it via drain.
            last = self._refused_t.get(v.index)
            if last is not None and now - last < cfg.token_cooldown_s:
                continue
            self._refused_t[v.index] = now
            recs.append(
                self._journal(
                    "fleet_refusal", "token_refused", v.name, now,
                    actuated=False, reversal=False, views=views,
                    cause="max_concurrent_degraded",
                    evidence={
                        "level": v.level,
                        "burn": v.burn,
                        "overloaded": v.overloaded,
                        "holders": self._token_names(),
                        "max_concurrent_degraded":
                            cfg.max_concurrent_degraded,
                    },
                )
            )
            recs += self._maybe_drain(
                v, views, now, cause="token_refused", detect_ms=0.0
            )
        return recs

    def _token_names(self) -> List[str]:
        slots = self.router.slots
        return [slots[i].name for i in self._tokens if i < len(slots)]

    # ------------------------------------------------------- (b) drain ---

    def _drain_step(
        self, views: List[_BackendView], now: float
    ) -> List[Dict[str, Any]]:
        cfg, recs = self.cfg, []
        for v in views:
            if v.drained or v.state != "up" or v.burn is None:
                self._burn_high_since.pop(v.index, None)
                continue
            if v.burn >= cfg.drain_burn_high:
                t0 = self._burn_high_since.setdefault(v.index, now)
                if now - t0 >= cfg.drain_after_s:
                    recs += self._maybe_drain(
                        v, views, now,
                        cause="sustained_burn",
                        detect_ms=(now - t0) * 1e3,
                    )
            else:
                self._burn_high_since.pop(v.index, None)
        return recs

    def _maybe_drain(
        self,
        v: _BackendView,
        views: List[_BackendView],
        now: float,
        *,
        cause: str,
        detect_ms: float,
    ) -> List[Dict[str, Any]]:
        cfg = self.cfg
        if v.drained or v.index in self._drained:
            return []
        # Drain-vs-shed arbitration, resolved: while the fleet is preshed
        # for a forecast crest, SHED has been chosen over DRAIN.  Pulling a
        # backend out now spills its protected-class share onto the
        # survivors mid-crest and cascades the whole fleet down its
        # ladders — the one correlated failure this tier exists to prevent.
        if self._preshed_active:
            return self._refuse_drain(
                v, views, now, "preshed_active",
                {"burn": v.burn, "level": v.level},
            )
        if len(self._drained) >= cfg.max_drained:
            return self._refuse_drain(
                v, views, now, "max_drained",
                {
                    "drained": self._drained_names(),
                    "max_drained": cfg.max_drained,
                },
            )
        active_after = sum(
            1
            for o in views
            if o.index != v.index
            and o.state == "up"
            and not o.drained
            and o.index not in self._drained
        )
        if active_after < cfg.min_active:
            return self._refuse_drain(
                v, views, now, "min_active",
                {
                    "active_after": active_after,
                    "min_active": cfg.min_active,
                },
            )
        t0 = time.perf_counter()
        self.router.set_drained(v.index, True)
        ms = (time.perf_counter() - t0) * 1e3
        v.drained = True
        self._drained.append(v.index)
        self._drain_t[v.index] = now
        self._burn_high_since.pop(v.index, None)
        return [
            self._journal(
                "fleet_action", "drain", v.name, now,
                actuated=True, reversal=False, views=views,
                cause=cause, ms=ms,
                evidence={
                    "detect_ms": round(detect_ms, 3),
                    "burn": v.burn,
                    "level": v.level,
                    "depth": v.depth,
                    "drained_after": self._drained_names(),
                },
            )
        ]

    def _refuse_drain(
        self,
        v: _BackendView,
        views: List[_BackendView],
        now: float,
        cause: str,
        evidence: Dict[str, Any],
    ) -> List[Dict[str, Any]]:
        """Journal ONE drain_refused per backend per cooldown window — a
        refused drain usually stays refused for many sweeps, and the
        journal needs the arbitration, not a record per probe."""
        last = self._drain_refused_t.get(v.index)
        if last is not None and now - last < self.cfg.token_cooldown_s:
            return []
        self._drain_refused_t[v.index] = now
        return [
            self._journal(
                "fleet_refusal", "drain_refused", v.name, now,
                actuated=False, reversal=False, views=views,
                cause=cause, evidence=evidence,
            )
        ]

    def _drained_names(self) -> List[str]:
        slots = self.router.slots
        return [slots[i].name for i in self._drained if i < len(slots)]

    # ----------------------------------------------------- (b) readmit ---

    def _readmit_step(
        self, views: List[_BackendView], now: float
    ) -> List[Dict[str, Any]]:
        """Strict LIFO: only the most recently drained backend may readmit;
        the stack below it waits its turn (mirrors the Autopilot's LIFO
        ladder discipline)."""
        recs: List[Dict[str, Any]] = []
        by_index = {v.index: v for v in views}
        while self._drained:
            idx = self._drained[-1]
            v = by_index.get(idx)
            if v is None:
                self._drained.pop()
                self._drain_t.pop(idx, None)
                continue
            if not self._grow_back(v, now):
                break
            recs.append(self._do_readmit(v, views, now, cause="grow_back"))
        return recs

    def _grow_back(self, v: _BackendView, now: float) -> bool:
        """Readmit key: drain dwell served, probes still passing, queue
        drained to empty, and the backend's own intent not overloaded.
        Burn is deliberately excluded — it is frozen while drained."""
        dwell = now - self._drain_t.get(v.index, now)
        if dwell < self.cfg.drain_min_s:
            return False
        if v.state != "up":
            return False
        if v.depth is not None and v.depth > 0:
            return False
        return not bool(v.overloaded)

    def _do_readmit(
        self,
        v: _BackendView,
        views: List[_BackendView],
        now: float,
        *,
        cause: str,
        extra: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        t0 = time.perf_counter()
        self.router.set_drained(v.index, False)
        ms = (time.perf_counter() - t0) * 1e3
        v.drained = False
        if v.index in self._drained:
            self._drained.remove(v.index)
        dwell = now - self._drain_t.pop(v.index, now)
        self._refused_t.pop(v.index, None)
        ev = {
            "drain_ms": round(dwell * 1e3, 3),
            "level": v.level,
            "depth": v.depth,
            "overloaded": v.overloaded,
            "drained_after": self._drained_names(),
        }
        if extra:
            ev.update(extra)
        return self._journal(
            "fleet_action", "readmit", v.name, now,
            actuated=True, reversal=True, views=views,
            cause=cause, ms=ms, evidence=ev,
        )

    # ---------------------------------------------------- (c) forecast ---

    def _sample_rate(self, now: float, dt: float) -> None:
        """One realized-arrival-rate sample per evaluate, from the delta of
        the router's total offered counter (per-class accounting already
        maintained by the request path — no new bookkeeping)."""
        r = self.router
        with r._lock:
            offered = sum(st.offered for st in r.stats.values())
        if self._last_offered is None:
            self._last_offered = offered
            return
        rate = max(0.0, (offered - self._last_offered) / dt)
        self._last_offered = offered
        self._samples.append((now, rate))
        if self._preshed_active:
            self._preshed_peak_rps = max(self._preshed_peak_rps, rate)

    def _forecast_step(self, now: float) -> List[Dict[str, Any]]:
        cfg = self.cfg
        if (
            not cfg.forecast
            or cfg.forecast_period_s is None
            or self._capacity_rps is None
            or self._capacity_rps <= 0.0
            or len(self._samples) < cfg.forecast_min_samples
        ):
            return []
        fit = fit_diurnal(self._samples, cfg.forecast_period_s)
        realized = self._samples[-1][1]
        realized_burn = realized / self._capacity_rps
        predicted = (
            predict_rate(fit, now + cfg.forecast_horizon_s)
            if fit is not None
            else None
        )
        predicted_burn = (
            predicted / self._capacity_rps if predicted is not None else None
        )
        recs: List[Dict[str, Any]] = []
        if not self._preshed_active:
            by_forecast = (
                predicted_burn is not None
                and predicted_burn >= cfg.forecast_burn_high
            )
            # Reactive backstop: a realized crest the fit has not converged
            # on yet must still preshed.
            by_realized = realized_burn >= cfg.forecast_burn_high
            if by_forecast or by_realized:
                self._preshed_active = True
                self._preshed_peak_rps = realized
                self._preshed_entry = {
                    "predicted_rps": predicted,
                    "predicted_burn": predicted_burn,
                    "realized_rps": realized,
                    "t": now,
                }
                t0 = time.perf_counter()
                self.router.set_preshed(cfg.preshed_classes)
                ms = (time.perf_counter() - t0) * 1e3
                recs.append(
                    self._journal(
                        "fleet_action", "preshed", ",".join(
                            cfg.preshed_classes
                        ), now,
                        actuated=True, reversal=False, views=None,
                        cause="forecast" if by_forecast else "realized",
                        ms=ms,
                        evidence=self._forecast_evidence(
                            fit, predicted, predicted_burn,
                            realized, realized_burn,
                        ),
                    )
                )
                # Pre-release every drain before the crest: the fleet needs
                # all capacity for the protected class it still admits.
                views = self._snapshot()
                by_index = {v.index: v for v in views}
                for idx in list(reversed(self._drained)):
                    v = by_index.get(idx)
                    if v is None:
                        continue
                    recs.append(
                        self._do_readmit(
                            v, views, now,
                            cause="forecast_release",
                            extra={
                                "predicted_rps": predicted,
                                "predicted_burn": predicted_burn,
                            },
                        )
                    )
        else:
            worst = max(
                realized_burn,
                predicted_burn if predicted_burn is not None else 0.0,
            )
            # Release discipline mirrors drain grow-back: a minimum dwell,
            # and every ROUTABLE backend back at the top rung and not
            # overloaded.  The realized rate alone cannot be trusted here —
            # in a closed loop a collapsing fleet stops being OFFERED
            # traffic, which reads exactly like calm and would release the
            # shed into the crest (drained backends are excluded: their
            # scraped state is frozen at the pre-drain value by design).
            dwelled = (
                now - self._preshed_entry.get("t", now) >= cfg.preshed_min_s
            )
            grown_back = all(
                v.level == 0 and not bool(v.overloaded)
                for v in self._snapshot()
                if v.state == "up" and not v.drained
            )
            if worst <= cfg.forecast_burn_low and dwelled and grown_back:
                self._preshed_active = False
                entry = self._preshed_entry
                t0 = time.perf_counter()
                self.router.set_preshed(())
                ms = (time.perf_counter() - t0) * 1e3
                ev = self._forecast_evidence(
                    fit, predicted, predicted_burn, realized, realized_burn
                )
                ev.update(
                    {
                        "entry_predicted_rps": entry.get("predicted_rps"),
                        "entry_realized_rps": entry.get("realized_rps"),
                        "realized_peak_rps": round(
                            self._preshed_peak_rps, 3
                        ),
                        "preshed_s": round(now - entry.get("t", now), 3),
                    }
                )
                recs.append(
                    self._journal(
                        "fleet_action", "preshed_release", ",".join(
                            cfg.preshed_classes
                        ), now,
                        actuated=True, reversal=True, views=None,
                        cause="forecast", ms=ms, evidence=ev,
                    )
                )
        return recs

    def _forecast_evidence(
        self, fit, predicted, predicted_burn, realized, realized_burn
    ) -> Dict[str, Any]:
        cfg = self.cfg
        ev: Dict[str, Any] = {
            "predicted_rps":
                None if predicted is None else round(predicted, 3),
            "predicted_burn":
                None if predicted_burn is None else round(predicted_burn, 4),
            "realized_rps": round(realized, 3),
            "realized_burn": round(realized_burn, 4),
            "capacity_rps": round(self._capacity_rps, 3),
            "horizon_s": cfg.forecast_horizon_s,
            "burn_high": cfg.forecast_burn_high,
            "burn_low": cfg.forecast_burn_low,
            "n_samples": len(self._samples),
        }
        if fit is not None:
            ev["fit"] = {
                "base": round(fit["base"], 3),
                "amp": round(fit["amp"], 3),
                "rmse": round(fit["rmse"], 3),
                "period_s": fit["period_s"],
            }
        return ev

    # ------------------------------------------------------ journaling ---

    @off_timed_path
    def _journal(
        self,
        kind: str,
        action: str,
        target: str,
        now: float,
        *,
        actuated: bool,
        reversal: bool,
        views: Optional[List[_BackendView]],
        cause: Optional[str] = None,
        ms: float = 0.0,
        evidence: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """ONE record per action/refusal, mirroring ``controller_action``:
        what was done, to whom, whether it actuated, and the full fleet
        evidence it was decided on."""
        self._seq += 1
        ev: Dict[str, Any] = dict(evidence or {})
        if views is not None:
            ev["fleet"] = {
                v.name: {
                    "state": v.state,
                    "level": v.level,
                    "burn": v.burn,
                    "drained": v.drained,
                }
                for v in views
            }
        rec = {
            "action": action,
            "target": target,
            "actuated": bool(actuated),
            "reversal": bool(reversal),
            "tokens": self._token_names(),
            "drained": self._drained_names(),
            "preshed": self._preshed_active,
            "ms": round(ms, 3),
            "evidence": ev,
        }
        if cause is not None:
            rec["cause"] = cause
        self.action_counts[action] = self.action_counts.get(action, 0) + 1
        reg = _metrics()
        reg.counter("fleet.actions").inc()
        reg.counter(f"fleet.action.{action}").inc()
        if kind == "fleet_refusal":
            reg.counter("fleet.refusals").inc()
        r = self.router
        r._journal_append(
            kind, key=f"fleet:{self._seq}", t_ms=r._t_ms(), **rec
        )
        return dict(rec, kind=kind)

    # ------------------------------------------------------- reporting ---

    def state_obj(self) -> Dict[str, Any]:
        """JSON-safe state for the router's ``/stats`` endpoint."""
        return {
            "tokens": self._token_names(),
            "drained": self._drained_names(),
            "preshed": self._preshed_active,
            "preshed_classes": list(self.cfg.preshed_classes),
            "capacity_rps": self._capacity_rps,
            "n_samples": len(self._samples),
            "actions": dict(self.action_counts),
        }

    def summary(self) -> Dict[str, Any]:
        """Bench-row summary: action counts plus totals."""
        total = sum(self.action_counts.values())
        return {"actions": dict(self.action_counts), "total": total}
