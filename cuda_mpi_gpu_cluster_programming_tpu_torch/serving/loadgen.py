"""Poisson load generator and latency reporting for the serve bench.

The JAX package's ``serving/loadgen.py``, copied. Arrivals are a seeded
Poisson process (``random.Random(seed)`` exponential gaps: one schedule per
seed), submitted against a running :class:`~.server.InferenceServer` on the
caller's thread while the server's dispatch thread drains them.

The report separates the ways a request can finish (OK, SHED, FAILED, and
rejected at admission) and computes p50/p99 over the OK latencies;
sustained img/s is completed images over the span from the first submit to
the last completion. ``percentile`` is the nearest-rank estimator, so a
small run reports a latency that was observed, never an interpolated one.
Also here: the saturation sweep and its knee (:func:`saturation_sweep`,
:func:`locate_knee`), the capacity-derived rate :func:`saturating_rate`,
and the correlated-pressure shape with its ``fleet_pressure`` chaos site.

Standard library and numpy only (no torch import; ``server`` imports torch
when it builds its forward).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, List, Optional

import numpy as np

from .queue import FAILED, OK, SHED, RequestHandle
from .server import InferenceServer
from .traffic import (
    ClassStats,
    RequestClass,
    ShapedReport,
    assign_classes,
    default_class_mix,
    shaped_arrivals,
)


def poisson_arrivals(
    rate_rps: float, duration_s: float, seed: int = 0
) -> List[float]:
    """Arrival offsets (seconds from start) of a seeded Poisson process."""
    if rate_rps <= 0 or duration_s <= 0:
        return []
    rng = random.Random(f"loadgen:{seed}")
    t, out = 0.0, []
    while True:
        t += rng.expovariate(rate_rps)
        if t >= duration_s:
            return out
        out.append(t)


def percentile(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on empty input."""
    if not xs:
        return None
    s = sorted(xs)
    if q <= 0:
        return s[0]
    rank = int(np.ceil(q / 100.0 * len(s)))
    return s[min(max(rank, 1), len(s)) - 1]


@dataclasses.dataclass
class LoadReport:
    """One load run's verdict — everything the bench JSON row needs."""

    n_requests: int
    n_ok: int
    n_shed: int
    n_failed: int
    n_rejected: int  # admission-control refusals (QueueFull / too wide)
    p50_ms: Optional[float]
    p99_ms: Optional[float]
    sustained_img_s: float
    duration_s: float
    latencies_ms: List[float]

    def summary(self) -> str:
        """Machine-parseable 'Serve load:' payload for the run CLI."""
        p50 = f"{self.p50_ms:.3f}" if self.p50_ms is not None else "nan"
        p99 = f"{self.p99_ms:.3f}" if self.p99_ms is not None else "nan"
        return (
            f"reqs={self.n_requests} ok={self.n_ok} shed={self.n_shed} "
            f"failed={self.n_failed} rejected={self.n_rejected} "
            f"p50_ms={p50} p99_ms={p99} "
            f"img_s={self.sustained_img_s:.1f} wall_s={self.duration_s:.2f}"
        )


def run_load(
    server: InferenceServer,
    *,
    rate_rps: float,
    duration_s: float,
    seed: int = 0,
    make_input: Optional[Callable[[int], np.ndarray]] = None,
    deadline_s: Optional[float] = None,
    wait_timeout_s: float = 120.0,
) -> LoadReport:
    """Drive a started server with Poisson traffic and wait everything out.

    ``make_input(i)`` supplies the i-th request's (n, H, W, C) array;
    default is a single deterministic image matching the server's model
    geometry. Every submitted handle is awaited (bounded), so the report
    accounts for each request exactly once: ok + shed + failed +
    rejected == offered.
    """
    if make_input is None:
        m = server._model_cfg()
        img = np.ones((1, m.in_height, m.in_width, m.in_channels), np.float32)
        make_input = lambda i: img  # noqa: E731 — trivial default factory
    arrivals = poisson_arrivals(rate_rps, duration_s, seed)
    handles: List[RequestHandle] = []
    n_rejected = 0
    t0 = time.monotonic()
    for i, at in enumerate(arrivals):
        now = time.monotonic() - t0
        if at > now:
            time.sleep(at - now)
        try:
            handles.append(server.submit(make_input(i), deadline_s=deadline_s))
        except (ValueError, RuntimeError):
            n_rejected += 1  # QueueFull/too-wide: admission control, counted
    wait_deadline = time.monotonic() + wait_timeout_s
    for h in handles:
        h.wait(max(0.0, wait_deadline - time.monotonic()))
    ok = [h for h in handles if h.status == OK]
    lat = [h.latency_ms for h in ok if h.latency_ms is not None]
    completed_at = [h.completed_at for h in handles if h.completed_at is not None]
    wall = (max(completed_at) - t0) if completed_at else (time.monotonic() - t0)
    images_ok = sum(h.n_images for h in ok)
    return LoadReport(
        n_requests=len(handles) + n_rejected,
        n_ok=len(ok),
        n_shed=sum(1 for h in handles if h.status == SHED),
        n_failed=sum(1 for h in handles if h.status == FAILED),
        n_rejected=n_rejected,
        p50_ms=percentile(lat, 50),
        p99_ms=percentile(lat, 99),
        sustained_img_s=images_ok / wall if wall > 0 else 0.0,
        duration_s=wall,
        latencies_ms=lat,
    )


# ------------------------------------------------------- shaped traffic ---


def run_shaped_load(
    server: InferenceServer,
    *,
    shape: str = "steady",
    rate_rps: float,
    duration_s: float,
    classes: Optional[List[RequestClass]] = None,
    seed: int = 0,
    wait_timeout_s: float = 120.0,
) -> ShapedReport:
    """Drive a started server with traffic-shaped, class-mixed load.

    Arrivals come from :func:`~.traffic.shaped_arrivals` (diurnal ramps,
    bursts, flash crowds — seeded, deterministic); each arrival draws a
    seeded (class, n_images) assignment from the heavy-tailed mix
    (default: :func:`~.traffic.default_class_mix` over the server's
    bucket set) and submits with the class's own deadline. Every handle
    is awaited (bounded), so per-class accounting CLOSES: ok + shed +
    failed + rejected == offered for every class — the report's
    ``closed`` property is the drill's acceptance check.
    """
    if classes is None:
        classes = list(default_class_mix(server.buckets))
    m = server._model_cfg()
    imgs: dict = {}  # n_images -> cached input (allocation, not payload)

    def _input(n: int) -> np.ndarray:
        if n not in imgs:
            imgs[n] = np.ones(
                (n, m.in_height, m.in_width, m.in_channels), np.float32
            )
        return imgs[n]

    arrivals = shaped_arrivals(shape, rate_rps, duration_s, seed)
    plan = assign_classes(classes, len(arrivals), seed)
    stats: dict = {c.name: ClassStats() for c in classes}
    handles: List[tuple] = []  # (RequestClass, handle)
    t0 = time.monotonic()
    for (at, (c, n)) in zip(arrivals, plan):
        now = time.monotonic() - t0
        if at > now:
            time.sleep(at - now)
        st = stats[c.name]
        st.offered += 1
        try:
            handles.append(
                (c, server.submit(_input(n), deadline_s=c.deadline_s, cls=c.name))
            )
        except (ValueError, RuntimeError):
            st.rejected += 1  # QueueFull/too-wide: backpressure, counted
    wait_deadline = time.monotonic() + wait_timeout_s
    for _c, h in handles:
        h.wait(max(0.0, wait_deadline - time.monotonic()))
    images_ok = 0
    completed_at: List[float] = []
    for c, h in handles:
        st = stats[c.name]
        if h.completed_at is not None:
            completed_at.append(h.completed_at)
        if h.status == OK:
            st.ok += 1
            st.images_ok += h.n_images
            images_ok += h.n_images
            if h.latency_ms is not None:
                st.latencies_ms.append(h.latency_ms)
        elif h.status == SHED:
            st.shed += 1
        else:
            st.failed += 1
    wall = (max(completed_at) - t0) if completed_at else (time.monotonic() - t0)
    return ShapedReport(
        shape=shape,
        per_class=stats,
        duration_s=wall,
        sustained_img_s=images_ok / wall if wall > 0 else 0.0,
    )


# ------------------------------------------------------ saturation sweep ---


def locate_knee(rows: List[dict], factor: float = 3.0) -> Optional[float]:
    """The p99 knee of a saturation sweep: the first offered rate (img/s,
    ascending) whose journal p99 exceeds ``factor`` x the lowest measured
    rate's p99 — where the latency curve leaves its flat region and turns
    vertical. None when every swept rate stayed under the threshold (the
    sweep never crossed capacity — sweep higher)."""
    measured = [
        r for r in sorted(rows, key=lambda r: r["offered_img_s"])
        if isinstance(r.get("p99_ms"), (int, float))
    ]
    if not measured:
        return None
    base = measured[0]["p99_ms"]
    if base <= 0:
        return None
    for r in measured[1:]:
        if r["p99_ms"] > factor * base:
            return float(r["offered_img_s"])
    return None


def saturation_sweep(
    server: InferenceServer,
    rates_rps: List[float],
    *,
    duration_s: float,
    classes: Optional[List[RequestClass]] = None,
    shape: str = "steady",
    seed: int = 0,
    knee_factor: float = 3.0,
    journal_path: str = "",
) -> List[dict]:
    """Sweep offered load past capacity on ONE started server; one row
    dict per rate, each carrying the located ``knee_rate_img_s``.

    Per rate: the metrics registry is reset (so its ``serve.request_ms``
    percentiles cover exactly this rate's window), a shaped load runs,
    and percentiles are computed BOTH from the journal slice this rate
    appended and from the registry histogram — the same nearest-rank
    estimator over the same population, so the row can assert they agree
    (``percentiles_agree``). After the sweep the p99 knee is located
    (:func:`locate_knee`) and stamped on every row.
    """
    from ..observability.metrics import registry as metrics_registry
    from ..resilience.journal import Journal
    from .server import class_latencies_from_records, latencies_from_records

    if classes is None:
        classes = list(default_class_mix(server.buckets))
    rows: List[dict] = []
    for rate in sorted(rates_rps):
        n0 = len(Journal.load(journal_path)) if journal_path else 0
        misses0 = server.stats.cache_misses
        metrics_registry().reset()
        report = run_shaped_load(
            server, shape=shape, rate_rps=rate, duration_s=duration_s,
            classes=classes, seed=seed,
        )
        # Quiesce before reading: a handle wakes its waiter BEFORE the
        # dispatch thread's @off_timed_path completion helper finishes
        # journaling the batch, so the last batch's records can lag the
        # report by a scheduler slice. The rate's row must cover its whole
        # population (and the registry must be settled before the next
        # rate resets it) — poll, bounded.
        recs: List[dict] = []
        quiesce = time.monotonic() + 10.0
        while journal_path:
            recs = Journal.load(journal_path)[n0:]
            if (
                len(latencies_from_records(recs)) >= report.n_ok
                or time.monotonic() >= quiesce
            ):
                break
            time.sleep(0.01)
        jlat = latencies_from_records(recs)
        by_cls = class_latencies_from_records(recs)
        reg_p99 = metrics_registry().histogram("serve.request_ms").percentile(99)
        j_p99 = percentile(jlat, 99)
        rows.append(
            {
                "rate_rps": rate,
                "offered": report.n_requests,
                "offered_img_s": round(rate * _mean_images(classes), 3),
                "value": round(report.sustained_img_s, 1),
                "p50_ms": percentile(jlat, 50),
                "p99_ms": j_p99,
                "metrics_p99_ms": reg_p99,
                "percentiles_agree": (
                    j_p99 is not None and reg_p99 is not None
                    and abs(j_p99 - reg_p99) <= max(1e-6, 0.05 * j_p99)
                ),
                "classes": {
                    (n or "default"): {
                        **report.per_class[n].to_obj(),
                        "journal_p99_ms": percentile(by_cls.get(n, []), 99),
                    }
                    for n in report.per_class
                },
                "n_ok": report.n_ok,
                "n_shed": report.n_shed,
                "n_failed": report.n_failed,
                "n_rejected": report.n_rejected,
                "accounting_closed": report.closed,
                "cache_misses": server.stats.cache_misses - misses0,
                "duration_s": round(report.duration_s, 3),
                "shape": shape,
                "seed": seed,
            }
        )
    knee = locate_knee(rows, knee_factor)
    for r in rows:
        r["knee_rate_img_s"] = knee
        r["knee_factor"] = knee_factor
    return rows


def _mean_images(classes: List[RequestClass]) -> float:
    """Expected images per request under the mix — converts an arrival
    rate (req/s) into offered load (img/s), the knee's unit."""
    wsum = sum(c.weight for c in classes) or 1.0
    total = 0.0
    for c in classes:
        szw = sum(c.size_weights) or 1.0
        mean_sz = sum(s * w for s, w in zip(c.sizes, c.size_weights)) / szw
        total += (c.weight / wsum) * mean_sz
    return total


def saturating_rate(
    journal_path: str,
    classes: List[RequestClass],
    *,
    oversubscribe: float = 1.5,
    batch_efficiency: float = 1.0,
    fallback_img_s: float = 600.0,
    lo_rps: float = 150.0,
    hi_rps: float = 4000.0,
) -> float:
    """Pick a saturating request rate from a capacity probe's measured
    service throughput — the anti-flake of an A/B of the serving
    controller (``BENCH_MODE=control``).

    A FIXED saturating rate cannot survive hosts whose speed varies 3x:
    too low and the controller-off side never burns (the A/B goes
    vacuous), too high and BOTH sides peg at the burn cap. The peg is
    structural, not a tuning artifact: under shed-at-cut overload every
    SERVED request has queue wait near the shed cut, so its end-to-end
    latency violates the SLO too — violation share goes to ~1 as soon
    as the protected class alone saturates. The usable regime is a rate
    whose total offered load oversubscribes capacity while the
    protected class ALONE still fits — there, shedding the unprotected
    classes visibly rescues the protected one (the default mix's
    protected class is ~half the image load, so 1.5x total puts it at
    ~0.75x capacity).

    ``journal_path`` should come from a short SATURATED, SLO-free,
    controller-free probe: with no shed path, every batch runs at the
    service's real (max_batch) batching, so the journal's busy
    throughput (``n_images / batch_ms`` over ``serve_batch`` records)
    IS the capacity — ``batch_efficiency`` stays 1.0. For a CALM probe
    (small batches under-drive the batcher) pass ~1.5. The img/s
    estimate converts to req/s via the mix's expected images/request,
    times ``oversubscribe``, clamped to [lo_rps, hi_rps];
    ``fallback_img_s`` covers a journal with no batches.
    """
    from ..resilience.journal import Journal

    imgs = 0.0
    busy_ms = 0.0
    for r in Journal.load(journal_path):
        if r.get("kind") == "serve_batch" and r.get("batch_ms"):
            imgs += float(r.get("n_images", 0))
            busy_ms += float(r["batch_ms"])
    busy_img_s = imgs / (busy_ms / 1000.0) if busy_ms else fallback_img_s
    cap_img_s = batch_efficiency * busy_img_s
    rate = oversubscribe * cap_img_s / max(_mean_images(classes), 1e-9)
    return min(hi_rps, max(lo_rps, rate))


def correlated_pressure(
    duration_s: float, *, amp: float = 0.9, period_s: Optional[float] = None
) -> str:
    """The fleet-control drill's load shape: one diurnal
    swell whose crest hits EVERY backend at once — deterministic routing
    spreads rids uniformly, so a fleet-wide ramp is per-backend
    correlated pressure, the exact failure mode N uncoordinated
    Autopilots all-degrade under. With the default ``amp=0.9`` the
    crest carries 1.9x the base rate at ``period/2`` and the trough
    ~0.1x — callers size the base at ~0.8x fleet capacity so the crest
    oversubscribes while the protected class alone still fits. Returns
    a ``traffic.parse_shape`` spec string.
    """
    period = duration_s if period_s is None else period_s
    return f"diurnal:amp={amp},period={period}"


def maybe_fleet_pressure(
    rate_rps: float, duration_s: float, *, amp: float = 0.9
) -> Optional[str]:
    """Chaos consumer for the seeded ``fleet_pressure`` site: when the
    site fires, the drill's load becomes a correlated diurnal swell
    (:func:`correlated_pressure`) over the whole window. Returns the
    shape spec to feed ``run_shaped_load``/``http_fleet_load``, or None
    when the site didn't fire (callers keep their calm shape). The
    swell is deterministic per CHAOS_SPEC seed — same discipline as
    every other site."""
    from ..resilience import chaos

    ch = chaos.active()
    if ch is None or not ch.draw("fleet_pressure"):
        return None
    return correlated_pressure(duration_s, amp=amp)
