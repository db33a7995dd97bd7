"""Traffic-shaped load: diurnal ramps, bursts, flash crowds, class mixes.

The JAX package's ``serving/traffic.py``, copied: its seeded draws give the
same arrivals and classes for the same seed. A single homogeneous Poisson
stream of 1-image requests is nothing like production traffic, which
breathes (diurnal ramps), spikes (bursts, flash crowds) and mixes request
classes whose sizes are heavy-tailed. This module generates those shapes,
seeded and deterministic:

- :func:`shaped_arrivals` turns a shape spec (``"steady"``,
  ``"diurnal"``, ``"burst"``, ``"flash"``, composable with ``+``:
  ``"diurnal+burst"``) into sorted arrival offsets. Diurnal is an
  inhomogeneous Poisson process by thinning (the rate swings by ``amp``
  around the base over ``period`` seconds, from the trough); burst adds a
  ``mult``x clump of arrivals every ``every`` seconds; flash adds one
  ``mult``x crowd at ``at`` x duration.
- :class:`RequestClass` couples a mix weight, a heavy-tailed size
  distribution over the bucket set, and the class's deadline and SLO
  target; :func:`default_class_mix` is the interactive/batch/bulk triple;
  :func:`assign_classes` deals a seeded class per arrival.
- :class:`ShapedReport` and :class:`ClassStats` carry per-class accounting
  that must close per class (``ok + shed + failed + rejected == offered``)
  and per-class nearest-rank p50/p99.

Standard library only (no torch import), as ``queue`` and ``loadgen``.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from .slo import SLOClass, SLOPolicy


# ------------------------------------------------------------- shapes ---


@dataclasses.dataclass(frozen=True)
class TrafficShape:
    """One parsed shape component (see :func:`parse_shape`)."""

    kind: str  # steady | diurnal | burst | flash
    params: Tuple[Tuple[str, float], ...] = ()

    def param(self, name: str, default: float) -> float:
        return dict(self.params).get(name, default)


_SHAPE_KINDS = ("steady", "diurnal", "burst", "flash")


def parse_shape(spec: str) -> List[TrafficShape]:
    """``"diurnal:amp=0.8,period=4+burst:every=2,mult=5"`` -> components.

    Unknown kinds/params raise — a typo'd drill spec must fail loudly,
    not silently run a steady load labeled diurnal (the chaos
    KNOWN_SITES rule applied to traffic)."""
    comps: List[TrafficShape] = []
    for part in (spec or "steady").split("+"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition(":")
        kind = kind.strip()
        if kind not in _SHAPE_KINDS:
            raise ValueError(
                f"unknown traffic shape {kind!r} (valid: {', '.join(_SHAPE_KINDS)})"
            )
        params = []
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            try:
                params.append((k.strip(), float(v)))
            except ValueError:
                raise ValueError(
                    f"traffic shape param {kv!r} is not key=number"
                ) from None
        comps.append(TrafficShape(kind, tuple(params)))
    return comps or [TrafficShape("steady")]


def _steady(rng: random.Random, rate: float, duration: float) -> List[float]:
    t, out = 0.0, []
    while True:
        t += rng.expovariate(rate)
        if t >= duration:
            return out
        out.append(t)


def shaped_arrivals(
    shape, rate_rps: float, duration_s: float, seed: int = 0
) -> List[float]:
    """Sorted arrival offsets for a shape spec (string or parsed list).

    The FIRST component carries the base load at ``rate_rps``; burst/
    flash components after it ADD their spikes on top (so
    ``"diurnal+burst"`` is a breathing base with clumps riding it). A
    burst/flash listed first still gets a steady base underneath — a
    flash crowd arrives *on top of* normal traffic, not instead of it.
    """
    comps = parse_shape(shape) if isinstance(shape, str) else list(shape)
    if rate_rps <= 0 or duration_s <= 0:
        return []
    rng = random.Random(f"traffic:{seed}")
    out: List[float] = []
    base_done = False
    for comp in comps:
        if comp.kind == "steady":
            out.extend(_steady(rng, rate_rps, duration_s))
            base_done = True
        elif comp.kind == "diurnal":
            # Inhomogeneous Poisson by thinning: rate(t) swings ±amp
            # around base over one period, phased to START at the trough
            # so the window ramps up like a morning.
            amp = min(0.99, max(0.0, comp.param("amp", 0.6)))
            period = comp.param("period", duration_s)
            rmax = rate_rps * (1.0 + amp)
            t = 0.0
            while True:
                t += rng.expovariate(rmax)
                if t >= duration_s:
                    break
                r_t = rate_rps * (
                    1.0 + amp * math.sin(2 * math.pi * t / period - math.pi / 2)
                )
                if rng.random() < r_t / rmax:
                    out.append(t)
            base_done = True
        elif comp.kind == "burst":
            if not base_done:
                out.extend(_steady(rng, rate_rps, duration_s))
                base_done = True
            every = max(1e-3, comp.param("every", max(duration_s / 2, 1e-3)))
            width = comp.param("width", min(0.2, every / 4))
            mult = comp.param("mult", 4.0)
            t0 = every
            while t0 < duration_s:
                out.extend(
                    t0 + a for a in _steady(rng, rate_rps * mult, width)
                )
                t0 += every
        elif comp.kind == "flash":
            if not base_done:
                out.extend(_steady(rng, rate_rps, duration_s))
                base_done = True
            at = comp.param("at", 0.5) * duration_s
            width = comp.param("width", max(duration_s * 0.1, 1e-3))
            mult = comp.param("mult", 8.0)
            out.extend(
                min(at + a, duration_s - 1e-9)
                for a in _steady(rng, rate_rps * mult, width)
            )
    return sorted(out)


# -------------------------------------------------------- class mixes ---


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One traffic class: mix weight, size distribution, deadline, SLO."""

    name: str
    weight: float  # mix probability mass (normalized across the mix)
    sizes: Tuple[int, ...]  # n_images per request, drawn from these
    size_weights: Tuple[float, ...]  # heavy-tailed over ``sizes``
    deadline_s: Optional[float]  # hard deadline (shed reason="deadline")
    slo_ms: float  # latency target (shed reason="slo" once blown)

    def slo_class(self) -> SLOClass:
        return SLOClass(self.name, slo_ms=self.slo_ms, deadline_s=self.deadline_s)


def default_class_mix(
    buckets: Sequence[int],
    *,
    interactive_slo_ms: float = 1000.0,
    batch_slo_ms: float = 5000.0,
    bulk_slo_ms: float = 0.0,
) -> Tuple[RequestClass, ...]:
    """The canonical three-class mix over a bucket set: a heavy head of
    1-image interactive calls with a tight SLO, a middle of multi-image
    batch calls, and a thin tail of largest-bucket bulk requests with no
    SLO (shed last, by hard deadline only). Sizes within a class are
    weighted ~1/n — the heavy-tailed request-size reality that makes a
    fixed bucket set earn its keep."""
    bs = sorted(set(int(b) for b in buckets))
    mid = [b for b in bs if 1 < b < bs[-1]] or bs[:1]
    return (
        RequestClass(
            "interactive", 0.7, (1,), (1.0,),
            deadline_s=interactive_slo_ms * 4 / 1e3, slo_ms=interactive_slo_ms,
        ),
        RequestClass(
            "batch", 0.25, tuple(mid), tuple(1.0 / b for b in mid),
            deadline_s=batch_slo_ms * 4 / 1e3, slo_ms=batch_slo_ms,
        ),
        RequestClass(
            "bulk", 0.05, (bs[-1],), (1.0,),
            deadline_s=None, slo_ms=bulk_slo_ms,
        ),
    )


def slo_policy(classes: Sequence[RequestClass]) -> SLOPolicy:
    """The admission policy a class mix implies (shed-by-class)."""
    return SLOPolicy([c.slo_class() for c in classes])


def assign_classes(
    classes: Sequence[RequestClass], n: int, seed: int = 0
) -> List[Tuple[RequestClass, int]]:
    """Seeded per-arrival (class, n_images) assignments — the same
    deterministic-schedule rule as the arrival offsets, so two runs at
    one seed offer byte-identical work."""
    rng = random.Random(f"classes:{seed}")
    weights = [c.weight for c in classes]
    out: List[Tuple[RequestClass, int]] = []
    for _ in range(n):
        c = rng.choices(list(classes), weights=weights)[0]
        size = rng.choices(list(c.sizes), weights=list(c.size_weights))[0]
        out.append((c, int(size)))
    return out


# ---------------------------------------------------------- accounting ---


def _fmt_ms(v: Optional[float]) -> str:
    return f"{v:.3f}" if v is not None else "nan"


@dataclasses.dataclass
class ClassStats:
    """One class's closed accounting + latency percentiles."""

    offered: int = 0
    ok: int = 0
    shed: int = 0
    failed: int = 0
    rejected: int = 0
    images_ok: int = 0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)

    @property
    def closed(self) -> bool:
        return self.ok + self.shed + self.failed + self.rejected == self.offered

    def percentile(self, q: float) -> Optional[float]:
        from .loadgen import percentile  # local: avoid a module cycle

        return percentile(self.latencies_ms, q)

    def to_obj(self) -> dict:
        p50, p99 = self.percentile(50), self.percentile(99)
        return {
            "offered": self.offered, "ok": self.ok, "shed": self.shed,
            "failed": self.failed, "rejected": self.rejected,
            "p50_ms": round(p50, 3) if p50 is not None else None,
            "p99_ms": round(p99, 3) if p99 is not None else None,
        }


@dataclasses.dataclass
class ShapedReport:
    """One shaped load run's verdict, per class and total."""

    shape: str
    per_class: Dict[str, ClassStats]
    duration_s: float = 0.0
    sustained_img_s: float = 0.0

    def _total(self, field: str) -> int:
        return sum(getattr(c, field) for c in self.per_class.values())

    @property
    def n_requests(self) -> int:
        return self._total("offered")

    @property
    def n_ok(self) -> int:
        return self._total("ok")

    @property
    def n_shed(self) -> int:
        return self._total("shed")

    @property
    def n_failed(self) -> int:
        return self._total("failed")

    @property
    def n_rejected(self) -> int:
        return self._total("rejected")

    @property
    def closed(self) -> bool:
        """Accounting closes for EVERY class, not just in aggregate —
        a lost bulk request cannot hide behind a surplus interactive one."""
        return all(c.closed for c in self.per_class.values())

    def all_latencies(self) -> List[float]:
        out: List[float] = []
        for c in self.per_class.values():
            out.extend(c.latencies_ms)
        return out

    def summary(self) -> str:
        """Machine-parseable 'Serve load:' payload (run CLI contract)."""
        from .loadgen import percentile

        lat = self.all_latencies()
        p50, p99 = percentile(lat, 50), percentile(lat, 99)
        return (
            f"shape={self.shape} reqs={self.n_requests} ok={self.n_ok} "
            f"shed={self.n_shed} failed={self.n_failed} "
            f"rejected={self.n_rejected} "
            f"p50_ms={_fmt_ms(p50)} p99_ms={_fmt_ms(p99)} "
            f"img_s={self.sustained_img_s:.1f} wall_s={self.duration_s:.2f}"
        )

    def class_lines(self) -> List[str]:
        """One machine-parseable 'Serve class:' line per class."""
        out = []
        for name in sorted(self.per_class):
            c = self.per_class[name]
            out.append(
                f"Serve class: name={name or 'default'} offered={c.offered} "
                f"ok={c.ok} shed={c.shed} failed={c.failed} "
                f"rejected={c.rejected} p50_ms={_fmt_ms(c.percentile(50))} "
                f"p99_ms={_fmt_ms(c.percentile(99))}"
            )
        return out

    def to_obj(self) -> dict:
        return {
            "shape": self.shape,
            "classes": {
                (n or "default"): c.to_obj() for n, c in self.per_class.items()
            },
            "accounting_closed": self.closed,
        }
