"""Process-wide metrics registry: counters, gauges, histograms.

The JAX package's ``observability/metrics.py``, copied (the port imports
nothing of that package):

- :class:`Counter` (monotonic ``inc``), :class:`Gauge` (last ``set``
  wins), :class:`Histogram` (``observe`` and nearest-rank p50/p99 by
  :func:`nearest_rank`, the JAX package's serving estimator, so a metrics
  percentile and a bench percentile of one stream agree).
- :meth:`MetricsRegistry.snapshot`/:meth:`~MetricsRegistry.summary` are the
  dicts a bench row or CLI summary embeds; :meth:`~MetricsRegistry.export`
  writes one JSON line per metric through ``resilience.journal``'s atomic
  write (readers see the old complete export or the new one);
  :meth:`~MetricsRegistry.prometheus` the text exposition.

Registration and observation are thread-safe. Observing inside a timed
region costs a lock per call: record after the region, as the bench does.
Standard library and ``resilience.journal`` only.
"""

from __future__ import annotations

import json
import math
import re
import threading
from typing import Dict, List, Optional

from ..resilience.journal import atomic_write_text

# Prometheus metric-name grammar: [a-zA-Z_:][a-zA-Z0-9_:]* — the dotted
# registry names ("serve.ok") sanitize to underscores ("serve_ok").
_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    pname = _PROM_BAD.sub("_", name)
    return pname if not pname[:1].isdigit() else f"_{pname}"


def nearest_rank(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on empty input. The JAX
    package's serving estimator (``serving.loadgen.percentile``): small
    samples report an observed value, never an interpolated one."""
    if not xs:
        return None
    s = sorted(xs)
    if q <= 0:
        return s[0]
    rank = math.ceil(q / 100.0 * len(s))
    return s[min(max(rank, 1), len(s)) - 1]


class Counter:
    """Monotonic event count."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def to_obj(self) -> dict:
        return {"name": self.name, "type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def to_obj(self) -> dict:
        return {"name": self.name, "type": "gauge", "value": self.value}


class Histogram:
    """Value stream with nearest-rank percentiles. Keeps up to ``cap``
    observations (newest win — a bounded reservoir so a week-long serve
    process cannot grow without bound); count/sum stay exact."""

    def __init__(self, name: str, cap: int = 65536):
        self.name = name
        self.cap = cap
        self.count = 0
        self.sum = 0.0
        self._values: List[float] = []
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self._values.append(v)
            if len(self._values) > self.cap:
                del self._values[: len(self._values) - self.cap]

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            vals = list(self._values)
        return nearest_rank(vals, q)

    def to_obj(self) -> dict:
        p50, p99 = self.percentile(50), self.percentile(99)
        return {
            "name": self.name,
            "type": "histogram",
            "count": self.count,
            "sum": round(self.sum, 4),
            "mean": round(self.sum / self.count, 4) if self.count else None,
            "p50": round(p50, 4) if p50 is not None else None,
            "p99": round(p99, 4) if p99 is not None else None,
        }


class MetricsRegistry:
    """Named metrics, one instance per process (module-level
    :func:`registry`); ``counter``/``gauge``/``histogram`` create on first
    use and return the existing instrument after — a name can hold exactly
    one instrument type (mixing is a bug worth failing loudly on)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, cap: int = 65536) -> Histogram:
        return self._get(name, Histogram, cap=cap)

    def snapshot(self) -> Dict[str, dict]:
        """{name: instrument.to_obj()} for every registered metric."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.to_obj() for name, m in sorted(items)}

    def summary(self) -> Dict[str, object]:
        """The compact form the bench row embeds: counters/gauges as bare
        values, histograms as {count, mean, p50, p99}."""
        out: Dict[str, object] = {}
        for name, obj in self.snapshot().items():
            if obj["type"] == "histogram":
                out[name] = {
                    k: obj[k] for k in ("count", "mean", "p50", "p99")
                }
            else:
                out[name] = obj["value"]
        return out

    def export(self, path) -> None:
        """Atomic JSONL export: one JSON object per metric (tmp-write,
        fsync, rename: the journal module's ``atomic_write_text``)."""
        lines = [json.dumps(obj) for _name, obj in sorted(self.snapshot().items())]
        atomic_write_text(path, "\n".join(lines) + ("\n" if lines else ""))

    def prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every registered
        metric. Counters/gauges map directly; histograms expose as
        summaries (p50/p99 quantile samples plus ``_sum``/``_count``, the
        same nearest-rank percentiles). Metric names sanitize ``.`` to
        ``_`` per the exposition grammar."""
        lines: List[str] = []
        for name, obj in self.snapshot().items():
            pname = _prom_name(name)
            if obj["type"] == "counter":
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {obj['value']}")
            elif obj["type"] == "gauge":
                lines.append(f"# TYPE {pname} gauge")
                v = obj["value"]
                lines.append(f"{pname} {v if v is not None else 'NaN'}")
            else:  # histogram -> summary
                lines.append(f"# TYPE {pname} summary")
                for q, key in (("0.5", "p50"), ("0.99", "p99")):
                    if obj.get(key) is not None:
                        lines.append(f'{pname}{{quantile="{q}"}} {obj[key]}')
                lines.append(f"{pname}_sum {obj['sum']}")
                lines.append(f"{pname}_count {obj['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every wired subsystem records into."""
    return _REGISTRY
