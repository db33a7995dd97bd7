"""Observability: journal-correlated tracing, a metrics registry, per-stage
attribution, the roofline, journal replay, the regression gate, the health
folds and the Perfetto export (the JAX package's ``observability``).

- ``trace``: spans with trace/span/parent ids persisted through the journal.
- ``metrics``: process-wide counters, gauges and histograms (nearest-rank).
- ``stages``, ``roofline``, ``specs``: per-stage attribution of the forward
  and its MFU / HBM-traffic verdicts against the device spec.
- ``replay``: a recorded serve journal re-driven through a live server.
- ``gate``: the cross-run ``BENCH_r*.json`` regression gate.
- ``health``: incidents, availability, SLO attainment and compile
  attribution folded from any journal.
- ``export``: spans and journal records stitched into one Perfetto timeline.

CLI: ``python -m cuda_mpi_gpu_cluster_programming_tpu_torch.observability
export|report|replay|roofline|health`` (``__main__.py``). The package
re-exports only the import-light tracing and metrics surface.
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, registry
from .trace import Span, Tracer, current_ids, get_tracer, set_tracer, span

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "Span",
    "Tracer",
    "current_ids",
    "get_tracer",
    "set_tracer",
    "span",
]
