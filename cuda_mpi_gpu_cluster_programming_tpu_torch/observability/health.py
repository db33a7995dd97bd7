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

The journal folds over these records (incidents, availability, SLO
attainment, compile attribution, ``health_from_journal``) wait for ROADMAP
Queue 1 item 8. Standard library only.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from .trace import off_timed_path


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
