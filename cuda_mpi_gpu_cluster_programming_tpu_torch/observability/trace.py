"""Span tracing: trace/span/parent ids over the crash-consistent journal.

The JAX package's ``observability/trace.py``, copied:

- :class:`Tracer` owns one ``trace_id`` per run, mints span ids, and
  persists every span as a ``kind="span"`` record in a
  :class:`~..resilience.journal.Journal` (when given one) and in memory.
- :meth:`Tracer.span` is a context manager stacking parent ids per thread;
  :meth:`Tracer.emit` records an explicitly-timed span after the fact.
- :func:`set_tracer` installs a process-wide tracer; :func:`span` and
  :func:`current_ids` are the no-op-when-untraced surface the port's
  autotuner (``tune.layer``, ``tune.candidate``, ``tune.gate`` spans) and
  tolerance gate (trace ids on its journal records) call: an untraced run
  pays one ``None`` check per site.

Timestamps are ``time.monotonic`` readings relative to the tracer's epoch
(``t0_ms``/``dur_ms``). Standard library and ``resilience.journal`` only.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from typing import Dict, Iterator, List, Optional

from ..resilience.journal import Journal


def off_timed_path(fn):
    """Marks a function that is never called inside a timed region (the
    JAX package's decorator of the same name)."""
    fn.__off_timed_path__ = True
    return fn


def _new_hex(rng: random.Random, n: int) -> str:
    return "".join(rng.choice("0123456789abcdef") for _ in range(n))


class Span:
    """Handle yielded by :meth:`Tracer.span`; ``set(**attrs)`` attaches
    result attributes before the span closes (a timed tuning candidate
    records its measured ms on the span that timed it)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs")

    def __init__(self, trace_id: str, span_id: str, parent_id: str, name: str):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs: Dict = {}

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self


class Tracer:
    """One run's trace: a ``trace_id``, a per-thread span stack, and a
    journal the spans persist to. Thread-safe: threads share one tracer,
    each with its own parent stack and a stable small ``tid``."""

    def __init__(
        self,
        journal: Optional[Journal] = None,
        trace_id: Optional[str] = None,
        seed: Optional[int] = None,
    ):
        self._rng = random.Random(
            seed if seed is not None else int.from_bytes(os.urandom(8), "big")
        )
        self.journal = journal
        self.trace_id = trace_id or _new_hex(self._rng, 16)
        self.clock = time.monotonic
        self._epoch = self.clock()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: Dict[int, int] = {}
        self.spans: List[dict] = []  # in-memory mirror (tests, no-journal use)

    # ------------------------------------------------------------- plumbing

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            if ident not in self._tids:
                self._tids[ident] = len(self._tids)
            return self._tids[ident]

    def new_id(self) -> str:
        with self._lock:
            return _new_hex(self._rng, 8)

    def rel_ms(self, t_s: float) -> float:
        """A ``time.monotonic`` reading as ms since the tracer epoch."""
        return (t_s - self._epoch) * 1e3

    @off_timed_path
    def _persist(self, rec: dict) -> None:
        """Journal one completed span — fsync'd, strictly between timed
        regions (the span body already ended when this runs)."""
        self.spans.append(rec)
        if self.journal is not None:
            self.journal.append("span", key=f"span:{rec['span_id']}", **rec)

    # -------------------------------------------------------------- surface

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        """Record the enclosed block as one span. Exceptions are recorded
        as an ``error`` attribute and re-raised — a trace of a failed run
        shows WHERE it failed."""
        stack = self._stack()
        sp = Span(self.trace_id, self.new_id(), stack[-1] if stack else "", name)
        sp.attrs.update(attrs)
        stack.append(sp.span_id)
        t0 = self.clock()
        try:
            yield sp
        except BaseException as e:
            sp.attrs["error"] = f"{type(e).__name__}: {e}"[:200]
            raise
        finally:
            t1 = self.clock()
            stack.pop()
            self._persist(
                {
                    "name": name,
                    "trace_id": self.trace_id,
                    "span_id": sp.span_id,
                    "parent_id": sp.parent_id,
                    "tid": self._tid(),
                    "t0_ms": round(self.rel_ms(t0), 3),
                    "dur_ms": round((t1 - t0) * 1e3, 3),
                    **({"attrs": sp.attrs} if sp.attrs else {}),
                }
            )

    @off_timed_path
    def emit(
        self,
        name: str,
        t0_s: float,
        t1_s: float,
        parent_id: Optional[str] = None,
        track: str = "",
        **attrs,
    ) -> str:
        """Record an explicitly-timed span after the fact (both bounds are
        ``time.monotonic`` readings): measure a timed region first, emit
        its span after it. ``track`` labels an export lane. Returns the
        span id so journal records can carry it."""
        stack = self._stack()
        sid = self.new_id()
        rec = {
            "name": name,
            "trace_id": self.trace_id,
            "span_id": sid,
            "parent_id": (
                parent_id if parent_id is not None else (stack[-1] if stack else "")
            ),
            "tid": self._tid(),
            "t0_ms": round(self.rel_ms(t0_s), 3),
            "dur_ms": round(max(0.0, t1_s - t0_s) * 1e3, 3),
        }
        if track:
            rec["track"] = track
        if attrs:
            rec["attrs"] = attrs
        self._persist(rec)
        return sid

    def current_span_id(self) -> str:
        stack = self._stack()
        return stack[-1] if stack else ""


# ---------------------------------------------------------------- module API

_TRACER: Optional[Tracer] = None


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install the process-wide tracer (None uninstalls); returns the
    previous one so tests can restore it."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def get_tracer() -> Optional[Tracer]:
    return _TRACER


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Optional[Span]]:
    """``with span("sup.trip", kind=...):`` — records on the installed
    tracer, or does nothing (yields None) when tracing is off. The wired
    subsystems call THIS, so an untraced run pays one None check."""
    t = _TRACER
    if t is None:
        yield None
        return
    with t.span(name, **attrs) as sp:
        yield sp


def current_ids() -> Dict[str, str]:
    """``{"trace_id": ..., "span_id": ...}`` of the innermost open span on
    this thread ({} when untraced; no ``span_id`` key outside any span).
    Journal call sites merge this into payloads so existing record schemas
    gain correlation without changing shape for old tooling."""
    t = _TRACER
    if t is None:
        return {}
    ids = {"trace_id": t.trace_id}
    sid = t.current_span_id()
    if sid:
        ids["span_id"] = sid
    return ids
