"""Admission queue: per-request deadlines, FIFO pop, explicit shedding.

The JAX package's ``serving/queue.py``, copied, over the port's
``resilience.policy.Deadline``. Requests enter through
:meth:`AdmissionQueue.submit`, which returns a :class:`RequestHandle` the
caller waits on. The dispatch loop pops FIFO prefixes with
:meth:`AdmissionQueue.pop_ready`, which also returns the requests it sheds:
a shed request always completes its handle with status ``SHED`` and is
handed back for journaling, never silently dropped. Two shed causes
(``Request.shed_reason``): the request's hard deadline expired
(``"deadline"``), or an installed :class:`~.slo.SLOPolicy` ruled its class
SLO blown (``"slo"``).

Saturation is observable before the first shed: :meth:`AdmissionQueue.stats`
returns :class:`QueueStats` with the FIFO head's age (``oldest_wait_ms``),
depth, pending images and per-class depths, the gauges the server mirrors
into the metrics registry each dispatch step.

Standard library and numpy only (no torch import), so tests and the load
generator exercise queue semantics without a device.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..resilience.policy import Deadline

# Terminal request statuses. PENDING is the only non-terminal state; a
# handle's status moves exactly once, under the completing thread.
PENDING = "PENDING"
OK = "OK"
SHED = "SHED"  # deadline expired before dispatch — explicit, journaled
FAILED = "FAILED"  # the dispatch raised


class QueueFull(RuntimeError):
    """Admission refused: backpressure, not silent buffering to OOM."""


class RequestHandle:
    """Caller-facing completion handle for one submitted request."""

    def __init__(self, rid: str, n_images: int, cls: str = ""):
        self.rid = rid
        self.n_images = n_images
        self.cls = cls  # request class ("" = unclassed, never SLO-shed)
        self.status = PENDING
        self.result: Optional[np.ndarray] = None
        self.error = ""
        self.submitted_at = time.monotonic()
        self.completed_at: Optional[float] = None
        self._done = threading.Event()

    def _complete(self, status: str, result=None, error: str = "") -> None:
        self.status = status
        self.result = result
        self.error = error
        self.completed_at = time.monotonic()
        self._done.set()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        return self._done.wait(timeout_s)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def latency_ms(self) -> Optional[float]:
        """submit -> complete wall latency (the user-visible number the
        serve bench reports percentiles of); None while pending."""
        if self.completed_at is None:
            return None
        return (self.completed_at - self.submitted_at) * 1e3


@dataclasses.dataclass
class Request:
    """One queued unit of work: ``x`` is a host-side (n, H, W, C) array."""

    rid: str
    x: np.ndarray
    deadline: Deadline
    handle: RequestHandle
    cls: str = ""  # request class (SLO policy + journal attribution)
    shed_reason: str = ""  # "deadline" | "slo" once shed (journal field)

    @property
    def n_images(self) -> int:
        return int(self.x.shape[0])

    @property
    def waited_ms(self) -> float:
        return (time.monotonic() - self.handle.submitted_at) * 1e3


@dataclasses.dataclass(frozen=True)
class QueueStats:
    """One lock-held snapshot of queue saturation — readable BEFORE the
    first shed (the ``oldest_wait_ms`` gauge is the early-warning number:
    it climbs toward the tightest class SLO while every request is still
    servable)."""

    depth: int  # pending requests
    pending_images: int  # pending work in images (the dispatch unit)
    oldest_wait_ms: float  # age of the FIFO head; 0.0 when empty
    per_class: Dict[str, int]  # pending requests per class name

    def to_obj(self) -> dict:
        return {
            "depth": self.depth,
            "pending_images": self.pending_images,
            "oldest_wait_ms": round(self.oldest_wait_ms, 3),
            "per_class": dict(self.per_class),
        }


class AdmissionQueue:
    """Thread-safe FIFO with bounded depth and deadline/SLO-aware popping.

    ``slo`` is an optional :class:`~.slo.SLOPolicy`: when installed,
    :meth:`pop_ready` also sheds requests whose class SLO is already
    blown by their queue wait (``shed_reason="slo"``) — per-class
    admission control that activates only under saturation."""

    def __init__(self, max_pending: int = 1024, slo=None):
        self.max_pending = max_pending
        self.slo = slo
        self._pending: Deque[Request] = deque()
        self._pending_images = 0
        self._per_class: Dict[str, int] = {}
        self._cv = threading.Condition()
        self._seq = 0

    def __len__(self) -> int:
        with self._cv:
            return len(self._pending)

    def stats(self) -> QueueStats:
        """Saturation gauges under one lock hold (O(1) + per-class dict
        copy); the server mirrors these into the metrics registry."""
        with self._cv:
            oldest = (
                self._pending[0].waited_ms if self._pending else 0.0
            )
            return QueueStats(
                depth=len(self._pending),
                pending_images=self._pending_images,
                oldest_wait_ms=oldest,
                per_class={k: v for k, v in self._per_class.items() if v},
            )

    def submit(
        self,
        x,
        *,
        deadline_s: Optional[float] = None,
        rid: Optional[str] = None,
        cls: str = "",
    ) -> RequestHandle:
        """Admit one request. ``x`` is (H, W, C) or (n, H, W, C); a single
        image is promoted to a 1-batch. Raises :class:`QueueFull` past
        ``max_pending`` — admission control is the caller-visible
        backpressure signal, not an unbounded buffer. ``cls`` names the
        request's traffic class (SLO policy + journal attribution)."""
        x = np.asarray(x)
        if x.ndim == 3:
            x = x[None]
        if x.ndim != 4:
            raise ValueError(f"request input must be (H,W,C) or (n,H,W,C), got {x.shape}")
        with self._cv:
            if len(self._pending) >= self.max_pending:
                raise QueueFull(
                    f"admission queue at max_pending={self.max_pending}"
                )
            self._seq += 1
            rid = rid or f"r{self._seq:06d}"
            handle = RequestHandle(rid, int(x.shape[0]), cls=cls)
            self._pending.append(
                Request(rid, x, Deadline.after(deadline_s), handle, cls=cls)
            )
            self._pending_images += int(x.shape[0])
            self._per_class[cls] = self._per_class.get(cls, 0) + 1
            self._cv.notify_all()
            return handle

    def wait_nonempty(self, timeout_s: float) -> bool:
        """Block until a request is pending (or timeout) — the dispatch
        loop's idle parking spot, so an empty service burns no CPU."""
        with self._cv:
            return self._cv.wait_for(lambda: bool(self._pending), timeout_s)

    def _drop_head(self) -> Request:
        req = self._pending.popleft()
        self._pending_images -= req.n_images
        self._per_class[req.cls] = self._per_class.get(req.cls, 1) - 1
        return req

    def pop_ready(self, max_images: int) -> Tuple[List[Request], List[Request]]:
        """Pop a FIFO prefix of live requests totaling <= ``max_images``
        images, shedding every unservable request encountered on the way:
        hard-deadline expiry (``shed_reason="deadline"``) and, with an
        installed SLO policy, class-SLO blow-out (``shed_reason="slo"`` —
        the request's queue wait already exceeds its class latency
        budget, so dispatching it would only burn a batch slot that
        pushes the next request over too).

        Returns ``(taken, shed)``. Shed handles are completed with status
        ``SHED`` *here* (the caller stops waiting immediately) and the
        requests are returned so the server journals each one — counted,
        attributed, never silently dropped. FIFO order is preserved: the
        first live request that does not fit closes the batch (no
        out-of-order cherry-picking, so no starvation)."""
        taken: List[Request] = []
        shed: List[Request] = []
        images = 0
        with self._cv:
            while self._pending:
                req = self._pending[0]
                if req.deadline.expired:
                    self._drop_head()
                    req.shed_reason = "deadline"
                    req.handle._complete(
                        SHED, error="deadline expired before dispatch"
                    )
                    shed.append(req)
                    continue
                slo_reason = (
                    self.slo.should_shed(req.cls, req.waited_ms)
                    if self.slo is not None
                    else None
                )
                if slo_reason:
                    self._drop_head()
                    req.shed_reason = slo_reason
                    req.handle._complete(
                        SHED,
                        error=(
                            f"class {req.cls or 'default'!r} SLO blown "
                            "before dispatch"
                        ),
                    )
                    shed.append(req)
                    continue
                if images + req.n_images > max_images:
                    break
                self._drop_head()
                taken.append(req)
                images += req.n_images
        return taken, shed
