"""SLO-aware admission: per-class latency targets and shed-by-class.

The JAX package's ``serving/slo.py``, copied. A queue that sheds by age
alone drops a bulk job and an interactive query at the same age, although
one has seconds of budget and the other milliseconds. This module adds the
class:

- :class:`SLOClass` names a request class, its latency SLO (``slo_ms``,
  the p99 target) and its default hard deadline. ``shed_wait_ms``
  (default: the SLO itself) is the queue wait past which dispatching the
  request wastes capacity: it can no longer meet its SLO, and its batch
  slot pushes the next request over too.
- :class:`SLOPolicy` is the queue's pop-time hook
  (:meth:`AdmissionQueue.pop_ready`): ``should_shed(cls, waited_ms)``
  returns ``"slo"`` when a request's wait has blown its class budget. Each
  class carries its own threshold, so saturation sheds the tight classes
  first while loose ones still complete. Idle queues never trigger it.

Every policy shed completes the handle with status ``SHED`` and is
journaled (``serve_shed`` with ``cls``, ``reason="slo"``, ``waited_ms``),
as a deadline shed is (``reason="deadline"``).

Standard library only: the queue layer imports neither torch nor numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

# The class name requests fall into when the submitter names none; its SLO
# is unbounded, so an un-classed request is never SLO-shed.
DEFAULT_CLASS = ""


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One request class's operating targets."""

    name: str
    slo_ms: float  # p99 latency target (0 = unbounded: never SLO-shed)
    deadline_s: Optional[float] = None  # class default hard deadline
    # Queue-wait past which the request is shed as unservable within its
    # SLO; defaults to slo_ms (a request that already waited its whole
    # latency budget cannot meet it, dispatch time still to come).
    shed_wait_ms: Optional[float] = None

    @property
    def shed_cut_ms(self) -> float:
        cut = self.shed_wait_ms if self.shed_wait_ms is not None else self.slo_ms
        return float(cut or 0.0)

    def to_obj(self) -> dict:
        return {
            "name": self.name,
            "slo_ms": self.slo_ms,
            "deadline_s": self.deadline_s,
            "shed_wait_ms": self.shed_cut_ms or None,
        }

    @staticmethod
    def from_obj(obj: dict) -> "SLOClass":
        """Inverse of :meth:`to_obj` — the ``serve_config`` journal record
        round-trip ``observability.replay`` rebuilds a recorded run's
        admission policy from."""
        return SLOClass(
            name=str(obj.get("name", "")),
            slo_ms=float(obj.get("slo_ms") or 0.0),
            deadline_s=(
                float(obj["deadline_s"])
                if obj.get("deadline_s") is not None
                else None
            ),
            shed_wait_ms=(
                float(obj["shed_wait_ms"])
                if obj.get("shed_wait_ms") is not None
                else None
            ),
        )

    def scaled(self, factor: float) -> "SLOClass":
        """This class with every latency budget scaled by ``factor`` — the
        replay harness's ``--slo-scale`` what-if knob (0.5 = 'would the
        run hold with SLOs twice as tight?'). Unbounded budgets (0 /
        None) stay unbounded: scaling cannot invent a ceiling."""
        return SLOClass(
            name=self.name,
            slo_ms=self.slo_ms * factor if self.slo_ms else self.slo_ms,
            deadline_s=(
                self.deadline_s * factor
                if self.deadline_s is not None
                else None
            ),
            shed_wait_ms=(
                self.shed_wait_ms * factor
                if self.shed_wait_ms
                else self.shed_wait_ms
            ),
        )


class SLOPolicy:
    """Per-class shed policy the queue consults at pop time.

    Unknown class names resolve to ``default`` (unbounded unless given) —
    a request the submitter never classified is served exactly like a
    request under hard deadlines alone, never SLO-shed.
    """

    def __init__(
        self,
        classes: Sequence[SLOClass],
        default: Optional[SLOClass] = None,
    ):
        self.classes: Dict[str, SLOClass] = {c.name: c for c in classes}
        self.default = default or SLOClass(DEFAULT_CLASS, slo_ms=0.0)

    def class_for(self, name: str) -> SLOClass:
        return self.classes.get(name, self.default)

    def deadline_for(self, name: str) -> Optional[float]:
        """The class's default hard deadline (an explicit per-request
        deadline always wins — resolution happens at submit)."""
        return self.class_for(name).deadline_s

    def should_shed(self, cls: str, waited_ms: float) -> Optional[str]:
        """``"slo"`` when the request's queue wait has blown its class
        budget (completing it would only burn a batch slot that pushes
        the *next* request over), else None. Hard-deadline expiry is the
        queue's own check, journaled ``reason="deadline"``."""
        cut = self.class_for(cls).shed_cut_ms
        if cut and waited_ms > cut:
            return "slo"
        return None

    def to_obj(self) -> dict:
        return {
            "classes": [c.to_obj() for c in self.classes.values()],
            "default": self.default.to_obj(),
        }

    @staticmethod
    def from_obj(obj: dict) -> "SLOPolicy":
        """Inverse of :meth:`to_obj` (the ``serve_config`` round-trip)."""
        return SLOPolicy(
            [SLOClass.from_obj(c) for c in obj.get("classes") or []],
            default=(
                SLOClass.from_obj(obj["default"])
                if obj.get("default")
                else None
            ),
        )

    def scaled(self, factor: float) -> "SLOPolicy":
        """Every class budget scaled by ``factor`` (replay ``--slo-scale``)."""
        return SLOPolicy(
            [c.scaled(factor) for c in self.classes.values()],
            default=self.default.scaled(factor),
        )

    def tightened(self, name: str, shed_wait_ms: float) -> "SLOPolicy":
        """This policy with ``name``'s pop-time shed cut replaced — the
        serving controller's admission-tightening actuation.
        Only ``shed_wait_ms`` moves: the class's SLO target and deadline
        are product contracts the controller must never rewrite, and the
        burn it steers by stays priced against them. A class the policy
        does not know is added (an unbounded class gains its first
        finite cut this way — bulk under pressure)."""
        cur = self.class_for(name)
        new = dataclasses.replace(
            cur, name=name, shed_wait_ms=float(shed_wait_ms)
        )
        classes = [
            new if c.name == name else c for c in self.classes.values()
        ]
        if name not in self.classes:
            classes.append(new)
        return SLOPolicy(classes, default=self.default)
