"""Deadlines: a wall-clock budget handed down to the callee.

The ``Deadline`` of the JAX package's ``resilience/policy.py``, copied. The
port's autotuner runs its sweep under one (``run --deadline-s``): when it
expires, the candidates not yet timed are skipped and the plan says so.
Standard library only.
"""

from __future__ import annotations

import time
from typing import Optional


class Deadline:
    """A monotonic wall-clock budget, propagated callee-ward.

    ``Deadline.after(None)`` is unbounded — every ``remaining()`` query
    returns the caller's cap unchanged, so call sites need no None checks."""

    def __init__(self, expires_at: Optional[float]):
        self._expires_at = expires_at

    @classmethod
    def after(cls, seconds: Optional[float]) -> "Deadline":
        if seconds is None or seconds <= 0:
            return cls(None)
        return cls(time.monotonic() + seconds)

    @property
    def unbounded(self) -> bool:
        return self._expires_at is None

    def remaining(self, cap: Optional[float] = None) -> float:
        """Seconds left (>= 0). With ``cap``, the lesser of budget and cap —
        the per-step timeout a transport should actually use."""
        if self._expires_at is None:
            return float("inf") if cap is None else cap
        left = max(0.0, self._expires_at - time.monotonic())
        return left if cap is None else min(left, cap)

    @property
    def expired(self) -> bool:
        return self._expires_at is not None and time.monotonic() >= self._expires_at
