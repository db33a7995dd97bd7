"""Retry with bounded backoff, deadlines, fault logs and the degradation
chain walker.

The JAX package's ``resilience/policy.py``, copied:

- ``Deadline``: a wall-clock budget handed down to the callee. The port's
  autotuner runs its sweep under one (``run --deadline-s``), the bench its
  retries (``BENCH_DEADLINE_S``).
- ``RetryPolicy``: exponential backoff with deterministic jitter, seeded
  per (seed, attempt), so one policy always gives one schedule, number for
  number the JAX package's. The bench's ``BENCH_MAX_RETRIES`` and
  ``BENCH_RETRY_BACKOFF`` set one.
- ``Attempt``/``FaultLog``: the per-site trail of attempts; ``summary()``
  is the string a bench row carries under ``resilience``.
- ``retry_call``: call until it returns, within the policy and deadline;
  ``run --max-retries`` wraps each tier's build and first pass in it.
- ``Degrader``, ``DegradedEvent``, ``DegradationExhausted``: walk an
  ordered fallback chain, printing each step as ``DEGRADED(a -> b): cause``;
  ``tier_fallback_chain`` is ``run --fallback-chain auto``'s chain, from the
  JAX package's whole fallback table (keys the port has no config for yet
  are data only).

Standard library only.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, List, Optional, Sequence, Tuple

# Triage status of a run that succeeded only on a lower tier: a warning,
# not a failure, but never mistaken for the tier that was asked for.
DEGRADED = "DEGRADED"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with bounded, deterministic jitter.

    ``max_retries`` counts ADDITIONAL attempts after the first (0 = run
    once). ``delay_s(k)`` is the pause before retry k (k >= 1):
    ``base * backoff**(k-1)`` capped at ``max_delay_s``, then jittered by
    ±``jitter`` fraction using a RNG seeded from (seed, k)."""

    max_retries: int = 0
    base_delay_s: float = 0.5
    backoff: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.1
    seed: int = 0

    def delay_s(self, attempt: int) -> float:
        if attempt < 1:
            return 0.0
        d = min(self.max_delay_s, self.base_delay_s * self.backoff ** (attempt - 1))
        if self.jitter:
            r = random.Random(f"{self.seed}:{attempt}")
            d *= 1.0 + self.jitter * (2.0 * r.random() - 1.0)
        return max(0.0, d)


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


@dataclasses.dataclass
class Attempt:
    """One try at a site: what happened and how long it took."""

    attempt: int  # 0-based
    outcome: str  # "ok" | "retry" | "fail"
    cause: str = ""
    duration_s: float = 0.0
    backoff_s: float = 0.0  # pause taken AFTER this attempt (0 on the last)


@dataclasses.dataclass
class FaultLog:
    """Per-site attempt trail. ``summary()`` is the compact string a bench
    row carries (empty when nothing was retried)."""

    site: str = ""
    attempts: List[Attempt] = dataclasses.field(default_factory=list)

    def record(self, outcome: str, cause: str = "", duration_s: float = 0.0,
               backoff_s: float = 0.0) -> Attempt:
        a = Attempt(len(self.attempts), outcome, cause, duration_s, backoff_s)
        self.attempts.append(a)
        return a

    @property
    def n_attempts(self) -> int:
        return len(self.attempts)

    @property
    def retried(self) -> bool:
        return len(self.attempts) > 1

    def summary(self) -> str:
        if not self.retried:
            return ""
        causes = [a.cause for a in self.attempts[:-1] if a.cause]
        last = self.attempts[-1]
        tail = last.cause if last.outcome != "ok" else "ok"
        return f"retried x{len(self.attempts) - 1} ({'; '.join(causes)[:120]}) -> {tail}"


def retry_call(
    fn: Callable[[], object],
    *,
    policy: RetryPolicy,
    deadline: Optional[Deadline] = None,
    retry_on: Callable[[BaseException], bool] = lambda e: True,
    fault_log: Optional[FaultLog] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn`` until it returns, retrying per ``policy`` on exceptions
    ``retry_on`` accepts, never outliving ``deadline``. The last exception
    propagates when the budget is exhausted; ``fault_log`` carries the
    per-attempt trail either way."""
    deadline = deadline or Deadline.after(None)
    log = fault_log if fault_log is not None else FaultLog()
    for attempt in range(policy.max_retries + 1):
        t0 = time.monotonic()
        try:
            out = fn()
        except Exception as e:  # re-raised below once the budget is spent
            cause = f"{type(e).__name__}: {e}"[:160]
            if attempt >= policy.max_retries or deadline.expired or not retry_on(e):
                log.record("fail", cause, time.monotonic() - t0)
                raise
            pause = min(policy.delay_s(attempt + 1), deadline.remaining())
            log.record("retry", cause, time.monotonic() - t0, backoff_s=pause)
            if pause > 0:
                sleep(pause)
            continue
        log.record("ok", duration_s=time.monotonic() - t0)
        return out
    raise AssertionError("unreachable: the last attempt returns or raises")


@dataclasses.dataclass(frozen=True)
class DegradedEvent:
    """One fallback step: emitted and logged, never silently swallowed."""

    from_tier: str
    to_tier: str
    cause: str

    def __str__(self) -> str:
        return f"DEGRADED({self.from_tier} -> {self.to_tier}): {self.cause}"


class DegradationExhausted(RuntimeError):
    """Every tier in the chain failed; carries the events and the last cause."""

    def __init__(self, chain: Sequence[str], events: Sequence[DegradedEvent], last: BaseException):
        super().__init__(
            f"all {len(chain)} tiers failed ({' -> '.join(chain)}); last: {type(last).__name__}: {last}"
        )
        self.chain = list(chain)
        self.events = list(events)
        self.last = last


class Degrader:
    """Walk an ordered fallback chain, emitting ``DEGRADED`` events.

    ``run(build)`` calls ``build(tier)`` for each tier in order and returns
    ``(tier, result)`` from the first that succeeds. A failure that
    ``should_degrade`` rejects re-raises at once (a genuine bug must not be
    papered over by a cheaper tier); an accepted one emits a
    ``DegradedEvent`` and falls through. Per-tier retries compose by passing
    a ``build`` wrapped in ``retry_call``."""

    def __init__(
        self,
        chain: Sequence[str],
        should_degrade: Optional[Callable[[BaseException], bool]] = None,
        on_event: Optional[Callable[[DegradedEvent], None]] = None,
    ):
        if not chain:
            raise ValueError("Degrader needs a non-empty fallback chain")
        self.chain = list(chain)
        self.should_degrade = should_degrade
        self.on_event = on_event
        self.events: List[DegradedEvent] = []

    @property
    def degraded(self) -> bool:
        return bool(self.events)

    def run(self, build: Callable[[str], object]) -> Tuple[str, object]:
        last: Optional[BaseException] = None
        for i, tier in enumerate(self.chain):
            try:
                return tier, build(tier)
            except Exception as e:  # re-raised per policy below
                if self.should_degrade is not None and not self.should_degrade(e):
                    raise
                last = e
                if i + 1 == len(self.chain):
                    break
                ev = DegradedEvent(tier, self.chain[i + 1], f"{type(e).__name__}: {e}"[:200])
                self.events.append(ev)
                if self.on_event is not None:
                    self.on_event(ev)
        raise DegradationExhausted(self.chain, self.events, last) from last


# Each config's next-cheaper sibling, ending at a single-device library-op
# tier: the JAX package's table, kept as data. The sharded tiers drop their
# kernels and staging first, then the mesh; the kernel tiers drop to the
# library ops (a kernel build or launch fault).
_FALLBACK_NEXT = {
    "v5_collective": "v4_hybrid",
    "v4_hybrid": "v2.2_sharded",
    "v2.2_sharded": "v1_jit",
    "v2.1_replicated": "v1_jit",
    "v7_tp": "v2.2_sharded",
    "v3_pallas": "v1_jit",
    "v6_full_pallas": "v6_full_jit",
    "v6_full_sharded": "v6_full_jit",
}


def tier_fallback_chain(config_key: str) -> List[str]:
    """``--fallback-chain auto`` for a config: the config itself, then every
    next-cheaper tier down to the single-device library-op floor."""
    chain = [config_key]
    while chain[-1] in _FALLBACK_NEXT:
        chain.append(_FALLBACK_NEXT[chain[-1]])
    return chain
