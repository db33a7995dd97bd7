"""Wall-clock timing of a forward callable, fenced on the device.

PyTorch returns before the card finishes, so a host clock measures the
enqueue unless the run ends in ``torch.cuda.synchronize()``: that is the
fence here (the JAX package fences with a device-to-host scalar fetch).
The estimator is the JAX package's: enqueue a short and a long chain of
calls, fence each, and difference them so the fixed cost of the fence
cancels; repeat the pair until the median's spread is resolved.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, List, Optional

import torch

# A long chain must accumulate at least this much measured wall time on a
# GPU, so one pair is not dominated by launch and fence jitter. A CPU run
# is synchronous and gets no floor.
GPU_WORK_FLOOR_MS = 50.0


def _tensors(args) -> List[torch.Tensor]:
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, dict):
            out.extend(_tensors(a.values()))
    return out


def fence(device: torch.device) -> None:
    """Wait until every call enqueued on ``device`` has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class AmortizedStats:
    """Result of :func:`amortized_stats`: per-call estimates plus the
    chain length and measured time behind them."""

    samples_ms: List[float]   # independent per-call estimates, one per repeat
    n_chain: int              # chain length the estimates were taken at
    shadowed: bool            # True = fence-shadowed upper bound, not a difference
    total_measured_s: float   # wall time accumulated across all measurement runs
    underconverged: bool = False  # ended below min_samples after discarding pairs

    @property
    def per_call_ms(self) -> float:
        return max(1e-3, statistics.median(self.samples_ms))

    @property
    def n_samples(self) -> int:
        return len(self.samples_ms)

    @property
    def stdev_ms(self) -> float:
        return statistics.stdev(self.samples_ms) if len(self.samples_ms) > 1 else 0.0

    @property
    def ci95_ms(self) -> float:
        """Half-width of a 95% CI on the median, MAD-based:
        sigma ≈ 1.4826·MAD; Var(median) ≈ (π/2)·σ²/n."""
        if len(self.samples_ms) < 2:
            return 0.0
        med = statistics.median(self.samples_ms)
        mad = statistics.median([abs(s - med) for s in self.samples_ms])
        sigma = 1.4826 * mad
        return 1.96 * sigma * (1.5707963267948966 / len(self.samples_ms)) ** 0.5


def amortized_stats(
    fn: Callable, *args: Any, n_small: int = 10, n_large: int = 110,
    max_chain: int = 4096, work_floor_ms: Optional[float] = None,
    min_samples: int = 3, max_samples: int = 15, lockstep: bool = False,
) -> AmortizedStats:
    """Per-call wall time of ``fn(*args)``:

        per_call = (T(n_large) - T(n_small)) / (n_large - n_small)

    with each T a chain of calls ended by the device fence. On a GPU the
    chain grows until the long run clearly dominates the short one and
    accumulates ``work_floor_ms`` (default :data:`GPU_WORK_FLOOR_MS`); if
    even ``max_chain`` calls cannot escape the fence's shadow, the
    conservative T(n)/n is returned with ``shadowed`` set. The pair is then
    re-measured until ci95 < 5% of the median or ``max_samples``. The CPU
    runs each call synchronously, so its work is fixed whatever the host's
    load: the chain stays at ``n_large`` (a long run under 1.5x the short
    one is a preempted short run, not a fence's shadow: T(n_large)/n_large
    is returned, ``shadowed``) and ``min_samples`` pairs are drawn.

    ``lockstep``: the number of calls is fixed before the first, whatever
    the clocks read (the ranks of a process group, whose every call holds
    collectives, must make the same calls): the chain stays at ``n_large``
    and exactly ``min_samples`` pairs run; a pair whose long run is under
    1.5x its short one gives no sample, and with none left T(n_large)/n_large
    is returned, ``shadowed``."""
    if n_large <= n_small:
        raise ValueError(f"n_large ({n_large}) must exceed n_small ({n_small})")
    if min_samples < 1 or max_samples < min_samples:
        raise ValueError(f"need 1 <= min_samples <= max_samples, got {min_samples}/{max_samples}")
    tensors = _tensors(args)
    device = tensors[0].device if tensors else torch.device("cpu")
    if work_floor_ms is None:
        work_floor_ms = GPU_WORK_FLOOR_MS if device.type == "cuda" else 0.0
    fn(*args)
    fence(device)

    total = 0.0

    def run(n: int) -> float:
        nonlocal total
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        fence(device)
        dt = time.perf_counter() - t0
        total += dt
        return dt

    if lockstep:
        pairs = [(run(n_small), run(n_large)) for _ in range(min_samples)]
        kept = [(tl - ts) / (n_large - n_small) * 1e3 for ts, tl in pairs if tl >= 1.5 * ts]
        if not kept:
            return AmortizedStats(samples_ms=[pairs[-1][1] / n_large * 1e3], n_chain=n_large, shadowed=True,
                                  total_measured_s=total)
        return AmortizedStats(samples_ms=kept, n_chain=n_large, shadowed=False, total_measured_s=total)
    t_small = run(n_small)
    n = n_large
    t_large = run(n)
    if device.type != "cuda":
        max_chain, max_samples = n_large, min_samples  # no fence to amortize; the spread is the host's load
    while (t_large < 1.5 * t_small or t_large * 1e3 < work_floor_ms) and n < max_chain:
        n = min(max_chain, n * 2)
        t_large = run(n)
    if t_large < 1.5 * t_small:
        return AmortizedStats(
            samples_ms=[t_large / n * 1e3], n_chain=n, shadowed=True, total_measured_s=total,
        )

    samples = [max(1e-3, (t_large - t_small) / (n - n_small) * 1e3)]
    attempts = 1
    while len(samples) < max_samples and attempts < 2 * max_samples:
        stats = AmortizedStats(samples, n, False, total)
        if len(samples) >= min_samples and stats.ci95_ms < 0.05 * stats.per_call_ms:
            break
        ts, tl = run(n_small), run(n)
        attempts += 1
        if tl < 1.5 * ts:  # a hiccup on the short run: discard, never clamp
            continue
        samples.append((tl - ts) / (n - n_small) * 1e3)
    return AmortizedStats(
        samples_ms=samples, n_chain=n, shadowed=False, total_measured_s=total,
        underconverged=len(samples) < min_samples,
    )


def amortized_ms(
    fn: Callable, *args: Any, n_small: int = 10, n_large: int = 110, max_chain: int = 4096,
) -> float:
    """Scalar form of :func:`amortized_stats` (one sample, no work floor),
    as the JAX package's: the long-context example times with it."""
    return amortized_stats(
        fn, *args, n_small=n_small, n_large=n_large, max_chain=max_chain,
        work_floor_ms=0.0, min_samples=1, max_samples=1,
    ).per_call_ms
