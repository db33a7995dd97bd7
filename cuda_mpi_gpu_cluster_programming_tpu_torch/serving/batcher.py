"""Bucketed batch assembly: pack pending requests into a fixed shape set.

The JAX package's ``serving/batcher.py``, copied. Every dispatched batch is
padded up to one of a small set of bucket sizes (powers of two up to
``max_batch`` by default, or the batch sizes a ``TunePlan`` holds tuned
winners for: ``tuning.plan.plan_batches``). On the card each bucket's
forward is captured once as a CUDA graph (``utils.cuda_graphs``), the
analogue of the JAX package's per-shape compile cache: a service that
dispatches only bucket shapes captures exactly ``len(buckets)`` graphs at
warmup and never on the request path.

Invariants (``tests/test_torch_serving.py``):
  - every assembled batch's padded size is a member of the bucket set;
  - requests are never split across batches and never reordered (FIFO);
  - every popped request lands in exactly one batch; expired ones are shed
    through the queue's explicit-shed path, never silently dropped.

Standard library and numpy only (no torch import).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .queue import AdmissionQueue, Request


def power_of_two_buckets(max_batch: int) -> Tuple[int, ...]:
    """1, 2, 4, ... up to and including ``max_batch`` (itself included even
    when not a power of two — the configured ceiling is always a legal
    dispatch shape)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


def bucket_for(n_images: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= ``n_images``. Raises when nothing fits — the
    admission layer must reject requests larger than max(buckets), so
    hitting this from the dispatch loop is a logic error, not load."""
    for b in sorted(buckets):
        if n_images <= b:
            return int(b)
    raise ValueError(
        f"{n_images} images fit no bucket (buckets={sorted(buckets)})"
    )


@dataclasses.dataclass
class AssembledBatch:
    """One dispatch unit: FIFO requests padded to a bucket shape."""

    seq: int
    requests: List[Request]
    bucket: int  # padded batch size — ALWAYS a member of the bucket set

    @property
    def n_images(self) -> int:
        return sum(r.n_images for r in self.requests)

    @property
    def pad(self) -> int:
        return self.bucket - self.n_images

    def offsets(self) -> List[Tuple[Request, int]]:
        """(request, row offset) pairs — how to slice the padded output."""
        out, off = [], 0
        for r in self.requests:
            out.append((r, off))
            off += r.n_images
        return out

    def padded_input(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        """(bucket, H, W, C) array: requests concatenated, zero rows after.
        Zero padding is numerically safe here — the forward is pointwise
        per image (conv/pool/LRN never mix batch rows), so pad rows cannot
        contaminate real outputs; they are sliced off before completion.
        ``out`` (the port's addition): write into this array instead, as
        the server does into a bucket's pinned host buffer."""
        xs = [r.x for r in self.requests]
        n = self.n_images
        if out is not None:
            np.concatenate(xs, axis=0, out=out[:n], casting="same_kind")
            out[n:] = 0
            return out
        if self.pad:
            xs.append(np.zeros((self.pad,) + xs[0].shape[1:], xs[0].dtype))
        out = np.concatenate(xs, axis=0)
        assert out.shape[0] == self.bucket and n <= self.bucket
        return out


class Batcher:
    """Pull-side batch assembler over an :class:`AdmissionQueue`."""

    def __init__(self, queue: AdmissionQueue, buckets: Sequence[int]):
        if not buckets:
            raise ValueError("Batcher needs a non-empty bucket set")
        self.queue = queue
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_batch = self.buckets[-1]
        self._seq = 0

    def next_batch(
        self, wait_s: float = 0.05
    ) -> Tuple[Optional[AssembledBatch], List[Request]]:
        """Assemble the next batch, or (None, shed) when nothing is ready.

        Waits up to ``wait_s`` for work, pops a FIFO prefix capped at the
        largest bucket, and pads to the smallest bucket that fits — the
        latency/throughput trade is made by the bucket set, not a timer:
        a lone request dispatches immediately at bucket 1 instead of
        waiting for co-riders that may never come (deadline-aware: holding
        it could expire it). ``shed`` carries every request the queue
        dropped on the way — hard-deadline expiries AND class-SLO
        blow-outs when an :class:`~.slo.SLOPolicy` is installed
        (``Request.shed_reason`` says which); the server journals each
        one attributably."""
        if not len(self.queue):
            self.queue.wait_nonempty(wait_s)
        taken, shed = self.queue.pop_ready(self.max_batch)
        if not taken:
            return None, shed
        self._seq += 1
        batch = AssembledBatch(
            self._seq, taken, bucket_for(sum(r.n_images for r in taken), self.buckets)
        )
        return batch, shed
