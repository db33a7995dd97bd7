"""One CUDA graph per bucket: a forward captured once per padded batch size.

The analogue of the JAX package's per-shape compile cache. A caller that
runs ``fn(params, x)`` at a fixed set of batch sizes (the serving buckets)
captures each size once and then replays it: one graph launch instead of
one ctypes launch per kernel and one PyTorch dispatch per op. Per bucket
:class:`BucketGraphs` holds

- a static fp32 input buffer of ``(bucket, *item_shape)`` on the device,
  beside a pinned host buffer of the same shape that feeds it;
- a ``torch.cuda.CUDAGraph`` of ``fn(params, static_in)``;
- the graph's static output.

Capture follows the PyTorch recipe: warm calls on a side stream first, so
that the kernel library's build and load, ``cudaFuncSetAttribute`` and
cuDNN's algorithm choice happen outside capture, then ``torch.cuda.graph``
with ``capture_error_mode="thread_local"`` (another thread's CUDA work does
not void a capture on the request path). All buckets share one memory
pool; their replays run one at a time on one stream. A capture that fails
raises: nothing here runs the forward eagerly in a graph's place. Whatever
``fn`` reads besides its input (``params``, a cast of them, a quantized
copy) is baked into the graph, so ``params`` must stay the same tensors for
the graphs' life; :meth:`BucketGraphs.release` drops one bucket's graph
and :meth:`BucketGraphs.close` releases the graphs and pool. A caller that
changes ``fn`` (a new precision policy) builds a new :class:`BucketGraphs`,
with a pool of its own, captures every bucket there and then closes the old
one: no graph of the old forward is replayed after the swap, and no memory
of a graph still live is handed to a new capture.

On the CPU there is no graph: :meth:`BucketGraphs.warm` makes the first
call at the bucket's shape and :meth:`BucketGraphs.run` calls ``fn``. That
is the device the caller asked for, not a fallback.

A kernel wrapper counts its launch in Python (``ops.cuda_kernels.LAUNCHES``),
which inside a capture records a graph node and launches nothing. So a
capture takes back the counts its forward added and keeps them with the
graph, and each replay, which launches those nodes, adds them: the counters
move with the device's launches. Each graph keeps its captured node list
(``keep_graph=True``), which :meth:`BucketGraphs.dump` prints as CUDA's
Graphviz text, to check the kept counts against the nodes themselves.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.cuda_kernels import LAUNCHES

# Calls of the forward on a side stream before a capture: the first builds and
# loads the kernel library and picks cuDNN's algorithms, the second runs warm.
WARM_CALLS = 2


class _Captured:
    """One bucket's graph, its static input and output, and the pinned host
    buffer the input is copied from."""

    __slots__ = ("graph", "static_in", "static_out", "host_in", "copied", "kernels")

    def __init__(self, graph, static_in, static_out, host_in, kernels):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.host_in = host_in
        self.copied = torch.cuda.Event()  # the last copy out of host_in
        self.kernels = kernels  # {LAUNCHES key: launches} the capture recorded

    def replay(self) -> None:
        """Launch the graph and count its kernels' launches."""
        self.graph.replay()
        for name, n in self.kernels.items():
            LAUNCHES[name] += n


class BucketGraphs:
    """Per-bucket CUDA graphs of ``fn(params, x)`` on ``device``; ``x`` is
    fp32 of shape ``(bucket, *item_shape)``."""

    def __init__(
        self,
        fn: Callable,
        params,
        item_shape: Sequence[int],
        device,
    ):
        self.fn = fn
        self.params = params
        self.item_shape = tuple(int(d) for d in item_shape)
        self.device = torch.device(device)
        self._graphs: Dict[int, _Captured] = {}
        self._seen: set = set()  # CPU: the buckets whose first call was made
        self._pool = None  # one memory pool for every bucket, made at the first capture
        self._stream: Optional[torch.cuda.Stream] = None

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def __contains__(self, bucket: int) -> bool:
        return bucket in (self._graphs if self.on_cuda else self._seen)

    def shape(self, bucket: int) -> tuple:
        return (int(bucket),) + self.item_shape

    def static_input(self, bucket: int) -> torch.Tensor:
        """The bucket's static input (CUDA), which every replay reads."""
        return self._graphs[bucket].static_in

    def host_buffer(self, bucket: int) -> Optional[np.ndarray]:
        """The bucket's pinned host buffer as a numpy array (None on the CPU
        or for a bucket not captured), free to write once its last copy to
        the device has run: a caller that assembles its batch here spares
        :meth:`run` a host copy."""
        cap = self._graphs.get(bucket) if self.on_cuda else None
        if cap is None:
            return None
        cap.copied.synchronize()
        return cap.host_in.numpy()

    def warm(self, bucket: int) -> float:
        """Capture ``bucket`` (CUDA) or make its first call (CPU); returns the
        wall ms of the whole first call: warm calls, capture and one fenced
        replay on the card. Recapturing a bucket replaces its graph."""
        t0 = time.perf_counter()
        if not self.on_cuda:
            self.fn(self.params, torch.zeros(self.shape(bucket), dtype=torch.float32))
            self._seen.add(bucket)
            return (time.perf_counter() - t0) * 1e3
        old = self._graphs.pop(bucket, None)
        if old is not None:
            old.graph.reset()
        with torch.cuda.device(self.device):
            static_in = torch.zeros(self.shape(bucket), dtype=torch.float32, device=self.device)
            host_in = torch.zeros(self.shape(bucket), dtype=torch.float32, pin_memory=True)
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            side = self._stream
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(WARM_CALLS):
                    self.fn(self.params, static_in)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph(keep_graph=True)  # keep the node list for dump()
            before = dict(LAUNCHES)
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                static_out = self.fn(self.params, static_in)
            graph.instantiate()
            kernels = {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}
            for name, n in kernels.items():  # recorded, not launched: a replay counts them
                LAUNCHES[name] -= n
            cap = _Captured(graph, static_in, static_out, host_in, kernels)
            cap.replay()
            self.fence()
        self._graphs[bucket] = cap
        return (time.perf_counter() - t0) * 1e3

    def release(self, bucket: int) -> None:
        """Drop ``bucket``'s graph, static tensors and pinned buffer (on the
        card, once the stream has run its last replay; the graph's memory
        goes back to the shared pool), or on the CPU forget its first call. A
        later :meth:`warm` captures it again."""
        self._seen.discard(bucket)
        cap = self._graphs.pop(bucket, None)
        if cap is not None:
            self.fence()
            cap.graph.reset()

    def run(self, bucket: int, xb: np.ndarray) -> torch.Tensor:
        """``fn(params, xb)`` for a warmed bucket, without a fence. On the
        card: ``xb`` copied through the pinned buffer (unless it is that
        buffer, :meth:`host_buffer`) into the static input, then one replay;
        the result is the static output, which the next replay of this
        bucket overwrites. On the CPU: a call of ``fn``."""
        if not self.on_cuda:
            return self.fn(self.params, torch.from_numpy(np.ascontiguousarray(xb, dtype=np.float32)))
        cap = self._graphs[bucket]
        host = cap.host_in.numpy()
        if not np.may_share_memory(xb, host):
            cap.copied.synchronize()  # host_in is free once its last copy has run
            np.copyto(host, xb, casting="same_kind")
        with torch.cuda.device(self.device):
            cap.static_in.copy_(cap.host_in, non_blocking=True)
            cap.copied.record()
            cap.replay()
        return cap.static_out

    def kernels(self, bucket: int) -> dict:
        """The wrapper launches one replay of ``bucket`` makes ({LAUNCHES
        key: launches}, from its capture; empty on the CPU)."""
        cap = self._graphs.get(bucket) if self.on_cuda else None
        return dict(cap.kernels) if cap is not None else {}

    def dump(self, bucket: int, path) -> str:
        """Write ``bucket``'s captured graph to ``path`` as CUDA prints it
        (Graphviz text, one record per node, a kernel node with its
        function's name) and return the text."""
        self._graphs[bucket].graph.debug_dump(str(path))
        return Path(path).read_text()

    def fence(self) -> None:
        """Wait until the device's current stream is done (no-op on the CPU):
        the counterpart of ``block_until_ready``."""
        if self.on_cuda:
            torch.cuda.current_stream(self.device).synchronize()

    def close(self) -> None:
        """Release every graph, its static tensors and the shared pool."""
        if self.on_cuda:
            self.fence()
        for cap in self._graphs.values():
            cap.graph.reset()
        self._graphs.clear()
        self._seen.clear()
        self._pool = None
