"""The continuous-batching inference server: queue -> bucket -> dispatch.

The JAX package's ``serving/server.py`` over the port's
``configs.build_forward``, on one device:

- **Warmup captures everything, dispatch captures nothing.** At
  :meth:`InferenceServer.start` every bucket's forward is captured once as
  a CUDA graph (``utils.cuda_graphs``; on the CPU: its first call), the
  analogue of the JAX package's per-shape compile. A dispatched batch whose
  bucket is not warm is a counted and journaled ``cache_miss``
  (``serve_miss``): it is captured there, on the request path, then
  replayed. The acceptance number is zero misses after warmup. A capture
  that fails at warmup raises out of :meth:`start`; one that fails on the
  request path fails that batch's requests with its cause. No request is
  ever served by the eager forward in a graph's place.
- **Every batch is journaled** (``serve_batch`` with per-request
  latencies; ``serve_shed`` and ``serve_fail`` for the loss paths) through
  the fsync'd ``resilience.journal.Journal``, so the bench's p50/p99 come
  from a crash-consistent trail.
- **Deadline-aware shedding.** Expired requests complete with status
  ``SHED`` at assembly time and are journaled, never silently dropped.
- **Every run can be replayed.** One ``serve_config`` record at build time
  and one ``serve_submit`` record per admission attempt carry the arrival
  schedule as well as the outcomes (``observability.replay``).
- **The serving controller** (``ServeConfig.controller``, a
  ``serving.controller.ControllerConfig``) is evaluated between batches
  and moves three knobs through the actuators :meth:`apply_slo_policy`,
  :meth:`apply_buckets` (a bucket added is captured before the batcher
  can pick it, a bucket dropped has its graph released) and
  :meth:`apply_compute` (the forward rebuilt at another precision policy
  and every bucket captured again into a new ``BucketGraphs``, which
  replaces the old one before the next dispatch). A capture there is a
  warmup, journaled as such, never a cache miss; one that fails raises,
  and the old graphs go on serving.

``_dispatch``'s timed region copies the padded batch into the bucket's
static input, replays its graph and fences the stream (the counterpart of
``block_until_ready``); ``_complete`` copies the static output to the host
before the next replay can overwrite it. Result slicing, spans, metrics
and journal writes run in ``@off_timed_path`` helpers after the region.

**The shard width.** A sharded config (``v2.1_replicated``,
``v2.2_sharded``, ``v4_hybrid``, ``v5_collective``, ``v7_tp``) serves at
``ServeConfig.n_shards`` on a mesh whose slots all sit on the server's
device (:func:`serve_mesh`), and each bucket's graph captures the whole
sharded forward: its kernels, halo copies and masks. One graph is captured
on one device's stream, so the mesh takes no other device; a server whose
slots span cards (a rank a card, ``parallel/distributed.py``) is ROADMAP
Queue 1 item 17. A single-device config
serves on one device whatever ``n_shards`` says, as in the JAX package.

**Degradation, not 500s.** With ``supervise=True`` the forward is the
elastic supervisor's (``resilience/supervisor.py``, on ``sup``): each
rung's forward, digest taps included, is what every bucket's graph
captures, and a dispatch replays the graph through
:meth:`~..resilience.supervisor.Supervisor.execute`, which screens the
digests after it. A trip walks the ladder; the supervisor's ``on_rebuild``
(:meth:`_rewarm`) captures every bucket again on the new rung, into a new
``BucketGraphs`` that replaces the old one, and the tripped batch replays
there: its requests are served, never dropped. Between batches
:meth:`_maybe_promote` climbs back once healed slots graduate, recapturing
the same way, and the controller gains its ``degrade_capacity`` rung
(:meth:`request_degrade`, :meth:`request_promote`); a supervised server has
no dtype rung (the ladder's rungs carry none), as in the JAX package. The
server runs on CUDA unless ``ServeConfig.device`` asks for the CPU; without
a GPU it raises.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..observability.metrics import registry as metrics_registry
from ..observability.trace import current_ids, get_tracer, off_timed_path, span
from ..resilience.journal import Journal
from .batcher import AssembledBatch, Batcher, power_of_two_buckets
from .queue import FAILED, OK, AdmissionQueue, QueueFull, Request, RequestHandle


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """How to build and run the service (the CLI and bench surface)."""

    config: str = "v1_jit"  # configs.REGISTRY key (Blocks 1-2 configs only)
    n_shards: int = 1  # shard slots of a sharded config, all on the server's device (serve_mesh)
    compute: str = "fp32"  # the precision policy the service runs and warms at: fp32 | bf16 | int8w
    max_batch: int = 8
    # None = powers of two up to max_batch, or the plan's batch sizes when
    # plan_path names a plan covering this point (tuning.plan.plan_batches).
    buckets: Optional[Tuple[int, ...]] = None
    plan_path: str = ""
    supervise: bool = False  # serve under the elastic supervisor (sup)
    journal_path: str = ""
    max_pending: int = 1024
    poll_s: float = 0.02
    default_deadline_s: Optional[float] = None
    model_cfg: Any = None  # Blocks12Config override (tests use 63x63)
    # Optional serving.slo.SLOPolicy: per-class SLO targets with pop-time
    # shed-by-class. None = hard deadlines only.
    slo: Any = None
    # Every ``mem_snapshot_s`` seconds the dispatch loop journals one
    # ``serve_gauges`` (queue depth, pending images, oldest wait) and one
    # ``mem_snapshot`` (the caching allocator's bytes, RSS on the CPU)
    # record, off the timed path. 0 disables.
    mem_snapshot_s: float = 1.0
    # Optional serving.controller.ControllerConfig (or its to_obj dict): the
    # closed-loop controller over admission, bucket width and precision.
    # None = every knob stays as built.
    controller: Any = None
    device: str = "cuda"


@dataclasses.dataclass
class ServeStats:
    """Steady-state counters the bench row and CLI line surface."""

    n_batches: int = 0
    n_images: int = 0
    n_ok: int = 0
    n_shed: int = 0
    n_failed: int = 0
    warmup_compiles: int = 0  # buckets captured (CPU: first calls)
    cache_misses: int = 0  # post-warmup dispatches at an un-warmed bucket
    rewarm_ms: float = 0.0  # wall ms of the captures of every apply_compute and every rung's recapture
    rewarms: int = 0  # recaptures of every bucket: dtype shifts and supervised rebuilds
    promotions: int = 0  # supervised grow-back climbs committed mid-serve
    batch_ms: List[float] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        return (
            f"batches={self.n_batches} images={self.n_images} ok={self.n_ok} "
            f"shed={self.n_shed} failed={self.n_failed} "
            f"cache_misses={self.cache_misses} warmups={self.warmup_compiles}"
        )


class InferenceServer:
    """Continuous-batching service over one execution config.

    Two run modes: :meth:`start`/:meth:`stop` run the dispatch loop on a
    background thread (the load-generator path), while
    :meth:`run_until_drained` runs it inline until the queue empties, the
    deterministic path: batch assembly then depends only on submission
    order. :meth:`close` releases the captured graphs.
    """

    def __init__(self, cfg: ServeConfig, params=None, plan=None, ladder=None):
        # ``ladder``: the supervisor's LadderEntry list (supervise only; default the config's ladder at
        # n_shards): a drill pins a clean comparison server to the rung a faulted run landed on
        if cfg.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {cfg.n_shards}")
        self.cfg = cfg
        self._ladder = ladder
        self.sup = None  # the Supervisor in supervise mode, made at the build
        self.queue = AdmissionQueue(max_pending=cfg.max_pending, slo=cfg.slo)
        self.stats = ServeStats()
        self.journal = Journal(cfg.journal_path) if cfg.journal_path else None
        self._plan = plan
        self._params = params
        self._fwd = None
        self._graphs = None  # utils.cuda_graphs.BucketGraphs once built
        self._warmed: set = set()  # buckets captured on the current build
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started = False
        # The epoch every serve_submit arrival offset is relative to.
        self._epoch = time.monotonic()
        self._seq_submit = 0
        self._seq_snapshot = 0
        self._last_snapshot = 0.0  # monotonic: the first _step snapshots
        self._submit_lock = threading.Lock()  # submit() is thread-safe
        self._compute_override: Optional[str] = None  # the controller's live dtype shift
        self.buckets = self._resolve_buckets()
        self._batcher = Batcher(self.queue, self.buckets)
        self.controller = None
        if cfg.controller is not None:
            from .controller import AutopilotController, ControllerConfig

            ctl_cfg = (
                cfg.controller if isinstance(cfg.controller, ControllerConfig)
                else ControllerConfig.from_obj(cfg.controller)
            )
            self.controller = AutopilotController(self, ctl_cfg)

    # ------------------------------------------------------------- building

    def _resolve_buckets(self) -> Tuple[int, ...]:
        cfg = self.cfg
        if cfg.buckets:
            return tuple(sorted(set(int(b) for b in cfg.buckets)))
        if cfg.plan_path:
            from ..configs import resolve_device
            from ..tuning.plan import device_kind, plan_batches

            tuned = plan_batches(
                cfg.plan_path,
                device_kind=device_kind(resolve_device(cfg.device)),
                model_cfg=self._model_cfg(),
                dtype=cfg.compute,
            )
            tuned = [b for b in tuned if b <= cfg.max_batch]
            if tuned:
                return tuple(tuned)
        return power_of_two_buckets(cfg.max_batch)

    def _model_cfg(self):
        from ..models.alexnet import BLOCKS12

        return self.cfg.model_cfg if self.cfg.model_cfg is not None else BLOCKS12

    @property
    def device(self):
        return self._graphs.device if self._graphs is not None else None

    @property
    def current_compute(self) -> str:
        """The precision policy the service runs now: the build's unless the
        controller has shifted it (:meth:`apply_compute`)."""
        return self._compute_override or self.cfg.compute

    def _build(self) -> None:
        from ..configs import REGISTRY, resolve_device
        from ..models.init import init_params_deterministic, params_to
        from ..utils.cuda_graphs import BucketGraphs

        cfg = self.cfg
        exec_cfg = REGISTRY[cfg.config]
        if exec_cfg.model != "blocks12":
            raise ValueError(f"serving supports the Blocks 1-2 configs only, got {cfg.config!r}")
        device = resolve_device(cfg.device)
        model_cfg = self._model_cfg()
        if self._params is None:
            self._params = init_params_deterministic(model_cfg, device=device)
        else:
            self._params = params_to(self._params, device=device)
        if cfg.supervise:
            from ..resilience.supervisor import Supervisor, default_ladder

            self.sup = Supervisor(
                model_cfg, self._ladder or default_ladder(exec_cfg.strategy, exec_cfg.tier, cfg.n_shards),
                plan=self._plan, journal=self.journal, on_rebuild=self._rewarm, site="serve",
                policy=self.current_compute, device=device,
            )
            self._fwd = self.sup.fwd()
        else:
            # build_forward sets the TF32 switches on the host, before any capture
            self._fwd = self._forward(self.current_compute, device)
        self._graphs = BucketGraphs(
            self._fwd, self._params, (model_cfg.in_height, model_cfg.in_width, model_cfg.in_channels), device
        )

    def _forward(self, compute: str, device):
        """``configs.build_forward`` at ``compute``: a sharded config on
        ``serve_mesh(n_shards, device)``, a single-device one on
        ``device``."""
        from ..configs import REGISTRY, build_forward

        exec_cfg = REGISTRY[self.cfg.config]
        mesh = serve_mesh(self.cfg.n_shards, device) if exec_cfg.strategy != "single" else None
        return build_forward(exec_cfg, self._model_cfg(), policy=compute, device=device, plan=self._plan,
                             n_shards=self.cfg.n_shards, mesh=mesh)

    @property
    def shards(self) -> int:
        """The shard slots a dispatch runs: ``n_shards`` for a sharded
        config, 1 for a single-device one."""
        from ..configs import REGISTRY

        return self.cfg.n_shards if REGISTRY[self.cfg.config].strategy != "single" else 1

    @off_timed_path
    def _note_compile(self, shape, ms: float, *, hit: bool) -> None:
        """Journal one ``compile_event`` for a bucket's capture (its first
        call on the CPU)."""
        if self.journal is None:
            return
        from ..observability.health import compile_event, journal_compile_event

        journal_compile_event(
            self.journal,
            compile_event(
                site="serve", entry=self.cfg.config, shape=shape, dtype=self.current_compute,
                ms=ms, cache_hit=hit, n_shards=self.shards,
            ),
        )

    @off_timed_path
    def warmup(self) -> None:
        """Capture every bucket now, before any request is waiting. After
        this, a dispatch that captures is a counted cache miss."""
        with span("serve.warmup", buckets=list(self.buckets)):
            for bucket in self.buckets:
                self._warm_bucket(bucket)

    @off_timed_path
    def _warm_bucket(self, bucket: int, graphs=None) -> float:
        """Capture one bucket into ``graphs`` (default: the live ones) and
        journal it (``compile_event``, ``serve_warm``); warmup's unit, which
        the controller's actuators and the supervisor's rebuilds capture
        through too. Supervised, the ``compile_event`` is the supervisor's
        (its per-rung ledger)."""
        live = graphs is None
        graphs = self._graphs if live else graphs
        ms = graphs.warm(bucket)
        if self.sup is not None:
            self.sup.note_warm(graphs.shape(bucket), self.current_compute, ms)
        else:
            self._note_compile(graphs.shape(bucket), ms, hit=live and bucket in self._warmed)
        self.stats.warmup_compiles += 1
        if live:
            self._warmed.add(bucket)
        self._journal(
            "serve_warm", key=f"warm:b{bucket}", bucket=bucket,
            ms=round(ms, 3), dtype=self.current_compute,
        )
        return ms

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "InferenceServer":
        """Build, capture every bucket, then serve on a background thread."""
        if self._started:
            raise RuntimeError("server already started")
        self._ensure_built()
        self._started = True
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="serve-dispatch", daemon=True)
        self._thread.start()
        return self

    def _ensure_built(self) -> None:
        if self._fwd is None:
            self._build()
            self._journal_config()
            self.warmup()

    @off_timed_path
    def _journal_config(self) -> None:
        """One ``serve_config`` record per built server: the conditions this
        run serves under (config, buckets, SLO policy, geometry), written
        before warmup so a run killed mid-warm leaves its header."""
        m = self._model_cfg()
        cfg = self.cfg
        self._journal(
            "serve_config",
            key="config",
            config=cfg.config,
            n_shards=cfg.n_shards,
            compute=cfg.compute,
            max_batch=cfg.max_batch,
            buckets=list(self.buckets),
            max_pending=cfg.max_pending,
            poll_s=cfg.poll_s,
            default_deadline_s=cfg.default_deadline_s,
            supervise=cfg.supervise,
            height=m.in_height,
            width=m.in_width,
            channels=m.in_channels,
            slo=cfg.slo.to_obj() if cfg.slo is not None else None,
            # the capacity timeline's start (health.capacity_timeline): a supervised server's surviving slots
            devices=self.sup.pool.n_alive if self.sup is not None else 1,
            # the controller's knobs (None = uncontrolled): a replay rebuilds it from them
            controller=self.controller.cfg.to_obj() if self.controller is not None else None,
            device=str(self.device),
        )

    def stop(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Stop the dispatch thread; with ``drain`` (default) the loop first
        finishes everything already admitted. The graphs stay captured: a
        later :meth:`start` or :meth:`run_until_drained` replays them."""
        if self._thread is None:
            return
        if drain:
            deadline = time.monotonic() + timeout_s
            while len(self.queue) and time.monotonic() < deadline:
                time.sleep(0.005)
        self._stop.set()
        self._thread.join(timeout_s)
        self._thread = None
        self._started = False

    def close(self) -> None:
        """Stop, then release the captured graphs and their memory pool and
        close the journal. A closed server builds and warms again when it is
        next started."""
        self.stop()
        if self._graphs is not None:
            self._graphs.close()
        self._graphs = None
        self._fwd = None
        self._warmed.clear()
        if self.journal is not None:
            self.journal.close()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._step()

    def run_until_drained(self) -> None:
        """Inline dispatch until the queue is empty: with every request
        submitted first, batch assembly depends only on FIFO order and the
        bucket set."""
        self._ensure_built()
        while len(self.queue):
            self._step()

    # ------------------------------------------------------------- dispatch

    def _step(self) -> None:
        # grow-back first, between batches: a promotion recaptures every bucket before the next batch
        self._maybe_promote()
        self._observe_queue()
        self._observe_resources()
        self._observe_controller()
        batch, shed = self._batcher.next_batch(self.cfg.poll_s)
        if shed:
            self._record_shed(shed)
        if batch is not None:
            self._dispatch(batch)

    @off_timed_path
    def _observe_queue(self) -> None:
        """Mirror the queue's saturation gauges into the metrics registry
        between batches: ``serve.queue_oldest_wait_ms`` climbs toward the
        tightest class SLO while every request is still servable."""
        qs = self.queue.stats()
        reg = metrics_registry()
        reg.gauge("serve.queue_depth").set(qs.depth)
        reg.gauge("serve.queue_pending_images").set(qs.pending_images)
        reg.gauge("serve.queue_oldest_wait_ms").set(qs.oldest_wait_ms)

    @off_timed_path
    def _observe_resources(self) -> None:
        """Resource telemetry every ``cfg.mem_snapshot_s``: one
        ``serve_gauges`` and one ``mem_snapshot`` journal record and the
        ``mem.*`` registry gauges, off the dispatch timed region."""
        if self.cfg.mem_snapshot_s <= 0:
            return
        now = time.monotonic()
        if now - self._last_snapshot < self.cfg.mem_snapshot_s:
            return
        self._last_snapshot = now
        from ..observability.specs import device_memory_stats

        snap = device_memory_stats()
        reg = metrics_registry()
        for field in ("bytes_in_use", "peak_bytes_in_use"):
            if isinstance(snap.get(field), (int, float)):
                reg.gauge(f"mem.{field}").set(snap[field])
        if self.journal is None:
            return
        qs = self.queue.stats()
        self._seq_snapshot += 1
        t_ms = round((now - self._epoch) * 1e3, 3)
        self._journal(
            "serve_gauges", key=f"gauges:{self._seq_snapshot}", t_ms=t_ms,
            depth=qs.depth, pending_images=qs.pending_images, oldest_wait_ms=qs.oldest_wait_ms,
            # the controller's ladder depth beside the queue trio (absent without one)
            **({"ctl_level": self.controller.level} if self.controller is not None else {}),
        )
        self._journal("mem_snapshot", key=f"mem:{self._seq_snapshot}", t_ms=t_ms, **snap)

    @off_timed_path
    def _observe_controller(self) -> None:
        """The controller's evaluation, on the between-batches cadence of the
        queue and resource gauges: it folds signals and now and then
        actuates, off the dispatch timed region."""
        if self.controller is not None:
            self.controller.evaluate(time.monotonic())

    # ------------------------------------------------------ controller hooks
    #
    # Each actuator swaps ONE live knob, reversibly, between batches, on the
    # dispatch thread. The controller journals the decision
    # (``controller_action`` with its evidence); these journal only what
    # the build-time path journals too (serve_warm, serve_rewarm).

    @off_timed_path
    def apply_slo_policy(self, policy) -> None:
        """Swap the queue's pop-time admission policy: the queue reads
        ``slo`` per pop under its own lock, so the attribute swap is the
        whole cutover; admitted work is never dropped after the fact."""
        self.queue.slo = policy

    @off_timed_path
    def apply_buckets(self, buckets) -> float:
        """Swap the active bucket set (narrow under pressure, widen on
        recovery). A bucket not captured on the current forward is captured
        FIRST, then the batcher is rebuilt over the new set (its dispatch
        seq carries over, so journal keys stay unique), and a captured
        bucket outside the set has its graph released. Returns the wall ms
        of the captures (0 for a pure narrowing)."""
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets:
            raise ValueError("bucket set cannot be empty")
        ms = 0.0
        if self._graphs is not None:
            for bucket in buckets:
                if bucket not in self._warmed:
                    ms += self._warm_bucket(bucket)
            for bucket in sorted(self._warmed - set(buckets)):
                self._graphs.release(bucket)
                self._warmed.discard(bucket)
        seq = self._batcher._seq
        self.buckets = buckets
        self._batcher = Batcher(self.queue, buckets)
        self._batcher._seq = seq
        return ms

    @off_timed_path
    def _rewarm(self, entry) -> None:
        """The supervisor's ``on_rebuild``: a degrade or a promotion landed on
        a freshly built rung, so every bucket is captured again on its
        forward, into a new ``BucketGraphs`` that replaces the live one
        (then closed) before the tripped batch replays. The params are
        resharded onto the rung's surviving slots first. Journals
        ``serve_rewarm``."""
        from ..utils.cuda_graphs import BucketGraphs

        with span("serve.rewarm", entry=entry.key):
            self._params = self.sup.reshard(self._params)
            old = self._graphs
            fwd = self.sup.fwd()
            graphs = BucketGraphs(fwd, self._params, old.item_shape, old.device)
            ms = 0.0
            try:
                for bucket in self.buckets:
                    ms += self._warm_bucket(bucket, graphs)
            except BaseException:
                graphs.close()
                raise
            self._fwd, self._graphs = fwd, graphs
            self._warmed = set(self.buckets)
            old.close()
            self.stats.rewarm_ms += ms
            self.stats.rewarms += 1
            metrics_registry().counter("serve.rewarms").inc()
            self._journal("serve_rewarm", key=f"rewarm:{entry.key}", entry=entry.key, buckets=list(self.buckets),
                          ms=round(ms, 3), devices=self.sup.pool.n_alive)

    @off_timed_path
    def _maybe_promote(self) -> None:
        """Between batches: when healed slots have graduated, the supervised
        promotion (its ``on_rebuild`` recaptures every bucket first)."""
        if self.sup is None:
            return
        state = self.sup.maybe_promote(self._params)
        if state is not None:
            self._params = state
            self.stats.promotions += 1
            metrics_registry().counter("serve.promotions").inc()

    @off_timed_path
    def request_degrade(self, cause: str) -> bool:
        """One supervised rung down as a capacity decision (the controller's
        ``degrade_capacity``): the walk, recapture and journal trail of a
        trip, with cause ``requested: ...``. False unsupervised or at the
        floor."""
        if self.sup is None:
            return False
        return self.sup.request_degrade(cause)

    @off_timed_path
    def request_promote(self) -> bool:
        """One rung up, verified against the current rung like any promotion
        (a refusal journals ``sup_promote_refused`` and leaves the rung).
        False when nothing was adopted."""
        if self.sup is None:
            return False
        state = self.sup.request_promote(self._params)
        if state is None:
            return False
        self._params = state
        self.stats.promotions += 1
        metrics_registry().counter("serve.promotions").inc()
        return True

    @off_timed_path
    def apply_compute(self, compute: str) -> float:
        """Rebuild the forward at precision policy ``compute`` and capture
        every bucket again before the next dispatch: the controller's dtype
        downshift and upshift, screened by its ToleranceGate first. The
        captures go into a new ``BucketGraphs`` with a pool of its own,
        which replaces the live one; the old one is closed after the swap,
        so no graph of the old forward is replayed. A capture that fails
        raises and leaves the old forward and graphs serving. Journals one
        ``serve_rewarm`` and returns its wall ms. A supervised server has no
        dtype actuation (its ladder's rungs carry no dtype): it raises."""
        from ..utils.cuda_graphs import BucketGraphs

        if self.sup is not None:
            raise RuntimeError("dtype actuation is unsupervised-only — supervised servers degrade through the ladder")
        prev = self._compute_override
        self._compute_override = compute if compute != self.cfg.compute else None
        old = self._graphs
        if old is None:  # not built yet: the build runs at the new policy
            return 0.0
        ms, graphs = 0.0, None
        try:
            with span("serve.rewarm", entry=self.cfg.config, dtype=compute):
                fwd = self._forward(compute, old.device)
                graphs = BucketGraphs(fwd, self._params, old.item_shape, old.device)
                for bucket in self.buckets:
                    ms += self._warm_bucket(bucket, graphs)
        except BaseException:
            if graphs is not None:
                graphs.close()
            self._compute_override = prev
            raise
        self._fwd, self._graphs = fwd, graphs
        self._warmed = set(self.buckets)
        old.close()
        self.stats.rewarm_ms += ms
        self.stats.rewarms += 1
        metrics_registry().counter("serve.rewarms").inc()
        self._journal(
            "serve_rewarm", key=f"rewarm:dtype:{compute}",
            entry=self.cfg.config, buckets=list(self.buckets),
            ms=round(ms, 3), dtype=compute, devices=1,
        )
        return ms

    def _dispatch(self, batch: AssembledBatch) -> None:
        """One timed region: copy into the static input -> replay -> fence.
        Completion (host copy, slicing, handle wakeups, journal) happens off
        the timed path."""
        miss = batch.bucket not in self._warmed
        if miss:
            # A capture on the request path: the failure the bucket
            # discipline exists to prevent. Counted and journaled, then
            # captured below, inside the timed region it delays.
            self.stats.cache_misses += 1
            metrics_registry().counter("serve.cache_misses").inc()
            self._journal("serve_miss", key=f"miss:b{batch.bucket}", bucket=batch.bucket)
        # assembled into the bucket's pinned host buffer where it has one (a warm bucket on the card)
        xb = batch.padded_input(out=self._graphs.host_buffer(batch.bucket))
        t0 = time.perf_counter()
        try:
            if miss:
                capture_ms = self._graphs.warm(batch.bucket)
            if self.sup is not None:
                # the supervisor replays the live graph (a trip's rebuild swaps in new graphs) and screens its digests
                out = self.sup.execute(self._params, xb, runner=lambda _f, _p, x: self._graphs.run(batch.bucket, x))
            else:
                out = self._graphs.run(batch.bucket, xb)
            self._graphs.fence()
        except Exception as e:  # noqa — the forward raised or the ladder ran out: every request FAILS with the cause
            self._record_failed(batch, e)
            return
        batch_ms = (time.perf_counter() - t0) * 1e3
        if miss:
            self._warmed.add(batch.bucket)
            if self.sup is not None:
                self.sup.note_warm(self._graphs.shape(batch.bucket), self.current_compute, capture_ms)
            else:
                self._note_compile(self._graphs.shape(batch.bucket), capture_ms, hit=False)
        self._complete(batch, out, batch_ms)

    @off_timed_path
    def _complete(self, batch: AssembledBatch, out, batch_ms: float) -> None:
        """Copy the output to the host (before the next replay overwrites
        the static output), slice it per request and wake the handles.
        The dispatch span is emitted from its measured bounds and each
        request gets a queue-wait span (submit -> dispatch start)."""
        arr = out.detach().cpu().numpy() if hasattr(out, "detach") else np.asarray(out)
        lat_ms: Dict[str, float] = {}
        req_cls: Dict[str, str] = {}
        reg = metrics_registry()
        for req, off in batch.offsets():
            req.handle._complete(OK, arr[off : off + req.n_images])
            lat_ms[req.rid] = round(req.handle.latency_ms, 3)
            req_cls[req.rid] = req.cls
            # the journal's percentiles and this histogram: one estimator, one population
            reg.histogram("serve.request_ms").observe(req.handle.latency_ms)
        if self.controller is not None:
            # the controller's burn windows, fed the outcomes the journal records
            for req in batch.requests:
                self.controller.note_ok(req.cls, lat_ms[req.rid])
        self.stats.n_batches += 1
        self.stats.n_images += batch.n_images
        self.stats.n_ok += len(batch.requests)
        self.stats.batch_ms.append(batch_ms)
        reg.counter("serve.ok").inc(len(batch.requests))
        reg.counter("serve.images").inc(batch.n_images)
        reg.histogram("serve.batch_ms").observe(batch_ms)
        trace_fields: Dict[str, str] = {}
        tr = get_tracer()
        if tr is not None:
            t1 = tr.clock()
            t0 = t1 - batch_ms / 1e3
            dsid = tr.emit(
                "serve.dispatch", t0, t1, track="dispatch",
                bucket=batch.bucket, seq=batch.seq,
                n_requests=len(batch.requests), entry=self._entry_key(),
            )
            trace_fields = {"trace_id": tr.trace_id, "span_id": dsid}
            for req in batch.requests:
                wait_ms = (t0 - req.handle.submitted_at) * 1e3
                reg.histogram("serve.queue_wait_ms").observe(max(0.0, wait_ms))
                tr.emit(
                    "serve.queue_wait", req.handle.submitted_at, t0,
                    parent_id="", track="queue", rid=req.rid,
                )
        else:
            for req in batch.requests:
                reg.histogram("serve.queue_wait_ms").observe(max(0.0, req.handle.latency_ms - batch_ms))
        self._journal(
            "serve_batch",
            key=f"batch:{batch.seq}",
            bucket=batch.bucket,
            n_requests=len(batch.requests),
            n_images=batch.n_images,
            pad=batch.pad,
            batch_ms=round(batch_ms, 3),
            req_lat_ms=lat_ms,
            req_cls=req_cls,
            entry=self._entry_key(),
            **trace_fields,
        )

    @off_timed_path
    def _record_shed(self, shed: List[Request]) -> None:
        self.stats.n_shed += len(shed)
        reg = metrics_registry()
        reg.counter("serve.shed").inc(len(shed))
        if self.controller is not None:
            for req in shed:
                self.controller.note_shed(req.cls)
        for req in shed:
            reason = req.shed_reason or "deadline"
            if reason == "slo":
                reg.counter("serve.shed_slo").inc()
            self._journal(
                "serve_shed", key=f"shed:{req.rid}", rid=req.rid,
                n_images=req.n_images, cls=req.cls, reason=reason,
                waited_ms=round(req.handle.latency_ms or 0.0, 3),
            )

    @off_timed_path
    def _record_failed(self, batch: AssembledBatch, e: BaseException) -> None:
        cause = f"{type(e).__name__}: {e}"[:200]
        for req in batch.requests:
            req.handle._complete(FAILED, error=cause)
        if self.controller is not None:
            for req in batch.requests:
                self.controller.note_fail(req.cls)
        self.stats.n_failed += len(batch.requests)
        metrics_registry().counter("serve.failed").inc(len(batch.requests))
        self._journal(
            "serve_fail",
            key=f"fail:{batch.seq}",
            bucket=batch.bucket,
            n_requests=len(batch.requests),
            req_cls={req.rid: req.cls for req in batch.requests},
            cause=cause,
        )

    # ------------------------------------------------------------- frontend

    def submit(
        self,
        x,
        *,
        deadline_s: Optional[float] = None,
        rid: Optional[str] = None,
        cls: str = "",
    ) -> RequestHandle:
        """Admit one request (thread-safe). A request wider than the largest
        bucket is rejected at the door (``ValueError``): it could never
        dispatch. Deadline: explicit ``deadline_s``, else the class's default
        (SLO policy), else the server default."""
        x = np.asarray(x)
        n = 1 if x.ndim == 3 else int(x.shape[0])
        if n > self.buckets[-1]:
            self._journal_submit(rid or "", n, cls, None, "too_wide")
            raise ValueError(
                f"request of {n} images exceeds the largest bucket "
                f"{self.buckets[-1]} — split it client-side"
            )
        if deadline_s is None and self.cfg.slo is not None:
            deadline_s = self.cfg.slo.deadline_for(cls)
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        try:
            handle = self.queue.submit(x, deadline_s=deadline_s, rid=rid, cls=cls)
        except QueueFull:
            self._journal_submit(rid or "", n, cls, deadline_s, "queue_full")
            raise
        self._journal_submit(handle.rid, n, cls, deadline_s, "", t=handle.submitted_at)
        return handle

    def _journal_submit(
        self,
        rid: str,
        n: int,
        cls: str,
        deadline_s: Optional[float],
        reason: str,
        t: Optional[float] = None,
    ) -> None:
        """One ``serve_submit`` record per admission attempt (the arrival
        offset from the server epoch, shape, class, deadline, admitted or
        the reason not); runs on the submitting thread."""
        if self.journal is None:
            return
        with self._submit_lock:  # HTTP handler threads submit concurrently
            self._seq_submit += 1
            self._journal(
                "serve_submit",
                key=f"sub:{self._seq_submit}",
                rid=rid,
                t_ms=round(((t if t is not None else time.monotonic()) - self._epoch) * 1e3, 3),
                n=n,
                cls=cls,
                deadline_s=deadline_s,
                admitted=not reason,
                reason=reason,
            )

    def _journal(self, kind: str, key: str, **payload) -> None:
        if self.journal is not None:
            self.journal.append(kind, key=key, **{**current_ids(), **payload})

    def _entry_key(self) -> str:
        """What served a batch: the supervisor's rung, or the config."""
        return self.sup.entry.key if self.sup is not None else self.cfg.config

    def summary(self) -> str:
        """One machine-parsed line (the run CLI's ``Serve:``)."""
        buckets = ",".join(str(b) for b in self.buckets)
        tail = (f" entry={self.sup.entry.key} trips={len(self.sup.trips)} promotions={self.sup.promotions}"
                if self.sup is not None else "")
        return f"{self.stats.summary()} buckets={buckets}{tail}"


def serve_mesh(n_shards: int, device):
    """The mesh of a sharded server: ``n_shards`` slots, every one on the
    server's ``device``, so they share its card (a bucket's graph is
    captured on one device's stream; slots across cards are ROADMAP Queue
    1 item 17)."""
    import torch

    from ..parallel.mesh import make_mesh

    # a shard's window lands on cuda:<current>, the key its slot's params are copied under
    dev = torch.device(device)
    if dev == torch.device("cuda"):
        dev = torch.device("cuda", torch.cuda.current_device())
    return make_mesh(n_shards, axis_name="sp", devices=[dev])


def request_latencies_from_journal(path) -> List[float]:
    """Every per-request latency (ms) journaled by ``serve_batch`` records:
    the crash-consistent source of the serve bench's p50/p99."""
    return latencies_from_records(Journal.load(path))


def latencies_from_records(records: List[dict]) -> List[float]:
    """Per-request latencies out of a loaded record list (the saturation
    sweep slices one journal into per-rate windows)."""
    lats: List[float] = []
    for rec in records:
        if rec.get("kind") == "serve_batch":
            req_lat = rec.get("req_lat_ms")
            if isinstance(req_lat, dict):
                lats.extend(float(v) for v in req_lat.values() if isinstance(v, (int, float)))
    return lats


def class_latencies_from_records(records: List[dict]) -> Dict[str, List[float]]:
    """{class name: [latency ms, ...]} from ``serve_batch`` records (rids
    without a class land under ``""``)."""
    out: Dict[str, List[float]] = {}
    for rec in records:
        if rec.get("kind") != "serve_batch":
            continue
        req_lat = rec.get("req_lat_ms")
        req_cls = rec.get("req_cls") or {}
        if not isinstance(req_lat, dict):
            continue
        for rid, v in req_lat.items():
            if isinstance(v, (int, float)):
                out.setdefault(str(req_cls.get(rid, "")), []).append(float(v))
    return out


def class_latencies_from_journal(path) -> Dict[str, List[float]]:
    """Journal-file form of :func:`class_latencies_from_records`."""
    return class_latencies_from_records(Journal.load(path))
