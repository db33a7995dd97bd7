"""The elastic supervisor: sentinel screening and a degradation ladder over
any built forward, and its training twin. The JAX package's
``resilience/supervisor.py``.

``policy.Degrader`` walks a fallback chain at build time; the supervisor
sees what happens inside a sharded forward while it serves:

- every ladder rung builds its forward with the sentinel's taps
  (``with_digests=True``: one digest a stage boundary and a shard slot,
  device tensors beside the output), so the hot loop makes no host sync;
- :meth:`Supervisor.execute` runs a batch, then screens the digests on the
  host (:class:`~.sentinel.StageDigests`), off the timed path;
- a trip (``stage_digest``, ``shard_divergence``, ``device_loss``,
  ``mesh_shrink``) re-plans to the next rung that builds (fewer shards,
  then replicated, then the single-device reference floor), reshards the
  live params onto the rung's surviving slots, and replays the SAME batch
  there, journaling every transition (``sup_trip``, ``sup_degrade``,
  ``sup_reshard``, ``sup_replay``, ``sup_ok``) in ``policy``'s
  ``DEGRADED(a -> b): cause`` vocabulary;
- :meth:`Supervisor.supervise_step` does the same for training steps
  (``training.make_elastic_step_builder``): a trip or a non-finite loss
  replays the step on the next rung with the params and optimizer state
  resharded, no checkpoint consumed;
- the ladder climbs back (:meth:`maybe_promote`, :meth:`promote`): once
  healed slots graduate from the pool's probation, the higher rung is
  rebuilt over them and verified against the current rung on a sentinel
  input before it is adopted; a promotion that changes results is refused
  and journaled (``sup_promote_refused``), never adopted.

The rungs are the JAX package's, spelled as its keys (``halo@4:pallas``,
``replicated@4:reference``, ``single@1:reference``), so journals and
``DEGRADED(...)`` lines read the same in both packages; ``pallas`` is the
port's kernels tier (``tier="kernels"``: the CUDA kernels). The pool
(``parallel.elastic.ElasticPool``) is one of shard slots: on one H100 every
slot shares the card, so a lost "device" is a lost slot, and the drills of
``CHAOS_SPEC`` exercise every path: ``stage_sdc=1`` corrupts a seeded stage
digest before screening, ``device_loss=1`` raises the loss signature
before the forward, ``mesh_shrink=k`` loses k seeded slots so the rebuild
lands on a smaller mesh, ``device_rejoin=k`` heals the k most recently lost
through probation, and ``flap=k`` bounces one seeded slot through k
lose/heal cycles, which must end in quarantine, never in a mesh that
oscillates. A kernel that fails to build or launch is not a trip: its
error propagates (a build that fails is a degrade only through
``_advance``'s eager build, where it is journaled and printed).

``policy`` (``fp32`` or ``bf16``; the JAX package's supervisor runs fp32)
is the precision every rung runs at: params and input cast to bf16, the
output cast back to fp32, as ``configs.build_forward`` casts.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..observability.trace import current_ids
from ..observability.trace import span as obs_span
from . import chaos
from .journal import Journal
from .policy import DegradationExhausted, DegradedEvent
from .sentinel import SDC, SentinelConfig, StageDigests, off_timed_path, tree_digest

# The signatures a lost slot surfaces as (a message quoting slot counts;
# chaos writes the same words, so triage reads one grammar).
_DEVICE_LOSS_MARKERS = ("device_loss", "mesh_shrink", "devices, have", "), have ")


def _loss_kind(e: BaseException) -> str:
    return "mesh_shrink" if "mesh_shrink" in str(e) else "device_loss"


@dataclasses.dataclass(frozen=True)
class LadderEntry:
    """One rung of the degradation ladder: how to build the forward."""

    strategy: str  # "halo" | "staged_halo" | "tp" | "replicated" | "single"
    tier: str = "reference"  # "reference" | "pallas" (the port's kernels tier)
    n_shards: int = 1

    @property
    def key(self) -> str:
        return f"{self.strategy}@{self.n_shards}:{self.tier}"


def ladder_tier(tier: str) -> str:
    """A config's tier in the ladder's spelling: the port's ``kernels`` is
    the JAX package's ``pallas``."""
    return "pallas" if tier == "kernels" else tier


def default_ladder(strategy: str, tier: str, n_shards: int) -> List[LadderEntry]:
    """The recovery ladder of a (strategy, tier, shards) point: the requested
    plan, the same strategy at halved shard counts, replicate-all, then the
    single-device reference floor. ``tier``: ``reference``, ``pallas`` or
    the port's ``kernels``."""
    tier = ladder_tier(tier)
    entries: List[LadderEntry] = []
    if strategy in ("halo", "staged_halo", "tp"):
        n = n_shards
        while n >= 2:
            entries.append(LadderEntry(strategy, tier, n))
            n //= 2
        if n_shards >= 2:
            entries.append(LadderEntry("replicated", "reference", n_shards))
    elif strategy == "replicated":
        entries.append(LadderEntry("replicated", "reference", max(1, n_shards)))
    elif strategy == "single":
        if tier != "reference":
            entries.append(LadderEntry("single", tier, 1))
    else:
        raise ValueError(f"no supervisor ladder for strategy {strategy!r}")
    entries.append(LadderEntry("single", "reference", 1))
    return entries


def train_ladder(sp_shards: int = 0, tp_shards: int = 0) -> List[LadderEntry]:
    """The training-step ladder: the sharded strategy at halved shard counts
    down to 2, then the single-device reference floor (no replicated rung:
    N copies of one optimizer step screen nothing the sentinel does not)."""
    if sp_shards and tp_shards:
        raise ValueError("sp_shards and tp_shards are mutually exclusive strategies")
    strategy = "halo" if sp_shards else ("tp" if tp_shards else "single")
    entries: List[LadderEntry] = []
    n = sp_shards or tp_shards or 1
    while n >= 2:
        entries.append(LadderEntry(strategy, "reference", n))
        n //= 2
    entries.append(LadderEntry("single", "reference", 1))
    return entries


def _is_device_loss(e: BaseException) -> bool:
    msg = str(e)
    return isinstance(e, (RuntimeError, ValueError, chaos.InjectedFault)) and any(m in msg for m in _DEVICE_LOSS_MARKERS)


@dataclasses.dataclass
class ScriptedFault:
    """One scheduled loss (:meth:`Supervisor.script_fault`): at supervised
    step ``step``, lose ``device_ids`` (none: a transient loss) and raise the
    loss signature. The replay of a recorded journal builds these from its
    ``sup_trip`` and ``mesh_shrink`` records: the same steps, the same slots."""

    step: int
    kind: str = "device_loss"  # "device_loss" | "mesh_shrink"
    device_ids: Tuple[int, ...] = ()
    cause: str = "scripted"
    fired: bool = False


def _fence(out) -> None:
    """Wait for the device work that produced ``out`` (a tensor or a tuple
    whose first element is one)."""
    t = out[0] if isinstance(out, (tuple, list)) else out
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Supervisor:
    """A degradation ladder of digest-tapped forwards with trip handling.
    ``execute(params, x)`` returns the batch's output from some rung, or
    raises :class:`DegradationExhausted` when every rung is spent;
    ``attempts``, ``trips`` and ``events`` are the incident trail.

    ``device``: where the rungs run (``cuda`` unless the caller asks for
    ``cpu``); the pool's slots sit there. ``pool``: an
    ``parallel.elastic.ElasticPool`` (default: as many slots as the widest
    rung needs, at least ``elastic.DEFAULT_SLOTS``). ``step_builder(entry,
    mesh) -> step_fn`` puts it in training mode (:meth:`supervise_step`).
    ``on_rebuild(entry)`` runs after a rung is built by a degrade or a
    promotion, before the batch replays on it (the server recaptures its
    graphs there)."""

    def __init__(
        self,
        model_cfg,
        ladder: List[LadderEntry],
        *,
        plan=None,
        sentinel_cfg: SentinelConfig = SentinelConfig(),
        journal: Optional[Journal] = None,
        on_event: Optional[Callable[[DegradedEvent], None]] = None,
        on_rebuild: Optional[Callable[[LadderEntry], None]] = None,
        pool=None,
        step_builder: Optional[Callable] = None,
        site: str = "supervisor",
        promote_rtol: float = 1e-5,
        policy: str = "fp32",
        device: str = "cuda",
    ):
        if not ladder:
            raise ValueError("Supervisor needs a non-empty ladder")
        if policy not in ("fp32", "bf16"):
            raise ValueError(f"the supervisor runs fp32 or bf16, got {policy!r}")
        from ..configs import resolve_device

        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.ladder = list(ladder)
        self.plan = plan
        self.policy = policy
        self.journal = journal
        self.on_event = on_event
        self.on_rebuild = on_rebuild
        if pool is None:
            from ..parallel.elastic import DEFAULT_SLOTS, ElasticPool

            pool = ElasticPool(journal=journal, site=site, device=self.device.type,
                               n_slots=max([DEFAULT_SLOTS] + [e.n_shards for e in self.ladder]))
        self.pool = pool
        self.step_builder = step_builder
        self.site = site
        self.promote_rtol = float(promote_rtol)
        self.checker = StageDigests(sentinel_cfg, site=site)
        self.trips: List[SDC] = []
        self.events: List[DegradedEvent] = []
        self.attempts = 0
        self.replays = 0
        self.promotions = 0
        self.compile_ms: Optional[float] = None
        # (rung, shape) pairs the current executable has run: the first call
        # at a shape journals a compile_event; the set is cleared with the rung
        self._compiled: set = set()
        self._idx = 0
        self._fwd: Optional[Callable] = None
        self._sfn: Optional[Callable] = None
        self._step = 0
        # the pool's eligible count at the last degrade or promotion decision:
        # maybe_promote fires only once it has grown past it
        self._promote_floor_alive: Optional[int] = None
        self._flap_cycles = 0
        self._flap_device = None
        self._flap_last_step: Optional[int] = None
        self._rejoin_blocked_step: Optional[int] = None
        self._scripted_faults: List[ScriptedFault] = []

    # ------------------------------------------------------------ building

    @property
    def entry(self) -> LadderEntry:
        return self.ladder[self._idx]

    def _journal(self, kind: str, key: str, **payload) -> None:
        if self.journal is not None:
            self.journal.append(kind, key=key, **{**current_ids(), **payload})

    @off_timed_path
    def _note_compile(self, *, shape, dtype, ms, cache_hit) -> None:
        """One ``compile_event`` for the current rung (its first call at a
        shape: kernel library load, cuDNN's algorithm choice, or a graph
        capture); ``compile_ms`` keeps the first."""
        if not cache_hit and self.compile_ms is None:
            self.compile_ms = ms
        if self.journal is None:
            return
        from ..observability.health import compile_event

        entry = self.entry
        rec = compile_event(site=self.site, entry=entry.key, shape=shape, dtype=dtype, ms=ms, cache_hit=cache_hit,
                            n_shards=entry.n_shards if entry.strategy in ("halo", "staged_halo", "tp") else 1)
        self._journal("compile_event", key=f"compile:{self.site}:{entry.key}:b{rec['batch']}", **rec)

    def _entry_mesh(self, entry: LadderEntry):
        """The mesh over the surviving slots this rung runs on (None for the
        single floor), built through the pool at every build."""
        if entry.strategy == "single" or entry.n_shards < 2:
            return None
        return self.pool.mesh_for(entry.n_shards, axis_name="tp" if entry.strategy == "tp" else "sp")

    def _cast(self, fwd: Callable) -> Callable:
        """``fwd`` (returning ``(out, digests)``) at the supervisor's policy."""
        if self.policy != "bf16":
            return fwd
        from ..models.init import params_to

        def run(p, x):
            out, digs = fwd(params_to(p, dtype=torch.bfloat16), x.to(torch.bfloat16))
            return out.float().contiguous(), digs

        return run

    def _build_entry(self, entry: LadderEntry) -> Callable:
        """The rung's ``(params, x) -> (out, digests)``."""
        from ..ops.reference import true_fp32

        cfg, dev = self.model_cfg, self.device
        if entry.strategy != "single" and self.policy == "fp32":
            true_fp32(dev)
        if entry.strategy in ("halo", "staged_halo"):
            from ..parallel.sharded import build_sharded_forward

            return self._cast(build_sharded_forward(
                cfg, entry.n_shards, mesh=self._entry_mesh(entry),
                tier="kernels" if entry.tier == "pallas" else "reference",
                staged=entry.strategy == "staged_halo", with_digests=True, plan=self.plan, device=dev.type,
            ))
        if entry.strategy == "tp":
            from ..parallel.tensor_parallel import build_tp_forward

            return self._cast(build_tp_forward(cfg, entry.n_shards, mesh=self._entry_mesh(entry),
                                               with_digests=True, device=dev.type))
        if entry.strategy == "replicated":
            from ..parallel.replicated import build_replicated_forward

            return self._cast(build_replicated_forward(cfg, entry.n_shards, mesh=self._entry_mesh(entry),
                                                       with_digests=True, device=dev.type))
        if entry.strategy == "single":
            # through configs.build_forward, so a TunePlan keeps its env > plan > default order on the floor
            from ..configs import REGISTRY, build_forward

            key = "v3_pallas" if entry.tier == "pallas" else "v1_jit"
            return self._wrap_digest(build_forward(REGISTRY[key], cfg, policy=self.policy, device=dev,
                                                   plan=self.plan))
        raise ValueError(f"unknown ladder strategy {entry.strategy!r}")

    @staticmethod
    def _wrap_digest(base: Callable) -> Callable:
        """The output's digest tap, for a forward without stage taps."""

        def fwd(p, x):
            out = base(p, x)
            return out, {"out": tree_digest(out)[None]}

        return fwd

    def fwd(self) -> Callable:
        """The current rung's ``(params, x) -> (out, digests)``, taps
        included, no host sync: what a timing harness measures. Built on
        first use."""
        if self._fwd is None:
            self._fwd = self._build_entry(self.entry)
            self._journal("sup_build", key=self.entry.key, entry=self.entry.key)
        return self._fwd

    def step_fn(self) -> Callable:
        """The current rung's training step, ``step_builder(entry, mesh)``
        over the surviving slots, built on first use."""
        if self.step_builder is None:
            raise ValueError("supervise_step needs Supervisor(step_builder=...) — see "
                             "training.make_elastic_step_builder")
        if self._sfn is None:
            entry = self.entry
            self._sfn = self.step_builder(entry, self._entry_mesh(entry))
            self._journal("sup_build", key=f"step:{entry.key}", entry=entry.key)
        return self._sfn

    def _build_current(self) -> None:
        if self.step_builder is not None:
            self.step_fn()
        else:
            self.fwd()

    @off_timed_path
    def reshard(self, tree):
        """The tree on the current rung's surviving slots
        (``elastic.reshard_tree``; the single floor: one slot), journaled
        ``sup_reshard``."""
        from ..parallel.elastic import reshard_tree

        entry = self.entry
        n = entry.n_shards if entry.strategy != "single" else 1
        with obs_span("sup.reshard", entry=entry.key, devices=self.pool.n_alive):
            mesh = self.pool.mesh_for(max(1, n))
            self._journal("sup_reshard", key=f"reshard:{entry.key}:{self.pool.summary()}", entry=entry.key,
                          devices=self.pool.n_alive)
            return reshard_tree(tree, mesh)

    @off_timed_path
    def note_warm(self, shape, dtype: str, ms: float) -> None:
        """A caller warmed the current rung at ``shape`` itself (the server's
        graph capture): ledger it as this rung's compile, so the first
        screened batch at that shape is not counted again."""
        shape = tuple(int(d) for d in shape)
        hit = (self.entry.key, shape) in self._compiled
        self._compiled.add((self.entry.key, shape))
        self._note_compile(shape=shape, dtype=dtype, ms=ms, cache_hit=hit)
        self._journal("sup_warm", key=f"warm:{self.entry.key}:b{shape[0]}", entry=self.entry.key,
                      batch=shape[0], ms=round(ms, 3))

    @off_timed_path
    def warm(self, params, x) -> float:
        """Run the current rung once at ``x``'s shape outside the screened
        path (no chaos draw, no screening); journals ``compile_event`` and
        ``sup_warm``; returns the wall ms."""
        t0 = time.perf_counter()
        out, _ = self.fwd()(params, x)
        _fence(out)
        ms = (time.perf_counter() - t0) * 1e3
        self.note_warm(x.shape, str(x.dtype).replace("torch.", ""), ms)
        return ms

    # ----------------------------------------------------------- execution

    def script_fault(self, step: int, kind: str = "device_loss", device_ids: Iterable[int] = (),
                     cause: str = "scripted") -> ScriptedFault:
        """Schedule a loss at supervised step ``step``, of exactly
        ``device_ids`` (the replay of a recorded journal's incidents): it
        rides the ordinary trip path, so the replay journals the same
        ``mesh_shrink``/``sup_trip`` shape."""
        f = ScriptedFault(step=int(step), kind=kind, device_ids=tuple(device_ids), cause=cause)
        self._scripted_faults.append(f)
        return f

    def _maybe_scripted_fault(self, entry: LadderEntry) -> None:
        for f in self._scripted_faults:
            if f.fired or f.step != self._step:
                continue
            f.fired = True
            lost: List[int] = []
            if f.device_ids:
                alive = {d.id for d in self.pool.alive()}
                lost = [i for i in f.device_ids if i in alive]
                if len(lost) >= len(alive):
                    lost = lost[: len(alive) - 1]
                if lost:
                    self.pool.lose(lost, cause=f.cause)
            if f.kind == "mesh_shrink" and lost:
                raise chaos.InjectedFault(
                    "mesh_shrink",
                    f"scripted ({f.cause}): lost {len(lost)} device(s) {sorted(lost)}; entry {entry.key} mesh is "
                    f"stale — {self.pool.n_alive} of {self.pool.n_total} devices survive",
                )
            raise chaos.InjectedFault(
                "device_loss",
                f"scripted ({f.cause}): entry {entry.key} needs {entry.n_shards} devices, have "
                f"{max(entry.n_shards - 1, 0)}",
            )

    def _maybe_chaos_device_loss(self, entry: LadderEntry) -> None:
        ch = chaos.active()
        if ch is None or entry.n_shards <= 1:
            return
        if ch.draw("device_loss"):
            raise chaos.InjectedFault("device_loss",
                                      f"entry {entry.key} needs {entry.n_shards} devices, have {entry.n_shards - 1}")

    def _maybe_chaos_mesh_shrink(self, entry: LadderEntry) -> None:
        """``mesh_shrink=k``: lose k seeded slots in one event, then raise the
        loss signature; every later mesh sees the smaller pool."""
        ch = chaos.active()
        if ch is None or entry.n_shards <= 1 or self.pool.n_alive <= 1:
            return
        k = ch.drain("mesh_shrink")
        if k == 0 and ch.draw("mesh_shrink"):
            k = 1
        if k == 0:
            return
        from ..parallel.elastic import seeded_victims

        victims = seeded_victims(self.pool, k, ch.spec.seed)
        if not victims:
            return
        self.pool.lose(victims, cause="chaos:mesh_shrink")
        raise chaos.InjectedFault(
            "mesh_shrink",
            f"lost {len(victims)} device(s) {sorted(d.id for d in victims)}; entry {entry.key} mesh is stale — "
            f"{self.pool.n_alive} of {self.pool.n_total} devices survive",
        )

    def _maybe_chaos_device_rejoin(self) -> None:
        """``device_rejoin=k``: heal the k most recently lost slots into
        probation, once something is lost, never inside the step whose trip
        is being recovered."""
        ch = chaos.active()
        if ch is None or self.pool.n_lost == 0 or self._step == self._rejoin_blocked_step:
            return
        k = ch.drain("device_rejoin")
        if k == 0 and ch.draw("device_rejoin"):
            k = 1
        if k == 0:
            return
        self.pool.heal(self.pool.recently_lost(k), cause="chaos:device_rejoin")

    def _maybe_chaos_flap(self, entry: LadderEntry) -> None:
        """``flap=k``: one seeded slot through k lose/heal cycles, a half
        cycle a step. Its first loss trips; its later ones land while it is
        probationary (in no mesh), so the ladder stays put until the pool
        quarantines it."""
        ch = chaos.active()
        if ch is None:
            return
        self._flap_cycles += ch.drain("flap")
        if self._flap_cycles <= 0 or self._flap_last_step == self._step:
            return
        pool = self.pool
        if self._flap_device is None:
            from ..parallel.elastic import seeded_victims

            victims = seeded_victims(pool, 1, ch.spec.seed, site="flap")
            if not victims:
                self._flap_cycles = 0
                return
            self._flap_device = victims[0]
        d = self._flap_device
        if pool.is_quarantined(d):
            self._flap_cycles = 0
            return
        self._flap_last_step = self._step
        if pool.is_lost(d):
            pool.heal([d], cause="chaos:flap")
            self._flap_cycles -= 1
            return
        was_probationary = pool.is_probationary(d)
        pool.lose([d], cause="chaos:flap")
        if not was_probationary and entry.n_shards > 1:
            raise chaos.InjectedFault(
                "mesh_shrink",
                f"flap: lost device {d.id}; entry {entry.key} mesh is stale — {pool.n_alive} of {pool.n_total} "
                "devices survive",
            )

    def _maybe_chaos_stage_sdc(self, digests: Dict) -> Dict:
        ch = chaos.active()
        if ch is None or not digests:
            return digests
        if ch.draw("stage_sdc"):
            pick = random.Random(f"{ch.spec.seed}:stage_sdc").choice(sorted(digests))
            corrupt = dict(digests)
            corrupt[pick] = torch.full(tuple(digests[pick].shape), float("nan"), dtype=torch.float64)
            return corrupt
        return digests

    @off_timed_path
    def _screen(self, digests) -> None:
        """Screen the digests on the host, between timed regions: on the
        replicated rung the per-replica output digests must agree (the JAX
        package's cross-shard compare of the replicated output)."""
        digests = self._maybe_chaos_stage_sdc(digests)
        self.checker.check(self._step, digests, replicated=(self.entry.strategy == "replicated"))

    def _advance(self, cause: str, last: BaseException):
        """Move to the next rung that builds, journaling each DEGRADED hop."""
        while True:
            if self._idx + 1 >= len(self.ladder):
                raise DegradationExhausted([e.key for e in self.ladder], self.events, last) from last
            ev = DegradedEvent(self.ladder[self._idx].key, self.ladder[self._idx + 1].key, cause)
            self.events.append(ev)
            if self.on_event is not None:
                self.on_event(ev)
            self._journal("sup_degrade", key=f"degrade:{len(self.events)}", frm=ev.from_tier, to=ev.to_tier,
                          cause=ev.cause)
            self._idx += 1
            self._fwd = None
            self._sfn = None
            self._compiled.clear()
            try:
                # an unbuildable rung (more slots than survive) degrades again
                self._build_current()
                if self.on_rebuild is not None:
                    self.on_rebuild(self.entry)
                return
            except Exception as e:  # noqa: BLE001 — the next hop carries the cause
                last = e
                cause = f"build failed: {type(e).__name__}: {e}"[:200]

    @off_timed_path
    def execute(self, params, x, step: Optional[int] = None, runner: Optional[Callable] = None):
        """Run one batch, screen it, and on a trip replay it on the next rung;
        returns the output. ``runner(fwd, params, x) -> (out, digests)`` runs
        the rung's forward another way (the server replays its captured
        graph of ``fwd``); by default ``fwd(params, x)``. Bounded by the
        ladder: a rung that keeps tripping degrades to the floor, then
        :class:`DegradationExhausted` propagates."""
        if step is not None:
            self._step = step
        while True:
            self.attempts += 1
            entry = self.entry
            try:
                fwd = self.fwd()
            except Exception as e:  # noqa: BLE001 — an unbuildable rung degrades
                self._advance(f"build failed: {type(e).__name__}: {e}"[:200], e)
                continue
            try:
                self._maybe_scripted_fault(entry)
                self._maybe_chaos_device_rejoin()
                self._maybe_chaos_flap(entry)
                self._maybe_chaos_mesh_shrink(entry)
                self._maybe_chaos_device_loss(entry)
                shape = tuple(int(d) for d in x.shape)
                first = (entry.key, shape) not in self._compiled
                t0 = time.perf_counter()
                out, digests = (runner or (lambda f, p, xx: f(p, xx)))(fwd, params, x)
                if first:
                    _fence(out)
                    self._compiled.add((entry.key, shape))
                    self._note_compile(shape=shape, dtype=self._dtype(x), ms=(time.perf_counter() - t0) * 1e3,
                                       cache_hit=False)
                self._screen(digests)
            except SDC as e:
                params = self._trip_and_recover(e, entry.key, str(e)[:200], f"SDC({e.kind}): {e.detail}"[:200],
                                                params)
                continue
            except Exception as e:  # noqa: BLE001 — classified below
                if not _is_device_loss(e):
                    raise
                kind = _loss_kind(e)
                sdc = SDC(kind, self._step, str(e)[:200])
                params = self._trip_and_recover(sdc, entry.key, str(e)[:200], f"SDC({kind}): {e}"[:200], params)
                continue
            self._journal("sup_ok", key=f"ok:{self._step}", entry=self.entry.key, attempts=self.attempts)
            self.pool.note_clean_batch()
            self._step += 1
            return out

    @staticmethod
    def _dtype(x) -> str:
        return str(x.dtype).replace("torch.", "")

    @off_timed_path
    def _replay_state(self, tree):
        """After a degrade: the state resharded onto the landed rung and the
        replay journaled."""
        self.replays += 1
        with obs_span("sup.replay", step=self._step, entry=self.entry.key):
            tree = self.reshard(tree)
            self._journal("sup_replay", key=f"replay:{self.replays}", step=self._step, entry=self.entry.key)
        return tree

    def _trip_and_recover(self, sdc: SDC, entry_key: str, journal_cause: str, advance_cause: str, tree):
        """One trip's recovery under a ``sup.trip`` span: the trip record,
        the degrade walk, then the reshard and the replay record. Returns the
        state the caller replays with."""
        self.trips.append(sdc)
        with obs_span("sup.trip", kind=sdc.kind, step=sdc.step, entry=entry_key):
            self._journal("sup_trip", key=f"trip:{len(self.trips)}", sdc_kind=sdc.kind, step=sdc.step,
                          entry=entry_key, cause=journal_cause)
            with obs_span("sup.degrade", frm=entry_key):
                self._advance(advance_cause, sdc)
            # promotion needs the eligible count to grow past what this degrade landed with
            self._promote_floor_alive = self.pool.n_alive
            self._rejoin_blocked_step = self._step
            return self._replay_state(tree)

    @off_timed_path
    def supervise_step(self, params, opt_state, x, y, step: Optional[int] = None):
        """Run one training step under supervision; returns the step's
        ``(new_params, new_opt_state, loss[, grad_norm])`` from some rung. A
        lost slot or a non-finite loss or grad norm (``step_nonfinite``)
        degrades, reshards params and optimizer state, and replays the same
        ``(x, y)``: no checkpoint consumed. Raises
        :class:`DegradationExhausted` when the ladder is spent (the caller's
        rollback is the floor below this)."""
        if self.step_builder is None:
            raise ValueError("supervise_step needs Supervisor(step_builder=...) — see "
                             "training.make_elastic_step_builder")
        if step is not None:
            self._step = step
        while True:
            self.attempts += 1
            entry = self.entry
            try:
                fn = self.step_fn()
            except Exception as e:  # noqa: BLE001 — an unbuildable rung degrades
                self._advance(f"build failed: {type(e).__name__}: {e}"[:200], e)
                params, opt_state = self._replay_state((params, opt_state))
                continue
            try:
                self._maybe_chaos_device_rejoin()
                self._maybe_chaos_flap(entry)
                self._maybe_chaos_mesh_shrink(entry)
                self._maybe_chaos_device_loss(entry)
                shape = tuple(int(d) for d in x.shape)
                first = (f"step:{entry.key}", shape) not in self._compiled
                t0 = time.perf_counter()
                out = fn(params, opt_state, x, y)
                loss = float(out[2])  # the host read fences the step
                if first:
                    self._compiled.add((f"step:{entry.key}", shape))
                    self._note_compile(shape=shape, dtype=self._dtype(x), ms=(time.perf_counter() - t0) * 1e3,
                                       cache_hit=False)
                gnorm = float(out[3]) if len(out) > 3 else None
                for name, v in (("loss", loss), ("grad_norm", gnorm)):
                    if v is not None and not math.isfinite(v):
                        raise SDC("step_nonfinite", self._step, f"{self.site}/{entry.key}: {name} = {v}")
            except SDC as e:
                params, opt_state = self._trip_and_recover(e, entry.key, str(e)[:200],
                                                           f"SDC({e.kind}): {e.detail}"[:200], (params, opt_state))
                continue
            except Exception as e:  # noqa: BLE001 — classified below
                if not _is_device_loss(e):
                    raise
                kind = _loss_kind(e)
                sdc = SDC(kind, self._step, str(e)[:200])
                params, opt_state = self._trip_and_recover(sdc, entry.key, str(e)[:200], f"SDC({kind}): {e}"[:200],
                                                           (params, opt_state))
                continue
            self._journal("sup_step", key=f"sstep:{self._step}", entry=entry.key, attempts=self.attempts,
                          replays=self.replays)
            self.pool.note_clean_batch()
            self._step += 1
            return out

    def trip_external(self, e: SDC, params, opt_state):
        """A trip from the caller's own screening (the train loop's
        ``Sentinel``) routed into the degrade, reshard and replay path.
        Returns the resharded ``(params, opt_state)``; raises
        :class:`DegradationExhausted` when the ladder is spent."""
        return self._trip_and_recover(e, self.entry.key, str(e)[:200], f"SDC({e.kind}): {e.detail}"[:200],
                                      (params, opt_state))

    @off_timed_path
    def request_degrade(self, cause: str) -> bool:
        """A voluntary one-rung degrade, a capacity decision (the serving
        controller's ``degrade_capacity``): the same walk as a trip,
        journaled with cause ``requested: ...``, ``on_rebuild`` fired. The
        grow-back floor is pinned at the current pool, so only
        :meth:`request_promote` climbs back. False at the floor."""
        if self._idx + 1 >= len(self.ladder):
            return False
        try:
            self._advance(f"requested: {cause}"[:200], RuntimeError(cause))
        except DegradationExhausted:
            return False
        self._promote_floor_alive = self.pool.n_alive
        return True

    @off_timed_path
    def request_promote(self, params, opt_state=None):
        """The voluntary climb: one rung up, past the hysteresis floor, with
        every check :meth:`promote` makes. Returns the resharded state, or
        None when nothing was adopted."""
        if self._idx == 0:
            return None
        return self.promote(params, opt_state=opt_state, target_idx=self._idx - 1)

    # ------------------------------------------------------------ grow-back

    def _spot_batch(self):
        """The sentinel input a promotion is verified on (all ones, one
        image) and a zero target for the training step."""
        from ..models.alexnet import output_shape
        from ..models.init import deterministic_input

        x = deterministic_input(1, self.model_cfg, device=self.device)
        oh, ow, oc = output_shape(self.model_cfg)
        return x, torch.zeros((1, oh, ow, oc), dtype=torch.float32, device=self.device)

    def _promotion_target(self) -> Optional[int]:
        """The highest rung above the current one the eligible pool
        satisfies (probationary and quarantined slots do not count)."""
        for j in range(self._idx):
            entry = self.ladder[j]
            if entry.strategy == "single" or entry.n_shards <= self.pool.n_alive:
                return j
        return None

    @off_timed_path
    def maybe_promote(self, params, opt_state=None):
        """The between-batches grow-back hook: retry pending heals, and when
        the eligible count has grown past the last degrade's and a higher
        rung fits, run :meth:`promote`. Returns None, or the state resharded
        onto the promoted rung (``params``, or ``(params, opt_state)``)."""
        self.pool.rejoin_check()
        if self._idx == 0:
            return None
        if self._promote_floor_alive is None or self.pool.n_alive <= self._promote_floor_alive:
            return None
        target = self._promotion_target()
        if target is None or target >= self._idx:
            return None
        return self.promote(params, opt_state=opt_state, target_idx=target)

    @off_timed_path
    def promote(self, params, opt_state=None, target_idx: Optional[int] = None):
        """Climb to ``target_idx`` under a ``sup.recover`` span: build the
        rung over the eligible slots, verify it against the current rung on
        the sentinel input (:meth:`_verify_candidate`), and only then switch
        and reshard the state up (``on_rebuild`` fired). A candidate that
        does not build falls to the next rung down; one that changes results
        is refused (``sup_promote_refused``). Returns the resharded state, or
        None when no rung was adopted."""
        if target_idx is None:
            target_idx = self._promotion_target()
        if target_idx is None or target_idx >= self._idx:
            return None
        training = self.step_builder is not None and opt_state is not None
        cur = self.entry
        state = (params, opt_state) if training else params
        t_start = time.perf_counter()
        with obs_span("sup.recover", frm=cur.key, pool=self.pool.summary()) as sp:
            for j in range(target_idx, self._idx):
                entry = self.ladder[j]
                if entry.strategy != "single" and entry.n_shards > self.pool.n_alive:
                    continue
                try:
                    ok, refused_reason, built = self._verify_candidate(entry, params, opt_state, training)
                except Exception:  # noqa: BLE001 — the next rung down may still fit
                    continue
                if not ok:
                    self._journal("sup_promote_refused", key=f"promote-refused:{entry.key}", frm=cur.key,
                                  to=entry.key, devices=self.pool.n_alive, cause=refused_reason[:200])
                    if sp is not None:
                        sp.set(refused=entry.key)
                    self._promote_floor_alive = self.pool.n_alive
                    return None
                self._idx = j
                if training:
                    self._sfn, self._fwd = built, None
                else:
                    self._fwd, self._sfn = built, None
                self._compiled.clear()
                with obs_span("sup.promote", frm=cur.key, to=entry.key):
                    state = self.reshard(state)
                    if self.on_rebuild is not None:
                        self.on_rebuild(entry)
                    self.promotions += 1
                    self._promote_floor_alive = self.pool.n_alive
                    self._journal("sup_promote", key=f"promote:{self.promotions}", frm=cur.key, to=entry.key,
                                  devices=self.pool.n_alive, step=self._step,
                                  ms=round((time.perf_counter() - t_start) * 1e3, 3))
                return state
        return None

    @staticmethod
    def _rel_err(a, b) -> float:
        """max|a - b| / max|a| over trees (the precision gate's metric)."""
        from ..utils.tree import tree_leaves

        la, lb = tree_leaves(a), tree_leaves(b)
        if len(la) != len(lb):
            return float("inf")
        worst = 0.0
        for x, y in zip(la, lb):
            x = x.detach().double().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)
            y = y.detach().double().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y, np.float64)
            if x.shape != y.shape:
                return float("inf")
            scale = max(float(np.max(np.abs(x))) if x.size else 0.0, 1e-30)
            worst = max(worst, float(np.max(np.abs(x - y))) / scale if x.size else 0.0)
        return worst

    def _verify_candidate(self, entry: LadderEntry, params, opt_state, training):
        """Build the candidate rung and hold it to the current rung on the
        sentinel batch within ``promote_rtol`` of the max (a shard count
        reorders nothing on the reference tier, and a slot computing wrong
        results misses by orders of magnitude). Returns ``(ok, reason,
        built)``."""
        from ..parallel.elastic import reshard_tree

        x, y = self._spot_batch()
        mesh = self.pool.mesh_for(max(1, entry.n_shards if entry.strategy != "single" else 1))
        if training:
            cand = self.step_builder(entry, self._entry_mesh(entry))
            cur_fn = self.step_fn()
            p2, o2 = reshard_tree((params, opt_state), mesh)
            a = cur_fn(params, opt_state, x, y)
            b = cand(p2, o2, x, y)
            rel = max(self._rel_err(a[0], b[0]), self._rel_err(a[2], b[2]))
        else:
            cand = self._build_entry(entry)
            cur_fn = self.fwd()
            a, _ = cur_fn(params, x)
            b, _ = cand(reshard_tree(params, mesh), x)
            rel = self._rel_err(a, b)
        if rel > self.promote_rtol:
            return False, (f"sentinel spot-check mismatch: candidate {entry.key} diverges from {self.entry.key} by "
                           f"rel {rel:.3e} (> promote_rtol {self.promote_rtol:g})"), cand
        return True, "", cand

    # ------------------------------------------------------------ surfacing

    @property
    def degraded(self) -> bool:
        return bool(self.events)

    def summary(self) -> str:
        """One machine-parsed line for the run CLI ('Supervisor: ...')."""
        kinds = ",".join(t.kind for t in self.trips) or "none"
        return (f"attempts={self.attempts} trips={len(self.trips)} degradations={len(self.events)} "
                f"entry={self.entry.key} kinds={kinds} replays={self.replays} promotions={self.promotions} "
                f"pool={self.pool.summary()} quarantined={self.pool.n_quarantined}")
