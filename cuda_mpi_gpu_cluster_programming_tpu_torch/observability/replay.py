"""Journal replay: re-drive a recorded serve run through a live server.

The JAX package's ``observability/replay.py``. Every serve journal carries
the full *input* of its run, not only the outcomes: one ``serve_config``
record (config, shards, bucket set, SLO policy, geometry, controller) and
one ``serve_submit`` record per admission attempt (arrival offset, request
size, class, resolved deadline, admitted or not). This module rebuilds
that schedule and re-runs it through a **live** port
:class:`~..serving.server.InferenceServer` on ``ReplayKnobs.device`` (the
card unless the caller asks for the CPU): the same arrivals, request
shapes and classes, so a capacity what-if is answered by a deterministic
replay:

- ``traffic_mult``: the arrival schedule replicated k times (a fractional
  part selected by a stable per-rid crc32, never an RNG): "would twice the
  traffic hold p99?"
- ``slo_scale``: every class latency budget and per-request deadline
  scaled: "...with SLOs twice as tight?"
- ``controller``: the controller's A/B, forced on or off over one record.

**The determinism contract**: a replay of a journal under its own recorded
conditions (every knob neutral) must close per-class accounting
*identically* (the same offered / ok / shed / failed / rejected per class)
and reproduce the journal-derived p50/p99 within the nearest-rank
estimator's resolution (:func:`percentile_resolution`: the bracket between
adjacent order statistics, floored at the dispatch poll quantum). A neutral
replay that breaks it is a **divergence**; the CLI exits 3 on it.

What the port does not replay, and refuses with a ``ValueError`` naming its
ROADMAP Queue 1 item: ``devices`` other than one, or a journal recorded at
more than one shard (the distribution tiers, item 3), and a journal of a
supervised run or one holding device-loss incidents (the JAX replay scripts
them through the elastic supervisor's ``script_fault``; the supervisor is
item 8). A journal recorded before the replay schema (no ``serve_submit``
records) raises too.

Standard library at import; torch and the serving stack load inside
:func:`replay_recorded`.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..resilience.journal import Journal
from .export import load_records

# Journal kinds that mark grow-back activity replay cannot re-drive
# (losses are scripted; heals/promotions depend on live pool state).
_GROWBACK_KINDS = (
    "mesh_probation",
    "mesh_quarantine",
    "sup_promote",
    "sup_promote_refused",
)


# ------------------------------------------------------------- recording ---


@dataclasses.dataclass(frozen=True)
class RecordedSubmit:
    """One recorded admission attempt (a ``serve_submit`` record)."""

    t_ms: float  # arrival offset from the recorded server's epoch
    rid: str
    n: int
    cls: str
    deadline_s: Optional[float]
    admitted: bool
    reason: str  # "" | "queue_full" | "too_wide"


@dataclasses.dataclass(frozen=True)
class RecordedFault:
    """One recorded device-loss incident (``sup_trip`` + its paired
    ``mesh_shrink`` record when the loss shrank the pool)."""

    step: int
    kind: str  # "device_loss" | "mesh_shrink"
    lost: Tuple[int, ...]
    cause: str


def _empty_counts() -> Dict[str, int]:
    return {"offered": 0, "ok": 0, "shed": 0, "failed": 0, "rejected": 0}


@dataclasses.dataclass
class RecordedRun:
    """Everything a journal says about one serve run: the conditions
    (``config`` — the ``serve_config`` record), the offered schedule, the
    incident trail, and the recorded outcome accounting to diff a replay
    against."""

    config: dict
    submits: List[RecordedSubmit]
    faults: List[RecordedFault]
    accounting: Dict[str, Dict[str, int]]  # class -> closed counts
    latencies_ms: List[float]  # journal-derived (serve_batch req_lat_ms)
    class_latencies_ms: Dict[str, List[float]]
    unreplayed: Dict[str, int]  # journal kinds replay does not re-drive
    source: str = ""

    @property
    def duration_s(self) -> float:
        if not self.submits:
            return 0.0
        ts = [s.t_ms for s in self.submits]
        return (max(ts) - min(ts)) / 1e3


def load_recorded_run(journal_path) -> RecordedRun:
    """Reconstruct a :class:`RecordedRun` from a journal file/dir.

    Raises an attributable ``ValueError`` when the journal predates the
    replay schema (no ``serve_submit`` arrival records, or no
    ``serve_config`` conditions record) — an unreplayable journal is a
    loud refusal, never a silently-empty load."""
    records = load_records(journal_path)
    return recorded_run_from_records(records, source=str(journal_path))


def recorded_run_from_records(
    records: List[dict], source: str = ""
) -> RecordedRun:
    config: Optional[dict] = None
    submits: List[RecordedSubmit] = []
    faults: List[RecordedFault] = []
    accounting: Dict[str, Dict[str, int]] = {}
    latencies: List[float] = []
    class_lat: Dict[str, List[float]] = {}
    unreplayed: Dict[str, int] = {}
    pending_shrinks: List[dict] = []

    def counts(cls: str) -> Dict[str, int]:
        return accounting.setdefault(cls, _empty_counts())

    for rec in records:
        kind = rec.get("kind")
        if kind == "serve_config":
            new_cfg = {k: v for k, v in rec.items() if k not in ("kind", "key")}
            if config is not None and new_cfg != config:
                # Two DIFFERENT servers journaled into one file: there is
                # no single set of conditions to replay under. A reused
                # journal path is an operator mistake worth naming, not
                # silently replaying half the evidence.
                raise ValueError(
                    f"journal {source or '<records>'} carries two differing "
                    "serve_config records — it mixes runs from different "
                    "server configurations; record each serve run into its "
                    "own journal file"
                )
            config = new_cfg
        elif kind == "serve_submit":
            sub = RecordedSubmit(
                t_ms=float(rec.get("t_ms", 0.0)),
                rid=str(rec.get("rid", "")),
                n=int(rec.get("n", 1)),
                cls=str(rec.get("cls", "")),
                deadline_s=(
                    float(rec["deadline_s"])
                    if rec.get("deadline_s") is not None
                    else None
                ),
                admitted=bool(rec.get("admitted", True)),
                reason=str(rec.get("reason", "")),
            )
            submits.append(sub)
            c = counts(sub.cls)
            c["offered"] += 1
            if not sub.admitted:
                c["rejected"] += 1
        elif kind == "serve_batch":
            req_lat = rec.get("req_lat_ms") or {}
            req_cls = rec.get("req_cls") or {}
            for rid, ms in req_lat.items():
                cls = str(req_cls.get(rid, ""))
                counts(cls)["ok"] += 1
                if isinstance(ms, (int, float)):
                    latencies.append(float(ms))
                    class_lat.setdefault(cls, []).append(float(ms))
        elif kind == "serve_shed":
            counts(str(rec.get("cls", "")))["shed"] += 1
        elif kind == "serve_fail":
            req_cls = rec.get("req_cls")
            if isinstance(req_cls, dict) and req_cls:
                for cls in req_cls.values():
                    counts(str(cls))["failed"] += 1
            else:  # pre-PR12 serve_fail: no per-request attribution
                counts("")["failed"] += int(rec.get("n_requests", 0))
        elif kind == "mesh_shrink":
            pending_shrinks.append(rec)
        elif kind == "sup_trip":
            sdc_kind = str(rec.get("sdc_kind", "device_loss"))
            lost: Tuple[int, ...] = ()
            if sdc_kind == "mesh_shrink" and pending_shrinks:
                shrink = pending_shrinks.pop()
                lost = tuple(int(i) for i in shrink.get("lost") or ())
            faults.append(
                RecordedFault(
                    step=int(rec.get("step", 0)),
                    kind=sdc_kind,
                    lost=lost,
                    cause=str(rec.get("cause", ""))[:120],
                )
            )
        elif kind in _GROWBACK_KINDS:
            unreplayed[kind] = unreplayed.get(kind, 0) + 1

    if not submits:
        raise ValueError(
            f"journal {source or '<records>'} has no serve_submit records — "
            "it was recorded before the replay schema; re-record with a "
            "journaled server (run --serve --serve-journal / BENCH_MODE=serve)"
        )
    if config is None:
        raise ValueError(
            f"journal {source or '<records>'} has no serve_config record — "
            "the recorded conditions (config/shards/buckets/SLO) are the "
            "other half of the replay contract; re-record with a journaled "
            "server"
        )
    return RecordedRun(
        config=config,
        submits=submits,
        faults=faults,
        accounting=accounting,
        latencies_ms=latencies,
        class_latencies_ms=class_lat,
        unreplayed=unreplayed,
        source=source,
    )


# ------------------------------------------------------------- estimator ---


def percentile_resolution(
    xs: List[float], q: float, floor: float = 50.0
) -> float:
    """The nearest-rank estimator's resolution at quantile ``q`` over
    sample ``xs``: half the bracket between the order statistics adjacent
    to the selected rank, floored at ``floor`` (default 50 — the serving
    dispatch poll quantum in ms, the granularity below which two wall
    measurements of one schedule are indistinguishable). Two runs of the
    same offered schedule "agree" on a percentile when they differ by
    less than the sum of their resolutions — the estimator cannot claim
    more precision than the spacing of its own observed samples."""
    if not xs:
        return floor
    s = sorted(xs)
    n = len(s)
    rank = int(math.ceil(q / 100.0 * n)) if q > 0 else 1
    i = min(max(rank, 1), n) - 1
    lo = s[max(0, i - 1)]
    hi = s[min(n - 1, i + 1)]
    return max(floor, (hi - lo) / 2.0)


def _nearest_rank(xs: List[float], q: float) -> Optional[float]:
    from ..serving.loadgen import percentile

    return percentile(xs, q)


# ----------------------------------------------------------------- replay ---


@dataclasses.dataclass(frozen=True)
class ReplayKnobs:
    """The what-if dials. All neutral = the determinism contract run."""

    traffic_mult: float = 1.0
    devices: Optional[int] = None  # shard width override (None = recorded; > 1 waits for item 3)
    slo_scale: float = 1.0
    journal_path: str = ""  # replay's own journal (default: temp file)
    wait_timeout_s: float = 120.0
    percentile_floor_ms: float = 50.0
    # The controller's A/B dial: "" = as recorded, "on" = force a controller
    # onto the replay server (the recorded one when the journal carried its
    # config, defaults otherwise), "off" = strip it. One saturating trace
    # re-driven both ways is the controller's proof: the protected class's
    # burn must drop with it on, and the books must close both ways.
    controller: str = ""
    # Optional ControllerConfig.to_obj() dict for the forced-on side (a
    # short drill needs a snappier dwell and cooldown than the defaults).
    # Ignored unless ``controller == "on"``.
    controller_cfg: Optional[dict] = None
    device: str = "cuda"  # the replay server's device ("cpu" only when asked)

    @property
    def neutral(self) -> bool:
        # Forcing a controller ON is a what-if (the question being
        # asked); "" and "off" leave an uncontrolled recording untouched.
        return (
            self.traffic_mult == 1.0
            and self.devices is None
            and self.slo_scale == 1.0
            and self.controller != "on"
        )


def expand_schedule(
    submits: List[RecordedSubmit], mult: float
) -> List[RecordedSubmit]:
    """The offered schedule at ``mult``× traffic: each recorded arrival is
    replicated ``floor(mult)`` times (copies share the arrival instant —
    a doubled fleet of clients sends what it sends), and the fractional
    remainder selects arrivals by a stable hash of their rid — the
    deterministic-schedule rule (two replays at one mult offer identical
    work), with no RNG that a reseed could shear."""
    if mult <= 0:
        raise ValueError(f"traffic_mult must be > 0, got {mult}")
    whole, frac = int(mult), mult - int(mult)
    out: List[RecordedSubmit] = []
    for idx, sub in enumerate(submits):
        copies = whole
        if frac > 0.0:
            h = zlib.crc32(f"{sub.rid}:{idx}".encode()) % 10_000
            if h < frac * 10_000:
                copies += 1
        for c in range(copies):
            rid = sub.rid if c == 0 and sub.rid else ""
            out.append(dataclasses.replace(sub, rid=rid))
    out.sort(key=lambda s: s.t_ms)
    return out


@dataclasses.dataclass
class ReplayReport:
    """One replay's verdict: per-class accounting vs the record, both
    percentile pairs, and the divergence call."""

    knobs: ReplayKnobs
    recorded: RecordedRun
    per_class: Dict[str, Dict[str, int]]
    latencies_ms: List[float]
    class_latencies_ms: Dict[str, List[float]]
    scripted_faults: int
    duration_s: float
    sustained_img_s: float
    cache_misses: int
    journal_path: str
    trace_id: str = ""
    # Whether the replay server ran an autopilot, and what it did
    # (serving.controller state_obj) — the A/B's on-side summary.
    controller_active: bool = False
    controller_state: Optional[dict] = None

    # -- accounting ---------------------------------------------------------

    @property
    def accounting_matches(self) -> bool:
        """Per-class identity with the record — offered / ok / shed /
        failed / rejected all equal for every class. The determinism
        contract's accounting half (only meaningful at neutral knobs)."""
        classes = set(self.per_class) | set(self.recorded.accounting)
        for cls in classes:
            if self.per_class.get(cls, _empty_counts()) != (
                self.recorded.accounting.get(cls, _empty_counts())
            ):
                return False
        return True

    @property
    def accounting_closed(self) -> bool:
        """ok + shed + failed + rejected == offered, per class — the
        no-silent-loss contract, which must hold at ANY knob setting."""
        return all(
            c["ok"] + c["shed"] + c["failed"] + c["rejected"] == c["offered"]
            for c in self.per_class.values()
        )

    @property
    def n_offered(self) -> int:
        return sum(c["offered"] for c in self.per_class.values())

    @property
    def n_shed(self) -> int:
        return sum(c["shed"] for c in self.per_class.values())

    # -- percentiles --------------------------------------------------------

    def percentile_pair(self, q: float) -> Tuple[Optional[float], Optional[float]]:
        return (
            _nearest_rank(self.recorded.latencies_ms, q),
            _nearest_rank(self.latencies_ms, q),
        )

    def percentile_within_resolution(self, q: float) -> Optional[bool]:
        """None when either side measured nothing; else whether record and
        replay agree within the estimator's own resolution."""
        rec, rep = self.percentile_pair(q)
        if rec is None or rep is None:
            return None
        floor = self.knobs.percentile_floor_ms
        tol = percentile_resolution(
            self.recorded.latencies_ms, q, floor
        ) + percentile_resolution(self.latencies_ms, q, floor)
        return abs(rec - rep) <= tol

    @property
    def percentiles_within_resolution(self) -> bool:
        return all(
            self.percentile_within_resolution(q) is not False for q in (50, 99)
        )

    # -- verdict ------------------------------------------------------------

    @property
    def diverged(self) -> bool:
        """True when a NEUTRAL replay broke the determinism contract.
        Accounting must match identically in every neutral replay; the
        percentile half additionally gates incident-FREE replays only —
        a re-driven device loss pays the degraded rung's compile time,
        which is process compile-cache state, not part of the recorded
        schedule (both pairs are always reported either way). What-if
        runs (any knob turned) are never 'divergent'; they are the
        question being asked."""
        if not self.knobs.neutral:
            return False
        if self.controller_active or self.recorded.config.get("controller"):
            # A closed-loop controller actuates on wall-clock signals
            # (burn windows, queue waits) — its actions are not part of
            # the recorded schedule, so the determinism contract only
            # binds controller-free pairs. The A/B's assertable half is
            # accounting_closed + the burn comparison, not identity.
            return False
        if not self.accounting_matches:
            return True
        return self.scripted_faults == 0 and not self.percentiles_within_resolution

    def summary(self) -> str:
        """One machine-parseable 'Replay:' payload (run CLI contract)."""
        rec50, rep50 = self.percentile_pair(50)
        rec99, rep99 = self.percentile_pair(99)

        def fmt(v):
            return f"{v:.3f}" if v is not None else "nan"

        totals = _empty_counts()
        for c in self.per_class.values():
            for k in totals:
                totals[k] += c[k]
        return (
            f"offered={totals['offered']} ok={totals['ok']} "
            f"shed={totals['shed']} failed={totals['failed']} "
            f"rejected={totals['rejected']} "
            f"mult={self.knobs.traffic_mult:g} "
            f"devices={self.knobs.devices if self.knobs.devices is not None else 'recorded'} "
            f"slo_scale={self.knobs.slo_scale:g} "
            f"controller={'on' if self.controller_active else 'off'} "
            f"accounting_matches={self.accounting_matches} "
            f"closed={self.accounting_closed} "
            f"p50_ms={fmt(rep50)}/{fmt(rec50)} p99_ms={fmt(rep99)}/{fmt(rec99)} "
            f"within_resolution={self.percentiles_within_resolution} "
            f"faults={self.scripted_faults} diverged={self.diverged}"
        )

    def class_lines(self) -> List[str]:
        out = []
        for cls in sorted(set(self.per_class) | set(self.recorded.accounting)):
            got = self.per_class.get(cls, _empty_counts())
            want = self.recorded.accounting.get(cls, _empty_counts())
            out.append(
                f"Replay class: name={cls or 'default'} "
                + " ".join(
                    f"{k}={got[k]}/{want[k]}"
                    for k in ("offered", "ok", "shed", "failed", "rejected")
                )
            )
        return out

    def to_obj(self) -> dict:
        rec50, rep50 = self.percentile_pair(50)
        rec99, rep99 = self.percentile_pair(99)
        return {
            "source": self.recorded.source,
            "traffic_mult": self.knobs.traffic_mult,
            "devices": self.knobs.devices,
            "slo_scale": self.knobs.slo_scale,
            "neutral": self.knobs.neutral,
            "classes": {
                (cls or "default"): {
                    "replay": self.per_class.get(cls, _empty_counts()),
                    "recorded": self.recorded.accounting.get(
                        cls, _empty_counts()
                    ),
                }
                for cls in sorted(
                    set(self.per_class) | set(self.recorded.accounting)
                )
            },
            "accounting_matches": self.accounting_matches,
            "accounting_closed": self.accounting_closed,
            "p50_ms": rep50,
            "p99_ms": rep99,
            "recorded_p50_ms": rec50,
            "recorded_p99_ms": rec99,
            "percentiles_within_resolution": self.percentiles_within_resolution,
            "scripted_faults": self.scripted_faults,
            "unreplayed": dict(self.recorded.unreplayed),
            "duration_s": round(self.duration_s, 3),
            "value": round(self.sustained_img_s, 1),
            "cache_misses": self.cache_misses,
            "journal": self.journal_path,
            "trace_id": self.trace_id,
            "controller": self.controller_active,
            "controller_state": self.controller_state,
            "diverged": self.diverged,
        }


def _refusal(recorded: RecordedRun, knobs: ReplayKnobs) -> str:
    """Why the port cannot replay this run with these knobs ('' = it can)."""
    cfg = recorded.config
    shards = knobs.devices if knobs.devices is not None else int(cfg.get("n_shards", 1) or 1)
    if shards != 1:
        return (f"a replay at {shards} devices waits for the distribution tiers (ROADMAP Queue 1 item 3); "
                "the port serves on one device")
    if recorded.faults or cfg.get("supervise"):
        return (f"the recorded run was supervised ({len(recorded.faults)} device-loss incident(s)): re-driving "
                "its fault schedule waits for the elastic supervisor (ROADMAP Queue 1 item 8)")
    return ""


def _build_server(recorded: RecordedRun, knobs: ReplayKnobs):
    """A live server at the recorded conditions (modulo the knobs)."""
    import dataclasses as dc

    from ..models.alexnet import BLOCKS12
    from ..serving.server import InferenceServer, ServeConfig
    from ..serving.slo import SLOPolicy

    cfg = recorded.config
    channels = int(cfg.get("channels", 3))
    if channels != BLOCKS12.in_channels:
        raise ValueError(
            f"recorded run used {channels} input channels; the Blocks 1-2 "
            f"server takes {BLOCKS12.in_channels}: not replayable"
        )
    model_cfg = dc.replace(
        BLOCKS12,
        in_height=int(cfg.get("height", BLOCKS12.in_height)),
        in_width=int(cfg.get("width", BLOCKS12.in_width)),
    )
    slo = None
    if cfg.get("slo"):
        slo = SLOPolicy.from_obj(cfg["slo"])
        if knobs.slo_scale != 1.0:
            slo = slo.scaled(knobs.slo_scale)
    controller = None
    if knobs.controller != "off":
        # "" = as recorded; "on" forces one (rebuilding the recorded
        # knobs when the journal carried them, defaults otherwise).
        cobj = cfg.get("controller")
        if knobs.controller == "on" and knobs.controller_cfg:
            cobj = knobs.controller_cfg
        if knobs.controller == "on" or cobj:
            from ..serving.controller import ControllerConfig

            controller = (
                ControllerConfig.from_obj(cobj)
                if isinstance(cobj, dict)
                else ControllerConfig()
            )
    scfg = ServeConfig(
        config=str(cfg.get("config", "v1_jit")),
        compute=str(cfg.get("compute", "fp32")),
        max_batch=int(cfg.get("max_batch", 8)),
        buckets=tuple(cfg.get("buckets") or ()) or None,
        journal_path=knobs.journal_path,
        max_pending=int(cfg.get("max_pending", 1024)),
        poll_s=float(cfg.get("poll_s", 0.02)),
        default_deadline_s=(
            float(cfg["default_deadline_s"])
            if cfg.get("default_deadline_s") is not None
            else None
        ),
        model_cfg=model_cfg,
        slo=slo,
        controller=controller,
        device=knobs.device,
    )
    return InferenceServer(scfg)


def replay_recorded(
    recorded: RecordedRun, knobs: ReplayKnobs = ReplayKnobs()
) -> ReplayReport:
    """Re-drive a recorded run through a live server and report.

    The offered schedule is paced on the wall clock exactly as recorded
    (offsets normalized to the first arrival); every handle is awaited
    (bounded), so per-class accounting closes by construction. A run the
    port cannot replay raises ``ValueError`` naming its ROADMAP item
    (module docstring) before any server is built."""
    import tempfile

    import numpy as np

    from ..serving.queue import FAILED, OK, QueueFull, SHED
    from .metrics import registry as metrics_registry
    from .trace import Tracer, get_tracer, set_tracer, span

    why = _refusal(recorded, knobs)
    if why:
        raise ValueError(why)
    if not knobs.journal_path:
        fd, tmp_journal = tempfile.mkstemp(
            prefix="replay_journal_", suffix=".jsonl"
        )
        os.close(fd)
        knobs = dataclasses.replace(knobs, journal_path=tmp_journal)
    server = _build_server(recorded, knobs)
    schedule = expand_schedule(recorded.submits, knobs.traffic_mult)
    metrics_registry().reset()
    owns_tracer = get_tracer() is None
    tracer = None
    if owns_tracer and server.journal is not None:
        tracer = Tracer(journal=server.journal)
        set_tracer(tracer)

    per_class: Dict[str, Dict[str, int]] = {}
    class_lat: Dict[str, List[float]] = {}
    handles: List[Tuple[str, object]] = []
    imgs: dict = {}  # n -> cached deterministic input (allocation, not payload)
    m = server._model_cfg()

    def _input(n: int) -> np.ndarray:
        if n not in imgs:
            imgs[n] = np.ones(
                (n, m.in_height, m.in_width, m.in_channels), np.float32
            )
        return imgs[n]

    def counts(cls: str) -> Dict[str, int]:
        return per_class.setdefault(cls, _empty_counts())

    t0 = t_done = time.monotonic()
    drained = False
    try:
        server.start()
        t_first = schedule[0].t_ms if schedule else 0.0
        with span(
            "replay.load",
            source=recorded.source,
            offered=len(schedule),
            traffic_mult=knobs.traffic_mult,
        ):
            t0 = time.monotonic()
            for sub in schedule:
                at = (sub.t_ms - t_first) / 1e3
                now = time.monotonic() - t0
                if at > now:
                    time.sleep(at - now)
                c = counts(sub.cls)
                c["offered"] += 1
                deadline_s = sub.deadline_s
                if deadline_s is not None and knobs.slo_scale != 1.0:
                    deadline_s *= knobs.slo_scale
                try:
                    handles.append(
                        (
                            sub.cls,
                            server.submit(
                                _input(sub.n),
                                deadline_s=deadline_s,
                                rid=sub.rid or None,
                                cls=sub.cls,
                            ),
                        )
                    )
                except (QueueFull, ValueError):
                    c["rejected"] += 1  # backpressure: counted, attributed
        wait_deadline = time.monotonic() + knobs.wait_timeout_s
        for _cls, h in handles:
            h.wait(max(0.0, wait_deadline - time.monotonic()))
        images_ok = 0
        completed_at: List[float] = []
        t_done = time.monotonic()
        for cls, h in handles:
            c = counts(cls)
            if h.completed_at is not None:
                completed_at.append(h.completed_at)
            if h.status == OK:
                c["ok"] += 1
                images_ok += h.n_images
                if h.latency_ms is not None:
                    class_lat.setdefault(cls, []).append(h.latency_ms)
            elif h.status == SHED:
                c["shed"] += 1
            elif h.status == FAILED:
                c["failed"] += 1
            else:  # still PENDING past the bounded wait: a hung handle is
                # a failure, never an accounting leak
                c["failed"] += 1
        drained = True
    finally:
        try:
            # Drain only on the clean path; a failed replay must not hang
            # another wait_timeout on its way out. close() also releases the graphs.
            server.stop(drain=drained, timeout_s=10.0)
            server.close()
        except Exception:
            pass
        if tracer is not None:
            set_tracer(None)
    wall = (max(completed_at) - t0) if completed_at else (t_done - t0)

    # Journal-derived latencies — the SAME crash-consistent source the
    # recorded side's numbers come from, so the comparison is symmetric.
    from ..serving.server import latencies_from_records

    replay_records = Journal.load(knobs.journal_path)
    jlat = latencies_from_records(replay_records)

    return ReplayReport(
        knobs=knobs,
        recorded=recorded,
        per_class=per_class,
        latencies_ms=jlat,
        class_latencies_ms=class_lat,
        scripted_faults=len(recorded.faults),
        duration_s=wall,
        sustained_img_s=images_ok / wall if wall > 0 else 0.0,
        cache_misses=server.stats.cache_misses,
        journal_path=knobs.journal_path,
        trace_id=tracer.trace_id if tracer is not None else "",
        controller_active=server.controller is not None,
        controller_state=(
            server.controller.state_obj()
            if server.controller is not None
            else None
        ),
    )


def replay_journal(journal_path, **knob_kwargs) -> ReplayReport:
    """Load + replay in one call (the CLI / bench surface)."""
    return replay_recorded(
        load_recorded_run(journal_path), ReplayKnobs(**knob_kwargs)
    )
