"""Journal loading and the Perfetto export: spans and journal records
stitched into one Chrome trace-event timeline.

The JAX package's ``observability/export.py``. ``python -m
cuda_mpi_gpu_cluster_programming_tpu_torch.observability export --journal
<dir|file.jsonl>`` reads every journal in sight and writes a JSON object
Perfetto loads (``{"traceEvents": [...]}``, ``ts``/``dur`` in microseconds),
so a ``run --serve`` run, a supervised training run or a fleet drill
opens in https://ui.perfetto.dev as one correlated timeline:

- ``kind="span"`` records (``observability.trace``) become complete ("X")
  events; a greedy lane assigner (:class:`_Lanes`) splits spans that truly
  overlap onto separate tids, so no slice renders mis-nested.
- records carrying a ``span_id`` become instants pinned to their span's lane
  at its end (a correlated ``compile_event`` a slice ending there, on a
  ``compile`` sub-lane).
- uncorrelated records land on a per-kind timeline in append order; those
  with a duration field (``batch_ms``/``ms``) render as slices, gauges as
  counter tracks.
- folded incidents (``health.incidents_from_records``) get their own lane,
  a parent slice whose phase children tile it; the router gets its own.

Also here: :func:`bench_report`, the text face of the cross-run regression
gate (:mod:`.gate`). Standard library only.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

from ..resilience.journal import Journal, atomic_write_text

# Subsystem -> pid. Span names are "<subsystem>.<what>"; record kinds map
# through _KIND_PID.
_PIDS = {
    "run": 1,
    "serve": 2,
    "sup": 3,
    "tune": 4,
    "train": 5,
    "stages": 6,
    "journal": 7,
    # folded incidents (health.incidents_from_records): a parent slice per
    # incident whose phase children tile it, the MTTR decomposition to scale
    "incident": 8,
    # the fleet router: route verdicts, redirects and backend state
    # transitions, beside each backend's serve lane when a directory exports
    "router": 9,
    # the serving controller's actions, reversals and refusals, evidence as args
    "controller": 10,
    # the fleet control plane: probe scrapes and cross-backend arbitration
    "fleet": 11,
}
_KIND_PID = {
    "serve_batch": "serve", "serve_shed": "serve", "serve_fail": "serve",
    "serve_miss": "serve", "serve_warm": "serve", "serve_rewarm": "serve",
    # gauges and memory snapshots render as counter tracks (_COUNTER_KINDS)
    "serve_gauges": "serve", "mem_snapshot": "serve",
    "serve_transport": "serve", "serve_reject": "serve",
    "serve_config": "serve", "serve_submit": "serve",
    "sup_build": "sup", "sup_trip": "sup", "sup_degrade": "sup",
    "sup_ok": "sup", "sup_warm": "sup", "sup_reshard": "sup",
    "sup_replay": "sup", "sup_step": "sup", "mesh_shrink": "sup",
    # grow-back records share the trip family's lane: trip -> degrade ->
    # heal -> probation -> promote reads as one timeline
    "mesh_probation": "sup", "mesh_quarantine": "sup",
    "sup_promote": "sup", "sup_promote_refused": "sup",
    # a correlated compile pins inside the warmup/rewarm span that paid for it
    "compile_event": "sup",
    "router_config": "router", "router_route": "router",
    "router_redirect": "router", "router_backend_state": "router",
    "controller_action": "controller",
    "fleet_action": "fleet", "fleet_refusal": "fleet",
    "router_probe": "fleet",
    "gate_pass": "tune", "gate_fail": "tune",
    "step": "train", "ckpt": "train", "rollback": "train", "resume": "train",
    "wedge_detected": "journal", "recycle": "journal", "reprobe": "journal",
}
# The duration field of an uncorrelated record that carries a measured wall
# time: such records render as slices, not instants.
_KIND_DUR_FIELD = {
    "serve_batch": "batch_ms",
    "serve_warm": "ms",
    "serve_rewarm": "ms",
    "serve_transport": "ms",  # the whole HTTP exchange
    "sup_warm": "ms",
    "sup_promote": "ms",  # spot check + reshard + re-warm
    "mesh_probation": "ms",  # a "pass" record: the ms the slot waited
    "compile_event": "ms",
    "router_route": "ms",  # receive -> response at the router
    "controller_action": "ms",
    "fleet_action": "ms",
}
# Gauge-bearing record kinds -> the numeric fields that become counter
# series ("C" events); a record missing a field skips that series.
_COUNTER_KINDS = {
    "serve_gauges": ("depth", "pending_images", "oldest_wait_ms", "ctl_level"),
    "mem_snapshot": ("bytes_in_use", "peak_bytes_in_use"),
}


def load_records(path) -> List[dict]:
    """All journal records under ``path``: one ``.jsonl`` file, or every
    ``*.jsonl`` in a directory (sorted by name, so a replay is stable)."""
    p = Path(path)
    if p.is_dir():
        records: List[dict] = []
        for f in sorted(p.glob("*.jsonl")):
            records.extend(Journal.load(f))
        return records
    return Journal.load(p)


def _span_pid(name: str) -> int:
    return _PIDS.get(name.split(".", 1)[0], _PIDS["run"])


def _kind_pid(kind: str) -> int:
    return _PIDS[_KIND_PID.get(kind, "journal")]


class _Lanes:
    """Greedy interval-partitioning of slices into lanes (exported tids):
    a slice joins a lane if it nests inside the lane's innermost open
    slice or starts after everything on the lane ended. Keeps Chrome's
    same-tid containment invariant true by construction."""

    def __init__(self):
        self._lanes: List[List[float]] = []  # per lane: stack of open end-times

    def place(self, t0: float, t1: float) -> int:
        for i, stack in enumerate(self._lanes):
            while stack and stack[-1] <= t0:
                stack.pop()
            if not stack or t1 <= stack[-1]:
                stack.append(t1)
                return i
        self._lanes.append([t1])
        return len(self._lanes) - 1


def to_trace_events(records: List[dict]) -> dict:
    """Stitch journal records into ``{"traceEvents": [...]}`` (µs)."""
    spans = [r for r in records if r.get("kind") == "span"]
    others = [r for r in records if r.get("kind") != "span"]

    events: List[dict] = []
    # (pid, track-group) -> lane allocator; exported tid = stable index of
    # (pid, group, lane) so every lane gets its own named thread row.
    lanes: Dict[Tuple[int, str], _Lanes] = {}
    tid_map: Dict[Tuple[int, str, int], int] = {}
    tid_names: Dict[Tuple[int, int], str] = {}

    def _tid_for(pid: int, group: str, t0: float, t1: float) -> int:
        lane = lanes.setdefault((pid, group), _Lanes()).place(t0, t1)
        key = (pid, group, lane)
        if key not in tid_map:
            tid_map[key] = len(tid_map) + 1
            tid_names[(pid, tid_map[key])] = (
                f"{group}" + (f" [{lane}]" if lane else "")
            )
        return tid_map[key]

    # Spans: sorted by start so lane assignment sees intervals in order.
    span_loc: Dict[str, Tuple[int, int, float, float]] = {}  # sid -> pid,tid,t0,t1
    for rec in sorted(spans, key=lambda r: (r.get("t0_ms", 0.0), -r.get("dur_ms", 0.0))):
        t0 = float(rec.get("t0_ms", 0.0)) * 1e3  # ms -> µs
        dur = max(1.0, float(rec.get("dur_ms", 0.0)) * 1e3)
        pid = _span_pid(str(rec.get("name", "")))
        group = str(rec.get("track") or f"t{rec.get('tid', 0)}")
        tid = _tid_for(pid, group, t0, t0 + dur)
        args = {
            k: rec[k]
            for k in ("trace_id", "span_id", "parent_id")
            if rec.get(k)
        }
        args.update(rec.get("attrs") or {})
        events.append(
            {
                "ph": "X", "name": rec.get("name", "span"), "cat": "span",
                "ts": round(t0, 1), "dur": round(dur, 1),
                "pid": pid, "tid": tid, "args": args,
            }
        )
        if rec.get("span_id"):
            span_loc[rec["span_id"]] = (pid, tid, t0, t0 + dur)

    # Incident lane (observability.health): fold the trail into incidents
    # and draw every span-timed one as a parent slice whose per-phase
    # children tile it end to end — the MTTR decomposition to scale.
    # Span-less incidents (old/untraced journals) have no wall-clock
    # placement and are skipped; the journal otherwise exports unchanged.
    from .health import incidents_from_records

    for inc in incidents_from_records(records):
        if inc.t0_ms is None or inc.wall_ms <= 0:
            continue
        pid = _PIDS["incident"]
        p_ts = round(inc.t0_ms * 1e3, 1)
        p_end = round((inc.t0_ms + inc.wall_ms) * 1e3, 1)
        if p_end <= p_ts:
            continue
        tid = _tid_for(pid, inc.kind, p_ts, p_end)
        events.append(
            {
                "ph": "X", "name": f"incident.{inc.kind}",
                "cat": "incident", "ts": p_ts,
                "dur": round(p_end - p_ts, 1), "pid": pid, "tid": tid,
                "args": {
                    "entry": inc.entry, "cause": inc.cause,
                    "wall_ms": round(inc.wall_ms, 3),
                },
            }
        )
        cursor = p_ts
        for pname, v in inc.phases.items():
            if not v or v <= 0:
                continue
            end = min(p_end, round(cursor + v * 1e3, 1))
            dur = round(end - cursor, 1)
            if dur <= 0:
                continue
            events.append(
                {
                    "ph": "X", "name": f"phase.{pname}",
                    "cat": "incident", "ts": round(cursor, 1),
                    "dur": dur, "pid": pid, "tid": tid,
                    "args": {"ms": round(v, 3)},
                }
            )
            cursor = end

    # Journal records: correlated ones pin to their span; the rest get a
    # synthetic per-kind timeline that preserves append order.
    synth_clock: Dict[str, float] = {}
    for idx, rec in enumerate(others):
        kind = str(rec.get("kind", "record"))
        args = {k: v for k, v in rec.items() if k != "kind"}
        sid = rec.get("span_id")
        if sid and sid in span_loc:
            pid, tid, s_t0, t1 = span_loc[sid]
            ms = rec.get("ms")
            if (
                kind == "compile_event"
                and isinstance(ms, (int, float))
                and ms > 0
            ):
                # A correlated compile renders as a SLICE ending where its
                # enclosing warmup/rewarm span ends (the compile is the
                # tail of the timed first call), on a "compile" sub-lane
                # of the span's process row — several buckets compiling
                # under one rewarm span would mis-nest on the span's own
                # lane.
                dur = float(ms) * 1e3
                ts = max(s_t0, t1 - dur)
                ctid = _tid_for(pid, "compile", ts, t1)
                events.append(
                    {
                        "ph": "X", "name": kind, "cat": "journal",
                        "ts": round(ts, 1), "dur": round(t1 - ts, 1),
                        "pid": pid, "tid": ctid, "args": args,
                    }
                )
                continue
            events.append(
                {
                    "ph": "i", "name": kind, "cat": "journal",
                    "ts": round(t1, 1), "pid": pid, "tid": tid,
                    "s": "t", "args": args,
                }
            )
            continue
        pid = _kind_pid(kind)
        if kind in _COUNTER_KINDS:
            # Counter tracks: one "C" event per gauge field. The synthetic
            # append-order clock keeps the series monotonic alongside the
            # other uncorrelated records.
            t0 = max(synth_clock.get(kind, 0.0), float(idx) * 1e3)
            for field in _COUNTER_KINDS[kind]:
                v = rec.get(field)
                if isinstance(v, (int, float)):
                    events.append(
                        {
                            "ph": "C", "name": f"{kind}.{field}",
                            "cat": "journal", "ts": round(t0, 1),
                            "pid": pid, "tid": 0,
                            "args": {field: v},
                        }
                    )
            synth_clock[kind] = t0 + 1.0
            continue
        dur_field = _KIND_DUR_FIELD.get(kind)
        dur_ms = rec.get(dur_field) if dur_field else None
        t0 = max(synth_clock.get(kind, 0.0), float(idx) * 1e3)  # µs, ordered
        if isinstance(dur_ms, (int, float)) and dur_ms > 0:
            dur = float(dur_ms) * 1e3
            tid = _tid_for(pid, kind, t0, t0 + dur)
            events.append(
                {
                    "ph": "X", "name": kind, "cat": "journal",
                    "ts": round(t0, 1), "dur": round(dur, 1),
                    "pid": pid, "tid": tid, "args": args,
                }
            )
            synth_clock[kind] = t0 + dur
        else:
            tid = _tid_for(pid, kind, t0, t0 + 1.0)
            events.append(
                {
                    "ph": "i", "name": kind, "cat": "journal",
                    "ts": round(t0, 1), "pid": pid, "tid": tid,
                    "s": "t", "args": args,
                }
            )
            synth_clock[kind] = t0 + 1.0

    meta: List[dict] = []
    for name, pid in sorted(_PIDS.items(), key=lambda kv: kv[1]):
        if any(ev["pid"] == pid for ev in events):
            meta.append(
                {
                    "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": name},
                }
            )
    for (pid, tid), tname in sorted(tid_names.items()):
        meta.append(
            {
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tname},
            }
        )
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export_trace(journal_path, out_path) -> dict:
    """Load, stitch, atomically write. Returns a summary dict (the CLI
    prints it machine-readably)."""
    records = load_records(journal_path)
    trace = to_trace_events(records)
    atomic_write_text(out_path, json.dumps(trace))
    n_spans = sum(1 for r in records if r.get("kind") == "span")
    return {
        "out": str(out_path),
        "records": len(records),
        "spans": n_spans,
        "events": len(trace["traceEvents"]),
    }


# ------------------------------------------------------------ bench report


def bench_report(paths) -> str:
    """Cross-run text report: the BENCH_r*.json trajectory with >10%
    regressions between consecutive measured rounds flagged (plus
    per-stage breakdown deltas, with ``last_good``-echo rounds labeled
    and excluded). The text face of :mod:`..observability.gate` — the
    structured verdict (and the nonzero-exit CI gate) lives there."""
    from .gate import evaluate

    return evaluate(paths).render()
