"""The port's Perfetto export (``observability/export.py``) against the JAX
package's, on the CPU.

The export cases of the JAX ``tests/test_observability.py`` (spans and a
synthetic journal round-trip with valid nesting, the grow-back records on
the incident lane, the controller's own lane, a correlated record pinned to
its span, the ``export`` CLI on a file and a directory, ``bench_report``)
and the router lane of ``tests/test_router.py`` run on the port, and on the
same records ``to_trace_events`` gives the JAX package's dicts, including a
traced port supervisor drill whose incident renders on its own lane with
phase children tiling the parent.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.observability import export as jexport
from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import BLOCKS12
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import Tracer, set_tracer
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.export import (
    _PIDS,
    bench_report,
    export_trace,
    load_records,
    to_trace_events,
)
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import chaos
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal

ROOT = Path(__file__).resolve().parent.parent
PORT = "cuda_mpi_gpu_cluster_programming_tpu_torch"


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    set_tracer(None)
    yield
    set_tracer(None)


def _validate_nesting(trace):
    """X slices have int pids/tids, ts >= 0 and dur > 0, and slices sharing a
    (pid, tid) nest (contained or disjoint). Ends and starts are compared
    within 1e-6 us: an incident's phase children touch end to start, and
    ``ts + dur`` of the one before can round a hair past the next ``ts``."""
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    by_lane = {}
    for e in xs:
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        assert e["ts"] >= 0 and e["dur"] > 0
        by_lane.setdefault((e["pid"], e["tid"]), []).append(e)
    for lane in by_lane.values():
        lane.sort(key=lambda e: (e["ts"], -e["dur"]))
        open_stack = []
        for e in lane:
            while open_stack and open_stack[-1] <= e["ts"] + 1e-6:
                open_stack.pop()
            if open_stack:
                assert e["ts"] + e["dur"] <= open_stack[-1] + 1e-6, ("mis-nested slice", e)
            open_stack.append(e["ts"] + e["dur"])
    return xs


def _same_as_jax(records) -> dict:
    got = to_trace_events(records)
    assert got == jexport.to_trace_events(records)
    return got


def test_export_spans_and_synthetic_journal_roundtrip(tmp_path):
    jp = tmp_path / "j.jsonl"
    tr = Tracer(journal=Journal(jp), seed=3)
    with tr.span("sup.trip", kind="device_loss"):
        with tr.span("sup.degrade"):
            time.sleep(0.002)
        with tr.span("sup.replay"):
            time.sleep(0.001)
    j = Journal(jp)
    j.append("serve_batch", key="batch:0", bucket=2, batch_ms=3.25, req_lat_ms={"r1": 4.0})
    j.append("sup_trip", key="trip:1", sdc_kind="device_loss", step=0)
    j.append("sup_replay", key="replay:1", step=0, entry="halo@2:reference")
    j.append("gate_fail", key="gate:bf16", policy="bf16")
    out = tmp_path / "trace.json"
    info = export_trace(jp, out)
    assert info["spans"] == 3 and info["records"] == 7
    trace = json.loads(out.read_text())
    xs = _validate_nesting(trace)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"sup.trip", "sup.degrade", "sup.replay", "serve_batch"} <= {e["name"] for e in xs}
    assert {"sup_trip", "sup_replay", "gate_fail"} <= names
    trip = next(e for e in xs if e["name"] == "sup.trip")
    for child in ("sup.degrade", "sup.replay"):
        ev = next(e for e in xs if e["name"] == child)
        assert (ev["pid"], ev["tid"]) == (trip["pid"], trip["tid"])
        assert trip["ts"] <= ev["ts"] and ev["ts"] + ev["dur"] <= trip["ts"] + trip["dur"] + 1e-6
    meta_pids = {e["pid"] for e in trace["traceEvents"] if e["ph"] == "M" and e["name"] == "process_name"}
    assert {e["pid"] for e in xs} <= meta_pids
    assert trace == _same_as_jax(load_records(jp))
    # the trip span folds into an incident drawn on its own lane
    incident = [e for e in xs if e["pid"] == _PIDS["incident"]]
    assert any(e["name"] == "incident.trip" for e in incident)


def test_export_grow_back_records_on_incident_lane(tmp_path):
    jp = tmp_path / "j.jsonl"
    j = Journal(jp)
    j.append("sup_trip", key="trip:1", sdc_kind="mesh_shrink", step=0)
    j.append("mesh_shrink", key="shrink:8->7", before=8, after=7, lost=[3])
    j.append("mesh_probation", key="probation:3", event="enter", devices=[3], probation_steps=2,
             cause="chaos:device_rejoin")
    j.append("mesh_probation", key="probation-pass:3", event="pass", devices=[3], ms=12.5)
    j.append("sup_promote_refused", key="promote-refused:halo@4:reference", frm="halo@2:reference",
             to="halo@4:reference", devices=8, cause="sentinel spot-check mismatch")
    j.append("sup_promote", key="promote:1", frm="halo@2:reference", to="halo@4:reference", devices=8, step=3,
             ms=41.0)
    j.append("mesh_quarantine", key="quarantine:5", device=5, flaps=3, window=64, cause="chaos:flap")
    trace = _same_as_jax(Journal.load(jp))
    _validate_nesting(trace)
    evs = {e["name"]: e for e in trace["traceEvents"] if e["ph"] in "Xi"}
    sup_pid = evs["sup_trip"]["pid"]
    for kind in ("mesh_probation", "mesh_quarantine", "sup_promote", "sup_promote_refused"):
        assert evs[kind]["pid"] == sup_pid, kind
    assert evs["sup_promote"]["ph"] == "X" and evs["sup_promote"]["dur"] == pytest.approx(41.0 * 1e3)
    assert evs["sup_promote"]["args"]["frm"] == "halo@2:reference"
    assert evs["mesh_quarantine"]["ph"] == "i" and evs["sup_promote_refused"]["ph"] == "i"
    assert sorted(e["ph"] for e in trace["traceEvents"] if e["name"] == "mesh_probation") == ["X", "i"]


def test_export_controller_actions_on_their_own_lane(tmp_path):
    jp = tmp_path / "j.jsonl"
    j = Journal(jp)
    j.append("serve_batch", key="batch:0", bucket=2, batch_ms=3.0, req_lat_ms={"r1": 4.0})
    trace = to_trace_events(Journal.load(jp))
    assert all(e["pid"] != _PIDS["controller"] for e in trace["traceEvents"])
    j.append("controller_action", key="ctl:1", action="tighten_admission", target="bulk", actuated=True,
             reversal=False, level=1, ms=2.5, evidence={"burn": {"interactive": 64.0}, "oldest_wait_ms": 900.0})
    j.append("controller_action", key="ctl:2", action="relax_admission", target="bulk", actuated=True,
             reversal=True, level=0, ms=1.0, evidence={"burn": {"interactive": 0.0}, "oldest_wait_ms": 0.0})
    trace = _same_as_jax(Journal.load(jp))
    _validate_nesting(trace)
    acts = [e for e in trace["traceEvents"] if e["name"] == "controller_action"]
    assert len(acts) == 2
    for ev in acts:
        assert ev["pid"] == _PIDS["controller"] and ev["ph"] == "X"
        assert ev["args"]["evidence"]["burn"]["interactive"] is not None
    assert acts[0]["dur"] == pytest.approx(2.5 * 1e3)
    assert {a["args"]["action"] for a in acts} == {"tighten_admission", "relax_admission"}
    meta = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M" and e["name"] == "process_name"}
    assert meta[_PIDS["controller"]] == "controller"


def test_export_correlated_record_pins_to_span(tmp_path):
    jp = tmp_path / "j.jsonl"
    tr = Tracer(journal=Journal(jp), seed=1)
    t0 = tr.clock()
    sid = tr.emit("serve.dispatch", t0, t0 + 0.004, track="dispatch")
    Journal(jp).append("serve_batch", key="batch:1", trace_id=tr.trace_id, span_id=sid, batch_ms=4.0)
    Journal(jp).append("compile_event", key="compile:serve:v1_jit:b1", trace_id=tr.trace_id, span_id=sid,
                       site="serve", entry="v1_jit", shape=[1, 63, 63, 3], batch=1, dtype="float32", n_shards=1,
                       ms=2.0, cache_hit=False, xla_flops=None, xla_bytes=None)
    trace = _same_as_jax(Journal.load(jp))
    disp = next(e for e in trace["traceEvents"] if e["name"] == "serve.dispatch")
    inst = next(e for e in trace["traceEvents"] if e["name"] == "serve_batch")
    assert inst["ph"] == "i" and (inst["pid"], inst["tid"]) == (disp["pid"], disp["tid"])
    assert inst["ts"] == pytest.approx(disp["ts"] + disp["dur"], abs=1.0)
    comp = next(e for e in trace["traceEvents"] if e["name"] == "compile_event")
    assert comp["ph"] == "X" and comp["pid"] == disp["pid"] and comp["tid"] != disp["tid"]
    assert comp["ts"] + comp["dur"] == pytest.approx(disp["ts"] + disp["dur"], abs=1.0)


def test_export_cli_subprocess(tmp_path):
    jp = tmp_path / "j.jsonl"
    tr = Tracer(journal=Journal(jp), seed=0)
    with tr.span("run.measure"):
        pass
    proc = subprocess.run([sys.executable, "-m", f"{PORT}.observability", "export", "--journal", str(jp),
                           "--out", str(tmp_path / "t.json")], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Trace exported:" in proc.stdout and "spans=1" in proc.stdout
    trace = json.loads((tmp_path / "t.json").read_text())
    assert any(e.get("name") == "run.measure" for e in trace["traceEvents"])
    # the directory form stitches every *.jsonl
    proc = subprocess.run([sys.executable, "-m", f"{PORT}.observability", "export", "--journal", str(tmp_path)],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0 and "spans=1" in proc.stdout


def test_bench_report_flags_regressions(tmp_path):
    good = {"metric": "m", "value": 1000.0, "per_pass_ms": 1.0, "breakdown": {"stages": {"conv1": 0.6, "conv2": 0.4}}}
    bad = {"metric": "m", "value": 500.0, "per_pass_ms": 2.0, "breakdown": {"stages": {"conv1": 0.6, "conv2": 1.4}}}
    (tmp_path / "BENCH_r01.json").write_text(json.dumps({"parsed": good}))
    (tmp_path / "BENCH_r02.json").write_text(json.dumps(bad))
    paths = [tmp_path / "BENCH_r01.json", tmp_path / "BENCH_r02.json"]
    rep = bench_report(paths)
    assert "REGRESSION BENCH_r02.json: 1000.0 -> 500.0" in rep
    assert "REGRESSION BENCH_r02.json stage conv2" in rep
    assert rep == jexport.bench_report(paths)
    (tmp_path / "BENCH_r03.json").write_text(json.dumps(good))
    assert "flags: none" in bench_report([tmp_path / "BENCH_r01.json", tmp_path / "BENCH_r03.json"])


def _outage(jr):
    for rec in (
        {"kind": "router_config", "n_backends": 2, "t_ms": 0.0},
        {"kind": "router_backend_state", "backend": "b1", "url": "u", "frm": "up", "to": "down",
         "reason": "conn:ConnectionRefusedError", "consec_fail": 2, "detect_ms": 40.0, "t_ms": 1000.0},
        {"kind": "router_redirect", "rid": "r1", "frm": "b1", "to": "b0", "attempt": 1,
         "reason": "conn:ConnectionRefusedError", "t_ms": 1200.0},
        {"kind": "router_backend_state", "backend": "b1", "url": "u", "frm": "down", "to": "probation",
         "reason": "heal", "probes_needed": 2, "t_ms": 3000.0},
        {"kind": "router_backend_state", "backend": "b1", "url": "u", "frm": "probation", "to": "up",
         "reason": "readmit", "clean_probes": 2, "probation_ms": 1000.0, "down_ms": 3000.0, "t_ms": 4000.0},
        {"kind": "router_route", "rid": "r1", "cls": "interactive", "verdict": "ok", "backend": "b0", "attempts": 2,
         "redirects": 1, "http": 200, "ms": 12.0, "t_ms": 1212.0},
    ):
        kind = rec.pop("kind")
        jr.append(kind, **rec)


def test_export_renders_router_lane(tmp_path):
    """The counterpart of the JAX ``tests/test_router.py`` export: a journal
    directory (router and backend journals) exports into one timeline with
    the router's own process lane and the outage's incident lane."""
    _outage(Journal(str(tmp_path / "router.jsonl")))
    Journal(str(tmp_path / "backend_0.jsonl")).append("serve_transport", rid="r1", status="OK", http=200, ms=2.0)
    recs = load_records(tmp_path)
    assert any(r["kind"] == "router_route" for r in recs)
    obj = _same_as_jax(recs)
    events = obj["traceEvents"]
    names = {e["args"]["name"]: e["pid"] for e in events if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert "router" in names and "incident" in names
    on_lane = {e["name"] for e in events if e.get("pid") == names["router"] and e.get("ph") in ("X", "i", "I")}
    assert {"router_route", "router_redirect", "router_backend_state"} & on_lane
    down = [e for e in events if e.get("pid") == names["incident"] and e["name"] == "incident.backend_down"]
    assert len(down) == 1
    json.dumps(obj)


def test_a_traced_supervisor_drill_exports_its_incident_lane(tmp_path, monkeypatch):
    """A port supervisor's device-loss drill under a tracer: the incident
    lane holds one trip whose phase children tile the parent, and the dicts
    are the JAX package's."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models.init import init_params_deterministic
    from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.supervisor import Supervisor, default_ladder

    cfg = dataclasses.replace(BLOCKS12, in_height=45, in_width=45)
    jp = tmp_path / "drill.jsonl"
    jr = Journal(jp)
    monkeypatch.setenv(chaos.CHAOS_ENV, "seed=3,device_loss=1")
    chaos.reset()
    try:
        sup = Supervisor(cfg, default_ladder("halo", "reference", 4), journal=jr, device="cpu")
        set_tracer(Tracer(journal=jr, seed=4))
        sup.execute(init_params_deterministic(cfg, device="cpu"), torch.from_numpy(
            np.random.default_rng(0).random((1, 45, 45, 3), dtype=np.float32)))
    finally:
        set_tracer(None)
        monkeypatch.delenv(chaos.CHAOS_ENV)
        chaos.reset()
    assert [t.kind for t in sup.trips] == ["device_loss"]
    trace = _same_as_jax(load_records(jp))
    _validate_nesting(trace)
    lane = [e for e in trace["traceEvents"] if e["pid"] == _PIDS["incident"] and e["ph"] == "X"]
    (parent,) = [e for e in lane if e["name"] == "incident.trip"]
    kids = [e for e in lane if e["name"].startswith("phase.")]
    assert kids and all(parent["ts"] <= k["ts"] and k["ts"] + k["dur"] <= parent["ts"] + parent["dur"] + 1e-6
                        for k in kids)
    assert sum(k["dur"] for k in kids) == pytest.approx(parent["dur"], abs=0.1 * len(kids) + 0.1)
    out = tmp_path / "drill.trace.json"
    info = export_trace(jp, out)
    assert info["spans"] > 0 and os.path.getsize(out) > 0
