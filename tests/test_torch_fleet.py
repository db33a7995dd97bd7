"""The port's serving fleet over real backend processes, on the CPU.

The real-process tests of the JAX ``tests/test_router.py``: the host-loss
drill across a process boundary (3 backend processes behind the router,
the seeded ``host_loss`` chaos site SIGKILLs one mid-run, the router
detects, redirects, keeps its per-class ledger closed, and re-admits the
restarted process only through probation), ``run --serve --route 2`` and
``BENCH_MODE=route`` at 2 backends. Every backend is ``v1_jit`` at 63x63 on
``--device cpu``. The drill's directory folds into a backend-down
incident whose phases sum to its wall (``health_from_journal``), and the
run's and the bench row's health are that fold.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.export import load_records, to_trace_events
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.health import health_from_journal, health_from_records
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.metrics import registry as metrics_registry
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import chaos
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.batcher import power_of_two_buckets
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.fleet import BackendFleet, maybe_host_loss
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.frontend import http_fleet_load
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.router import DOWN, PROBATION, UP, FleetRouter, drill_config
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.traffic import default_class_mix

ROOT = Path(__file__).resolve().parent.parent
PORT = "cuda_mpi_gpu_cluster_programming_tpu_torch"


@pytest.fixture(autouse=True)
def _clean_process_state(monkeypatch):
    monkeypatch.delenv(chaos.CHAOS_ENV, raising=False)
    chaos.reset()
    metrics_registry().reset()
    yield
    chaos.reset()


def test_host_loss_drill_across_process_boundary(tmp_path, monkeypatch):
    monkeypatch.setenv(chaos.CHAOS_ENV, "seed=1,host_loss=1")
    chaos.reset()
    fleet = BackendFleet(3, tmp_path, height=63, width=63, max_batch=4, device="cpu")
    router = None
    try:
        fleet.start()
        assert all(b.spawn_s > 0 for b in fleet.backends)
        router = FleetRouter(fleet.urls(), drill_config(str(tmp_path / "router.jsonl"))).start()
        mix = list(default_class_mix(power_of_two_buckets(4)))
        pre = http_fleet_load(router.url, (63, 63, 3), shape="steady", rate_rps=25, duration_s=1.0, classes=mix,
                              seed=0)
        assert pre.n_ok > 0 and pre.n_failed == 0
        victim_pid = fleet.backends[1].pid
        killed = maybe_host_loss(fleet)
        assert killed == 1  # seed 1 % 3: the deterministic victim
        assert not fleet.backends[killed].alive
        with pytest.raises(ProcessLookupError):
            os.kill(victim_pid, 0)  # reaped: no zombie is left for the replacement to share the slot with
        post = http_fleet_load(router.url, (63, 63, 3), shape="steady", rate_rps=25, duration_s=1.2, classes=mix,
                               seed=1)
        assert post.n_ok > 0  # the dead host's share redirects within each request's budget
        assert router.backend_states()["b1"] == DOWN
        # the replacement keeps the ring slot on a new port, and re-admits only through probation
        router.replace_backend(killed, fleet.restart(killed))
        deadline = time.monotonic() + 60.0
        saw_probation = False
        while time.monotonic() < deadline:
            st = router.backend_states()["b1"]
            saw_probation = saw_probation or st == PROBATION
            if st == UP:
                break
            time.sleep(0.05)
        assert router.backend_states()["b1"] == UP and saw_probation
        rep = router.report()
        assert rep.closed, rep.summary()
        assert rep.n_offered == pre.n_requests + post.n_requests
        router.stop()
        recs = load_records(tmp_path)
        states = [r for r in recs if r["kind"] == "router_backend_state" and r["backend"] == "b1"]
        assert [r["to"] for r in states if r["frm"] != r["to"]][:3] == [DOWN, PROBATION, UP]
        assert any(r["reason"] == "endpoint_replaced" for r in states)
        kinds = {r["kind"] for r in recs}
        assert {"router_config", "router_route", "serve_config", "serve_batch"} <= kinds  # both trails, one dir
        # the directory folds one phase-decomposed backend_down incident and exports with the router's lane
        rep = health_from_records(recs)
        downs = [i for i in rep.incidents if i.kind == "backend_down" and i.entry == "b1"]
        assert len(downs) == 1 and downs[0].phase_sum_ms == pytest.approx(downs[0].wall_ms, abs=1e-6)
        names = {e["args"]["name"] for e in to_trace_events(recs)["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
        assert {"router", "incident", "serve"} <= names
    finally:
        if router is not None:
            router.stop()
        fleet.stop()


def test_run_route_cli(tmp_path):
    """``run --serve --route 2`` on the CPU with ``host_loss`` armed: the
    JAX run's Route lines, the seeded backend (``1 % 2``) SIGKILLed mid-window
    and restarted, the router's books closed and both backends up."""
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.run", "--config", "v1_jit", "--serve", "--route", "2", "--height", "63",
         "--width", "63", "--serve-max-batch", "4", "--device", "cpu", "--serve-rate", "15", "--serve-duration",
         "1.0", "--route-dir", str(tmp_path / "route")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, chaos.CHAOS_ENV: "seed=1,host_loss=1"},
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = proc.stdout
    assert "Route fleet: n=2" in out and "Route load: " in out and "Route class: name=interactive" in out
    assert "Route host loss: killed=b1 (chaos host_loss)" in out
    assert re.search(r"^Route recovery: killed=b1 ms=[1-9][0-9]*$", out, re.M), out
    route_line = next(line for line in out.splitlines() if line.startswith("Route: "))
    assert "closed=True" in route_line and "b0=up b1=up" in route_line
    assert re.search(r" redirects=[0-9]+ ", route_line)
    health = next(line for line in out.splitlines() if line.startswith("Health: "))
    assert "unavailable" not in health and "incidents=" in health and "budget_blown=" in health, health
    rep = health_from_journal(tmp_path / "route")
    assert health == f"Health: {rep.summary_line()}"
    downs = [i for i in rep.incidents if i.kind == "backend_down" and i.entry == "b1"]
    assert downs and all(i.phase_sum_ms == pytest.approx(i.wall_ms, abs=1e-6) for i in downs)
    assert (tmp_path / "route" / "router.jsonl").exists() and (tmp_path / "route" / "backend_0.jsonl").exists()
    recs = load_records(tmp_path / "route")
    moves = [r["to"] for r in recs if r["kind"] == "router_backend_state" and r["backend"] == "b1"
             and r["frm"] != r["to"]]
    assert moves[:3] == [DOWN, PROBATION, UP], moves  # the killed host re-admitted only through probation


def test_bench_route_mode(tmp_path):
    """``BENCH_MODE=route`` at 2 backends: one JSON row with the drill's
    fields, the victim ``seed % n``, a recovery and closed accounting."""
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.bench"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "BENCH_MODE": "route", "BENCH_DEVICE": "cpu", "BENCH_ROUTE_N": "2",
             "BENCH_ROUTE_RATE": "15", "BENCH_ROUTE_DURATION": "1.0", "BENCH_ROUTE_JOURNAL": str(tmp_path / "route")},
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(rows) == 1
    row = rows[0]
    assert row["metric"] == "alexnet_blocks12_route_host_loss" and "error" not in row, row
    assert row["accounting_closed"] is True and row["platform"] == "cpu" and row["config"] == "v1_jit"
    assert row["pre_loss_img_s"] > 0 and row["post_loss_img_s"] > 0
    assert row["killed"] == "b0"  # seed 0 % 2
    assert row["recovery_ms"] is not None and row["recovery_ms"] > 0
    assert row["backends"] == {"b0": "up", "b1": "up"}
    assert "skipped" not in row and "error" not in row["health"], row["health"]
    assert row["health"]["summary"] == health_from_journal(tmp_path / "route").summary_line()
    assert any(i["kind"] == "backend_down" and i["entry"] == "b0" for i in row["health"]["incidents"])
