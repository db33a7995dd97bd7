"""``python -m cuda_mpi_gpu_cluster_programming_tpu_torch.observability`` on
the CPU, and the compile-observer gate of ``configs.build_forward``.

Each subcommand's exit codes are the JAX CLI's: 0 clean, 2 for usage or a
missing, empty or unreplayable journal (and a device subcommand with no
GPU), 3 for a tripped gate (``report --fail-on-regression``, a diverged
neutral replay, ``health --fail-on-budget-burn`` on a blown budget).
``build_forward`` returns its forward itself with no observer installed, and
with one journals one ``compile_event`` (``site="build"``, null flops) per
input shape.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu_torch import configs
from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import BLOCKS12
from cuda_mpi_gpu_cluster_programming_tpu_torch.models.init import deterministic_input, init_params_deterministic
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import __main__ as cli
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import health
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.slo import SLOClass, SLOPolicy

ROOT = Path(__file__).resolve().parent.parent
PORT = "cuda_mpi_gpu_cluster_programming_tpu_torch"
CFG45 = dataclasses.replace(BLOCKS12, in_height=45, in_width=45)
NO_GPU = not torch.cuda.is_available()


def _blown(jp):
    j = Journal(jp)
    pol = SLOPolicy([SLOClass("tight", 10.0), SLOClass("loose", 5000.0)])
    j.append("serve_config", key="cfg", slo=pol.to_obj(), devices=2)
    for i in range(3):
        j.append("serve_submit", key=f"s:{i}", cls="tight", admitted=True)
    j.append("serve_batch", key="b:0", bucket=2, batch_ms=60.0, req_lat_ms={"r0": 50.0, "r1": 5.0, "r2": 6.0},
             req_cls={"r0": "tight", "r1": "tight", "r2": "tight"})
    return jp


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A short journaled CPU serve run (``v1_jit`` at 45x45): a replayable,
    healthy journal."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch import run

    jp = tmp_path_factory.mktemp("obs_cli") / "serve.jsonl"
    assert run.main(["--config", "v1_jit", "--serve", "--device", "cpu", "--height", "45", "--width", "45",
                     "--serve-duration", "0.3", "--serve-max-batch", "2", "--serve-journal", str(jp)]) == 0
    return jp


# ------------------------------------------------------------- health ---


def test_health_exit_codes(tmp_path, capsys):
    assert cli.main(["health", "--journal", str(tmp_path / "nope.jsonl")]) == 2
    (tmp_path / "empty.jsonl").write_text("")
    assert cli.main(["health", "--journal", str(tmp_path / "empty.jsonl")]) == 2
    jp = _blown(tmp_path / "blown.jsonl")
    capsys.readouterr()
    assert cli.main(["health", "--journal", str(jp)]) == 0  # reporting a blowout is not failing on it
    assert "BLOWN" in capsys.readouterr().out
    assert cli.main(["health", "--journal", str(jp), "--fail-on-budget-burn"]) == 3
    assert "tight" in capsys.readouterr().err
    assert cli.main(["health", "--journal", str(jp), "--json", "--fail-on-budget-burn"]) == 3
    obj = json.loads(capsys.readouterr().out)
    assert obj["budget_blown"] is True and obj["classes"][0] == {**obj["classes"][0], "class": "tight", "blown": True}


def test_health_on_a_served_journal_exits_0(served, capsys):
    assert cli.main(["health", "--journal", str(served), "--fail-on-budget-burn"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Fleet health: incidents=0 ") and "Compile attribution: 2 event(s)" in out


def test_health_subprocess_exit_3(tmp_path):
    proc = subprocess.run([sys.executable, "-m", f"{PORT}.observability", "health", "--journal",
                           str(_blown(tmp_path / "j.jsonl")), "--fail-on-budget-burn"],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert "health gate: FAIL" in proc.stderr and "Fleet health:" in proc.stdout


# ------------------------------------------------------ export, report ---


def test_export_missing_journal_exits_2(tmp_path, served, capsys):
    assert cli.main(["export", "--journal", str(tmp_path / "nope.jsonl")]) == 2
    assert cli.main(["export", "--journal", str(served), "--out", str(tmp_path / "t.json")]) == 0
    assert "Trace exported:" in capsys.readouterr().out
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]


def test_report_exit_codes(tmp_path, capsys):
    (tmp_path / "BENCH_r01.json").write_text(json.dumps({"metric": "m", "value": 1000.0}))
    (tmp_path / "BENCH_r02.json").write_text(json.dumps({"metric": "m", "value": 500.0}))
    paths = [str(tmp_path / "BENCH_r01.json"), str(tmp_path / "BENCH_r02.json")]
    assert cli.main(["report", *paths]) == 0
    assert "REGRESSION BENCH_r02.json" in capsys.readouterr().out
    assert cli.main(["report", "--fail-on-regression", *paths]) == 3
    assert "regression gate: FAIL" in capsys.readouterr().err
    assert cli.main(["report", "--json", paths[0]]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True


# ------------------------------------------------------------- replay ---


def test_replay_exit_codes(tmp_path, served, capsys):
    assert cli.main(["replay", "--journal", str(tmp_path / "nope.jsonl"), "--device", "cpu"]) == 2
    assert cli.main(["replay", "--journal", str(_blown(tmp_path / "b.jsonl")), "--device", "cpu",
                     "--slo-scale", "0"]) == 2
    old = Journal(tmp_path / "old.jsonl")
    old.append("serve_batch", key="b:0", bucket=1, batch_ms=1.0)
    assert cli.main(["replay", "--journal", str(tmp_path / "old.jsonl"), "--device", "cpu"]) == 2
    assert "unreplayable journal" in capsys.readouterr().err
    # a what-if (twice the recorded arrivals) exits 0 whatever the host's load does to the percentiles; the
    # neutral replay's contract is tests/test_torch_replay.py's
    assert cli.main(["replay", "--journal", str(served), "--device", "cpu", "--json", "--traffic-mult", "2",
                     "--journal-out", str(tmp_path / "replay.jsonl")]) == 0
    obj = json.loads(capsys.readouterr().out)
    assert obj["diverged"] is False and (tmp_path / "replay.jsonl").exists()


@pytest.mark.skipif(not NO_GPU, reason="a GPU is present: the default device replays")
def test_replay_without_a_gpu_exits_2(served, capsys):
    assert cli.main(["replay", "--journal", str(served)]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# ----------------------------------------------------------- roofline ---


def test_roofline_exit_codes(tmp_path, capsys):
    assert cli.main(["roofline"]) == 2
    row = {"metric": "m", "value": 100.0, "unit": "img/s", "batch": 2, "dtype": "fp32", "device_kind": "cpu",
           "breakdown": {"stages": {"conv1": 1.0, "pool1": 0.2, "conv2": 1.5, "pool2": 0.1, "lrn2": 0.3},
                         "total_ms": 3.1, "batch": 2}}
    (tmp_path / "rows.jsonl").write_text(json.dumps(row) + "\n")
    capsys.readouterr()
    assert cli.main(["roofline", str(tmp_path / "rows.jsonl"), "--json"]) == 0
    (view,) = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert view["row"] == f"{tmp_path / 'rows.jsonl'}:1"
    (tmp_path / "BENCH_r01.json").write_text(json.dumps({"metric": "m", "value": 0.0, "error": "wedged"}))
    assert cli.main(["roofline", str(tmp_path / "BENCH_r01.json")]) == 2  # no measurable view
    assert cli.main(["roofline", "--live", "--device", "cpu", "--batch", "1", "--height", "45", "--width", "45",
                     "--repeats", "1"]) == 0
    assert "conv1" in capsys.readouterr().out
    if NO_GPU:
        assert cli.main(["roofline", "--live", "--batch", "1"]) == 2


# ------------------------------------------------ the observer gate ---


def test_build_forward_without_an_observer_is_the_bare_forward():
    assert health.get_compile_observer() is None
    fwd = configs.build_forward(configs.REGISTRY["v1_jit"], CFG45, device="cpu")
    assert fwd.__qualname__ == "build_forward.<locals>.forward"


def test_build_forward_with_an_observer_journals_one_compile_event_per_shape(tmp_path):
    jr = Journal(tmp_path / "c.jsonl")
    prev = health.set_compile_observer(health.journal_compile_observer(jr))
    try:
        fwd = configs.build_forward(configs.REGISTRY["v1_jit"], CFG45, device="cpu")
        bare = fwd.__wrapped__
        assert fwd.__qualname__ == "observed_first_calls.<locals>.wrapped"
        assert bare.__qualname__ == "build_forward.<locals>.forward"
        params = init_params_deterministic(CFG45, device="cpu")
        for batch in (1, 1, 2):
            x = deterministic_input(batch, CFG45, device="cpu")
            assert torch.equal(fwd(params, x), bare(params, x))
    finally:
        health.set_compile_observer(prev)
    evs = [r for r in Journal.load(tmp_path / "c.jsonl") if r["kind"] == "compile_event"]
    assert [(e["site"], e["entry"], e["batch"], e["cache_hit"]) for e in evs] == [
        ("build", "v1_jit", 1, False), ("build", "v1_jit", 2, False)]
    assert all(e["ms"] > 0 and e["xla_flops"] is None and e["xla_bytes"] is None for e in evs)
    rep = health.health_from_journal(tmp_path / "c.jsonl")
    assert rep.compile["events"] == 2 and {c["verdict"] for c in rep.compile["flops_checks"]} == {"unavailable"}
