"""The port's bench (``python -m <port>.bench``) against the JAX package's, on the CPU.

The row schema of one ``BENCH_DEVICE=cpu`` run of ``v1_jit`` at batch 1 is
held to the row the JAX bench's measuring child prints for the same config:
the key set, the ``breakdown`` and its stage names, the ``roofline``. Both
children run in this process with their estimator cut to one timed pass
(the isolation test's ``pool_ab`` probe does the same): on a loaded CPU the
amortized chains grow without bound, and no time is compared. The
subprocess path runs where it costs seconds: the parent relaying its
child's row, and, without a GPU and without ``BENCH_DEVICE=cpu``, the error
row with ``value`` 0.0, exit 0 and nothing measured on the CPU. The retry,
journal and skip paths run with the measurement replaced.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench as jbench  # noqa: E402

from cuda_mpi_gpu_cluster_programming_tpu.utils import timing as jtiming  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch import bench as tbench  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import timing as ttiming  # noqa: E402

PORT = "cuda_mpi_gpu_cluster_programming_tpu_torch"
STAGES = {"conv1", "pool1", "conv2", "pool2", "lrn2"}


def _run_port(**env) -> tuple:
    full = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    full.update(env)
    proc = subprocess.run([sys.executable, "-m", f"{PORT}.bench"], capture_output=True, text=True, cwd=ROOT,
                          env=full, timeout=600)
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return proc, rows


def _one_pass(stats_cls):
    """An ``amortized_stats`` that times one call (after one warm call)."""
    def timer(fn, *args, **_kw):
        fn(*args)
        t0 = time.perf_counter()
        fn(*args)
        ms = (time.perf_counter() - t0) * 1e3
        return stats_cls(samples_ms=[ms], n_chain=1, shadowed=False, total_measured_s=ms / 1e3)
    return timer


def _child_row(module, timing, knobs, env):
    """The row a bench module's ``_child`` prints, run in this process with
    its module-level knobs set and its estimator cut to one pass."""
    mp = pytest.MonkeyPatch()
    out = []
    try:
        for name, value in knobs.items():
            mp.setattr(module, name, value)
        for name, value in env.items():
            mp.setenv(name, value)
        mp.delenv("BENCH_CONTINUITY_BATCH", raising=False)
        mp.setattr(timing, "amortized_stats", _one_pass(timing.AmortizedStats))
        mp.setattr("builtins.print", lambda *a, **kw: out.append(" ".join(str(v) for v in a)))
        assert module._child() == 0
    finally:
        mp.undo()
    rows = [json.loads(line) for line in out if line.startswith("{")]
    return {**rows[-1], "attempts": 1}  # main() adds the attempt count to every row


KNOBS = dict(CONFIG="v1_jit", CONFIGS=["v1_jit"], BATCH=1, REPEATS=1, COMPUTE="fp32", DTYPE="fp32", PLAN_PATH="")


@pytest.fixture(scope="module")
def port_cpu_row():
    return _child_row(tbench, ttiming, dict(KNOBS, DEVICE="cpu"), {"BENCH_BREAKDOWN_REPEATS": "1"})


@pytest.fixture(scope="module")
def jax_cpu_row():
    return _child_row(jbench, jtiming, KNOBS, {"BENCH_BREAKDOWN_REPEATS": "1", "TPU_FRAMEWORK_COMPILE_CACHE": "0"})


def test_cpu_row_schema_equals_jax(port_cpu_row, jax_cpu_row):
    row, jrow = port_cpu_row, jax_cpu_row
    assert set(row) == set(jrow), (set(row) ^ set(jrow))
    assert row["metric"] == jrow["metric"] == tbench.METRIC
    assert row["platform"] == "cpu" and row["device_kind"] == "cpu" and row["config"] == "v1_jit"
    assert row["batch"] == 1 and row["value"] > 0 and row["per_pass_ms"] > 0
    assert row["mfu"] is None and row["fp32_ceiling_fraction"] is None and row["assumed_peak_tflops"] is None
    assert "bf16" not in row and "last_good" not in row and "error" not in row
    assert row["flops_per_image"] == jrow["flops_per_image"]
    assert row["matmul_flops_per_image"] == jrow["matmul_flops_per_image"]
    bd, jbd = row["breakdown"], jrow["breakdown"]
    assert set(bd) == set(jbd) and set(bd["stages"]) == set(jbd["stages"]) == STAGES
    assert bd["method"] == "prefix-diff" and bd["tier"] == "reference" and bd["granularity"] == "stage"
    assert bd["stage_sum_ms"] == pytest.approx(bd["total_ms"], abs=1e-3)
    rf, jrf = row["roofline"], jrow["roofline"]
    assert set(rf) == set(jrf) and rf["source"] == "breakdown" and rf["spec_assumed"] is True
    assert {s["name"] for s in rf["stages"]} == STAGES
    assert all(set(s) - {"note"} == set(js) for s, js in zip(rf["stages"], jrf["stages"]))
    assert set(rf["blocks"]) == set(jrf["blocks"]) == {"block1", "block2"}
    assert rf["peak_tflops"] == 67.0  # an fp32 stage is judged against FFMA


def test_parent_relays_its_childs_row():
    """``python -m <port>.bench`` on the CPU: the parent starts the child
    from the repo root and prints the row it printed (a config that fails
    gives an error row, the sweep exit 0)."""
    proc, rows = _run_port(BENCH_DEVICE="cpu", BENCH_CONFIGS="v9_nonexistent", BENCH_MAX_RETRIES="0")
    assert proc.returncode == 0, proc.stderr[-2000:]
    (row,) = rows
    assert row["config"] == "v9_nonexistent" and row["platform"] == "cpu" and row["value"] == 0.0
    assert row["error"] == "KeyError: 'v9_nonexistent'" and row["attempts"] == 1


def test_no_gpu_gives_an_error_row_and_measures_nothing():
    proc, rows = _run_port(CUDA_VISIBLE_DEVICES="", BENCH_CONFIG="v1_jit", BENCH_RETRY_BACKOFF="0",
                           BENCH_PROBE_TIMEOUT="300")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(rows) == 1
    row = rows[0]
    assert row["value"] == 0.0 and row["error"].startswith("device probe failed")
    assert "last_good" not in row and "value_last_good" not in row
    # no measurement fields: the CPU was not measured in the GPU's place
    assert set(row) == {"metric", "value", "unit", "vs_baseline", "error", "platform", "config", "compute",
                        "dtype", "batch", "attempts", "resilience"}
    assert row["attempts"] == 2 and row["resilience"].startswith("retried x1")
    assert row["batch"] == 128 and row["platform"] == "unknown"


def test_error_row_carries_the_jax_keys_without_a_tpu_row(tmp_path, monkeypatch):
    monkeypatch.setattr(jbench, "ROOT", str(tmp_path))  # no perf/bench_latest.json: no last_good to attach
    assert tbench._error_obj("down", "gpu", "v3_pallas").keys() == jbench._error_obj("down", "gpu", "v3_pallas").keys()
    assert tbench._error_obj("down")["config"] == tbench.CONFIG


@pytest.mark.parametrize("mode", tbench.LATER_MODES + ("nonsense",))
def test_other_modes_exit_with_one_line(mode):
    proc, rows = _run_port(BENCH_MODE=mode)
    assert proc.returncode == 2 and rows == []
    assert len(proc.stderr.strip().splitlines()) == 1
    if mode != "nonsense":
        assert "Queue 1 item 1" in proc.stderr


def test_breakdown_skips_visibly():
    assert tbench._stage_breakdown("kernels", "int8w", None, None, "gpu") == {
        "skipped": "no staged-chain analogue for dtype 'int8w'"}
    assert "plain versions" in tbench._stage_breakdown("kernels", "fp32", None, None, "cpu")["skipped"]
    note = tbench._roofline_obj({"skipped": "why"}, "fp32", "cpu")
    assert note == jbench._roofline_obj({"skipped": "why"}, "fp32", "cpu")


def _good_row(config):
    return {"metric": tbench.METRIC, "value": 50.0, "unit": "img/s", "vs_baseline": 9.2, "platform": "gpu",
            "config": config, "batch": 2}


def test_journal_resume_measures_only_the_missing_configs(tmp_path, monkeypatch, capsys):
    journal = tmp_path / "bench_journal.jsonl"
    monkeypatch.setenv("BENCH_JOURNAL", str(journal))
    monkeypatch.setenv("BENCH_MAX_RETRIES", "0")
    monkeypatch.setattr(tbench, "CONFIGS", ["v1_jit", "v3_pallas"])
    asked = []

    def fake_measure(configs=None):
        asked.append(list(configs))
        return [tbench._error_obj("child died before v3_pallas", "gpu", c) if c == "v3_pallas" and len(asked) == 1
                else _good_row(c) for c in configs]

    monkeypatch.setattr(tbench, "_measure_once", fake_measure)
    rows = []
    for _ in range(3):
        assert tbench.main() == 0
        rows.append([json.loads(line) for line in capsys.readouterr().out.splitlines()])
    assert asked == [["v1_jit", "v3_pallas"], ["v3_pallas"]]
    assert [r["config"] for r in rows[0]] == ["v1_jit", "v3_pallas"] and rows[0][1]["error"]
    assert rows[1][0]["value"] == rows[0][0]["value"] and "error" not in rows[1][1]
    assert [r["value"] for r in rows[2]] == [50.0, 50.0]
    assert set(Journal.completed(Journal.load(journal), "bench_row")) == {"v1_jit", "v3_pallas"}


def test_a_pass_that_measured_nothing_is_retried_and_labelled(monkeypatch, capsys):
    monkeypatch.delenv("BENCH_JOURNAL", raising=False)
    monkeypatch.setenv("BENCH_MAX_RETRIES", "2")
    monkeypatch.setenv("BENCH_RETRY_BACKOFF", "0")
    monkeypatch.setattr(tbench, "CONFIGS", ["v3_pallas"])
    calls = []

    def flaky(configs=None):
        calls.append(configs)
        return [_good_row(c) if len(calls) == 2 else {**_good_row(c), "value": 0.0} for c in configs]

    monkeypatch.setattr(tbench, "_measure_once", flaky)
    monkeypatch.setattr(tbench.time, "sleep", lambda s: None)
    assert tbench.main() == 0
    (row,) = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(calls) == 2 and row["value"] == 50.0
    assert row["attempts"] == 2 and row["resilience"] == "retried x1 (value=0.0 (nothing measured)) -> ok"
