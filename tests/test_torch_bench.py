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


# ------------------------------------------- replay, control and gate modes ---


@pytest.mark.parametrize("mode", tbench.LATER_MODES)
def test_the_fleet_modes_name_the_third_step(mode):
    proc, rows = _run_port(BENCH_MODE=mode)
    assert proc.returncode == 2 and rows == [] and "item 1's third step" in proc.stderr


def _mode_rows(monkeypatch, capsys, main, **env):
    monkeypatch.setattr(tbench, "DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = main()
    return rc, [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A port serve journal at 63x63 under the class mix's policy."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch import run as trun

    path = tmp_path_factory.mktemp("bench_replay") / "serve.jsonl"
    assert trun.main(["--config", "v1_jit", "--serve", "--device", "cpu", "--height", "63", "--width", "63",
                      "--serve-max-batch", "2", "--serve-rate", "10", "--serve-duration", "0.3",
                      "--traffic-shape", "steady", "--serve-journal", str(path)]) == 0
    return path


def test_bench_replay_row_has_the_jax_reports_keys(recorded, tmp_path, monkeypatch, capsys):
    from cuda_mpi_gpu_cluster_programming_tpu.observability import replay as jreplay

    rc, (row,) = _mode_rows(monkeypatch, capsys, tbench._replay_main, BENCH_REPLAY_JOURNAL=str(recorded),
                            BENCH_REPLAY_TRAFFIC_MULT="2", BENCH_REPLAY_OUT=str(tmp_path / "replay.jsonl"))
    rec = jreplay.load_recorded_run(recorded)
    jkeys = set(jreplay.ReplayReport(jreplay.ReplayKnobs(), rec, {}, [], {}, 0, 0.0, 0.0, 0, "").to_obj())
    assert rc == 0 and set(row) == jkeys | {"metric", "unit", "platform"}
    assert row["metric"] == jbench.REPLAY_METRIC == tbench.REPLAY_METRIC and row["platform"] == "cpu"
    assert row["traffic_mult"] == 2.0 and row["accounting_closed"] and row["diverged"] is False
    assert sum(c["replay"]["offered"] for c in row["classes"].values()) == 2 * len(rec.submits)


@pytest.mark.parametrize("env,why", [
    (dict(), "BENCH_REPLAY_JOURNAL not set"),
    (dict(BENCH_REPLAY_JOURNAL="missing.jsonl"), "unreplayable journal"),
    (dict(BENCH_REPLAY_DEVICES="2"), "item 3"),
])
def test_bench_replay_refusals_exit_2_after_a_row(env, why, recorded, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BENCH_REPLAY_JOURNAL", raising=False)
    if "BENCH_REPLAY_DEVICES" in env:
        env = dict(env, BENCH_REPLAY_JOURNAL=str(recorded))
    rc, (row,) = _mode_rows(monkeypatch, capsys, tbench._replay_main, **env)
    assert rc == 2 and why in row["error"] and row["metric"] == tbench.REPLAY_METRIC and row["value"] == 0.0


def test_bench_gate_row_is_the_jax_rows(tmp_path, monkeypatch, capsys):
    for i, value in enumerate((100.0, 80.0), 1):
        (tmp_path / f"BENCH_r{i:02d}.json").write_text(json.dumps({"value": value}))
    monkeypatch.setenv("BENCH_GATE_PATHS", str(tmp_path / "BENCH_r*.json"))
    rc, (row,) = _mode_rows(monkeypatch, capsys, tbench._gate_main)
    assert jbench._gate_main() == rc == 3
    (jrow,) = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert row == jrow and row["metric"] == tbench.GATE_METRIC and len(row["regressions"]) == 1


# the JAX control row's keys (root bench.py _control_main), and the geometry the port's row adds
CONTROL_KEYS = {"metric", "value", "unit", "ok", "failures", "calm_actions", "calm_state", "on_actions",
                "controller_state", "burn_protected_off", "burn_protected_on", "protected_cls", "sat_rate_rps",
                "slo_scale", "accounting_closed", "diverged", "journals", "platform"}


def test_bench_control_row_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The drill's three phases at 63x63 with short windows and a forced
    rate (no probe): the row's keys, closed books and no divergence on both
    sides, no action on the calm trace. Whether the protected burn drops is
    timing on a loaded CPU; the row carries both burns either way."""
    rc, (row,) = _mode_rows(monkeypatch, capsys, tbench._control_main, BENCH_CTL_DURATION="0.4",
                            BENCH_CTL_SAT_RATE="60", BENCH_CTL_JOURNAL_DIR=str(tmp_path), BENCH_CONFIG="v1_jit")
    assert set(row) == CONTROL_KEYS | {"config", "dtype", "height", "width", "max_batch"}, row
    assert row["metric"] == jbench.CONTROL_METRIC == tbench.CONTROL_METRIC and row["platform"] == "cpu"
    assert (row["height"], row["width"], row["max_batch"]) == (63, 63, 4) and row["sat_rate_rps"] == 60.0
    assert row["accounting_closed"] == {"off": True, "on": True} and row["diverged"] == {"off": False, "on": False}
    assert row["calm_actions"] == 0 and row["controller_state"] is not None
    assert rc == (0 if row["ok"] else 3) and all(Path(p).exists() for p in row["journals"].values())
