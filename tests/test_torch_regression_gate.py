"""The port's regression gate (``<port>/observability/gate.py``) and
``BENCH_MODE=gate`` against the JAX package's gate, on synthetic rounds.

Every trajectory is written to ``tmp_path`` as round files (bare rows,
rows wrapped as ``{"parsed": ..., "tail": ...}``, JSONL, an unreadable
file): fresh headline drops, ``last_good`` echoes and first appearances,
stage regressions within one granularity and across two, error rounds and
zero rounds. ``evaluate`` gives the JAX gate's ``to_obj`` and ``render``
exactly on each, and the bench mode prints that verdict and exits 3 on a
regression. The repository's ``BENCH_r*.json`` (the JAX package's TPU
rounds) are never read: with no paths the verdict is over zero rounds.
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cuda_mpi_gpu_cluster_programming_tpu.observability import gate as jgate  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch import bench as tbench  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import gate  # noqa: E402

STAGED = {"conv1": 1.0, "pool1": 0.2, "conv2": 2.0, "pool2": 0.1, "lrn2": 0.3}


def _row(value, stages=None, granularity="stage", **extra):
    row = {"metric": "alexnet_blocks12_images_per_sec", "value": value, "per_pass_ms": 128e3 / value
           if isinstance(value, (int, float)) and value > 0 else None, **extra}
    if stages is not None:
        row["breakdown"] = {"stages": stages, "granularity": granularity}
    return row


def _scaled(stages, **factors):
    return {s: ms * factors.get(s, 1.0) for s, ms in stages.items()}


TRAJECTORIES = {
    "steady": [_row(1000.0, STAGED), _row(980.0, STAGED), _row(1010.0, STAGED)],
    "headline_drop": [_row(1000.0), _row(850.0), _row(860.0), _row(700.0)],
    "echoes": [
        _row(1000.0),
        {"value": 0.0, "error": "tunnel wedged", "last_good": {"value": 1000.0, "stale": True}},
        {"value": 0.0, "error": "tunnel wedged", "value_last_good": 1000.0},
        {"value": 0.0, "error": "down", "last_good": {"value": 880.0, "stale": True}},
        _row(870.0),
        {"error": "no value at all"},
        {"note": "neither value nor error"},
    ],
    "stages": [
        _row(1000.0, STAGED),
        _row(1000.0, _scaled(STAGED, conv2=1.3)),
        _row(990.0, {"block1": 1.5, "block2": 2.0}, granularity="block"),
        _row(995.0, {"block1": 1.5, "block2": 2.5}, granularity="block"),
        _row(1001.0, _scaled(STAGED, conv2=1.3, lrn2=1.05)),
    ],
}


def _write(tmp_path, rows, wrap=()) -> list:
    paths = []
    for i, row in enumerate(rows, 1):
        p = tmp_path / f"BENCH_r{i:02d}.json"
        if i in wrap:
            p.write_text(json.dumps({"parsed": row, "tail": "..."}))
        elif i % 3 == 0:
            p.write_text("not json\n" + json.dumps(row) + "\n")  # JSONL: the first parseable line
        else:
            p.write_text(json.dumps(row))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_the_verdict_is_the_jax_gates(name, tmp_path):
    paths = _write(tmp_path, TRAJECTORIES[name], wrap=(2,))
    got, want = gate.evaluate(paths), jgate.evaluate(paths)
    assert got.to_obj() == want.to_obj()
    assert got.render() == want.render()
    assert got.ok == want.ok == (name == "steady")


@pytest.mark.parametrize("threshold", [0.05, 0.2, 0.5])
def test_the_threshold_is_the_jax_gates(threshold, tmp_path):
    paths = _write(tmp_path, TRAJECTORIES["headline_drop"] + TRAJECTORIES["stages"])
    assert gate.evaluate(paths, threshold).to_obj() == jgate.evaluate(paths, threshold).to_obj()


def test_unreadable_and_zero_rounds_are_the_jax_gates(tmp_path):
    (tmp_path / "BENCH_r01.json").write_text("garbage")
    paths = [str(tmp_path / "BENCH_r01.json"), str(tmp_path / "missing.json")]
    for p in (paths, []):
        got, want = gate.evaluate(p), jgate.evaluate(p)
        assert got.to_obj() == want.to_obj() and got.render() == want.render()
        assert got.ok and got.compared == 0 and got.rows == []
    assert gate.THRESHOLD == jgate.THRESHOLD


def _bench_gate(monkeypatch, capsys, spec):
    monkeypatch.setenv("BENCH_GATE_PATHS", spec)
    rc = tbench._gate_main()
    (line,) = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    return rc, json.loads(line)


def test_bench_gate_mode_prints_the_verdict_and_exits_3_on_a_regression(tmp_path, monkeypatch, capsys):
    paths = _write(tmp_path, TRAJECTORIES["headline_drop"])
    rc, row = _bench_gate(monkeypatch, capsys, str(tmp_path / "BENCH_r*.json"))
    assert rc == 3 and row == {"metric": tbench.GATE_METRIC, **jgate.evaluate(paths).to_obj()}
    assert tbench.GATE_METRIC == "alexnet_blocks12_bench_gate"
    rc, row = _bench_gate(monkeypatch, capsys, f"{paths[2]}, {paths[1]}")  # 850 then 860 img/s, in name order
    assert rc == 0 and row["compared"] == 1 and [r["name"] for r in row["rounds"]] == ["BENCH_r02.json",
                                                                                          "BENCH_r03.json"]


def test_bench_gate_mode_without_paths_reads_no_tpu_round(monkeypatch, capsys):
    assert list(ROOT.glob("BENCH_r*.json"))  # the JAX package's rounds are there, and are not read
    rc, row = _bench_gate(monkeypatch, capsys, "")
    assert rc == 0 and row["rounds"] == [] and row["compared"] == 0 and row["ok"] is True
