"""The serving and replay shard width against the JAX package, on the CPU.

A ``v5_collective`` server at ``n_shards=2`` (both shard slots on the
server's device, ``serving.server.serve_mesh``) drains a request stream
whose results are within the gate's fp32 budget of the JAX package's
``build_forward(..., n_shards=2)`` on the same inputs (its Pallas tier in
interpret mode on the 8 virtual CPU devices of ``tests/conftest.py``), and
bitwise the port's own eager sharded forward on each padded bucket; each
dispatch runs the halo collectives the JAX tests count. A journal recorded
at one shard replays at ``devices=2`` with identical per-class accounting,
from the library, the run CLI and the bench. ``run --serve --shards 2`` and
``BENCH_SERVE_SHARDS=2`` serve at two shards. A serving mesh takes only
the server's device (slots across cards are ROADMAP Queue 1 item 17). On the card,
``chip_smoke.py`` phase 3i holds the graphs' captures of the sharded
forward (kernel nodes, collectives, bits).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu import configs as jcfg
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu_torch import bench as tbench
from cuda_mpi_gpu_cluster_programming_tpu_torch import configs as tcfg
from cuda_mpi_gpu_cluster_programming_tpu_torch import run as trun
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet as talex
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import replay
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import breakdown, halo
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving import server
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.loadgen import run_load
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.cuda_graphs import BucketGraphs

HW = 43
J_SMALL = dataclasses.replace(jalex.BLOCKS12, in_height=HW, in_width=HW)
T_SMALL = dataclasses.replace(talex.BLOCKS12, in_height=HW, in_width=HW)
SIZES = [1, 3, 2, 4, 1]
FP32_ABS, FP32_REL = 1e-4, 1e-5  # precision/gate.py DEFAULT_BUDGETS, fp32


@pytest.fixture(autouse=True)
def _default_variants(monkeypatch):
    for var in ("TPU_FRAMEWORK_FUSE", "TPU_FRAMEWORK_CONV", "TPU_FRAMEWORK_POOL", "TPU_FRAMEWORK_KBLOCK",
                "TPU_FRAMEWORK_ROWBLOCK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TPU_FRAMEWORK_COMPILE_CACHE", "0")


def _case(seed=21):
    """Zero-mean weights, small biases, and one uniform [0, 1) image stream,
    drawn with numpy."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        fan_in = shape[0] * shape[1] * shape[2]
        return ((rng.random(shape, dtype=np.float32) - 0.5) * (4 / fan_in**0.5)).astype(np.float32)

    params = {"conv1": {"w": w(11, 11, 3, 96), "b": (rng.random(96, dtype=np.float32) - 0.5) * 0.2},
              "conv2": {"w": w(5, 5, 96, 256), "b": (rng.random(256, dtype=np.float32) - 0.5) * 0.2}}
    return params, [rng.random((n, HW, HW, 3), dtype=np.float32) for n in SIZES]


def test_a_two_shard_server_is_the_jax_sharded_forward_within_budget(tmp_path):
    params, xs = _case()
    journal = tmp_path / "serve.jsonl"
    srv = server.InferenceServer(server.ServeConfig(
        config="v5_collective", n_shards=2, max_batch=4, model_cfg=T_SMALL, journal_path=str(journal),
        device="cpu"), params=tinit.params_from_jax(params, device="cpu"))
    srv.run_until_drained()  # builds and warms every bucket
    assert srv.shards == 2
    handles = [srv.submit(x) for x in xs]
    halo.reset_collectives()
    srv.run_until_drained()
    collectives = dict(halo.COLLECTIVES)
    srv.close()
    assert [h.status for h in handles] == ["OK"] * len(xs) and srv.stats.cache_misses == 0
    got = np.concatenate([h.result for h in handles])

    jfwd = jcfg.build_forward(jcfg.REGISTRY["v5_collective"], J_SMALL, n_shards=2, policy="fp32")
    want = np.asarray(jfwd(jax.tree.map(np.asarray, params), np.concatenate(xs)), np.float32)
    diff = float(np.max(np.abs(got - want)))
    assert diff <= FP32_ABS and diff / float(np.max(np.abs(want))) <= FP32_REL, diff

    # each result bitwise the port's eager sharded forward on its padded bucket, sliced
    fwd = tcfg.build_forward(tcfg.REGISTRY["v5_collective"], T_SMALL, device="cpu", n_shards=2)
    tp = tinit.params_from_jax(params, device="cpu")
    batches = [r for r in Journal.load(journal) if r["kind"] == "serve_batch"]
    pending = list(zip(xs, handles))
    for rec in batches:
        mine = [pending.pop(0) for _ in range(rec["n_requests"])]
        padded = np.concatenate([x for x, _ in mine] + [np.zeros((rec["pad"], HW, HW, 3), np.float32)])
        eager = fwd(tp, torch.from_numpy(padded)).numpy()
        off = 0
        for x, h in mine:
            assert np.array_equal(h.result, eager[off : off + len(x)])
            off += len(x)
    assert not pending
    per_dispatch = breakdown.expected_collectives(T_SMALL, 2, staged=False)
    assert collectives == {**dict.fromkeys(collectives, 0), "ppermute": per_dispatch * len(batches)}
    cfg = next(r for r in Journal.load(journal) if r["kind"] == "serve_config")
    assert cfg["n_shards"] == 2 and cfg["config"] == "v5_collective"


@pytest.fixture(scope="module")
def one_shard_journal(tmp_path_factory):
    """A ``v5_collective`` serve journal recorded at one shard, 43x43."""
    path = tmp_path_factory.mktemp("shards") / "serve.jsonl"
    srv = server.InferenceServer(server.ServeConfig(
        config="v5_collective", n_shards=1, max_batch=4, model_cfg=T_SMALL, journal_path=str(path),
        device="cpu", default_deadline_s=30.0))
    srv.start()
    try:
        rep = run_load(srv, rate_rps=20.0, duration_s=0.4, seed=3)
    finally:
        srv.close()
    assert rep.n_ok == rep.n_requests > 0
    return path


def test_a_replay_at_two_devices_keeps_the_recorded_accounting(one_shard_journal, tmp_path):
    recorded = replay.load_recorded_run(one_shard_journal)
    assert recorded.config["n_shards"] == 1
    rep = replay.replay_recorded(recorded, replay.ReplayKnobs(
        devices=2, journal_path=str(tmp_path / "x2dev.jsonl"), device="cpu"))
    assert rep.accounting_matches and rep.accounting_closed and not rep.knobs.neutral
    assert rep.n_offered == len(recorded.submits) and rep.cache_misses == 0
    again = replay.load_recorded_run(tmp_path / "x2dev.jsonl")
    assert again.config["n_shards"] == 2 and again.accounting == recorded.accounting
    assert "devices=2 " in rep.summary()


def test_the_cli_and_the_bench_replay_at_two_devices(one_shard_journal, tmp_path, monkeypatch, capsys):
    rc = trun.main(["--serve-replay", str(one_shard_journal), "--device", "cpu", "--replay-devices", "2",
                    "--replay-journal", str(tmp_path / "cli.jsonl")])
    out = capsys.readouterr().out
    assert rc == 0 and "devices=2 " in out and "accounting_matches=True" in out
    monkeypatch.setattr(tbench, "DEVICE", "cpu")
    monkeypatch.setenv("BENCH_REPLAY_JOURNAL", str(one_shard_journal))
    monkeypatch.setenv("BENCH_REPLAY_DEVICES", "2")
    monkeypatch.setenv("BENCH_REPLAY_OUT", str(tmp_path / "bench.jsonl"))
    rc = tbench._replay_main()
    (row,) = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert rc == 0 and row["devices"] == 2 and row["accounting_matches"] and "error" not in row


def test_run_serve_shards_2_and_the_bench_serve_shards(tmp_path, monkeypatch, capsys):
    rc = trun.main(["--config", "v5_collective", "--serve", "--shards", "2", "--device", "cpu", "--height", "43",
                    "--width", "43", "--serve-max-batch", "2", "--serve-rate", "20", "--serve-duration", "0.3",
                    "--serve-journal", str(tmp_path / "run.jsonl")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Mesh: 2 shards on 1 device: cpu" in out and "Serve: " in out and " failed=0 cache_misses=0 " in out
    cfg = next(r for r in Journal.load(tmp_path / "run.jsonl") if r["kind"] == "serve_config")
    assert cfg["n_shards"] == 2
    monkeypatch.setattr(tbench, "DEVICE", "cpu")
    for k, v in dict(BENCH_SERVE_CONFIG="v5_collective", BENCH_SERVE_SHARDS="2", BENCH_SERVE_HEIGHT="43",
                     BENCH_SERVE_WIDTH="43", BENCH_SERVE_MAX_BATCH="2", BENCH_SERVE_DURATION="0.3",
                     BENCH_SERVE_RATE="20", BENCH_BREAKDOWN="0",
                     BENCH_SERVE_JOURNAL=str(tmp_path / "bench.jsonl")).items():
        monkeypatch.setenv(k, v)
    assert tbench._serve_main() == 0
    (row,) = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert "error" not in row and row["shards"] == 2 and row["n_failed"] == 0 and row["value"] > 0


def test_a_serving_mesh_stays_on_one_device():
    mesh = server.serve_mesh(3, torch.device("cpu"))
    assert mesh.describe() == "3 shards on 1 device: cpu"
    assert server.serve_mesh(2, "cpu").describe() == "2 shards on 1 device: cpu"
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        server.InferenceServer(server.ServeConfig(config="v5_collective", n_shards=0, device="cpu"))
    # a single-device config serves on one device whatever n_shards says, as in the JAX package
    srv = server.InferenceServer(server.ServeConfig(config="v1_jit", n_shards=4, device="cpu"))
    assert srv.shards == 1


def test_the_graph_helper_counts_no_collectives_on_the_cpu():
    graphs = BucketGraphs(lambda p, x: x * p, 2.0, (2, 3), "cpu")
    graphs.warm(2)
    assert graphs.collectives(2) == {} and graphs.kernels(2) == {}
    graphs.close()
