"""The port's inference service (``<port>/serving``) against the JAX package's, on the CPU.

At the 63x63 geometry of ``tests/test_serving.py``, with the JAX package's
``init_params_deterministic`` carried over by ``params_from_jax`` and
inputs drawn from a numpy seed:

- the pure modules (arrivals, shapes, classes, percentiles, the knee, the
  buckets, the queue and the batch assembly of a random stream) equal the
  JAX package's exactly, seed for seed;
- one request stream through the JAX ``v1_jit`` server and through each
  port server (``v1_jit`` and ``v3_pallas``, whose kernels run their plain
  versions on the CPU) in ``run_until_drained``: every result within the
  ``precision/gate.py`` budget of its dtype against the JAX fp32 server's,
  the ``serve_batch`` records' (bucket, n_requests, n_images, pad) equal
  to the JAX run's, no cache miss and one warmup a bucket;
- the edge paths (a journaled deadline shed, a request wider than the
  largest bucket), one threaded ``run_load`` that accounts for every
  request (no latency is asserted: timing on a loaded CPU varies), the
  refusals naming their ROADMAP items, the entry points raising without
  CUDA, the bench's serve and saturate rows (keys against the JAX rows'),
  and ``run --serve``.

Each server is built once per module; the CUDA graph path runs on the card
(``chip_smoke.py`` phase 3f).
"""

import ast
import dataclasses
import random
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cuda_mpi_gpu_cluster_programming_tpu.models.alexnet import BLOCKS12 as JBLOCKS12  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.models.init import init_params_deterministic as jinit  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.observability import health as jhealth  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.precision.gate import DEFAULT_BUDGETS  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.resilience.journal import Journal as JJournal  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import batcher as jbatcher  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import loadgen as jloadgen  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import queue as jqueue  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import server as jserver  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import slo as jslo  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import traffic as jtraffic  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch import bench as tbench  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch import run as trun  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import BLOCKS12  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.models.init import params_from_jax  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import health  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.metrics import registry  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import sentinel  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving import batcher, loadgen, queue, server  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving import slo, traffic  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.cuda_graphs import BucketGraphs  # noqa: E402

CFG = dataclasses.replace(BLOCKS12, in_height=63, in_width=63)
JCFG = dataclasses.replace(JBLOCKS12, in_height=63, in_width=63)
IMG = (CFG.in_height, CFG.in_width, CFG.in_channels)
SIZES = [1, 3, 2, 1, 4]
MAX_BATCH = 4


def _inputs(seed: int = 0) -> list:
    """Uniform [0, 1) images (pixels are not negative), the distribution of
    ``tests/test_torch_model.py``'s port-against-JAX cases."""
    rng = np.random.default_rng(seed)
    return [rng.random((n, *IMG), dtype=np.float32) for n in SIZES]


def _batches(records) -> list:
    return [(r["bucket"], r["n_requests"], r["n_images"], r["pad"]) for r in records if r["kind"] == "serve_batch"]


@pytest.fixture(scope="module")
def jax_params():
    return jinit(JCFG)


@pytest.fixture(scope="module")
def jax_run(jax_params, tmp_path_factory):
    """The request stream through the JAX package's v1_jit fp32 server."""
    path = tmp_path_factory.mktemp("jserve") / "serve.jsonl"
    srv = jserver.InferenceServer(jserver.ServeConfig(config="v1_jit", max_batch=MAX_BATCH, model_cfg=JCFG,
                                                      journal_path=str(path)), params=jax_params)
    handles = [srv.submit(x) for x in _inputs()]
    srv.run_until_drained()
    return dict(results=[np.asarray(h.result) for h in handles], records=JJournal.load(path), server=srv)


_PORT_RUNS = {}


@pytest.fixture(scope="module")
def port_run(jax_params, tmp_path_factory):
    """The same stream through the port's server at (config, dtype), built once each."""
    def run(config: str, compute: str) -> dict:
        if (config, compute) not in _PORT_RUNS:
            path = tmp_path_factory.mktemp("tserve") / "serve.jsonl"
            srv = server.InferenceServer(
                server.ServeConfig(config=config, compute=compute, max_batch=MAX_BATCH, model_cfg=CFG,
                                   journal_path=str(path), device="cpu"),
                params=params_from_jax(jax_params, device="cpu"))
            handles = [srv.submit(x) for x in _inputs()]
            srv.run_until_drained()
            _PORT_RUNS[config, compute] = dict(handles=handles, records=Journal.load(path), server=srv)
        return _PORT_RUNS[config, compute]

    yield run
    for r in _PORT_RUNS.values():
        r["server"].close()
    _PORT_RUNS.clear()


# ------------------------------------------------------------- pure modules ---


@pytest.mark.parametrize("max_batch", [1, 2, 3, 6, 8, 16])
def test_power_of_two_buckets_are_the_jax_packages(max_batch):
    assert batcher.power_of_two_buckets(max_batch) == jbatcher.power_of_two_buckets(max_batch)


def test_bucket_for_is_the_jax_packages():
    for n in range(1, 10):
        for buckets in ((1, 2, 4, 8), (8, 2, 1), (3, 6)):
            try:
                want = jbatcher.bucket_for(n, buckets)
            except ValueError as e:
                with pytest.raises(ValueError, match="fit no bucket"):
                    batcher.bucket_for(n, buckets)
                assert "fit no bucket" in str(e)
                continue
            assert batcher.bucket_for(n, buckets) == want
    with pytest.raises(ValueError):
        batcher.power_of_two_buckets(0)


@pytest.mark.parametrize("rate,duration,seed", [(50.0, 3.0, 0), (7.0, 2.0, 3), (400.0, 0.5, 11), (0.0, 1.0, 0)])
def test_poisson_arrivals_are_the_jax_packages(rate, duration, seed):
    assert loadgen.poisson_arrivals(rate, duration, seed) == jloadgen.poisson_arrivals(rate, duration, seed)


@pytest.mark.parametrize("shape", ["steady", "diurnal", "burst", "flash", "diurnal+burst",
                                   "diurnal:amp=0.8,period=2+burst:every=1,mult=5", "flash:at=0.3,mult=8"])
def test_shaped_arrivals_are_the_jax_packages(shape):
    for seed in (0, 7):
        assert traffic.shaped_arrivals(shape, 40.0, 2.0, seed) == jtraffic.shaped_arrivals(shape, 40.0, 2.0, seed)
    assert [(c.kind, c.params) for c in traffic.parse_shape(shape)] == [
        (c.kind, c.params) for c in jtraffic.parse_shape(shape)]


def test_unknown_shapes_fail_as_in_the_jax_package():
    for spec in ("tsunami", "diurnal:amp=x"):
        with pytest.raises(ValueError) as want:
            jtraffic.parse_shape(spec)
        with pytest.raises(ValueError) as got:
            traffic.parse_shape(spec)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("buckets", [(1, 2, 4), (1, 2, 4, 8), (1, 8)])
def test_class_mix_and_assignment_are_the_jax_packages(buckets):
    mix, jmix = traffic.default_class_mix(buckets), jtraffic.default_class_mix(buckets)
    assert [dataclasses.astuple(c) for c in mix] == [dataclasses.astuple(c) for c in jmix]
    for seed in (0, 5):
        got = traffic.assign_classes(list(mix), 200, seed)
        want = jtraffic.assign_classes(list(jmix), 200, seed)
        assert [(c.name, n) for c, n in got] == [(c.name, n) for c, n in want]
    assert traffic.slo_policy(mix).to_obj() == jtraffic.slo_policy(jmix).to_obj()


def test_percentile_and_knee_are_the_jax_packages():
    rng = random.Random(4)
    for n in (0, 1, 2, 7, 100):
        xs = [rng.uniform(0, 50) for _ in range(n)]
        for q in (0, 1, 50, 90, 99, 99.9, 100):
            assert loadgen.percentile(xs, q) == jloadgen.percentile(xs, q)
    for p99s in ([1.0, 2.0, 9.0], [1.0, 1.1, 1.2], [None, 3.0, 12.0], [5.0]):
        rows = [{"offered_img_s": 10.0 * (i + 1), "p99_ms": p} for i, p in enumerate(p99s)]
        for factor in (2.0, 3.0):
            assert loadgen.locate_knee(rows, factor) == jloadgen.locate_knee(rows, factor)


def test_slo_policy_is_the_jax_packages():
    classes = [slo.SLOClass("a", 10.0, 0.5), slo.SLOClass("b", 0.0), slo.SLOClass("c", 5.0, None, 2.0)]
    jclasses = [jslo.SLOClass("a", 10.0, 0.5), jslo.SLOClass("b", 0.0), jslo.SLOClass("c", 5.0, None, 2.0)]
    pol, jpol = slo.SLOPolicy(classes), jslo.SLOPolicy(jclasses)
    assert pol.to_obj() == jpol.to_obj()
    assert slo.SLOPolicy.from_obj(pol.to_obj()).to_obj() == jpol.to_obj()
    assert pol.scaled(0.5).to_obj() == jpol.scaled(0.5).to_obj()
    assert pol.tightened("b", 3.0).to_obj() == jpol.tightened("b", 3.0).to_obj()
    for cls in ("a", "b", "c", "other"):
        for waited in (0.0, 2.5, 6.0, 11.0):
            assert pol.should_shed(cls, waited) == jpol.should_shed(cls, waited)
        assert pol.deadline_for(cls) == jpol.deadline_for(cls)


def _assemble(qmod, bmod, sizes, buckets):
    q = qmod.AdmissionQueue()
    handles = [q.submit(np.full((n, 2, 2, 1), i, np.float32), cls=f"c{n % 2}") for i, n in enumerate(sizes)]
    b = bmod.Batcher(q, buckets)
    out = []
    while len(q):
        batch, shed = b.next_batch(0.0)
        assert not shed
        padded = batch.padded_input()
        if bmod is batcher:  # the port's padded_input(out=...) writes the same rows into a given buffer
            into = np.full_like(padded, np.nan)
            assert batch.padded_input(out=into) is into and np.array_equal(into, padded)
        out.append((batch.seq, batch.bucket, batch.n_images, batch.pad,
                    [(r.rid, off) for r, off in batch.offsets()], padded.shape))
    return out, [h.rid for h in handles]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_assembly_of_a_random_stream_is_the_jax_packages(seed):
    rng = random.Random(seed)
    buckets = (1, 2, 4, 8)
    sizes = [rng.choice([1, 1, 1, 2, 3, 4, 5, 8]) for _ in range(60)]
    got, rids = _assemble(queue, batcher, sizes, buckets)
    want, jrids = _assemble(jqueue, jbatcher, sizes, buckets)
    assert got == want and rids == jrids
    assert all(bucket in buckets for _s, bucket, *_ in got)
    assert sum(n for _s, _b, n, *_ in got) == sum(sizes)


def test_queue_fifo_backpressure_and_deadline_shed_are_the_jax_packages():
    for qmod in (queue, jqueue):
        q = qmod.AdmissionQueue(max_pending=3)
        h1 = q.submit(np.zeros((2, 2, 1), np.float32))
        expired = q.submit(np.zeros((1, 2, 2, 1), np.float32), deadline_s=1e-9)
        h3 = q.submit(np.zeros((3, 2, 2, 1), np.float32), cls="x")
        with pytest.raises(qmod.QueueFull, match="max_pending=3"):
            q.submit(np.zeros((2, 2, 1), np.float32))
        stats = q.stats()
        assert (stats.depth, stats.pending_images, stats.per_class) == (3, 5, {"": 2, "x": 1})
        time.sleep(0.01)
        taken, shed = q.pop_ready(max_images=3)
        assert [r.handle for r in taken] == [h1] and [r.handle for r in shed] == [expired]
        assert expired.status == qmod.SHED and shed[0].shed_reason == "deadline"
        taken, _ = q.pop_ready(max_images=3)
        assert [r.handle for r in taken] == [h3] and len(q) == 0
        with pytest.raises(ValueError, match=r"\(H,W,C\) or \(n,H,W,C\)"):
            q.submit(np.zeros((2, 2), np.float32))


def test_journal_latency_folds_are_the_jax_packages(jax_run):
    recs = jax_run["records"]
    assert server.latencies_from_records(recs) == jserver.latencies_from_records(recs)
    assert server.class_latencies_from_records(recs) == jserver.class_latencies_from_records(recs)


def test_compile_event_keeps_the_jax_record():
    kw = dict(site="serve", entry="v3_pallas", shape=(4, 63, 63, 3), dtype="bf16", ms=12.3456, cache_hit=False)
    assert health.compile_event(**kw) == jhealth.compile_event(**kw)  # xla_flops, xla_bytes: null in both
    seen = []
    prev = health.set_compile_observer(seen.append)
    try:
        assert health.get_compile_observer() is not None
        health.get_compile_observer()(health.compile_event(**kw))
    finally:
        health.set_compile_observer(prev)
    assert seen and seen[0]["batch"] == 4


# --------------------------------------------------------------- the server ---


def _within_budget(got: np.ndarray, want: np.ndarray, policy: str) -> bool:
    b = DEFAULT_BUDGETS[policy]["*"]
    diff = float(np.max(np.abs(got.astype(np.float64) - want)))
    return diff <= b.max_abs and diff / max(float(np.max(np.abs(want))), 1e-30) <= b.max_rel


@pytest.mark.parametrize("config,compute", [("v1_jit", "fp32"), ("v3_pallas", "fp32"), ("v1_jit", "bf16"),
                                            ("v3_pallas", "bf16"), ("v3_pallas", "int8w")])
def test_a_stream_through_the_port_server_is_the_jax_servers(config, compute, jax_run, port_run):
    run = port_run(config, compute)
    srv = run["server"]
    assert [h.status for h in run["handles"]] == [queue.OK] * len(SIZES)
    for h, want in zip(run["handles"], jax_run["results"]):
        assert h.result.shape == want.shape and h.result.dtype == np.float32
        assert _within_budget(h.result, want, compute), (config, compute, np.abs(h.result - want).max())
    assert _batches(run["records"]) == _batches(jax_run["records"])
    # bitwise the port's own forward on each padded bucket, sliced: serving adds nothing to a result
    xs, handles = _inputs(), list(run["handles"])
    for bucket, n_requests, n_images, pad in _batches(run["records"]):
        mine = [xs.pop(0) for _ in range(n_requests)]
        padded = np.concatenate(mine + [np.zeros((pad, *IMG), np.float32)])
        out = srv._fwd(srv._params, torch.from_numpy(padded)).numpy()
        for x in mine:
            h = handles.pop(0)
            assert np.array_equal(h.result, out[: len(x)]), (config, compute, bucket)
            out = out[len(x):]
    assert srv.stats.cache_misses == 0 and srv.stats.warmup_compiles == len(srv.buckets) == 3
    assert srv.buckets == jax_run["server"].buckets
    kinds = [r["kind"] for r in run["records"]]
    assert [k for k in kinds if k != "serve_submit"][0] == "serve_config"  # built at the first drain
    assert kinds.count("serve_warm") == kinds.count("compile_event") == 3
    assert kinds.count("serve_submit") == len(SIZES) and "serve_miss" not in kinds
    events = [r for r in run["records"] if r["kind"] == "compile_event"]
    assert [e["batch"] for e in events] == [1, 2, 4] and all(e["xla_flops"] is None for e in events)
    assert {e["dtype"] for e in events} == {compute}


def test_the_default_cpu_convolution_is_the_jax_servers_within_its_rounding_bound(tmp_path, jax_params, jax_run):
    """The port's ``v1_jit`` fp32 server on the CPU's default convolution,
    as a CPU user runs it (no switch set here), against the JAX server,
    within the gate's fp32 budget, and bitwise its own forward. The default
    is ``ops.reference.conv2d``'s GEMM convolution; oneDNN's, which
    ``F.conv2d`` would pick, was 9.7e-5 to 2.5e-4 off here at |out|max 22,
    past the budget's 1e-4."""
    path = tmp_path / "serve.jsonl"
    srv = server.InferenceServer(
        server.ServeConfig(config="v1_jit", max_batch=MAX_BATCH, model_cfg=CFG, journal_path=str(path), device="cpu"),
        params=params_from_jax(jax_params, device="cpu"))
    try:
        handles = [srv.submit(x) for x in _inputs()]
        srv.run_until_drained()
        for h, want in zip(handles, jax_run["results"]):
            assert h.status == queue.OK and h.result.shape == want.shape
            assert _within_budget(h.result, want, "fp32"), np.abs(h.result - want).max()
        records = Journal.load(path)
        assert _batches(records) == _batches(jax_run["records"])
        xs = _inputs()
        for n_requests, pad in [(n, p) for _b, n, _i, p in _batches(records)]:
            mine = [xs.pop(0) for _ in range(n_requests)]
            out = srv._fwd(srv._params, torch.from_numpy(np.concatenate(mine + [np.zeros((pad, *IMG), np.float32)])))
            for x in mine:
                h = handles.pop(0)
                assert np.array_equal(h.result, out[: len(x)].numpy())
                out = out[len(x):]
    finally:
        srv.close()


def test_the_port_server_journals_the_jax_vocabulary(jax_run, port_run):
    recs = port_run("v1_jit", "fp32")["records"]
    jrecs = jax_run["records"]
    for kind in ("serve_config", "serve_warm", "serve_submit", "serve_batch", "compile_event"):
        got = {k for r in recs if r["kind"] == kind for k in r}
        want = {k for r in jrecs if r["kind"] == kind for k in r}
        assert want <= got, (kind, want - got)


def test_a_missed_bucket_is_counted_journaled_and_served(tmp_path, jax_params):
    path = tmp_path / "serve.jsonl"
    srv = server.InferenceServer(server.ServeConfig(config="v1_jit", max_batch=4, model_cfg=CFG, device="cpu",
                                                    journal_path=str(path)), params=params_from_jax(jax_params, "cpu"))
    srv.run_until_drained()  # builds and warms every bucket
    srv._warmed.discard(2)
    h = srv.submit(_inputs()[2])  # two images: bucket 2
    srv.run_until_drained()
    srv.close()
    assert h.status == queue.OK and srv.stats.cache_misses == 1
    recs = Journal.load(path)
    assert [r["bucket"] for r in recs if r["kind"] == "serve_miss"] == [2]
    assert [r["batch"] for r in recs if r["kind"] == "compile_event"] == [1, 2, 4, 2]


def test_a_deadline_shed_is_explicit_and_journaled(tmp_path):
    path = tmp_path / "serve.jsonl"
    srv = server.InferenceServer(server.ServeConfig(config="v1_jit", max_batch=2, model_cfg=CFG, device="cpu",
                                                    journal_path=str(path)))
    srv.run_until_drained()
    expired = srv.submit(_inputs()[0], deadline_s=1e-9)
    live = srv.submit(_inputs()[0])
    time.sleep(0.01)
    srv.run_until_drained()
    srv.close()
    assert expired.status == queue.SHED and "deadline" in expired.error and expired.result is None
    assert live.status == queue.OK
    assert srv.stats.n_shed == 1 and srv.stats.n_ok == 1
    sheds = [r for r in Journal.load(path) if r["kind"] == "serve_shed"]
    assert [(r["rid"], r["reason"]) for r in sheds] == [(expired.rid, "deadline")]


def test_a_request_wider_than_the_largest_bucket_is_rejected(tmp_path):
    path = tmp_path / "serve.jsonl"
    srv = server.InferenceServer(server.ServeConfig(config="v1_jit", max_batch=4, model_cfg=CFG, device="cpu",
                                                    journal_path=str(path)))
    with pytest.raises(ValueError, match="exceeds the largest bucket 4"):
        srv.submit(np.zeros((5, *IMG), np.float32))
    assert len(srv.queue) == 0
    (rec,) = [r for r in Journal.load(path) if r["kind"] == "serve_submit"]
    assert rec["admitted"] is False and rec["reason"] == "too_wide" and rec["n"] == 5


def test_a_threaded_load_accounts_for_every_request(port_run):
    srv = port_run("v3_pallas", "fp32")["server"]
    registry().reset()
    srv.start()
    try:
        rep = loadgen.run_load(srv, rate_rps=40.0, duration_s=0.4, seed=3)
    finally:
        srv.stop()
    assert rep.n_requests == len(loadgen.poisson_arrivals(40.0, 0.4, 3)) > 0
    assert rep.n_ok + rep.n_shed + rep.n_failed + rep.n_rejected == rep.n_requests
    assert srv.stats.cache_misses == 0
    shaped = None
    srv.start()
    try:
        shaped = loadgen.run_shaped_load(srv, shape="diurnal+burst", rate_rps=30.0, duration_s=0.3,
                                         classes=list(traffic.default_class_mix(srv.buckets)), seed=1)
    finally:
        srv.stop()
    assert shaped.closed and sum(s.offered for s in shaped.per_class.values()) == len(
        traffic.shaped_arrivals("diurnal+burst", 30.0, 0.3, 1))


def test_concurrent_submitters_lose_no_request(tmp_path):
    """16 threads submit to a started server with the interpreter switching
    threads every microsecond: every request completes once, and the
    counters and the journal account for each (a lost update would not)."""
    import threading

    path = tmp_path / "serve.jsonl"
    srv = server.InferenceServer(server.ServeConfig(config="v3_pallas", max_batch=4, model_cfg=CFG, device="cpu",
                                                    journal_path=str(path), mem_snapshot_s=0.0)).start()
    img = np.ones((1, *IMG), np.float32)
    handles, lock = [], threading.Lock()

    def submitter():
        for _ in range(4):
            h = srv.submit(img)
            with lock:
                handles.append(h)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert all(h.wait(60) for h in handles)
    finally:
        sys.setswitchinterval(switch)
        srv.close()
    assert len(handles) == 64 and {h.status for h in handles} == {queue.OK}
    assert len({h.rid for h in handles}) == 64
    assert srv.stats.n_ok == 64 and srv.stats.n_images == 64 and len(srv.queue) == 0
    recs = Journal.load(path)
    assert sum(r["kind"] == "serve_submit" for r in recs) == 64
    assert sum(r["n_images"] for r in recs if r["kind"] == "serve_batch") == 64
    assert srv.queue.stats().pending_images == 0


def test_the_graph_helper_on_the_cpu_calls_the_forward():
    calls = []

    def fn(params, x):
        calls.append(tuple(x.shape))
        return x * params

    graphs = BucketGraphs(fn, 2.0, (2, 3), "cpu")
    assert 4 not in graphs and graphs.warm(4) >= 0.0 and 4 in graphs and 2 not in graphs
    out = graphs.run(4, np.ones((4, 2, 3), np.float64))
    graphs.fence()
    assert out.dtype == torch.float32 and torch.equal(out, torch.full((4, 2, 3), 2.0))
    assert calls == [(4, 2, 3), (4, 2, 3)] and graphs.host_buffer(4) is None  # no pinned buffer on the CPU
    assert graphs.kernels(4) == {}  # no graph, so no captured launches
    graphs.close()
    assert 4 not in graphs


@pytest.mark.parametrize("fields,item", [({"supervise": True, "compute": "int8w"}, "fp32 or bf16"),
                                         ({"n_shards": 0}, "n_shards must be")])
def test_what_waits_is_refused_naming_its_item(fields, item):
    """A shard width below one is refused at construction; a supervised
    server at int8w at its build (the supervisor's rungs run fp32 or bf16)."""
    with pytest.raises(ValueError, match=item):
        server.InferenceServer(server.ServeConfig(device="cpu", model_cfg=CFG, **fields)).run_until_drained()


def test_a_full_alexnet_config_is_refused():
    srv = server.InferenceServer(server.ServeConfig(config="v6_full_jit", device="cpu"))
    with pytest.raises(ValueError, match="Blocks 1-2 configs only"):
        srv.run_until_drained()


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv = server.InferenceServer(server.ServeConfig(config="v1_jit", model_cfg=CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv.start()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sentinel.oracle_spot_check()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--config", "v1_jit", "--serve", "--height", "63", "--width", "63"])


# ----------------------------------------------------------- bench and CLI ---


def _jax_row_keys(func: str, source: Path, var: str) -> set:
    """The keys a function of the JAX package's code puts in the dict ``var``:
    a dict literal assigned to it (or, with ``var`` None, one that spreads
    ``**row``) and its ``var["key"] = ...`` stores, outside nested functions."""
    tree = ast.parse(source.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.FunctionDef):
                continue
            if isinstance(child, ast.Dict) and (var is None and None in child.keys):
                keys.update(k.value for k in child.keys if k is not None)
            if isinstance(child, ast.Assign):
                for t in child.targets:
                    if isinstance(t, ast.Name) and t.id == var and isinstance(child.value, ast.Dict):
                        keys.update(k.value for k in child.value.keys if k is not None)
                    if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) and t.value.id == var
                            and isinstance(t.slice, ast.Constant)):
                        keys.add(t.slice.value)
            if (isinstance(child, ast.Call) and isinstance(child.func, ast.Attribute) and child.func.attr == "append"
                    and child.args and isinstance(child.args[0], ast.Dict) and var == "rows.append"):
                keys.update(k.value for k in child.args[0].keys if k is not None)
            visit(child)

    visit(fn)
    return keys


@pytest.fixture
def bench_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(tbench, "DEVICE", "cpu")
    monkeypatch.setattr(tbench, "CONFIG", "v3_pallas")
    for k, v in dict(BENCH_SERVE_HEIGHT="63", BENCH_SERVE_WIDTH="63", BENCH_SERVE_MAX_BATCH="4",
                     BENCH_SERVE_JOURNAL=str(tmp_path / "serve.jsonl")).items():
        monkeypatch.setenv(k, v)
    registry().reset()
    return tmp_path


def _rows(capsys) -> list:
    import json

    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def test_bench_serve_row_has_the_jax_rows_keys(bench_cpu, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_SERVE_DURATION", "0.3")
    monkeypatch.setenv("BENCH_SERVE_RATE", "30")
    assert tbench._serve_main() == 0
    (row,) = _rows(capsys)
    assert "error" not in row, row
    want = _jax_row_keys("_serve_main", ROOT / "bench.py", "row")
    # unsupervised, the row has no trips or entry (neither has the JAX one)
    assert set(row) == (want - set(tbench.SERVE_SKIPPED) - set(tbench.SUPERVISED_KEYS)) | {"skipped"}
    assert set(row["skipped"]) == {"drill"} <= want and set(tbench.SUPERVISED_KEYS) <= want
    assert "health" in want and row["health"]["summary"].startswith("incidents=0 ") and row["health"]["compile"]
    assert row["metric"] == tbench.SERVE_METRIC == "alexnet_blocks12_serve_images_per_sec"
    assert row["platform"] == "cpu" and row["value"] > 0 and row["buckets"] == [1, 2, 4]
    assert row["cache_misses_post_warmup"] == 0 and row["warmup_compiles"] == 3
    assert row["n_ok"] + row["n_shed"] + row["n_failed"] + row["n_rejected"] == row["n_requests"] > 0
    assert row["supervise"] is False and row["trace_id"]
    assert "plain versions" in row["breakdown"]["skipped"]
    lats = server.request_latencies_from_journal(bench_cpu / "serve.jsonl")
    assert len(lats) == row["n_ok"] and row["p50_ms"] == loadgen.percentile(lats, 50)


def test_bench_saturate_rows_have_the_jax_rows_keys(bench_cpu, monkeypatch, capsys):
    for k, v in dict(BENCH_SAT_RATES="20,400", BENCH_SAT_DURATION="0.25", BENCH_SERVE_SEED="7").items():
        monkeypatch.setenv(k, v)
    assert tbench._saturate_main() == 0
    rows = _rows(capsys)
    want = (_jax_row_keys("_saturate_main", ROOT / "bench.py", None)
            | _jax_row_keys("saturation_sweep", Path(jloadgen.__file__), "rows.append")
            | {"knee_rate_img_s", "knee_factor"})
    assert len(rows) == 2
    for row in rows:
        assert "error" not in row, row
        assert set(row) == want
        assert row["metric"] == "alexnet_blocks12_serve_saturation" and row["platform"] == "cpu"
        assert row["accounting_closed"] is True and row["percentiles_agree"] is True
        assert row["cache_misses"] == 0 == row["cache_misses_post_warmup"] and row["seed"] == 7


@pytest.mark.parametrize("mode", ["serve", "saturate"])
def test_bench_serve_modes_refuse_the_supervisor_and_a_dead_probe(mode, bench_cpu, monkeypatch, capsys):
    main = tbench._serve_main if mode == "serve" else tbench._saturate_main
    monkeypatch.setenv("BENCH_SERVE_SUPERVISE", "1")  # the JAX bench's default: a supervised service
    monkeypatch.setenv("BENCH_SERVE_DURATION", "0.3")
    monkeypatch.setenv("BENCH_SAT_RATES", "20")
    monkeypatch.setenv("BENCH_SAT_DURATION", "0.25")
    monkeypatch.setenv("BENCH_BREAKDOWN", "0")
    assert main() == 0
    rows = _rows(capsys)
    assert rows and all("error" not in r for r in rows), rows
    if mode == "serve":
        (row,) = rows
        assert row["supervise"] is True and row["trips"] == [] and row["entry"] == "single@1:pallas"
        assert row["value"] > 0 and row["platform"] == "cpu" and row["cache_misses_post_warmup"] == 0
    monkeypatch.setenv("BENCH_SERVE_SUPERVISE", "0")
    monkeypatch.setattr(tbench, "DEVICE", "cuda")
    import cuda_mpi_gpu_cluster_programming_tpu_torch.utils.probe as tprobe

    monkeypatch.setattr(tprobe, "probe", lambda timeout_s: (False, "probe failed (rc=1): no GPU"))
    assert main() == 0
    (row,) = _rows(capsys)
    assert row["value"] == 0.0 and row["error"].startswith("device probe failed") and row["platform"] == "unknown"


def test_run_serve_on_the_cpu(capsys, tmp_path):
    journal = tmp_path / "serve.jsonl"
    rc = trun.main(["--config", "v3_pallas", "--serve", "--device", "cpu", "--height", "63", "--width", "63",
                    "--serve-max-batch", "4", "--serve-duration", "0.3", "--serve-rate", "30",
                    "--serve-journal", str(journal)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Serve buckets: 1,2,4" in out and "Serve load: reqs=" in out and "cache_misses=0 warmups=3" in out
    kinds = {r["kind"] for r in Journal.load(journal)}
    assert {"serve_config", "serve_warm", "compile_event", "span"} <= kinds


@pytest.mark.parametrize("argv,why", [
    (["--serve", "--fallback-chain", "auto"], "degrades through the supervisor ladder"),
    (["--serve", "--shards", "0"], "--shards must be >= 1"),
    (["--serve", "--route", "2", "--fallback-chain", "auto"], "drop --fallback-chain"),
    (["--serve", "--serve-controller", "--route", "1", "--supervise"], "unsupervised backends"),
    (["--serve", "--supervise", "--dtype", "int8w"], "fp32 or bf16"),
    (["--serve", "--config", "v6_full_jit"], "Blocks 1-2 configs only"),
    (["--serve", "--traffic-shape", "tsunami"], "unknown traffic shape"),
])
def test_run_serve_refusals_exit_2(argv, why, capsys):
    rc = trun.main(["--device", "cpu", "--height", "63", "--width", "63", *argv])
    assert rc == 2 and why in capsys.readouterr().err


@pytest.mark.parametrize("argv,entry", [
    (["--config", "v3_pallas"], "single@1:pallas"),
    (["--config", "v5_collective", "--shards", "2"], "halo@2:pallas"),
])
def test_run_serve_supervise_on_the_cpu(argv, entry, capsys, tmp_path):
    """``run --serve --supervise``: the service under the supervisor, its
    ``Serve:`` line naming the rung and a ``Supervisor:`` line, every
    request served, nothing captured on the request path."""
    journal = tmp_path / "serve.jsonl"
    rc = trun.main(["--serve", "--supervise", "--device", "cpu", "--height", "63", "--width", "63",
                    "--serve-max-batch", "2", "--serve-duration", "0.3", "--serve-rate", "20",
                    "--serve-journal", str(journal), *argv])
    out = capsys.readouterr().out
    assert rc == 0, out
    serve_line = next(line for line in out.splitlines() if line.startswith("Serve: "))
    assert f"entry={entry} trips=0 promotions=0" in serve_line and "cache_misses=0" in serve_line
    assert f"Supervisor: attempts=" in out and f"entry={entry} kinds=none" in out
    kinds = [r["kind"] for r in Journal.load(journal)]
    assert kinds.count("sup_ok") >= 1 and "sup_trip" not in kinds and kinds[0] == "sup_build"
