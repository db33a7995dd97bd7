"""The port's serving controller (``<port>/serving/controller.py``) and the
server's actuators against the JAX package's, on the CPU.

- The two ``AutopilotController`` classes over one stub server surface (no
  forward), fed one seeded outcome stream and one injected clock, journal the
  same ``controller_action`` sequence: actions, targets, levels and evidence
  (every key but ``ms``, a wall time). The port's dtype screen is the real
  ``ToleranceGate`` at 63x63; the JAX side's ``_screen_dtype`` returns the
  port's verdict, which needs no edit to the JAX package.
- ``health.slo_attainment`` and ``controller_summary`` give the JAX
  functions' values on the same records.
- The port's server on the CPU: ``apply_compute`` captures every bucket
  again into new graphs and journals the JAX ``serve_rewarm`` keys; its
  outputs are bitwise the port's int8w forward and within the int8w budget
  of the JAX server's after its own ``apply_compute``; ``apply_buckets``
  releases a dropped bucket's graph and captures it again on widening; a
  screen that fails journals ``downshift_refused`` and changes nothing; the
  controller walks the whole ladder down and back on a live server, and
  the front end publishes its state.

Inputs are uniform [0, 1) images from a numpy seed at 63x63, as in
``tests/test_torch_serving.py``. The card runs the same walk at 227x227
(``chip_smoke.py`` phase 3g).
"""

import dataclasses
import json
import sys
import time
import types
import urllib.request
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
from cuda_mpi_gpu_cluster_programming_tpu.serving import controller as jcontroller  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import queue as jqueue  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import server as jserver  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import traffic as jtraffic  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.configs import REGISTRY, build_forward  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import BLOCKS12  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.models.init import params_from_jax  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import health  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.precision import gate as tgate  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving import controller, queue, server, traffic  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.frontend import ServingFrontend  # noqa: E402

CFG = dataclasses.replace(BLOCKS12, in_height=63, in_width=63)
JCFG = dataclasses.replace(JBLOCKS12, in_height=63, in_width=63)
IMG = (CFG.in_height, CFG.in_width, CFG.in_channels)
SIZES = [1, 3, 2, 1, 4]
BUCKETS = (1, 2, 4)
LIVE_SLO_MS = 600_000.0  # the interactive budget on a live CPU server
CLASSES = ("interactive", "batch", "bulk")
# the injected clock drives the throttle (eval_s) and the hysteresis (cooldown_s, min_dwell_s)
KNOBS = dict(eval_s=0.25, window=32, min_completed=8, cooldown_s=1.0, min_dwell_s=2.0)
LADDER = [("tighten_admission", "bulk"), ("tighten_admission", "batch"), ("narrow_buckets", ""),
          ("downshift_dtype", "int8w"), ("upshift_dtype", "int8w"), ("widen_buckets", ""),
          ("relax_admission", "batch"), ("relax_admission", "bulk")]


def _inputs(seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.random((n, *IMG), dtype=np.float32) for n in SIZES]


def _within_budget(got: np.ndarray, want: np.ndarray, policy: str) -> bool:
    b = DEFAULT_BUDGETS[policy]["*"]
    diff = float(np.max(np.abs(got.astype(np.float64) - want)))
    return diff <= b.max_abs and diff / max(float(np.max(np.abs(want))), 1e-30) <= b.max_rel


def _actions(records) -> list:
    return [{k: v for k, v in r.items() if k not in ("ms", "t", "seq", "wall")}
            for r in records if r["kind"] == "controller_action"]


@pytest.fixture(scope="module")
def jax_params():
    return jinit(JCFG)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax_params, device="cpu")


class _Stub:
    """The surface a controller reads and actuates, without a forward: the
    base policy and build dtype, an (empty) admission queue of one package,
    the bucket set, the three actuators and the journal hook."""

    def __init__(self, pkg_queue, slo, params=None):
        self.cfg = types.SimpleNamespace(slo=slo, compute="bf16")
        self.queue = pkg_queue.AdmissionQueue(max_pending=64, slo=slo)
        self.sup = None
        self.buckets = BUCKETS
        self.journal = None
        self.device = torch.device("cpu")
        self._params = params
        self.records = []
        self.computes = []

    def _model_cfg(self):
        return CFG

    def apply_slo_policy(self, policy):
        self.queue.slo = policy

    def apply_buckets(self, buckets):
        self.buckets = tuple(buckets)

    def apply_compute(self, compute):
        self.computes.append(compute)

    def _journal(self, kind, key, **payload):
        self.records.append({"kind": kind, "key": key, **payload})


def _pair(port_params):
    """The two controllers over one stub each; the JAX side's dtype screen
    returns the port's verdict."""
    pstub = _Stub(queue, traffic.slo_policy(traffic.default_class_mix(BUCKETS)), port_params)
    jstub = _Stub(jqueue, jtraffic.slo_policy(jtraffic.default_class_mix(BUCKETS)))
    pctl = controller.AutopilotController(pstub, controller.ControllerConfig(**KNOBS))
    jctl = jcontroller.AutopilotController(jstub, jcontroller.ControllerConfig(**KNOBS))
    verdicts = []
    real = pctl._screen_dtype

    def screen(compute):
        verdicts.append(real(compute))
        return verdicts[-1]

    pctl._screen_dtype = screen
    jctl._screen_dtype = lambda compute: verdicts[-1]
    return pctl, jctl, pstub, jstub


def _stream(seed: int, steps: int):
    """``steps`` evaluation steps: the outcomes fed before each (class,
    kind, latency ms) and the clock advance. The first half presses on the
    protected class, the second is calm."""
    rng = np.random.default_rng(seed)
    slo = {"interactive": 1000.0, "batch": 5000.0, "bulk": 0.0}
    out = []
    for step in range(steps):
        pressing = step < steps // 2
        events = []
        for _ in range(int(rng.integers(4, 16))):
            cls = CLASSES[int(rng.choice(3, p=[0.7, 0.25, 0.05]))]
            u = rng.random()
            if pressing and u < 0.1:
                events.append((cls, "shed", 0.0))
            elif pressing and u < 0.13:
                events.append((cls, "fail", 0.0))
            else:
                late = rng.random() < (0.6 if pressing else 0.0)
                events.append((cls, "ok", (slo[cls] or 100.0) * (1.5 if late else 0.2) * (0.5 + rng.random())))
        out.append((events, float(rng.uniform(0.3, 1.6))))
    return out


def _drive(ctl, events, now):
    for cls, kind, ms in events:
        if kind == "ok":
            ctl.note_ok(cls, ms)
        elif kind == "shed":
            ctl.note_shed(cls)
        else:
            ctl.note_fail(cls)
    return ctl.evaluate(now)


# ---------------------------------------------------- the controller alone ---


def test_the_controller_config_is_the_jax_packages():
    assert controller.ControllerConfig().to_obj() == jcontroller.ControllerConfig().to_obj()
    custom = dict(KNOBS, shed_order=("batch", "bulk"), downshift_to="int8w", enable_buckets=False)
    obj = controller.ControllerConfig(**custom).to_obj()
    assert obj == jcontroller.ControllerConfig(**custom).to_obj()
    assert controller.ControllerConfig.from_obj({**obj, "newer_knob": 1}) == controller.ControllerConfig(**custom)
    assert controller._REVERSALS == jcontroller._REVERSALS


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_controllers_journal_the_same_actions(seed, port_params):
    pctl, jctl, pstub, jstub = _pair(port_params)
    now = 1000.0
    for events, dt in _stream(seed, 60):
        now += dt
        got, want = _drive(pctl, events, now), _drive(jctl, events, now)
        assert (got is None) == (want is None), (now, got, want)
        if got is not None:
            assert {k: v for k, v in got.items() if k != "ms"} == {k: v for k, v in want.items() if k != "ms"}
        assert pctl.level == jctl.level and pstub.buckets == jstub.buckets
    assert _actions(pstub.records) == _actions(jstub.records)
    assert pstub.computes == jstub.computes
    assert pstub.queue.slo.to_obj() == jstub.queue.slo.to_obj()
    assert pctl.state_obj(now) == jctl.state_obj(now) and pctl.summary() == jctl.summary()
    assert pctl.signals().to_obj() == jctl.signals().to_obj()


def test_the_whole_ladder_down_and_back_is_the_jax_controllers(port_params):
    """All late, then all on time: the four escalations and their four
    reversals in LIFO order, the downshift screened by the port's gate."""
    pctl, jctl, pstub, jstub = _pair(port_params)
    now = 1000.0
    for late in [True] * 5 + [False] * 6:
        events = [("interactive", "ok", 2000.0 if late else 100.0)] * 32
        now += 2.5
        _drive(pctl, events, now)
        _drive(jctl, events, now)
    acts = _actions(pstub.records)
    assert [(a["action"], a["target"]) for a in acts] == LADDER
    assert [a["level"] for a in acts] == [1, 2, 3, 4, 3, 2, 1, 0]
    assert acts == _actions(jstub.records)
    assert pstub.computes == jstub.computes == ["int8w", "bf16"]
    assert acts[3]["gate_margin"] is not None and acts[3]["frm"] == "bf16"
    assert acts[0]["evidence"]["burn"]["interactive"] == 100.0 and acts[-1]["evidence"]["burn"]["interactive"] == 0.0
    assert pstub.buckets == BUCKETS and pstub.queue.slo.to_obj() == pctl.base_slo.to_obj()


def test_a_refused_screen_blocks_the_rung_as_in_the_jax_package(port_params, monkeypatch):
    monkeypatch.setitem(tgate.DEFAULT_BUDGETS, "int8w", {"*": tgate.StageBudget(max_rel=1e-9)})
    pctl, jctl, pstub, jstub = _pair(port_params)
    now = 1000.0
    for _ in range(6):
        now += 2.5
        _drive(pctl, [("interactive", "ok", 2000.0)] * 32, now)
        _drive(jctl, [("interactive", "ok", 2000.0)] * 32, now)
    acts = _actions(pstub.records)
    assert [a["action"] for a in acts] == ["tighten_admission", "tighten_admission", "narrow_buckets",
                                           "downshift_refused"]
    assert not acts[-1]["actuated"] and acts[-1]["cause"].startswith("gate refused")
    assert acts == _actions(jstub.records) and pstub.computes == jstub.computes == []


# ------------------------------------------------------------ health folds ---


@pytest.fixture(scope="module")
def jax_records(jax_params, tmp_path_factory):
    """A JAX server's journal under the class mix's SLO policy (a late
    class, a deadline shed and a too-wide rejection among them)."""
    path = tmp_path_factory.mktemp("jctl") / "serve.jsonl"
    mix = jtraffic.default_class_mix(BUCKETS)
    pol = jtraffic.slo_policy([dataclasses.replace(c, slo_ms=c.slo_ms and 1e-3) if c.name == "batch" else c
                               for c in mix])
    srv = jserver.InferenceServer(jserver.ServeConfig(config="v1_jit", max_batch=4, model_cfg=JCFG, slo=pol,
                                                      journal_path=str(path)), params=jax_params)
    xs = _inputs(1)
    for x, cls in zip(xs, ["interactive", "batch", "batch", "interactive", "bulk"]):
        srv.submit(x, cls=cls)
    srv.submit(xs[0], cls="interactive", deadline_s=0.0)
    with pytest.raises(ValueError):
        srv.submit(np.zeros((5, *IMG), np.float32), cls="bulk")
    srv.run_until_drained()
    return JJournal.load(path)


def test_slo_attainment_is_the_jax_folds(jax_records):
    got, want = health.slo_attainment(jax_records), jhealth.slo_attainment(jax_records)
    assert [c.to_obj() for c in got] == [c.to_obj() for c in want]
    assert [c.render() for c in got] == [c.render() for c in want]
    assert {c.name for c in got} == set(CLASSES) and any(c.violations for c in got)
    assert health.ERROR_BUDGET == jhealth.ERROR_BUDGET


def test_controller_summary_is_the_jax_folds(jax_records, port_params):
    pctl, jctl, pstub, _jstub = _pair(port_params)
    now = 1000.0
    for late in [True] * 3 + [False] * 3:
        now += 2.5
        _drive(pctl, [("interactive", "ok", 2000.0 if late else 100.0)] * 32, now)
    # the journal's serve records, then the controller's actions, then the serve records again
    records = jax_records + pstub.records + jax_records
    got = health.controller_summary(records)
    assert got == jhealth.controller_summary(records)
    assert got["total"] == 6 and got["reversals"] == 3 and set(got["burn_after"]) == set(CLASSES)
    assert health.controller_summary(jax_records) == jhealth.controller_summary(jax_records) == {}


# -------------------------------------------------- the server's actuators ---


def _server(tmp_path, name, port_params, config="v1_jit", **kw):
    """A bf16 server on the CPU: ``v1_jit`` (the reference tier, the quicker
    on the CPU) unless the test names the kernel route, whose kernels run
    their plain versions here."""
    return server.InferenceServer(
        server.ServeConfig(config=config, compute="bf16", max_batch=4, model_cfg=CFG, device="cpu",
                           journal_path=str(tmp_path / name), mem_snapshot_s=0.0, **kw),
        params=port_params)


def _live_policy():
    """The class mix's policy with budgets a drained CPU stream stays far
    inside (its knee would otherwise read the CPU's forward time as
    pressure); the tests press through the injected outcomes."""
    return traffic.slo_policy(traffic.default_class_mix(BUCKETS, interactive_slo_ms=LIVE_SLO_MS,
                                                        batch_slo_ms=5 * LIVE_SLO_MS))


def _drain(srv, xs) -> list:
    handles = [srv.submit(x) for x in xs]
    srv.run_until_drained()
    assert [h.status for h in handles] == [queue.OK] * len(xs)
    return [h.result for h in handles]


def _batches(records, since: int = 0) -> list:
    return [(r["bucket"], r["n_requests"], r["pad"]) for r in records[since:] if r["kind"] == "serve_batch"]


def _eager(fwd, params, xs, batches) -> list:
    """``fwd`` on each padded batch the server assembled, sliced per request."""
    xs, out = list(xs), []
    for _bucket, n_requests, pad in batches:
        mine = [xs.pop(0) for _ in range(n_requests)]
        y = fwd(params, torch.from_numpy(np.concatenate(mine + [np.zeros((pad, *IMG), np.float32)]))).numpy()
        for x in mine:
            out.append(y[: len(x)])
            y = y[len(x):]
    return out


@pytest.fixture(scope="module")
def jax_int8w(jax_params, tmp_path_factory):
    """The JAX server's int8w outputs after its own apply_compute, and its serve_rewarm record."""
    path = tmp_path_factory.mktemp("jrewarm") / "serve.jsonl"
    srv = jserver.InferenceServer(jserver.ServeConfig(config="v1_jit", compute="bf16", max_batch=4, model_cfg=JCFG,
                                                      journal_path=str(path)), params=jax_params)
    srv.run_until_drained()
    srv.apply_compute("int8w")
    handles = [srv.submit(x) for x in _inputs()[:3]]
    srv.run_until_drained()
    (rewarm,) = [r for r in JJournal.load(path) if r["kind"] == "serve_rewarm"]
    return dict(results=[np.asarray(h.result) for h in handles], rewarm=rewarm)


def test_apply_compute_captures_every_bucket_again(tmp_path, port_params, jax_int8w):
    srv = _server(tmp_path, "serve.jsonl", port_params, config="v3_pallas")
    try:
        before = _drain(srv, _inputs()[:3])
        old_graphs, n_warm = srv._graphs, srv.stats.warmup_compiles
        ms = srv.apply_compute("int8w")
        assert srv._graphs is not old_graphs and srv.current_compute == "int8w" and srv.cfg.compute == "bf16"
        assert srv._warmed == set(BUCKETS) and all(b in srv._graphs for b in BUCKETS)
        assert srv.stats.warmup_compiles == n_warm + len(BUCKETS) and srv.stats.rewarm_ms == ms > 0
        n_records = len(Journal.load(srv.cfg.journal_path))
        got = _drain(srv, _inputs()[:3])
        records = Journal.load(srv.cfg.journal_path)
        (rewarm,) = [r for r in records if r["kind"] == "serve_rewarm"]
        assert set(rewarm) == set(jax_int8w["rewarm"]) and rewarm["dtype"] == "int8w"
        assert rewarm["buckets"] == list(BUCKETS) and rewarm["key"] == jax_int8w["rewarm"]["key"]
        warms = [r for r in records if r["kind"] == "serve_warm"]
        assert [w["dtype"] for w in warms] == ["bf16"] * 3 + ["int8w"] * 3
        # bitwise the port's eager int8w forward on the same padded batches; within budget of the JAX int8w server
        fwd = build_forward(REGISTRY["v3_pallas"], CFG, policy="int8w", device="cpu")
        for mine, eager, want in zip(got, _eager(fwd, port_params, _inputs()[:3], _batches(records, n_records)),
                                     jax_int8w["results"]):
            assert np.array_equal(mine, eager)
            assert _within_budget(mine, want, "int8w"), np.abs(mine - want).max()
        # and back: bitwise the bf16 service it started as
        srv.apply_compute("bf16")
        assert srv.current_compute == "bf16" and srv._compute_override is None
        assert all(np.array_equal(a, b) for a, b in zip(_drain(srv, _inputs()[:3]), before))
        assert srv.stats.cache_misses == 0
        assert "serve_miss" not in {r["kind"] for r in Journal.load(srv.cfg.journal_path)}
    finally:
        srv.close()


def test_a_failed_capture_leaves_the_old_forward_serving(tmp_path, port_params, monkeypatch):
    srv = _server(tmp_path, "serve.jsonl", port_params)
    try:
        before = _drain(srv, _inputs())
        graphs = srv._graphs
        from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import cuda_graphs

        def broken(self, bucket):
            raise RuntimeError("capture failed")

        monkeypatch.setattr(cuda_graphs.BucketGraphs, "warm", broken)
        with pytest.raises(RuntimeError, match="capture failed"):
            srv.apply_compute("int8w")
        monkeypatch.undo()
        assert srv._graphs is graphs and srv.current_compute == "bf16" and srv.stats.rewarm_ms == 0.0
        assert all(np.array_equal(a, b) for a, b in zip(_drain(srv, _inputs()), before))
        assert "serve_rewarm" not in {r["kind"] for r in Journal.load(srv.cfg.journal_path)}
    finally:
        srv.close()


def test_apply_buckets_releases_a_dropped_bucket_and_captures_it_again(tmp_path, port_params):
    srv = _server(tmp_path, "serve.jsonl", port_params)
    try:
        _drain(srv, _inputs())
        assert srv.apply_buckets((1, 2)) == 0.0
        assert srv.buckets == (1, 2) and 4 not in srv._graphs and srv._warmed == {1, 2}
        with pytest.raises(ValueError, match="largest bucket 2"):
            srv.submit(np.zeros((3, *IMG), np.float32))
        n_records = len(Journal.load(srv.cfg.journal_path))
        assert srv.apply_buckets(BUCKETS) > 0.0
        assert 4 in srv._graphs and srv._warmed == set(BUCKETS)
        xs = _inputs(2)
        got = _drain(srv, xs)
        records = Journal.load(srv.cfg.journal_path)
        assert [r["bucket"] for r in records[n_records:] if r["kind"] == "serve_warm"] == [4]
        assert 4 in [b for b, _n, _p in _batches(records, n_records)]
        fwd = build_forward(REGISTRY["v1_jit"], CFG, policy="bf16", device="cpu")
        assert all(np.array_equal(a, b) for a, b in zip(got, _eager(fwd, port_params, xs,
                                                                     _batches(records, n_records))))
        assert srv.stats.cache_misses == 0
        seqs = [r["key"] for r in records if r["kind"] == "serve_batch"]
        assert len(seqs) == len(set(seqs))  # the batcher's seq carried over
        with pytest.raises(ValueError, match="empty"):
            srv.apply_buckets(())
    finally:
        srv.close()


def _walk(srv, xs) -> list:
    """Step the server's controller with late, then on-time interactive
    outcomes on an injected clock (ahead of the dispatch loop's own, whose
    evaluations it throttles); after each action, drain ``xs`` (a request
    wider than the largest bucket is rejected at the door) and keep what
    the drain served and how."""
    ctl, now, path = srv.controller, time.monotonic() + 1e6, srv.cfg.journal_path
    rungs = []
    for late in [True] * 4 + [False] * 4:
        for _ in range(ctl.cfg.window):
            ctl.note_ok("interactive", 2 * LIVE_SLO_MS if late else 100.0)
        now += 2.5
        rec = ctl.evaluate(now)
        assert rec is not None and rec["actuated"], rec
        fits = [x for x in xs if len(x) <= srv.buckets[-1]]
        for x in xs:
            if len(x) > srv.buckets[-1]:
                with pytest.raises(ValueError, match="largest bucket"):
                    srv.submit(x)
        n = len(Journal.load(path))
        got = _drain(srv, fits)
        rungs.append(dict(action=(rec["action"], rec["target"]), buckets=srv.buckets, compute=srv.current_compute,
                          fits=fits, got=got, batches=_batches(Journal.load(path), n)))
    return rungs


def test_the_controller_walks_the_server_down_and_back(tmp_path, port_params):
    srv = _server(tmp_path, "serve.jsonl", port_params, slo=_live_policy(),
                  controller=controller.ControllerConfig(**KNOBS))
    try:
        srv.run_until_drained()  # built before any request waits: a build-long wait would read as the knee
        xs = _inputs(3)[:2]  # 1 and 3 images: the 3 is rejected at the door while the buckets are narrowed
        before = _drain(srv, xs)
        rungs = _walk(srv, xs)
        records = Journal.load(srv.cfg.journal_path)
        acts = _actions(records)
        assert [(a["action"], a["target"]) for a in acts] == [r["action"] for r in rungs] == LADDER
        kinds = [r["kind"] for r in records]
        assert kinds.count("gate_pass") == 1 and kinds.count("serve_rewarm") == 2 and "serve_miss" not in kinds
        assert [r["dtype"] for r in records if r["kind"] == "serve_rewarm"] == ["int8w", "bf16"]
        assert [r["buckets"] for r in rungs] == [BUCKETS, BUCKETS, (1, 2), (1, 2), (1, 2), BUCKETS, BUCKETS, BUCKETS]
        assert [r["compute"] for r in rungs] == ["bf16"] * 3 + ["int8w"] + ["bf16"] * 4
        # every rung's results bitwise its policy's eager forward on the padded batches it assembled
        fwds = {pol: build_forward(REGISTRY["v1_jit"], CFG, policy=pol, device="cpu") for pol in ("bf16", "int8w")}
        for r in rungs:
            want = _eager(fwds[r["compute"]], port_params, r["fits"], r["batches"])
            assert all(np.array_equal(a, b) for a, b in zip(r["got"], want)), r["action"]
        # back at the start: the same batches as the bf16 service it started as, and its bits
        assert rungs[-1]["batches"] == _batches(records)[: len(rungs[-1]["batches"])]
        assert all(np.array_equal(a, b) for a, b in zip(rungs[-1]["got"], before))
        assert srv.stats.cache_misses == 0 and srv.current_compute == "bf16" and srv.controller.level == 0
        (config,) = [r for r in records if r["kind"] == "serve_config"]
        assert config["controller"] == controller.ControllerConfig(**KNOBS).to_obj()
    finally:
        srv.close()


def test_a_failed_screen_on_the_server_journals_the_refusal(tmp_path, port_params, monkeypatch):
    monkeypatch.setitem(tgate.DEFAULT_BUDGETS, "int8w", {"*": tgate.StageBudget(max_rel=1e-9)})
    srv = _server(tmp_path, "serve.jsonl", port_params, slo=_live_policy(),
                  controller=controller.ControllerConfig(**KNOBS))
    try:
        srv.run_until_drained()
        _drain(srv, _inputs())
        graphs, ctl, now = srv._graphs, srv.controller, time.monotonic() + 1e6
        for _ in range(4):
            for _ in range(ctl.cfg.window):
                ctl.note_ok("interactive", 2 * LIVE_SLO_MS)
            now += 2.5
            ctl.evaluate(now)
        records = Journal.load(srv.cfg.journal_path)
        assert [a["action"] for a in _actions(records)][-1] == "downshift_refused"
        kinds = [r["kind"] for r in records]
        assert "gate_fail" in kinds and "serve_rewarm" not in kinds
        assert srv._graphs is graphs and srv.current_compute == "bf16" and ctl.level == 3
    finally:
        srv.close()


def test_the_front_end_and_gauges_publish_the_controller(tmp_path, port_params):
    srv = _server(tmp_path, "serve.jsonl", port_params, slo=_live_policy(),
                  controller=controller.ControllerConfig(**KNOBS))
    srv.cfg = dataclasses.replace(srv.cfg, mem_snapshot_s=1e-6)
    fe = None
    try:
        srv.run_until_drained()
        _drain(srv, _inputs())
        fe = ServingFrontend(srv, port=0).start()
        for path in ("/healthz", "/stats"):
            with urllib.request.urlopen(fe.url + path, timeout=30) as resp:
                state = json.loads(resp.read())["controller"]
            assert state["mode"] == "steady" and state["level"] == 0 and state["intent"]["calm"] is True
        gauges = [r for r in Journal.load(srv.cfg.journal_path) if r["kind"] == "serve_gauges"]
        assert gauges and all(g["ctl_level"] == 0 for g in gauges)
    finally:
        if fe is not None:
            fe.stop()
        srv.close()
