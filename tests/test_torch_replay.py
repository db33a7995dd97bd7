"""The port's journal replay (``<port>/observability/replay.py``) against the
JAX package's, on the CPU.

- A journal the JAX server recorded loads to the same ``RecordedRun`` in
  both packages, and so do synthetic record lists with the supervisor's
  incident and grow-back records; the schedule expansion (crc32, no RNG) at
  ``traffic_mult`` 1, 1.5 and 2, the estimator's resolution and the report
  (``to_obj``, ``summary``, the class lines, the divergence verdict) are the
  JAX package's on the same inputs.
- A neutral replay on the port of a journal the port's server recorded closes
  per-class accounting identically; twice the traffic offers twice the
  requests and still closes. Latencies on a loaded CPU are not compared: both
  percentile pairs are reported, and the card holds them
  (``chip_smoke.py`` phase 3g).
- What the port cannot replay raises, naming its ROADMAP Queue 1 item: more
  than one device (item 3), a supervised recording or one with device-loss
  incidents (item 8).

63x63 geometry, seeded streams, as in ``tests/test_torch_serving.py``.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cuda_mpi_gpu_cluster_programming_tpu.models.alexnet import BLOCKS12 as JBLOCKS12  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.models.init import init_params_deterministic as jinit  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.observability import replay as jreplay  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import server as jserver  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import traffic as jtraffic  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import BLOCKS12  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import export, replay  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving import loadgen, server, traffic  # noqa: E402

CFG = dataclasses.replace(BLOCKS12, in_height=63, in_width=63)
JCFG = dataclasses.replace(JBLOCKS12, in_height=63, in_width=63)
IMG = (CFG.in_height, CFG.in_width, CFG.in_channels)
BUCKETS = (1, 2, 4)


@pytest.fixture(scope="module")
def jax_journal(tmp_path_factory):
    """A JAX server's journal under the class mix's policy: admitted requests
    of every class, a deadline shed and a too-wide rejection."""
    path = tmp_path_factory.mktemp("jreplay") / "serve.jsonl"
    srv = jserver.InferenceServer(jserver.ServeConfig(
        config="v1_jit", max_batch=4, model_cfg=JCFG, journal_path=str(path), default_deadline_s=30.0,
        slo=jtraffic.slo_policy(jtraffic.default_class_mix(BUCKETS))), params=jinit(JCFG))
    rng = np.random.default_rng(0)
    for n, cls in [(1, "interactive"), (2, "batch"), (4, "bulk"), (1, "interactive"), (3, "batch")]:
        srv.submit(rng.random((n, *IMG), dtype=np.float32), cls=cls)
    srv.submit(np.zeros((1, *IMG), np.float32), cls="interactive", deadline_s=1e-6)
    with pytest.raises(ValueError):
        srv.submit(np.zeros((5, *IMG), np.float32), cls="bulk")
    srv.run_until_drained()
    return path


@pytest.fixture(scope="module")
def port_journal(tmp_path_factory):
    """A journaled shaped load through the port's server on the CPU (light,
    with generous deadlines: every request served)."""
    path = tmp_path_factory.mktemp("treplay") / "recorded.jsonl"
    mix = list(traffic.default_class_mix(BUCKETS))
    srv = server.InferenceServer(server.ServeConfig(
        config="v1_jit", max_batch=4, model_cfg=CFG, journal_path=str(path), default_deadline_s=30.0,
        slo=traffic.slo_policy(mix), device="cpu"))
    srv.start()
    try:
        rep = loadgen.run_shaped_load(srv, shape="steady", rate_rps=15.0, duration_s=0.6, classes=mix, seed=0)
    finally:
        srv.close()
    assert rep.closed and rep.n_ok == rep.n_requests > 0
    return path


def _asdict(run) -> dict:
    return dataclasses.asdict(run)


def _incident_records(config: dict) -> list:
    """A supervised run's trail: a device loss, a mesh shrink with its
    victims, and grow-back records replay does not re-drive."""
    return [
        {"kind": "serve_config", "key": "config", **config},
        {"kind": "serve_submit", "key": "sub:1", "rid": "r1", "t_ms": 1.5, "n": 2, "cls": "batch",
         "deadline_s": 20.0, "admitted": True, "reason": ""},
        {"kind": "serve_submit", "key": "sub:2", "rid": "", "t_ms": 3.0, "n": 9, "cls": "bulk",
         "deadline_s": None, "admitted": False, "reason": "too_wide"},
        {"kind": "mesh_shrink", "key": "shrink:1", "lost": [3]},
        {"kind": "sup_trip", "key": "trip:1", "step": 4, "sdc_kind": "mesh_shrink", "cause": "device 3 lost"},
        {"kind": "sup_trip", "key": "trip:2", "step": 9, "cause": "x" * 300},
        {"kind": "mesh_probation", "key": "p:1"},
        {"kind": "sup_promote", "key": "pr:1"},
        {"kind": "serve_batch", "key": "batch:1", "req_lat_ms": {"r1": 12.5}, "req_cls": {"r1": "batch"}},
        {"kind": "serve_fail", "key": "fail:2", "n_requests": 2},
    ]


CONFIG = {"config": "v1_jit", "n_shards": 2, "compute": "fp32", "max_batch": 4, "buckets": [1, 2, 4],
          "supervise": True, "height": 63, "width": 63, "channels": 3, "slo": None, "controller": None}


# ------------------------------------------------------------ the record ---


def test_a_jax_recorded_journal_loads_to_the_same_run(jax_journal):
    got, want = replay.load_recorded_run(jax_journal), jreplay.load_recorded_run(jax_journal)
    assert _asdict(got) == _asdict(want)
    assert got.duration_s == want.duration_s
    assert {c["rejected"] for c in got.accounting.values()} == {0, 1}
    assert sum(c["shed"] for c in got.accounting.values()) == 1
    assert export.load_records(jax_journal.parent) == export.load_records(jax_journal) == Journal.load(jax_journal)


def test_an_incident_trail_loads_as_in_the_jax_package():
    records = _incident_records(CONFIG)
    got, want = replay.recorded_run_from_records(records, "x"), jreplay.recorded_run_from_records(records, "x")
    assert _asdict(got) == _asdict(want)
    assert [f.kind for f in got.faults] == ["mesh_shrink", "device_loss"] and got.faults[0].lost == (3,)
    assert got.unreplayed == {"mesh_probation": 1, "sup_promote": 1}


@pytest.mark.parametrize("records,why", [
    ([], "no serve_submit records"),
    (_incident_records(CONFIG)[1:], "no serve_config record"),
    (_incident_records(CONFIG) + [{"kind": "serve_config", "key": "config", **{**CONFIG, "max_batch": 8}}],
     "two differing serve_config records"),
])
def test_unreplayable_records_are_refused_as_in_the_jax_package(records, why):
    for module in (replay, jreplay):
        with pytest.raises(ValueError, match=why):
            module.recorded_run_from_records(records)


@pytest.mark.parametrize("mult", [1.0, 1.5, 2.0, 0.5])
def test_the_schedule_expansion_is_the_jax_packages(jax_journal, mult):
    subs = replay.load_recorded_run(jax_journal).submits
    jsubs = jreplay.load_recorded_run(jax_journal).submits
    rng = np.random.default_rng(int(mult * 10))
    extra = [replay.RecordedSubmit(float(t), f"r{i}", int(n), "batch", None, True, "")
             for i, (t, n) in enumerate(zip(rng.uniform(0, 500, 40), rng.integers(1, 5, 40)))]
    jextra = [jreplay.RecordedSubmit(*dataclasses.astuple(s)) for s in extra]
    got = replay.expand_schedule(subs + extra, mult)
    want = jreplay.expand_schedule(jsubs + jextra, mult)
    assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
    if mult == 2.0:
        assert len(got) == 2 * len(subs + extra)
    with pytest.raises(ValueError, match="traffic_mult must be > 0"):
        replay.expand_schedule(subs, 0.0)


def test_the_estimator_resolution_is_the_jax_packages():
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 7, 100):
        xs = list(rng.exponential(80.0, n))
        for q in (0, 50, 99):
            for floor in (50.0, 0.0):
                assert replay.percentile_resolution(xs, q, floor) == jreplay.percentile_resolution(xs, q, floor)


@pytest.mark.parametrize("knobs,per_class", [
    (dict(), None),
    (dict(), {"batch": {"offered": 2, "ok": 1, "shed": 1, "failed": 0, "rejected": 0}}),
    (dict(traffic_mult=2.0, slo_scale=0.5), None),
    (dict(controller="on"), None),
])
def test_the_report_is_the_jax_packages(jax_journal, knobs, per_class):
    rec, jrec = replay.load_recorded_run(jax_journal), jreplay.load_recorded_run(jax_journal)
    rng = np.random.default_rng(1)
    lat = list(rng.exponential(40.0, 9))
    kw = dict(per_class=per_class or {k: dict(v) for k, v in rec.accounting.items()}, latencies_ms=lat,
              class_latencies_ms={"batch": lat}, scripted_faults=0, duration_s=1.25, sustained_img_s=42.0,
              cache_misses=0, journal_path="replay.jsonl", controller_active=knobs.get("controller") == "on")
    got = replay.ReplayReport(knobs=replay.ReplayKnobs(device="cpu", **knobs), recorded=rec, **kw)
    want = jreplay.ReplayReport(knobs=jreplay.ReplayKnobs(**knobs), recorded=jrec, **kw)
    assert got.to_obj() == want.to_obj()
    assert got.summary() == want.summary() and got.class_lines() == want.class_lines()
    assert got.diverged == want.diverged


# ---------------------------------------------------------------- replays ---


def test_a_neutral_replay_closes_accounting_identically(port_journal, tmp_path):
    recorded = replay.load_recorded_run(port_journal)
    out = tmp_path / "replay.jsonl"
    rep = replay.replay_recorded(recorded, replay.ReplayKnobs(journal_path=str(out), device="cpu"))
    assert rep.accounting_matches and rep.accounting_closed and rep.knobs.neutral
    assert rep.n_offered == len(recorded.submits) and rep.cache_misses == 0 and not rep.controller_active
    for q in (50, 99):
        rec_q, rep_q = rep.percentile_pair(q)
        assert rec_q is not None and rep_q is not None
    assert rep.summary().startswith(f"offered={rep.n_offered} ok={rep.n_offered} ")
    # the replay's journal is itself a record of the same schedule
    again = replay.load_recorded_run(out)
    assert again.accounting == recorded.accounting and again.config["device"] == "cpu"


def test_twice_the_traffic_offers_twice_the_requests(port_journal, tmp_path):
    recorded = replay.load_recorded_run(port_journal)
    rep = replay.replay_recorded(recorded, replay.ReplayKnobs(
        traffic_mult=2.0, journal_path=str(tmp_path / "x2.jsonl"), device="cpu"))
    assert rep.n_offered == 2 * len(recorded.submits) and rep.accounting_closed
    assert not rep.knobs.neutral and not rep.diverged


@pytest.mark.parametrize("config,knobs,item", [
    ({}, dict(devices=2), "item 3"),
    ({"n_shards": 2, "supervise": False}, dict(), "item 3"),
    ({"n_shards": 1, "supervise": True}, dict(), "item 8"),
    ({"n_shards": 1, "supervise": False}, dict(), "item 8"),  # its incident records alone
])
def test_what_the_port_cannot_replay_names_its_item(config, knobs, item):
    records = _incident_records({**CONFIG, **config})
    if not config:
        records = [r for r in records if r["kind"] in ("serve_config", "serve_submit")]
        records[0] = {**records[0], "n_shards": 1, "supervise": False}
    recorded = replay.recorded_run_from_records(records)
    with pytest.raises(ValueError, match=item):
        replay.replay_recorded(recorded, replay.ReplayKnobs(device="cpu", **knobs))
