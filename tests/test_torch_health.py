"""The port's journal health folds against the JAX package's, on the CPU.

On the same records, the port's ``health_from_records(...).to_obj()``
equals the JAX package's (compared as sorted JSON), and so do
``summary_line()`` and ``render()``. The records come three ways: the
synthetic journals of the JAX ``tests/test_health.py`` (an old journal with
no ``compile_event``, the SLO blowout, the router outage of
``tests/test_router.py``, compile events carrying a compiler's flops count),
a port-recorded supervised serve drill (``v2.2_sharded`` at 2 shards, chaos
``device_loss``, traced), and a port grow-back drill (the train ladder at
``sp`` 4, ``mesh_shrink`` then ``device_rejoin``). Every incident's phases
sum to its wall; compile is None on a journal with no ``compile_event``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.observability import health as jhealth
from cuda_mpi_gpu_cluster_programming_tpu.resilience import chaos as jchaos
from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import BLOCKS12
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import Tracer, set_tracer
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.health import (
    BACKEND_DOWN_PHASES,
    ERROR_BUDGET,
    GROWBACK_PHASES,
    TRIP_PHASES,
    health_from_journal,
    health_from_records,
    incidents_from_records,
    slo_attainment,
)
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import chaos
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.slo import SLOClass, SLOPolicy

M63 = dataclasses.replace(BLOCKS12, in_height=63, in_width=63)


@pytest.fixture(autouse=True)
def _clean():
    set_tracer(None)
    yield
    set_tracer(None)
    chaos.reset()
    jchaos.reset()


def _same_as_jax(records) -> None:
    got, want = health_from_records(records), jhealth.health_from_records(records)
    assert json.dumps(got.to_obj(), sort_keys=True) == json.dumps(want.to_obj(), sort_keys=True)
    assert got.summary_line() == want.summary_line()
    assert got.render() == want.render()


def _sums_to_wall(rep) -> None:
    for inc in rep.incidents:
        assert inc.phase_sum_ms == pytest.approx(inc.wall_ms, abs=1e-6), inc


# ------------------------------------------------- the port's own drills ---


@pytest.fixture(scope="module")
def drill_journal(tmp_path_factory):
    """A seeded device-loss serve drill on a supervised ``v2.2_sharded``
    server (2 shards, 63x63), journaled under a tracer: the counterpart of
    the JAX ``tests/test_health.py`` fixture."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.queue import OK
    from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.server import InferenceServer, ServeConfig

    jp = tmp_path_factory.mktemp("health") / "serve.jsonl"
    scfg = ServeConfig(config="v2.2_sharded", n_shards=2, max_batch=4, supervise=True, journal_path=str(jp),
                       model_cfg=M63, device="cpu")
    saved = os.environ.get(chaos.CHAOS_ENV)
    os.environ[chaos.CHAOS_ENV] = "seed=3,device_loss=1"
    chaos.reset()
    try:
        srv = InferenceServer(scfg)
        set_tracer(Tracer(journal=srv.journal, seed=1))
        handles = [srv.submit(np.full((1, 63, 63, 3), 1.0 + 0.01 * i, np.float32)) for i in range(4)]
        srv.run_until_drained()
        srv.close()
    finally:
        set_tracer(None)
        if saved is None:
            os.environ.pop(chaos.CHAOS_ENV, None)
        else:
            os.environ[chaos.CHAOS_ENV] = saved
        chaos.reset()
    assert [h.status for h in handles] == [OK] * 4
    return jp


@pytest.fixture(scope="module")
def growback_journal(tmp_path_factory):
    """The grow-back drill: the train ladder at sp 4 under
    ``mesh_shrink=2,device_rejoin=2`` over 5 supervised steps, one
    promotion back to ``halo@4:reference``."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models.init import init_params_deterministic, init_params_random
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import forward_blocks12
    from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.supervisor import Supervisor, train_ladder
    from cuda_mpi_gpu_cluster_programming_tpu_torch.training import make_elastic_step_builder
    from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.optim import sgd

    jp = tmp_path_factory.mktemp("growback") / "sup.jsonl"
    teacher = init_params_deterministic(M63, device="cpu")
    params = init_params_random(torch.Generator().manual_seed(0), M63, device="cpu")
    gen = torch.Generator().manual_seed(9)
    xs = [torch.rand((2, 63, 63, 3), generator=gen) for _ in range(5)]
    with torch.no_grad():
        ys = [forward_blocks12(teacher, x, M63) for x in xs]
    saved = os.environ.get(chaos.CHAOS_ENV)
    os.environ[chaos.CHAOS_ENV] = "seed=3,mesh_shrink=2,device_rejoin=2"
    chaos.reset()
    opt = sgd(1e-3)
    sup = Supervisor(M63, train_ladder(sp_shards=4), step_builder=make_elastic_step_builder(M63, optimizer=opt,
                                                                                              device="cpu"),
                     journal=Journal(jp), device="cpu")
    set_tracer(Tracer(journal=sup.journal, seed=2))
    opt_state = opt[0](params)
    try:
        for i, (x, y) in enumerate(zip(xs, ys)):
            out = sup.supervise_step(params, opt_state, x, y, step=i)
            params, opt_state = out[0], out[1]
            promoted = sup.maybe_promote(params, opt_state)
            if promoted is not None:
                params, opt_state = promoted
    finally:
        set_tracer(None)
        if saved is None:
            os.environ.pop(chaos.CHAOS_ENV, None)
        else:
            os.environ[chaos.CHAOS_ENV] = saved
        chaos.reset()
    assert sup.promotions == 1
    return jp


def test_drill_incident_phases_sum_to_wall(drill_journal):
    rep = health_from_journal(drill_journal)
    assert len(rep.trips) == 1
    inc = rep.trips[0]
    assert inc.cause == "device_loss" and inc.wall_ms > 0
    assert set(inc.phases) == set(TRIP_PHASES)
    assert inc.phase_sum_ms == pytest.approx(inc.wall_ms, abs=1e-6)
    assert inc.phases["compile"] is not None
    assert rep.mttr_ms == pytest.approx(inc.wall_ms)
    assert inc.t0_ms is not None and inc.trace_id


def test_a_supervised_servers_capacity_starts_at_its_pool(drill_journal):
    """The ``serve_config`` header records the supervised pool's surviving
    slots, as the JAX server records its pool's devices, so a later
    ``sup_promote`` or ``mesh_shrink`` moves the capacity timeline from
    there and availability stays a share of the whole pool."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.elastic import DEFAULT_SLOTS

    records = Journal.load(drill_journal)
    (cfg,) = [r for r in records if r["kind"] == "serve_config"]
    assert cfg["devices"] == DEFAULT_SLOTS
    rep = health_from_records(records)
    assert rep.devices == DEFAULT_SLOTS
    assert rep.availability is None or 0.0 < rep.availability <= 1.0


def test_drill_compile_attribution_is_unavailable_not_invented(drill_journal):
    """The port's compile events carry no compiler flops count, so every
    cross-check says ``unavailable``, never a number."""
    rep = health_from_journal(drill_journal)
    comp = rep.compile
    assert comp["unattributed"] is False and comp["events"] >= 1 and comp["total_ms"] > 0
    assert comp["rows"] and comp["rows"][0]["compiles"] >= 1
    assert comp["flops_checks"] and {c["verdict"] for c in comp["flops_checks"]} == {"unavailable"}
    assert all(r["xla_flops"] is None for r in comp["rows"])
    fields = dict(kv.split("=", 1) for kv in rep.summary_line().split())
    assert fields["incidents"] == str(len(rep.incidents))
    assert float(fields["compile_ms"]) == pytest.approx(comp["total_ms"], abs=0.05)
    assert "unavailable (no XLA cost analysis on this backend)" in rep.render()


def test_drill_folds_as_the_jax_package_folds_it(drill_journal):
    records = Journal.load(drill_journal)
    assert any(r["kind"] == "span" for r in records) and any(r["kind"] == "sup_trip" for r in records)
    _same_as_jax(records)


def test_growback_drill_attributes_probation(growback_journal):
    rep = health_from_records(Journal.load(growback_journal))
    growbacks = [i for i in rep.incidents if i.kind == "growback"]
    assert len(growbacks) == 1
    gb = growbacks[0]
    assert gb.entry == "halo@4:reference" and tuple(gb.phases) == GROWBACK_PHASES
    assert gb.phases["probation"] is not None and gb.phases["probation"] > 0
    assert gb.phase_sum_ms == pytest.approx(gb.wall_ms, abs=1e-6)
    assert rep.probation_enters == 1 and rep.probation_passes == 1
    assert len(rep.trips) == 1 and rep.trips[0].cause == "mesh_shrink"
    _sums_to_wall(rep)


def test_growback_drill_folds_as_the_jax_package_folds_it(growback_journal):
    _same_as_jax(Journal.load(growback_journal))


# ------------------------------------------------- synthetic journals ---


def _old_journal(jp):
    j = Journal(jp)
    j.append("sup_trip", key="trip:1", sdc_kind="device_loss", step=0, entry="halo@2:reference")
    j.append("serve_rewarm", key="rewarm:1", ms=12.0, buckets=[2])
    j.append("sup_ok", key="ok:0", step=0)
    return jp


def _blowout_journal(jp):
    """Class "tight" blows its budget (1 of 3 completions late); "loose"
    stays clean; one rejected submit burns nothing."""
    j = Journal(jp)
    pol = SLOPolicy([SLOClass("tight", 10.0), SLOClass("loose", 5000.0)])
    j.append("serve_config", key="cfg", slo=pol.to_obj(), devices=2)
    for i in range(3):
        j.append("serve_submit", key=f"s:{i}", cls="tight", admitted=True)
    j.append("serve_submit", key="s:r", cls="tight", admitted=False)
    j.append("serve_batch", key="b:0", bucket=2, batch_ms=60.0, req_lat_ms={"r0": 50.0, "r1": 5.0, "r2": 6.0},
             req_cls={"r0": "tight", "r1": "tight", "r2": "tight"})
    return jp


def _outage_records():
    """The JAX ``tests/test_router.py`` outage: b1 down at 1000 ms (detected
    40 ms after the first miss), redirects, probation at 3000 ms, readmitted
    at 4000 ms."""
    return [
        {"kind": "router_config", "n_backends": 2, "t_ms": 0.0},
        {"kind": "router_backend_state", "backend": "b1", "url": "u", "frm": "up", "to": "down",
         "reason": "conn:ConnectionRefusedError", "consec_fail": 2, "detect_ms": 40.0, "t_ms": 1000.0},
        {"kind": "router_redirect", "rid": "r1", "frm": "b1", "to": "b0", "attempt": 1,
         "reason": "conn:ConnectionRefusedError", "t_ms": 1200.0},
        {"kind": "router_redirect", "rid": "r2", "frm": "b1", "to": "b0", "attempt": 1,
         "reason": "conn:ConnectionRefusedError", "t_ms": 1500.0},
        {"kind": "router_backend_state", "backend": "b1", "url": "u", "frm": "down", "to": "probation",
         "reason": "heal", "probes_needed": 2, "t_ms": 3000.0},
        {"kind": "router_backend_state", "backend": "b1", "url": "u", "frm": "probation", "to": "up",
         "reason": "readmit", "clean_probes": 2, "probation_ms": 1000.0, "down_ms": 3000.0, "t_ms": 4000.0},
        {"kind": "router_route", "rid": "r1", "cls": "interactive", "verdict": "ok", "backend": "b0", "attempts": 2,
         "redirects": 1, "http": 200, "ms": 12.0, "t_ms": 1212.0},
    ]


def test_old_journal_reports_compile_unattributed(tmp_path):
    rep = health_from_records(Journal.load(_old_journal(tmp_path / "old.jsonl")))
    assert rep.compile["unattributed"] is True
    (inc,) = rep.trips
    assert inc.phases["compile"] is None  # unknown, not 0.0
    assert inc.phases["rewarm"] == pytest.approx(12.0)
    assert inc.phase_sum_ms == pytest.approx(inc.wall_ms, abs=1e-6)
    assert "compile_ms=unattributed" in rep.summary_line()
    assert "unknown, not" in rep.render()


def test_slo_attainment_burn_ranking_and_rejections(tmp_path):
    classes = slo_attainment(Journal.load(_blowout_journal(tmp_path / "j.jsonl")))
    by_name = {c.name: c for c in classes}
    tight, loose = by_name["tight"], by_name["loose"]
    assert classes[0].name == "tight"
    assert tight.ok == 3 and tight.violations == 1
    assert tight.burn == pytest.approx((1 / 3) / ERROR_BUDGET)
    assert tight.blown and not loose.blown
    assert loose.burn == 0.0 and loose.violations == 0
    assert tight.rejected == 1 and tight.offered == 3
    assert tight.p99_ms == pytest.approx(50.0)


def test_health_folds_backend_down_incident_phases_sum_to_wall():
    """The port's counterpart of the JAX ``tests/test_router.py`` fold."""
    recs = _outage_records()
    (inc,) = [i for i in incidents_from_records(recs) if i.kind == "backend_down"]
    assert inc.entry == "b1" and inc.cause == "conn:ConnectionRefusedError"
    assert inc.wall_ms == pytest.approx(4000.0 - (1000.0 - 40.0))
    assert tuple(inc.phases) == BACKEND_DOWN_PHASES
    assert inc.phase_sum_ms == pytest.approx(inc.wall_ms)
    assert inc.phases["detect"] == pytest.approx(40.0)
    assert inc.phases["redirect"] == pytest.approx(500.0)
    assert inc.phases["readmit"] == pytest.approx(1000.0)
    assert "backend_down b1" in inc.render()
    rep = health_from_records(recs)
    assert rep.probation_enters >= 1 and rep.probation_passes >= 1


def _flops_journal(jp):
    """Compile events with a compiler's flops count: one within the
    tolerance of the analytic ledger, one a 2-shard per-shard count, one far
    off, one at a geometry the ledger cannot model, one cache hit."""
    j = Journal(jp)
    for entry, shape, flops, n_shards, hit in (
        ("v1_jit", [2, 63, 63, 3], 0.9e8, 1, False),
        ("v2.2_sharded", [4, 63, 63, 3], 1.1e8, 2, False),
        ("v3_pallas", [1, 63, 63, 3], 9.0e9, 1, False),
        ("v3_pallas", [1, 63, 63], 1.0e8, 1, False),
        ("v1_jit", [2, 63, 63, 3], None, 1, True),
    ):
        j.append("compile_event", site="serve", entry=entry, shape=shape, batch=shape[0], dtype="float32",
                 n_shards=n_shards, ms=5.0, cache_hit=hit, xla_flops=flops, xla_bytes=None)
    return jp


@pytest.mark.parametrize("journal", [_old_journal, _blowout_journal, _flops_journal])
def test_synthetic_journals_fold_as_the_jax_package_folds_them(journal, tmp_path):
    _same_as_jax(Journal.load(journal(tmp_path / "j.jsonl")))


def test_outage_and_merged_journals_fold_as_the_jax_package_folds_them(tmp_path):
    _same_as_jax(_outage_records())
    merged = (Journal.load(_blowout_journal(tmp_path / "a.jsonl")) + Journal.load(_old_journal(tmp_path / "b.jsonl"))
              + _outage_records())
    _same_as_jax(merged)
    _sums_to_wall(health_from_records(merged))


def test_flops_check_verdicts(tmp_path):
    comp = health_from_journal(_flops_journal(tmp_path / "f.jsonl")).compile
    verdicts = {(c["entry"], len(c["shape"])): c["verdict"] for c in comp["flops_checks"]}
    assert verdicts[("v3_pallas", 4)] == "diverges" and verdicts[("v3_pallas", 3)] == "unavailable"
    assert verdicts[("v1_jit", 4)] == "agree" and verdicts[("v2.2_sharded", 4)] == "agree"
    sharded = next(c for c in comp["flops_checks"] if c["entry"] == "v2.2_sharded")
    assert sharded["shard_scale"] == 2


def test_controller_and_fleet_folds_absent_when_empty_present_when_not(tmp_path):
    rep = health_from_records(Journal.load(_blowout_journal(tmp_path / "j.jsonl")))
    assert "controller" not in rep.to_obj() and "fleet" not in rep.to_obj()
    j = Journal(tmp_path / "j.jsonl")
    j.append("controller_action", key="ctl:1", action="shed_bulk", target="bulk", actuated=True, reversal=False,
             level=1, ms=1.0)
    j.append("fleet_action", key="f:1", action="drain", target="b0", actuated=True, t_ms=10.0, ms=0.1,
             evidence={"detect_ms": 5.0})
    j.append("fleet_action", key="f:2", action="readmit", target="b0", actuated=True, t_ms=30.0, ms=0.1)
    records = Journal.load(tmp_path / "j.jsonl")
    obj = health_from_records(records).to_obj()
    assert obj["controller"]["total"] == 1 and obj["fleet"]["drains"][0]["entry"] == "b0"
    _same_as_jax(records)
