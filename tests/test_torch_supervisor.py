"""The port's elastic supervisor against the JAX package's, on the CPU.

The ladders (``default_ladder``/``train_ladder`` keys over a grid of
strategy, tier and shard count), the clean supervised forward (within the
fp32 budget of the JAX package's: 1e-4 abs, 1e-5 of the max), the
``stage_sdc`` drill (the same ``DEGRADED`` text, the same journal kinds in
the same order, a replay bitwise a fresh copy of the landed rung), the
``device_loss`` and exhaustion drills, the replicated rung's divergence
screen, ``run --supervise`` against the JAX CLI (the first 10 values
``29.2931`` at 4 decimals), the supervised server with the controller's
``degrade_capacity`` rung, and the replay of a faulted supervised journal.
63x63, 2 and 4 shard slots on the CPU mesh (the JAX package's 8 virtual
CPU devices); inputs from seeded numpy.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.resilience import chaos as jchaos
from cuda_mpi_gpu_cluster_programming_tpu.resilience import supervisor as jsup
from cuda_mpi_gpu_cluster_programming_tpu.resilience.journal import Journal as JJournal
from cuda_mpi_gpu_cluster_programming_tpu_torch import run as trun
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet as talex
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import replay
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import chaos
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import supervisor as tsup
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.policy import DegradationExhausted
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.sentinel import SDC
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.controller import ControllerConfig
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.server import InferenceServer, ServeConfig

JCFG = dataclasses.replace(jalex.BLOCKS12, in_height=63, in_width=63)
TCFG = dataclasses.replace(talex.BLOCKS12, in_height=63, in_width=63)
FP32_ABS, FP32_REL = 1e-4, 1e-5


def _numpy_case(seed=20, batch=2, hw=63):
    """Zero-mean weights, small biases, a uniform [0, 1) input (numpy)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        fan_in = shape[0] * shape[1] * shape[2]
        return ((rng.random(shape, dtype=np.float32) - 0.5) * (4 / fan_in**0.5)).astype(np.float32)

    params = {"conv1": {"w": w(11, 11, 3, 96), "b": ((rng.random(96, dtype=np.float32) - 0.5) * 0.2)},
              "conv2": {"w": w(5, 5, 96, 256), "b": ((rng.random(256, dtype=np.float32) - 0.5) * 0.2)}}
    return params, rng.random((batch, hw, hw, 3), dtype=np.float32)


CASE = _numpy_case()


def _port_args():
    params, x = CASE
    return tinit.params_from_jax(params, device="cpu"), torch.from_numpy(x.copy())


def _chaos(monkeypatch, spec):
    for mod in (chaos, jchaos):
        if spec is None:
            monkeypatch.delenv(mod.CHAOS_ENV, raising=False)
        else:
            monkeypatch.setenv(mod.CHAOS_ENV, spec)
        mod.reset()


@pytest.fixture(autouse=True)
def _chaos_off(monkeypatch):
    _chaos(monkeypatch, None)
    yield
    chaos.reset()
    jchaos.reset()


def _within(got, want):
    diff = float(np.max(np.abs(got - want)))
    assert diff <= FP32_ABS and diff / float(np.max(np.abs(want))) <= FP32_REL, diff


# ------------------------------------------------------------- ladders ---


@pytest.mark.parametrize("strategy", ["halo", "staged_halo", "tp", "replicated", "single"])
def test_ladder_keys_are_the_jax_packages(strategy):
    for tier in ("reference", "pallas"):
        for n in (1, 2, 3, 4, 8):
            assert [e.key for e in tsup.default_ladder(strategy, tier, n)] == \
                [e.key for e in jsup.default_ladder(strategy, tier, n)]
    # the port's config tier reads as the JAX package's pallas
    assert tsup.default_ladder(strategy, "kernels", 4) == tsup.default_ladder(strategy, "pallas", 4)
    for sp, tp in ((0, 0), (2, 0), (8, 0), (0, 4)):
        assert [e.key for e in tsup.train_ladder(sp, tp)] == [e.key for e in jsup.train_ladder(sp, tp)]
    with pytest.raises(ValueError, match="no supervisor ladder"):
        tsup.default_ladder("fsdp", "reference", 4)


# ----------------------------------------------------------- supervisor ---


def test_clean_supervised_forward_matches_the_jax_supervisor():
    params, x = CASE
    want = np.asarray(jsup.Supervisor(JCFG, jsup.default_ladder("halo", "reference", 4)).execute(
        jax.tree.map(np.asarray, params), x))
    sup = tsup.Supervisor(TCFG, tsup.default_ladder("halo", "reference", 4), device="cpu")
    out = sup.execute(*_port_args())
    _within(out.numpy(), want)
    assert sup.attempts == 1 and sup.trips == [] and sup.events == [] and sup.entry.key == "halo@4:reference"
    # the taps ride beside the output and move none of its bits
    fwd_out, digs = sup.fwd()(*_port_args())
    assert torch.equal(fwd_out, out) and sorted(digs) == ["conv1", "conv2", "lrn2", "pool1", "pool2"]


def test_stage_sdc_drill_is_the_jax_packages(monkeypatch, tmp_path):
    """``seed=3,stage_sdc=1`` into the row-sharded forward: the same trip,
    the same DEGRADED text, the same journal kinds in the same order; the
    replay is bitwise an uninjected copy of the rung it lands on."""
    params, x = CASE
    _chaos(monkeypatch, "seed=3,stage_sdc=1")
    jevents, tevents = [], []
    js = jsup.Supervisor(JCFG, jsup.default_ladder("halo", "reference", 4), journal=JJournal(tmp_path / "j.jsonl"),
                         on_event=jevents.append)
    jout = np.asarray(js.execute(jax.tree.map(np.asarray, params), x))
    ts = tsup.Supervisor(TCFG, tsup.default_ladder("halo", "reference", 4), journal=Journal(tmp_path / "t.jsonl"),
                         on_event=tevents.append, device="cpu")
    out = ts.execute(*_port_args())
    assert [str(e) for e in tevents] == [str(e) for e in jevents]
    assert [t.kind for t in ts.trips] == [t.kind for t in js.trips] == ["stage_digest"]
    assert ts.attempts == js.attempts == 2 and ts.entry.key == js.entry.key == "halo@2:reference"
    assert [r["kind"] for r in Journal.load(tmp_path / "t.jsonl")] == \
        [r["kind"] for r in JJournal.load(tmp_path / "j.jsonl")]
    _within(out.numpy(), jout)
    _chaos(monkeypatch, None)
    clean = tsup.Supervisor(TCFG, [tsup.LadderEntry("halo", "reference", 2)], device="cpu").execute(*_port_args())
    assert torch.equal(out, clean)


def test_device_loss_and_persistent_trips_walk_the_ladder(monkeypatch):
    params, x = CASE
    _chaos(monkeypatch, "seed=3,device_loss=1")
    sup = tsup.Supervisor(TCFG, tsup.default_ladder("tp", "reference", 4), device="cpu")
    out = sup.execute(*_port_args())
    assert [t.kind for t in sup.trips] == ["device_loss"] and sup.events[0].from_tier == "tp@4:reference"
    want = np.asarray(jax.jit(lambda p, xx: jalex.forward_blocks12(p, xx, JCFG))(jax.tree.map(np.asarray, params), x))
    _within(out.numpy(), want)
    ladder = tsup.default_ladder("halo", "reference", 4)
    _chaos(monkeypatch, f"seed=3,stage_sdc={len(ladder)}")
    sup = tsup.Supervisor(TCFG, ladder, device="cpu")
    with pytest.raises(DegradationExhausted) as ei:
        sup.execute(*_port_args())
    assert len(sup.trips) == len(ladder) and isinstance(ei.value.last, SDC)
    assert [e.from_tier for e in sup.events] == [e.key for e in ladder[:-1]]


def test_replicated_rung_screens_its_copies(monkeypatch):
    """The replicated rung digests each replica's output: copies that agree
    screen clean; one that drifts trips shard_divergence and falls to the
    floor."""
    sup = tsup.Supervisor(TCFG, tsup.default_ladder("replicated", "reference", 4), device="cpu")
    out = sup.execute(*_port_args())
    assert sup.trips == [] and sup.checker.last["out"].shape == (4,)
    sup = tsup.Supervisor(TCFG, tsup.default_ladder("replicated", "reference", 4), device="cpu")
    real = sup._build_entry

    def drifting(entry):
        fwd = real(entry)
        if entry.strategy != "replicated":
            return fwd

        def run(p, x):
            o, digs = fwd(p, x)
            return o, {"out": digs["out"] + torch.tensor([0.0, 0.0, 0.0, 1.0])}  # replica 3 drifts

        return run

    monkeypatch.setattr(sup, "_build_entry", drifting)
    got = sup.execute(*_port_args())
    assert [t.kind for t in sup.trips] == ["shard_divergence"] and sup.entry.key == "single@1:reference"
    _within(got.numpy(), out.numpy())


def test_promote_after_heal_is_bitwise_and_a_refused_one_is_journaled(monkeypatch, tmp_path):
    """mesh_shrink drops the rung to halo@2; device_rejoin heals the slots
    into probation; after two clean batches maybe_promote climbs back to
    halo@4, the output bitwise a fresh halo@4's. A candidate that changes
    results is refused and journaled once, never adopted."""
    _chaos(monkeypatch, "seed=3,mesh_shrink=2,device_rejoin=2")
    sup = tsup.Supervisor(TCFG, tsup.default_ladder("halo", "reference", 4), device="cpu",
                          journal=Journal(tmp_path / "s.jsonl"))
    p, x = _port_args()
    entries = []
    for step in range(4):
        sup.execute(p, x, step=step)
        entries.append(sup.entry.key)
        promoted = sup.maybe_promote(p)
        if promoted is not None:
            p = promoted
    assert entries[0] == "halo@2:reference" and sup.entry.key == "halo@4:reference" and sup.promotions == 1
    _chaos(monkeypatch, None)
    fresh = tsup.Supervisor(TCFG, [tsup.LadderEntry("halo", "reference", 4)], device="cpu").execute(p, x)
    assert torch.equal(sup.execute(p, x), fresh)
    kinds = [r["kind"] for r in Journal.load(tmp_path / "s.jsonl")]
    assert kinds.index("mesh_shrink") < kinds.index("sup_trip") < kinds.index("mesh_probation") \
        < kinds.index("sup_promote")

    sup = tsup.Supervisor(TCFG, tsup.default_ladder("halo", "reference", 4), device="cpu",
                          journal=Journal(tmp_path / "r.jsonl"))
    sup.request_degrade("drill")
    real = sup._build_entry

    def wrong(entry):
        fwd = real(entry)
        return (lambda pp, xx: (lambda o: (o[0] * 1.01, o[1]))(fwd(pp, xx))) if entry.n_shards == 4 else fwd

    monkeypatch.setattr(sup, "_build_entry", wrong)
    assert sup.request_promote(p) is None and sup.entry.key == "halo@2:reference"
    (refused,) = [r for r in Journal.load(tmp_path / "r.jsonl") if r["kind"] == "sup_promote_refused"]
    assert refused["to"] == "halo@4:reference" and "spot-check mismatch" in refused["cause"]


def test_flap_drill_quarantines_and_never_oscillates(monkeypatch, tmp_path):
    _chaos(monkeypatch, "seed=3,flap=3")
    sup = tsup.Supervisor(TCFG, tsup.default_ladder("halo", "reference", 4), device="cpu",
                          journal=Journal(tmp_path / "s.jsonl"))
    p, x = _port_args()
    for step in range(8):
        sup.execute(p, x, step=step)
        assert sup.maybe_promote(p) is None
    assert [t.kind for t in sup.trips] == ["mesh_shrink"] and sup.pool.n_quarantined == 1
    assert sup.entry.key == "halo@2:reference" and sup.promotions == 0
    (q,) = [r for r in Journal.load(tmp_path / "s.jsonl") if r["kind"] == "mesh_quarantine"]
    assert q["flaps"] == sup.pool.quarantine_flaps and q["cause"] == "chaos:flap"


# ------------------------------------------------------------- run CLI ---


def test_run_supervise_drill_prints_the_jax_clis_lines(monkeypatch, capsys):
    """The JAX package's CLI drill (its ``tests/test_supervisor.py``
    ``test_run_cli_supervise_drill``, the same argv and ``CHAOS_SPEC``): the
    DEGRADED line its supervisor prints for this drill (the API-level drill
    above holds the two supervisors to one another), a ``Supervisor:`` line
    naming the trip, and the golden first values, 29.2931 at 4 decimals."""
    _chaos(monkeypatch, "seed=3,stage_sdc=1")
    events = []
    params, x = CASE
    jsup.Supervisor(JCFG, jsup.default_ladder("halo", "reference", 2), on_event=events.append).execute(
        jax.tree.map(np.asarray, params), x)
    _chaos(monkeypatch, "seed=3,stage_sdc=1")
    assert trun.main(["--config", "v2.2_sharded", "--shards", "2", "--supervise", "--height", "63", "--width", "63",
                      "--repeats", "1", "--warmup", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    degraded = [line for line in out.splitlines() if line.startswith("DEGRADED(")]
    assert degraded == [str(e) for e in events]
    assert degraded[0].startswith("DEGRADED(halo@2:reference -> replicated@2:reference)")
    sup_line = re.search(r"^Supervisor: (.+)$", out, re.M).group(1)
    assert "trips=1 degradations=1 entry=replicated@2:reference kinds=stage_digest replays=1" in sup_line
    assert "Final Output (first 10 values): 29.2931" in out


# ------------------------------------------------------ supervised server ---


def test_supervised_server_replays_a_tripped_batch_and_walks_degrade_capacity(monkeypatch, tmp_path):
    """A trip mid-serve replays the batch on the new rung, every request
    served, nothing captured on the request path; the controller's
    degrade_capacity rung steps the ladder down and promote_capacity back."""
    _chaos(monkeypatch, "seed=3,stage_sdc=1")
    srv = InferenceServer(ServeConfig(config="v5_collective", n_shards=4, supervise=True, device="cpu",
                                      model_cfg=TCFG, max_batch=4, journal_path=str(tmp_path / "s.jsonl")))
    rng = np.random.default_rng(1)
    xs = [rng.random((n, 63, 63, 3), dtype=np.float32) for n in (1, 3, 2)]
    srv.run_until_drained()
    hs = [srv.submit(xx) for xx in xs]
    srv.run_until_drained()
    assert [h.status for h in hs] == ["OK"] * 3 and srv.stats.cache_misses == 0 and srv.stats.n_failed == 0
    assert [t.kind for t in srv.sup.trips] == ["stage_digest"] and srv.sup.entry.key == "halo@2:pallas"
    assert srv.stats.rewarms == 1
    # the replayed requests are bitwise a clean server's pinned to the rung the trip landed on
    _chaos(monkeypatch, None)
    clean = InferenceServer(ServeConfig(config="v5_collective", n_shards=4, supervise=True, device="cpu",
                                        model_cfg=TCFG, max_batch=4), ladder=[srv.sup.entry])
    clean.run_until_drained()
    ch = [clean.submit(xx) for xx in xs]
    clean.run_until_drained()
    assert all(np.array_equal(a.result, b.result) for a, b in zip(hs, ch))
    # the controller's capacity rung on a supervised server: down one rung and back
    from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.controller import AutopilotController

    ctl = AutopilotController(srv, ControllerConfig())
    assert ("degrade_capacity", "") in ctl._rungs() and all(r[0] != "downshift_dtype" for r in ctl._rungs())
    undo, extra = ctl._apply("degrade_capacity", "")
    assert (undo, extra["to"]) == ("halo@2:pallas", "replicated@4:reference") and srv.stats.rewarms == 2
    ok, back = ctl._unapply("degrade_capacity", "", undo)
    assert ok and back["to"] == "halo@2:pallas" and srv.stats.promotions == 1 and srv.stats.rewarms == 3
    hs = [srv.submit(rng.random((2, 63, 63, 3), dtype=np.float32))]
    srv.run_until_drained()
    assert hs[0].status == "OK" and srv.stats.cache_misses == 0
    kinds = [r["kind"] for r in Journal.load(tmp_path / "s.jsonl")]
    assert kinds.count("serve_rewarm") == 3 and "sup_promote" in kinds
    srv.close()
    clean.close()


def test_a_faulted_supervised_journal_replays_its_incident(monkeypatch, tmp_path):
    """A supervised server that lost two slots mid-serve (``mesh_shrink=2``)
    records the incident; its replay scripts the same loss at the same step
    and journals the same incident shape, its books closed as recorded."""
    _chaos(monkeypatch, "seed=3,mesh_shrink=2")
    path = tmp_path / "rec.jsonl"
    srv = InferenceServer(ServeConfig(config="v5_collective", n_shards=4, supervise=True, device="cpu",
                                      model_cfg=TCFG, max_batch=2, journal_path=str(path)))
    srv.run_until_drained()
    rng = np.random.default_rng(2)
    hs = [srv.submit(rng.random((1, 63, 63, 3), dtype=np.float32)) for _ in range(3)]
    srv.run_until_drained()
    srv.close()
    assert all(h.status == "OK" for h in hs)
    _chaos(monkeypatch, None)
    recorded = replay.load_recorded_run(path)
    assert [(f.step, f.kind, len(f.lost)) for f in recorded.faults] == [(0, "mesh_shrink", 2)]
    rep = replay.replay_recorded(recorded, replay.ReplayKnobs(device="cpu", journal_path=str(tmp_path / "r.jsonl")))
    assert rep.scripted_faults == 1 and rep.accounting_closed and rep.accounting_matches
    got = [(r["sdc_kind"], r["step"]) for r in Journal.load(tmp_path / "r.jsonl") if r["kind"] == "sup_trip"]
    want = [(r["sdc_kind"], r["step"]) for r in Journal.load(path) if r["kind"] == "sup_trip"]
    assert got == want == [("mesh_shrink", 0)]
    lost = [r["lost"] for r in Journal.load(tmp_path / "r.jsonl") if r["kind"] == "mesh_shrink"]
    assert lost == [r["lost"] for r in Journal.load(path) if r["kind"] == "mesh_shrink"]
