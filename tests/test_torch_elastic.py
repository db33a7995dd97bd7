"""The port's elastic pool over shard slots and the supervisor's training
twin, against the JAX package's, on the CPU.

The pool: losses, the roster re-queried at every build (a lost slot never
reappears; a healed one only once the roster shows it, then through
probation), quarantine after K flaps, every transition journaled as the
JAX pool journals it, seeded victims the same ids as the JAX package's over
its 8 virtual devices, live resharding that moves no value. The training
twin: ``supervise_step`` clean equal to the plain step and to the JAX
supervisor's within 1e-5 of the max; the ``mesh_shrink`` drill replaying
the step on the surviving slots, bitwise a run pinned to that rung;
``trip_external`` down to the floor; promotion after heal bitwise; a
non-finite loss tripping ``step_nonfinite``. 63x63, seeded numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu import training as jtrain
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.parallel import elastic as jel
from cuda_mpi_gpu_cluster_programming_tpu.resilience import chaos as jchaos
from cuda_mpi_gpu_cluster_programming_tpu.resilience import supervisor as jsup
from cuda_mpi_gpu_cluster_programming_tpu.resilience.journal import Journal as JJournal
from cuda_mpi_gpu_cluster_programming_tpu_torch import training as ttrain
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet as talex
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import elastic as tel
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.mesh import make_mesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import chaos
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import supervisor as tsup
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.policy import DegradationExhausted
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.sentinel import SDC
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.optim import sgd
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_leaves

JCFG = dataclasses.replace(jalex.BLOCKS12, in_height=63, in_width=63)
TCFG = dataclasses.replace(talex.BLOCKS12, in_height=63, in_width=63)


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


def _pool(**kw):
    return tel.ElasticPool(device="cpu", **kw)


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------------------------------ pool ---


def test_pool_tracks_losses_requeries_and_journals(tmp_path):
    pool = tel.ElasticPool(device="cpu", journal=Journal(tmp_path / "p.jsonl"), site="drill")
    assert (pool.n_total, pool.n_alive, pool.n_lost) == (8, 8, 0)
    victims = pool.alive()[5:7]
    rec = pool.lose(victims, cause="chaos:mesh_shrink")
    assert (rec["before"], rec["after"], pool.summary()) == (8, 6, "6/8")
    assert {s.id for s in pool.alive()}.isdisjoint({s.id for s in victims})
    mesh = pool.mesh_for(4)
    assert mesh.n_shards == 4 and mesh.describe() == "4 shards on 1 device: cpu"
    with pytest.raises(ValueError, match="refusing to lose all"):
        pool.lose(pool.alive())
    pool.lose(pool.alive()[3:])
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 3"):
        pool.mesh_for(4)
    jpool = jel.ElasticPool(journal=JJournal(tmp_path / "j.jsonl"), site="drill")
    jpool.lose(jpool.alive()[5:7], cause="chaos:mesh_shrink")
    jpool.lose(jpool.alive()[3:])
    strip = lambda rs: [{k: v for k, v in r.items() if k not in ("ts", "t")} for r in rs]  # noqa: E731
    assert strip(Journal.load(tmp_path / "p.jsonl")) == strip(JJournal.load(tmp_path / "j.jsonl"))


def test_seeded_victims_are_the_jax_packages():
    pool, jpool = _pool(), jel.ElasticPool()
    for seed in range(6):
        for k in (1, 2, 3, 99):
            for site in ("mesh_shrink", "flap"):
                got = [s.id for s in tel.seeded_victims(pool, k, seed, site=site)]
                assert got == [d.id for d in jel.seeded_victims(jpool, k, seed, site=site)]
    assert len(tel.seeded_victims(pool, 99, 7)) == 7


def test_heal_waits_for_the_roster_then_probation_then_quarantine(monkeypatch, tmp_path):
    pool = tel.ElasticPool(device="cpu", probation_steps=2, quarantine_flaps=3, journal=Journal(tmp_path / "p.jsonl"))
    victim = pool.alive()[4]
    pool.lose([victim])
    real = tel.slot_roster
    monkeypatch.setattr(tel, "slot_roster", lambda n, d: [s for s in real(n, d) if s.id != victim.id])
    assert pool.heal([victim]) == {"probation": [], "absent": [victim.id], "quarantined": []}
    assert pool.is_lost(victim) and pool.n_alive == 7
    monkeypatch.setattr(tel, "slot_roster", real)  # the slot shows up again: the pending heal lands
    assert pool.rejoin_check()["probation"] == [victim.id]
    assert pool.is_probationary(victim) and pool.n_alive == 7
    with pytest.raises(ValueError, match="devices"):
        pool.mesh_for(8)
    assert pool.note_clean_batch() == [] and pool.note_clean_batch() == [victim.id]
    assert pool.n_alive == 8 and pool.mesh_for(8).n_shards == 8
    for _ in range(2):
        pool.lose([victim], cause="chaos:flap")
        rec = pool.heal([victim], cause="chaos:flap")
    assert rec["quarantined"] == [victim.id] and pool.is_quarantined(victim) and pool.n_alive == 7
    assert pool.heal([victim])["quarantined"] == [victim.id] and pool.n_alive == 7  # sticky
    kinds = [(r["kind"], r.get("event")) for r in Journal.load(tmp_path / "p.jsonl")]
    assert ("mesh_probation", "enter") in kinds and ("mesh_probation", "pass") in kinds
    (q,) = [r for r in Journal.load(tmp_path / "p.jsonl") if r["kind"] == "mesh_quarantine"]
    assert q["device"] == victim.id and q["flaps"] == 3 and q["cause"] == "chaos:flap"


def test_reshard_moves_no_value():
    params = tinit.init_params_random(torch.Generator().manual_seed(0), TCFG, device="cpu")
    pool = _pool()
    pool.lose(pool.alive()[2:3])
    mesh = pool.mesh_for(4)
    placed = tel.reshard_tree(params, mesh)
    assert _equal(placed, params) and tel.tree_device_ids(placed) == {"cpu"}
    p2, o2 = tel.reshard_train_state(params, {"count": torch.zeros((), dtype=torch.int32)}, make_mesh(2, device="cpu"))
    assert _equal(p2, params) and int(o2["count"]) == 0


# ------------------------------------------------- supervised train steps ---


def _case(steps=3, batch=2):
    """The JAX tests' case: a teacher (the deterministic init) labels seeded
    inputs, a seeded student learns."""
    rng = np.random.default_rng(9)

    def w(*shape):
        fan_in = shape[0] * shape[1] * shape[2]
        return ((rng.random(shape, dtype=np.float32) - 0.5) * (4 / fan_in**0.5)).astype(np.float32)

    student = {"conv1": {"w": w(11, 11, 3, 96), "b": np.zeros(96, np.float32)},
               "conv2": {"w": w(5, 5, 96, 256), "b": np.zeros(256, np.float32)}}
    teacher = tinit.init_params_deterministic(TCFG, device="cpu")
    xs = [rng.random((batch, 63, 63, 3), dtype=np.float32) for _ in range(steps)]
    ys = [talex.forward_blocks12(teacher, torch.from_numpy(x), TCFG).numpy() for x in xs]
    return student, xs, ys


def _t(a):
    return torch.from_numpy(np.array(a))


def _sup(ladder, **kw):
    return tsup.Supervisor(TCFG, ladder, device="cpu",
                           step_builder=ttrain.make_elastic_step_builder(TCFG, optimizer=sgd(1e-3), device="cpu"), **kw)


def test_supervise_step_clean_is_the_plain_step_and_the_jax_supervisors():
    student, xs, ys = _case(steps=1)
    sup = _sup(tsup.train_ladder(sp_shards=4))
    p = tinit.params_from_jax(student, device="cpu")
    out = sup.supervise_step(p, (), _t(xs[0]), _t(ys[0]), step=0)
    _i, plain = ttrain.make_train_step(TCFG, mesh=make_mesh(4, device="cpu"), optimizer=sgd(1e-3), sp_shards=4,
                                       device="cpu")
    want = plain(p, (), _t(xs[0]), _t(ys[0]))
    assert sup.trips == [] and sup.replays == 0 and _equal(out[0], want[0]) and torch.equal(out[2], want[2])
    with pytest.raises(ValueError, match="step_builder"):
        tsup.Supervisor(TCFG, tsup.train_ladder(sp_shards=2), device="cpu").supervise_step({}, (), None, None)
    opt = optax.sgd(1e-3)
    js = jsup.Supervisor(JCFG, jsup.train_ladder(sp_shards=4),
                         step_builder=jtrain.make_elastic_step_builder(JCFG, optimizer=opt))
    jp = jax.tree.map(jnp.asarray, student)
    jout = js.supervise_step(jp, opt.init(jp), jnp.asarray(xs[0]), jnp.asarray(ys[0]), step=0)
    assert float(out[2]) == pytest.approx(float(jout[2]), rel=1e-5)
    for a, b in zip(tree_leaves(out[0]), jax.tree.leaves(jout[0])):
        b = np.asarray(b, np.float64)
        assert float(np.max(np.abs(a.numpy() - b))) <= 1e-5 * float(np.max(np.abs(b)))


def test_mesh_shrink_drill_replays_the_step_on_the_survivors(monkeypatch, tmp_path):
    """``mesh_shrink=2`` at the first step loses 2 slots in one event; the
    step replays on halo@2 over the survivors, and the 3-step trajectory is
    bitwise a run pinned to halo@2, no checkpoint consumed."""
    student, xs, ys = _case(steps=3)
    _chaos(monkeypatch, "seed=3,mesh_shrink=2")
    sup = _sup(tsup.train_ladder(sp_shards=4), journal=Journal(tmp_path / "s.jsonl"))
    p, o = tinit.params_from_jax(student, device="cpu"), ()
    for i, (x, y) in enumerate(zip(xs, ys)):
        p, o = sup.supervise_step(p, o, _t(x), _t(y), step=i)[:2]
    assert [t.kind for t in sup.trips] == ["mesh_shrink"] and sup.replays == 1
    assert (sup.pool.n_total, sup.pool.n_alive, sup.entry.key) == (8, 6, "halo@2:reference")
    kinds = [r["kind"] for r in Journal.load(tmp_path / "s.jsonl")]
    assert kinds.count("sup_step") == 3 and kinds.count("sup_replay") == 1 and "mesh_shrink" in kinds
    _chaos(monkeypatch, None)
    _i, pinned = ttrain.make_train_step(TCFG, mesh=make_mesh(2, device="cpu"), optimizer=sgd(1e-3), sp_shards=2,
                                        device="cpu")
    p2, o2 = tinit.params_from_jax(student, device="cpu"), ()
    for x, y in zip(xs, ys):
        p2, o2 = pinned(p2, o2, _t(x), _t(y))[:2]
    assert _equal(p, p2)


def test_trip_external_and_a_nonfinite_loss_walk_to_the_floor():
    student, xs, ys = _case(steps=1)
    ladder = tsup.train_ladder(sp_shards=4)
    sup = _sup(ladder)
    p, o = tinit.params_from_jax(student, device="cpu"), ()
    for hop in range(len(ladder) - 1):
        p, o = sup.trip_external(SDC("norm_spike", hop, "drill"), p, o)
    assert sup.entry.key == "single@1:reference" and sup.replays == len(ladder) - 1
    with pytest.raises(DegradationExhausted):
        sup.trip_external(SDC("norm_spike", 9, "drill"), p, o)
    base = ttrain.make_elastic_step_builder(TCFG, optimizer=sgd(1e-3), device="cpu")

    def poisoned(entry, mesh):
        fn = base(entry, mesh)
        if entry.n_shards == 4:
            return lambda pp, oo, x, y: fn(pp, oo, x, y)[:2] + (torch.tensor(float("nan")),)
        return fn

    sup = tsup.Supervisor(TCFG, ladder, device="cpu", step_builder=poisoned)
    out = sup.supervise_step(tinit.params_from_jax(student, device="cpu"), (), _t(xs[0]), _t(ys[0]), step=0)
    assert [t.kind for t in sup.trips] == ["step_nonfinite"] and sup.entry.key == "halo@2:reference"
    assert np.isfinite(float(out[2]))


def test_promotion_after_heal_hands_over_the_exact_bits(monkeypatch, tmp_path):
    """shrink -> heal -> probation -> promote: the degraded steps are bitwise
    a halo@2-pinned run, the promoted ones a halo@4-pinned run continuing
    from that state."""
    student, xs, ys = _case(steps=5)
    _chaos(monkeypatch, "seed=3,mesh_shrink=2,device_rejoin=2")
    sup = _sup(tsup.train_ladder(sp_shards=4), journal=Journal(tmp_path / "s.jsonl"))
    p, o = tinit.params_from_jax(student, device="cpu"), ()
    entries = []
    for i, (x, y) in enumerate(zip(xs, ys)):
        p, o = sup.supervise_step(p, o, _t(x), _t(y), step=i)[:2]
        entries.append(sup.entry.key)
        promoted = sup.maybe_promote(p, o)
        if promoted is not None:
            p, o = promoted
    assert entries == ["halo@2:reference"] * 3 + ["halo@4:reference"] * 2
    assert sup.promotions == 1 and sup.pool.n_alive == 8
    (promo,) = [r for r in Journal.load(tmp_path / "s.jsonl") if r["kind"] == "sup_promote"]
    assert (promo["frm"], promo["to"], promo["devices"]) == ("halo@2:reference", "halo@4:reference", 8)
    _chaos(monkeypatch, None)
    steps = {n: ttrain.make_train_step(TCFG, mesh=make_mesh(n, device="cpu"), optimizer=sgd(1e-3), sp_shards=n,
                                       device="cpu")[1] for n in (2, 4)}
    p2, o2 = tinit.params_from_jax(student, device="cpu"), ()
    for k, (x, y) in enumerate(zip(xs, ys)):
        p2, o2 = steps[2 if k < 3 else 4](p2, o2, _t(x), _t(y))[:2]
    assert _equal(p, p2)
