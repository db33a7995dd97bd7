"""The port's autotuner, tuning plans, gate journal and preflight against
the JAX package's, on the CPU.

The sweeps run with an injected deterministic timer (the real timer times
CUDA kernels; ``chip_smoke.py`` runs it on the card), so these stay fast
and order-stable. Candidate spaces are compared at the model's full
227x227 geometry (no compute), sweeps and forwards at 43x43.
"""

import dataclasses
import importlib
import itertools
import json
import zlib

import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu import harness as jharness
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.ops import pallas_kernels as pk
from cuda_mpi_gpu_cluster_programming_tpu.precision import gate as jgate
from cuda_mpi_gpu_cluster_programming_tpu.tuning import plan as jplan
from cuda_mpi_gpu_cluster_programming_tpu.tuning import space as jspace
from cuda_mpi_gpu_cluster_programming_tpu_torch import configs as tcfg
from cuda_mpi_gpu_cluster_programming_tpu_torch import run as trun
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet as talex
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import variants as tv
from cuda_mpi_gpu_cluster_programming_tpu_torch.precision import gate as tgate
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import chaos, sentinel
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.policy import Deadline
from cuda_mpi_gpu_cluster_programming_tpu_torch.tuning import plan as tplan
from cuda_mpi_gpu_cluster_programming_tpu_torch.tuning import space as tspace

# The packages' tuning/__init__ re-exports the function autotune, which
# shadows the submodule's attribute: take the modules themselves.
jat = importlib.import_module("cuda_mpi_gpu_cluster_programming_tpu.tuning.autotune")
tat = importlib.import_module("cuda_mpi_gpu_cluster_programming_tpu_torch.tuning.autotune")

J_SMALL = dataclasses.replace(jalex.BLOCKS12, in_height=43, in_width=43)
T_SMALL = dataclasses.replace(talex.BLOCKS12, in_height=43, in_width=43)
KNOB_ENV = ("TPU_FRAMEWORK_CONV", "TPU_FRAMEWORK_POOL", "TPU_FRAMEWORK_ROWBLOCK", "TPU_FRAMEWORK_KBLOCK",
            "TPU_FRAMEWORK_FUSE")


@pytest.fixture(autouse=True)
def _no_knob_env(monkeypatch):
    for var in KNOB_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.delenv("CHAOS_SPEC", raising=False)
    chaos.reset()
    yield
    chaos.reset()


def _key(g, v, dtype):
    """What a deterministic timer may depend on: the knobs both packages'
    spaces keep apart (the port times one row block per lowering)."""
    return f"{g.name}|{dtype}|{v.conv}|{v.pool}|{v.k_block}|{v.fuse}"


def hashed_timer(g, v, dtype, batch, repeats, warmup):
    return 1.0 + zlib.crc32(_key(g, v, dtype).encode()) % 1000 / 100.0, 0.01, 3


def counting(timer):
    def wrapped(*a):
        wrapped.calls.append(a[1])
        return timer(*a)

    wrapped.calls = []
    return wrapped


def _knobs(v):
    return (v.conv, v.pool, v.row_block, v.k_block, v.fuse)


# ------------------------------------------------------------------ space ---


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8w"])
@pytest.mark.parametrize("layer", ["conv1", "conv2"])
def test_candidate_space_differs_from_jax_exactly(layer, dtype):
    """Against the JAX space with interpret=True (no lane rule): every combo
    the JAX space prunes, the port prunes with the same words; every combo
    it keeps, the port keeps unless it is a row-block alias of a kept one."""
    jg = {g.name: g for g in jspace.conv_geometries(jalex.BLOCKS12)}[layer]
    tg = {g.name: g for g in tspace.conv_geometries(talex.BLOCKS12)}[layer]
    assert dataclasses.astuple(jg) == dataclasses.astuple(tg)
    jcands = jspace.candidate_space(jg, interpret=True, dtype=dtype)
    tcands = tspace.candidate_space(tg, dtype=dtype)
    for combo in itertools.product(tspace.CONV_VARIANTS, tspace.POOL_VARIANTS, tspace.ROW_BLOCKS,
                                   tspace.K_BLOCKS, tspace.FUSES):
        kw = dict(zip(("conv", "pool", "row_block", "k_block", "fuse"), combo))
        jwhy = jspace.prune_reason(pk.KernelVariants(**kw), jg, interpret=True, dtype=dtype)
        twhy = tspace.prune_reason(tv.KernelVariants(**kw), tg, dtype=dtype)
        assert twhy == jwhy
    want, seen = [], set()
    for v in jcands:
        sig = tspace._effective_signature(v, tg)
        if sig not in seen:
            seen.add(sig)
            want.append(_knobs(v))
    assert [_knobs(v) for v in tcands] == want
    assert all(v.k_channels == tg.out_channels for v in tcands)


def test_candidate_space_counts_and_the_lane_rule():
    """At 227x227: conv1 keeps 14 of the JAX package's 44 fp32 candidates
    (30 row-block aliases, g8 among the kept), conv2 16 of 40 plus 4 with
    k_block=64, which the JAX package's hardware space prunes by the TPU
    lane rule."""
    tg = {g.name: g for g in tspace.conv_geometries(talex.BLOCKS12)}
    jg = {g.name: g for g in jspace.conv_geometries(jalex.BLOCKS12)}
    counts = {n: len(tspace.candidate_space(tg[n])) for n in tg}
    jcounts = {n: len(jspace.candidate_space(jg[n], interpret=False)) for n in jg}
    assert counts == {"conv1": 14, "conv2": 20} and jcounts == {"conv1": 44, "conv2": 40}
    assert sum(v.conv == "g8" for v in tspace.candidate_space(tg["conv1"])) == 2
    t64 = [v for v in tspace.candidate_space(tg["conv2"]) if v.k_block == 64]
    assert t64 and not [v for v in jspace.candidate_space(jg["conv2"], interpret=False) if v.k_block == 64]
    why = jspace.prune_reason(pk.KernelVariants(conv="taps", k_block=64), jg["conv2"], interpret=False)
    assert "lane tiling 128" in why
    assert tspace.prune_reason(tv.KernelVariants(conv="taps", k_block=64), tg["conv2"]) == ""
    aliases = []
    tspace.candidate_space(tg["conv1"], on_prune=lambda v, why: aliases.append(why))
    assert sum("duplicate effective lowering" in w for w in aliases) >= 30


# ------------------------------------------------------------------- plans ---


def test_plan_round_trip_and_jax_plan_files_read(tmp_path):
    timer = counting(hashed_timer)
    plan, cached = tat.autotune(tmp_path / "p.json", T_SMALL, dtype="fp32", batch=2, timer=timer,
                                log=lambda s: None, device="cpu")
    assert not cached and timer.calls and not plan.degraded and plan.device_kind == "cpu"
    again = counting(hashed_timer)
    plan2, cached2 = tat.autotune(tmp_path / "p.json", T_SMALL, dtype="fp32", batch=2, timer=again,
                                  log=lambda s: None, device="cpu")
    assert cached2 and not again.calls and plan2 == plan and plan2.plan_hash() == plan.plan_hash()
    # A file the JAX package wrote reads here, entry for entry, hash for hash.
    jp = jat.autotune_model(J_SMALL, dtype="fp32", batch=2, timer=hashed_timer, log=lambda s: None,
                            device_kind="TPU v5 lite")
    jplan.save_plan(jp, tmp_path / "jax.json")
    (entry,) = json.loads((tmp_path / "jax.json").read_text())["plans"].values()
    mine = tplan.TunePlan.from_obj(entry)
    assert mine.key == jp.key and mine.plan_hash() == jp.plan_hash()
    assert [(n, _knobs(v), v.k_channels) for n, v in mine.layers] == [
        (n, _knobs(v), v.k_channels) for n, v in jp.layers]
    # And the other way: the port's file reads in the JAX package.
    (entry,) = json.loads((tmp_path / "p.json").read_text())["plans"].values()
    assert jplan.TunePlan.from_obj(entry).plan_hash() == plan.plan_hash()
    assert tplan.plan_batches(tmp_path / "p.json", device_kind="cpu", model_cfg=T_SMALL, dtype="fp32") == [2]


def test_stale_code_rev_is_a_miss(tmp_path):
    path = tmp_path / "p.json"
    plan, _ = tat.autotune(path, T_SMALL, dtype="fp32", batch=2, timer=hashed_timer, log=lambda s: None,
                           device="cpu")
    obj = json.loads(path.read_text())
    (key,) = obj["plans"]
    obj["plans"][key.replace(plan.code_rev, "deadbeefdead")] = {**obj["plans"].pop(key), "code_rev": "deadbeefdead"}
    path.write_text(json.dumps(obj))
    assert tplan.load_plan(path, device_kind="cpu", model_cfg=T_SMALL, dtype="fp32", batch=2) is None
    timer = counting(hashed_timer)
    _plan, cached = tat.autotune(path, T_SMALL, dtype="fp32", batch=2, timer=timer, log=lambda s: None,
                                 device="cpu")
    assert not cached and timer.calls


def test_code_rev_follows_the_kernel_sources(monkeypatch):
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import _build

    before = tplan.code_rev()
    monkeypatch.setattr(_build, "source_hash", lambda: "edited")
    assert tplan.code_rev() != before


def test_deadline_abort_degrades_to_the_default_plan():
    timer = counting(hashed_timer)
    plan = tat.autotune_model(T_SMALL, dtype="fp32", batch=2, deadline=Deadline.after(1e-9), timer=timer,
                              log=lambda s: None, device="cpu")
    assert not timer.calls and "deadline" in plan.degraded
    for name, v in plan.layers:
        assert v.knobs() == tv.KernelVariants() and "degraded" in plan.stats[name]


def test_chaos_kernel_compile_faults_degrade_not_wedge(monkeypatch):
    monkeypatch.setenv("CHAOS_SPEC", "kernel_compile=2")
    chaos.reset()
    plan = tat.autotune_model(T_SMALL, dtype="fp32", batch=2, timer=hashed_timer, log=lambda s: None, device="cpu")
    assert not plan.degraded and plan.stats["conv1"]["failed"] == 2
    assert len(plan.stats["conv1"]["failures"]) == 2
    monkeypatch.setenv("CHAOS_SPEC", "kernel_compile=100000")
    chaos.reset()
    plan2 = tat.autotune_model(T_SMALL, dtype="fp32", batch=2, timer=hashed_timer, log=lambda s: None, device="cpu")
    assert "all" in plan2.degraded and "failed" in plan2.degraded
    for _n, v in plan2.layers:
        assert v.knobs() == tv.KernelVariants()


def test_chaos_spec_parses_as_in_jax():
    from cuda_mpi_gpu_cluster_programming_tpu.resilience import chaos as jchaos

    assert chaos.KNOWN_SITES == jchaos.KNOWN_SITES
    spec = chaos.ChaosSpec.parse("seed=7,kernel_compile=2,ssh=p0.5")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jchaos.ChaosSpec.parse("seed=7,kernel_compile=2,ssh=p0.5"))
    with pytest.raises(ValueError, match="unknown CHAOS_SPEC fault kind"):
        chaos.ChaosSpec.parse("kernel_compiel=1")


def _taps_then_fused_plan():
    return tplan.TunePlan(
        device_kind="cpu", shape_key=tplan.shape_key(T_SMALL), batch=2, dtype="fp32", code_rev=tplan.code_rev(),
        layers=(("conv1", tv.KernelVariants(conv="taps", pool="phases").bind(96)),
                ("conv2", tv.KernelVariants(conv="fused").bind(256))),
    )


def test_explicit_env_knob_beats_the_plan(monkeypatch):
    plan = _taps_then_fused_plan()
    lv = tplan.effective_layer_variants(plan)
    assert (lv.for_layer("conv1").conv, lv.for_layer("conv1").pool) == ("taps", "phases")
    monkeypatch.setenv("TPU_FRAMEWORK_CONV", "pairs")
    lv2 = tplan.effective_layer_variants(plan)
    assert (lv2.for_layer("conv1").conv, lv2.for_layer("conv1").pool) == ("pairs", "phases")
    assert lv2.for_layer("conv2").conv == "pairs" and lv2.for_layer("conv9").conv == "pairs"
    jl = jplan.effective_layer_variants(jplan.TunePlan.from_obj(plan.to_obj()))
    for name in ("conv1", "conv2", "conv9"):
        assert tuple(jl.for_layer(name)) == tuple(lv2.for_layer(name))


def _counting_wrappers(monkeypatch):
    calls = {}
    for fn in ("conv2d_bias_relu", "conv_taps", "conv_pairs", "conv_im2col", "conv_g8", "maxpool2d",
               "maxpool2d_w", "maxpool_phases", "lrn", "conv_block"):
        orig = getattr(ck, fn)

        def wrapped(*a, _orig=orig, _name=fn, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **kw)

        monkeypatch.setattr(ck, fn, wrapped)
    return calls


def test_build_forward_applies_the_plan(monkeypatch):
    calls = _counting_wrappers(monkeypatch)
    params = tinit.init_params_deterministic(T_SMALL, device="cpu")
    x = tinit.deterministic_input(1, T_SMALL, device="cpu")
    out = tcfg.build_forward(tcfg.REGISTRY["v3_pallas"], T_SMALL, device="cpu", plan=_taps_then_fused_plan())(
        params, x)
    assert calls == {"conv_taps": 1, "maxpool_phases": 1, "conv_im2col": 1, "maxpool2d": 1, "lrn": 1}
    ref = tcfg.build_forward(tcfg.REGISTRY["v1_jit"], T_SMALL, device="cpu")(params, x)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    calls.clear()
    monkeypatch.setenv("TPU_FRAMEWORK_FUSE", "block")
    monkeypatch.setenv("TPU_FRAMEWORK_POOL", "sep2")
    tcfg.build_forward(tcfg.REGISTRY["v3_pallas"], T_SMALL, device="cpu", plan=_taps_then_fused_plan())(params, x)
    # the env pins fuse and pool on both layers: conv1 (taps, sep2) fuses;
    # conv2 keeps the plan's fused conv, which the block gate refuses
    assert calls == {"conv_block": 1, "conv_im2col": 1, "maxpool2d": 1, "lrn": 1}


class _PassGate:
    """A gate that passes every dtype (each package's own GateResult)."""

    def __init__(self, result_cls):
        self.result_cls = result_cls

    def screen(self, dt, params, x, cfg, key=""):
        return self.result_cls(policy=dt)


def test_autotune_precision_picks_the_jax_winners(tmp_path):
    jres = jat.autotune_precision(tmp_path / "j.json", J_SMALL, batch=2, timer=hashed_timer, log=lambda s: None,
                                  device_kind="cpu", gate=_PassGate(jgate.GateResult))
    tres = tat.autotune_precision(tmp_path / "t.json", T_SMALL, batch=2, timer=hashed_timer, log=lambda s: None,
                                  device="cpu", gate=_PassGate(tgate.GateResult))
    assert tres.winner == jres.winner and set(tres.plans) == set(jres.plans) == set(tat.DTYPES)
    for dt in tat.DTYPES:
        tl, jl = dict(tres.plans[dt].layers), dict(jres.plans[dt].layers)
        assert {n: _knobs(v) for n, v in tl.items()} == {n: _knobs(v) for n, v in jl.items()}, dt
        for n in tl:
            assert tres.plans[dt].stats[n]["best_ms"] == jres.plans[dt].stats[n]["best_ms"]
    assert tres.summary() == jres.summary()
    again = tat.autotune_precision(tmp_path / "t.json", T_SMALL, batch=2, timer=hashed_timer, log=lambda s: None,
                                   device="cpu", gate=_PassGate(tgate.GateResult))
    assert again.cached and again.winner == tres.winner


# ---------------------------------------------------- gate journal, preflight ---


def _gate_inputs():
    gen = torch.Generator().manual_seed(0)
    return tinit.init_params_random(gen, T_SMALL, device="cpu"), tinit.random_input(gen, 2, T_SMALL, device="cpu")


def test_gate_journals_verdicts(tmp_path):
    params, x = _gate_inputs()
    gate = tgate.ToleranceGate(journal=Journal(tmp_path / "g.jsonl"))
    assert gate.screen("bf16", params, x, T_SMALL, key="gate:bf16").passed
    bad = {n: {k: v.clone() for k, v in p.items()} for n, p in params.items()}
    bad["conv2"]["w"][0, 0, 0, :] += 50.0
    assert not gate.screen("fp32", params, x, T_SMALL, candidate_params=bad).passed
    assert gate.screen_blocks("int8w", params, x, T_SMALL, key="gate-blocks:int8w").passed
    recs = Journal.load(tmp_path / "g.jsonl")
    assert [(r["kind"], r["key"]) for r in recs] == [
        ("gate_pass", "gate:bf16"), ("gate_fail", "gate:fp32"), ("gate_pass", "gate-blocks:int8w")]
    assert recs[1]["reason"].startswith("fp32: stage") and recs[0]["policy"] == "bf16"
    assert set(recs[0]) >= {"passed", "margin", "worst_stage", "oracle_fault", "stages"}


def test_oracle_spot_check_and_a_corrupted_one_trips(tmp_path, monkeypatch):
    from cuda_mpi_gpu_cluster_programming_tpu.resilience import sentinel as jsentinel

    assert sentinel.oracle_spot_check(device="cpu") <= 1e-5
    assert sentinel.oracle_spot_check(_corrupt=True, device="cpu") > 1e-3
    assert abs(sentinel.oracle_spot_check(_corrupt=True, device="cpu")
               - jsentinel.oracle_spot_check(_corrupt=True)) <= 1e-5
    monkeypatch.setattr(sentinel, "oracle_spot_check", lambda **kw: sentinel.__dict__["conv2d_np"] and 0.5)
    params, x = _gate_inputs()
    gate = tgate.ToleranceGate(journal=Journal(tmp_path / "g.jsonl"))
    for res in (gate.screen("fp32", params, x, T_SMALL), gate.screen_blocks("bf16", params, x, T_SMALL)):
        assert not res.passed and res.margin == float("-inf") and not res.stages
        assert res.oracle_fault.startswith("fp32 oracle failed preflight")
    recs = Journal.load(tmp_path / "g.jsonl")
    assert [r["kind"] for r in recs] == ["gate_fail", "gate_fail"] and "preflight" in recs[0]["reason"]
    assert tgate.ToleranceGate(preflight=False).screen("fp32", params, x, T_SMALL).passed
    with pytest.raises(tat.AllDtypesPruned, match="every sweep dtype was gate-pruned"):
        tat.autotune_precision(tmp_path / "p.json", T_SMALL, batch=2, timer=hashed_timer, log=lambda s: None,
                               device="cpu", gate_journal=str(tmp_path / "g2.jsonl"))


def test_gate_trace_ids_reach_the_journal(tmp_path):
    from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import trace

    params, x = _gate_inputs()
    tracer = trace.Tracer(seed=1)
    prev = trace.set_tracer(tracer)
    try:
        with trace.span("tune.gate", dtype="fp32"):
            tgate.ToleranceGate(journal=Journal(tmp_path / "g.jsonl")).screen("fp32", params, x, T_SMALL)
    finally:
        trace.set_tracer(prev)
    (rec,) = Journal.load(tmp_path / "g.jsonl")
    assert rec["trace_id"] == tracer.trace_id and rec["span_id"] == tracer.spans[0]["span_id"]
    assert tracer.spans[0]["name"] == "tune.gate"


# --------------------------------------------------------------------- CLI ---


def test_run_tune_sweeps_then_caches(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tat, "_default_timer", lambda *a, **kw: hashed_timer(*a))
    argv = ["--config", "v3_pallas", "--device", "cpu", "--height", "43", "--width", "43", "--batch", "1",
            "--tune", "--plan", str(tmp_path / "plan.json"), "--repeats", "1", "--warmup", "1"]
    assert trun.main(argv) == 0
    out = capsys.readouterr().out
    assert "Tune plan: swept hash=" in out and "|blocks12_43x43x3|b1|" in out
    # the JAX package's harness reads the port's contract lines
    assert jharness._RE_PLAN.search(out) and jharness._RE_PRECISION.search(out)
    assert "Final Output Shape: 1x1x256" in out
    recs = Journal.load(tmp_path / "plan_gate.jsonl")
    assert {(r["kind"], r["policy"]) for r in recs} >= {("gate_pass", "fp32"), ("gate_pass", "bf16"),
                                                         ("gate_pass", "int8w")}
    assert trun.main(argv) == 0
    out2 = capsys.readouterr().out
    assert "Tune plan: cache hash=" in out2 and "tune conv1" not in out2
    m1 = [ln for ln in out.splitlines() if ln.startswith("Precision:")]
    assert m1 == [ln for ln in out2.splitlines() if ln.startswith("Precision:")] and "source=tuned" in m1[0]
    # --plan alone loads; --policy tuned runs the saved winner.
    assert trun.main(["--config", "v3_pallas", "--device", "cpu", "--height", "43", "--width", "43",
                      "--batch", "1", "--policy", "tuned", "--plan", str(tmp_path / "plan.json"),
                      "--repeats", "1", "--warmup", "1"]) == 0
    out3 = capsys.readouterr().out
    assert "Tune plan: loaded hash=" in out3 and "source=tuned" in out3


@pytest.mark.parametrize("error", ["gate_pruned", "launch_error"])
def test_run_tune_reports_only_gate_prunes(monkeypatch, capsys, tmp_path, error):
    """Every dtype gate-pruned: run says so and runs untuned. Any other
    error of the sweep (a kernel build or launch) propagates."""
    def fail(*a, **kw):
        if error == "gate_pruned":
            raise tat.AllDtypesPruned("every sweep dtype was gate-pruned: fp32: stage conv1")
        raise RuntimeError("conv_taps: CUDA error 700 (an illegal memory access was encountered)")

    monkeypatch.setattr(tat, "autotune_precision", fail)
    argv = ["--config", "v3_pallas", "--device", "cpu", "--height", "43", "--width", "43", "--batch", "1",
            "--tune", "--plan", str(tmp_path / "plan.json"), "--repeats", "1", "--warmup", "1"]
    if error == "launch_error":
        with pytest.raises(RuntimeError, match="illegal memory access"):
            trun.main(argv)
        return
    assert trun.main(argv) == 0
    out = capsys.readouterr().out
    assert "Gate pruned: every sweep dtype was gate-pruned" in out and "Tune plan: none for dtype" in out


def test_run_dtype_and_policy_are_exclusive(capsys):
    assert trun.main(["--config", "v3_pallas", "--device", "cpu", "--dtype", "bf16", "--policy", "fp32"]) == 2
    assert "mutually exclusive" in capsys.readouterr().err


def test_run_plan_path_defaults_to_the_build_directory(tmp_path, monkeypatch, capsys):
    """--policy tuned without --plan reads the git-ignored build directory,
    never the JAX package's perf/tune_plan.json."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.tuning import plan as plan_mod

    seen = []
    monkeypatch.setattr(plan_mod, "load_policy", lambda path, **kw: seen.append(str(path)))
    monkeypatch.setattr(plan_mod, "load_plan", lambda path, **kw: None)
    assert trun.main(["--config", "v3_pallas", "--device", "cpu", "--height", "43", "--width", "43",
                      "--policy", "tuned", "--repeats", "1", "--warmup", "1"]) == 0
    assert seen and seen[0].endswith("cuda_mpi_gpu_cluster_programming_tpu_torch/_build/tune_plan.json")
    assert "Policy: no tuned dtype record" in capsys.readouterr().out
