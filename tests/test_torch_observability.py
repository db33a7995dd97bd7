"""The port's forward observability against the JAX package, on the CPU.

The roofline ledger, the fused byte model and the roofline join are pure
arithmetic: the port's must equal the JAX package's, integers exactly and
floats within 1e-12 relative, on the same stage times and roofs. The stage
attribution's telescoping is held to JAX's on fixed prefix times (the JAX
function reached by replacing its timer, which changes nothing in the JAX
package). The stage functions run stage by stage against the JAX
reference tier on the same numpy inputs, within ``precision/gate.py``'s fp32
budget (1e-4 abs, 1e-5 of the stage max). The metrics registry, the retry
policy, the fault log and the journal's ``completed`` are held to JAX's on
seeded data.
"""

import dataclasses
import itertools
import json
import math
import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.observability import metrics as jmetrics
from cuda_mpi_gpu_cluster_programming_tpu.observability import roofline as jroof
from cuda_mpi_gpu_cluster_programming_tpu.observability import stages as jstages
from cuda_mpi_gpu_cluster_programming_tpu.resilience import journal as jjournal
from cuda_mpi_gpu_cluster_programming_tpu.resilience import policy as jpolicy
from cuda_mpi_gpu_cluster_programming_tpu.utils import profiling as jprof
from cuda_mpi_gpu_cluster_programming_tpu.utils import timing as jtiming
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet as talex
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import metrics as tmetrics
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import roofline as troof
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import specs as tspecs
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import stages as tstages
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import journal as tjournal
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import policy as tpolicy
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import env_info as tenv
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import probe as tprobe
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import profiling as tprof
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import timing as ttiming

FP32_ABS, FP32_REL = 1e-4, 1e-5
REL = 1e-12
PEAK, HBM = 989.0, 3350.0  # the H100 SXM's bf16 tensor-core peak and HBM rate, passed to both sides
H100 = "NVIDIA H100 80GB HBM3"

# tests/test_megakernel.py's SMALL geometry
GEOMETRIES = {
    "BLOCKS12": (jalex.BLOCKS12, talex.BLOCKS12),
    "SMALL": (jalex.Blocks12Config(in_height=43, in_width=43), talex.Blocks12Config(in_height=43, in_width=43)),
}
DTYPES = ("fp32", "bf16", "int8w")

# measured-looking stage times at batch 128, none faster than its roof at the passed peak
STAGE_MS = {"conv1": 1.3677, "pool1": 0.0623, "conv2": 3.2809, "pool2": 0.0402, "lrn2": 0.0383}
BLOCK_MS = {"block1": 2.4907, "block2": 6.0617}


def _close(a, b, what):
    if isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=REL, abs_tol=0.0), f"{what}: {a} != {b}"
    else:
        assert a == b, f"{what}: {a!r} != {b!r}"


def _same_dataclass(t, j, what, skip=()):
    for f in dataclasses.fields(j):
        if f.name in skip:
            continue
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if isinstance(jv, (list, tuple)) and jv and dataclasses.is_dataclass(jv[0]):
            assert len(tv) == len(jv), what
            for i, (tt, jj) in enumerate(zip(tv, jv)):
                _same_dataclass(tt, jj, f"{what}.{f.name}[{i}]", skip)
        elif isinstance(jv, (float, int)) and not isinstance(jv, bool) and jv is not None and tv is not None:
            _close(tv, jv, f"{what}.{f.name}")
        else:
            assert tv == jv, f"{what}.{f.name}: {tv!r} != {jv!r}"


# ------------------------------------------------------------------ ledger


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_pass_and_stage_ledgers_equal_jax_field_for_field(geo, dtype):
    jcfg, tcfg = GEOMETRIES[geo]
    for batch in (1, 128):
        jl, tl = jroof.pass_ledger(jcfg, dtype=dtype, batch=batch), troof.pass_ledger(tcfg, dtype=dtype, batch=batch)
        assert [dataclasses.asdict(e) for e in tl] == [dataclasses.asdict(e) for e in jl]
        assert all(isinstance(v, int) for e in tl for k, v in dataclasses.asdict(e).items() if k != "name")
    assert [dataclasses.asdict(e) for e in troof.stage_ledger(tcfg, dtype)] == \
        [dataclasses.asdict(e) for e in jroof.stage_ledger(jcfg, dtype)]
    with pytest.raises(ValueError, match="roofline ledger supports"):
        troof.pass_ledger(tcfg, dtype="fp8")


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_blocks_equal_jax(dtype):
    jl, tl = jroof.pass_ledger(None, dtype=dtype, batch=128), troof.pass_ledger(None, dtype=dtype, batch=128)
    for peak in (PEAK, 67.0):
        jb, tb = jroof.fused_blocks(jl, peak, HBM), troof.fused_blocks(tl, peak, HBM)
        assert [b.name for b in tb] == ["block1", "block2"]
        for t, j in zip(tb, jb):
            _same_dataclass(t, j, t.name)
            assert t.to_obj() == j.to_obj()
    split_j = jroof.model_stage_split(4.69, jl, PEAK, HBM)
    split_t = troof.model_stage_split(4.69, tl, PEAK, HBM)
    assert split_t.keys() == split_j.keys()
    for k in split_j:
        _close(split_t[k], split_j[k], k)
    assert math.isclose(sum(split_t.values()), 4.69, rel_tol=1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("granularity", ["stage", "block"])
@pytest.mark.parametrize("img_s", [None, 27292.0])
def test_attribute_roofline_equals_jax(dtype, granularity, img_s):
    stages_ms = STAGE_MS if granularity == "stage" else BLOCK_MS
    kw = dict(dtype=dtype, batch=128, source="breakdown", total_ms=sum(stages_ms.values()),
              peak_override=PEAK, hbm_override=HBM, pass_img_s=img_s, label="x")
    j = jroof.attribute_roofline(stages_ms, **kw)
    t = troof.attribute_roofline(stages_ms, device_kind=H100, **kw)
    # the device names differ by design (a TPU table against the H100 table); every number and verdict agrees
    _same_dataclass(t, j, "report", skip=("device", "device_kind", "spec_assumed", "note", "stale"))
    assert t.granularity == granularity
    assert [s.name for s in t.stages] == [s.name for s in j.stages]  # the same ranking by headroom
    assert [s.bound for s in t.stages] == [s.bound for s in j.stages]
    assert not any(s.note for s in t.stages)
    tobj, jobj = t.to_obj(), j.to_obj()
    assert tobj.keys() == jobj.keys()
    assert [s.keys() for s in tobj["stages"]] == [s.keys() for s in jobj["stages"]]
    assert t.device == "H100 SXM" and not t.spec_assumed
    assert t.render().splitlines()[0].startswith(f"roofline [{dtype} b=128 H100 SXM")


def test_roofline_marks_a_stage_faster_than_its_roof():
    """cuDNN's fp32 conv2 by FFT (0.7154 ms at batch 128, PERF.md's kernel
    table) beats the FFMA roof of the direct conv's FLOPs: its row says so
    and shows its share as measured, above 1."""
    stages_ms = dict(STAGE_MS, conv2=0.7154)
    t = troof.attribute_roofline(stages_ms, dtype="fp32", batch=128, device_kind=H100)
    j = jroof.attribute_roofline(stages_ms, dtype="fp32", batch=128, peak_override=67.0, hbm_override=HBM)
    _same_dataclass(t, j, "report", skip=("device", "device_kind", "spec_assumed", "note", "stale"))
    conv2 = next(s for s in t.stages if s.name == "conv2")
    assert t.peak_tflops == 67.0 and conv2.mfu > 2.0 and conv2.note == troof.ABOVE_ROOF_NOTE
    assert next(s for s in t.to_obj()["stages"] if s["name"] == "conv2")["note"] == troof.ABOVE_ROOF_NOTE
    assert "ABOVE ROOF" in t.render()
    assert all(not s.note for s in t.stages if s.name != "conv2")


def test_roofline_from_bench_row_equals_jax(monkeypatch):
    # the row carries its peak; the bandwidth comes from each side's table for its device_kind, so both
    # read the H100's through the override
    monkeypatch.setenv("BENCH_PEAK_HBM_GBPS", str(HBM))
    row = {"value": 27292.0, "per_pass_ms": 4.69, "batch": 128, "dtype": "fp32", "compute": "fp32",
           "assumed_peak_tflops": PEAK, "device_kind": H100,
           "breakdown": {"stages": STAGE_MS, "total_ms": sum(STAGE_MS.values())},
           "bf16": {"value": 108000.0, "per_pass_ms": 1.185, "dtype": "bf16", "compute": "bf16"}}
    tr, jr = troof.roofline_from_bench_row(row), jroof.roofline_from_bench_row(row)
    assert [r.source for r in tr] == ["breakdown", "model"] == [r.source for r in jr]
    for t, j in zip(tr, jr):
        _same_dataclass(t, j, t.label, skip=("device", "spec_assumed", "note", "stale"))
    # the row's own mfu comes back from its own fields
    assert math.isclose(tr[0].pass_mfu, 27292.0 * talex.matmul_flops_per_image() / (PEAK * 1e12), rel_tol=1e-12)
    assert troof.row_views({"value": 0.0, "error": "down", "last_good": {"value": 5.0}}) == []


def test_spec_peaks_and_overrides(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("BENCH_PEAK_HBM_GBPS", raising=False)
    assert tspecs.peak_tflops(H100, "bf16") == 989.0 == tspecs.peak_tflops(H100, "int8w")
    assert tspecs.peak_tflops(H100, "fp32") == 67.0
    assert tspecs.hbm_gbps(H100) == 3350.0
    assert tspecs.peak_tflops("NVIDIA H100 PCIe", "fp32") == 51.2
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "494.5")
    monkeypatch.setenv("BENCH_PEAK_HBM_GBPS", "2000")
    assert tspecs.peak_tflops(H100, "bf16") == 494.5
    assert math.isclose(tspecs.peak_tflops(H100, "fp32"), 33.5, rel_tol=1e-12)  # scales with the override
    assert tspecs.hbm_gbps(H100) == 2000.0
    snap = tspecs.device_memory_stats()
    assert snap["source"] in ("device", "rss") and snap["bytes_in_use"] > 0


# ---------------------------------------------------------------- stages

PREFIXES = {
    "rising": [1.0, 1.5, 4.0, 4.2, 4.5],
    "noise_negative": [1.0, 0.9, 3.0, 3.1, 3.05],
    "first_two_equal": [0.5, 0.5, 2.5, 2.6, 2.7],
}


def _fake_timer(times):
    it = iter(times)
    return lambda fn, *a, **kw: types.SimpleNamespace(per_call_ms=next(it))


@pytest.mark.parametrize("case", sorted(PREFIXES))
def test_stage_telescoping_equals_jax(case, monkeypatch):
    prefix = PREFIXES[case]
    monkeypatch.setattr(jtiming, "amortized_stats", _fake_timer(prefix))
    monkeypatch.setattr(ttiming, "amortized_stats", _fake_timer(prefix))
    cfg_j, cfg_t = GEOMETRIES["SMALL"]
    xj = jnp.ones((1, 43, 43, 3), jnp.float32)
    ja = jstages.attribute_stages(_jax_params(cfg_j), xj, cfg_j)
    ta = tstages.attribute_stages(tinit.init_params_deterministic(cfg_t, device="cpu"),
                                  tinit.deterministic_input(1, cfg_t, device="cpu"), cfg_t)
    assert ta.to_obj() == ja.to_obj()
    assert ta.prefix_ms == ja.prefix_ms and ta.total_ms == ja.total_ms
    for (tn, tms), (jn, jms) in zip(ta.stages, ja.stages):
        assert tn == jn
        _close(tms, jms, tn)
    assert all(ms >= 0 for _n, ms in ta.stages)
    assert abs(ta.stage_sum_ms - ta.total_ms) <= 1e-9
    assert tstages.telescope(tstages.SENTINEL_STAGES, prefix) == ta.stages


@pytest.mark.parametrize("prefix", [[2.0, 5.0], [2.0, 1.9]], ids=["rising", "noise_negative"])
def test_block_telescoping_equals_jax(prefix, monkeypatch):
    monkeypatch.setattr(jtiming, "amortized_stats", _fake_timer(prefix))
    monkeypatch.setattr(ttiming, "amortized_stats", _fake_timer(prefix))
    cfg_j, cfg_t = GEOMETRIES["SMALL"]
    ja = jstages.attribute_blocks(_jax_params(cfg_j), jnp.ones((1, 43, 43, 3), jnp.float32), cfg_j)
    ta = tstages.attribute_blocks(tinit.init_params_deterministic(cfg_t, device="cpu"),
                                  tinit.deterministic_input(1, cfg_t, device="cpu"), cfg_t)
    tobj, jobj = ta.to_obj(), ja.to_obj()
    assert tobj["tier"] == "kernels" and jobj["tier"] == "pallas"
    tobj.pop("tier"), jobj.pop("tier")
    assert tobj == jobj and ta.granularity == "block"
    assert abs(ta.stage_sum_ms - ta.total_ms) <= 1e-9


def _jax_params(cfg):
    from cuda_mpi_gpu_cluster_programming_tpu.models.init import init_params_deterministic

    return init_params_deterministic(cfg)


def test_attribution_refuses_int8w():
    p, x = tinit.init_params_deterministic(device="cpu"), tinit.deterministic_input(1, device="cpu")
    with pytest.raises(ValueError, match="fp32|bf16"):
        tstages.attribute_stages(p, x, compute="int8w")
    with pytest.raises(ValueError, match="fp32|bf16"):
        tstages.attribute_blocks(p, x, compute="int8w")


def _numpy_case(seed=2026):
    """Activations of order 1 at every stage, the scale the gate's absolute
    fp32 budget is written for (tests/test_torch_kernels.py's draw): normal
    input, weights normal over sqrt(fan-in), bias normal x 0.1. The
    course code's uniform [0, 1) weights grow conv2's outputs to ~1e5,
    where 1e-4 abs is below one fp32 ulp."""
    rng = np.random.default_rng(seed)
    params = {
        "conv1": {"w": (rng.standard_normal((11, 11, 3, 96)) / np.sqrt(363)).astype(np.float32),
                  "b": (0.1 * rng.standard_normal(96)).astype(np.float32)},
        "conv2": {"w": (rng.standard_normal((5, 5, 96, 256)) / np.sqrt(2400)).astype(np.float32),
                  "b": (0.1 * rng.standard_normal(256)).astype(np.float32)},
    }
    return params, rng.standard_normal((2, 43, 43, 3)).astype(np.float32)


def _within_fp32_budget(got, want, what):
    err = float(np.max(np.abs(got - want)))
    assert err <= FP32_ABS and err <= FP32_REL * float(np.max(np.abs(want))), f"{what}: max_abs {err}"


def _jax_chain(fns, params, x):
    outs, cur = [], jnp.asarray(x)
    for _n, fn in fns:
        cur = fn(params, cur)
        outs.append(np.asarray(cur))
    return outs


@pytest.mark.parametrize("tier", ["reference", "kernels"])
def test_sentinel_stage_chain_matches_jax_reference_tier(tier):
    """Stage by stage, each port stage fed the port's previous output; the
    kernels tier runs its kernels' plain versions on the CPU."""
    cfg_j, cfg_t = GEOMETRIES["SMALL"]
    params, x = _numpy_case()
    jp = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in params.items()}
    want = _jax_chain(jstages.sentinel_stage_fns(cfg_j, tier="reference"), jp, x)
    fns = tstages.sentinel_stage_fns(cfg_t, tier=tier)
    assert [n for n, _f in fns] == list(tstages.SENTINEL_STAGES) == list(jstages.SENTINEL_STAGES)
    tp, cur = tinit.params_from_jax(params, device="cpu"), torch.from_numpy(x)
    ck.reset_launches()
    for (name, fn), w in zip(fns, want):
        cur = fn(tp, cur)
        _within_fp32_budget(cur.numpy(), w, f"{tier} {name}")
    assert all(v == 0 for v in ck.LAUNCHES.values())  # CPU tensors: the plain versions, no launch
    full = tstages.stage_prefix(fns, len(fns))(tp, torch.from_numpy(x))
    assert torch.equal(full, cur)


@pytest.mark.parametrize("tier", ["reference", "kernels"])
def test_layer_stage_fns_match_jax_and_compose_to_the_forward(tier):
    cfg_j, cfg_t = GEOMETRIES["SMALL"]
    params, x = _numpy_case(7)
    jp = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in params.items()}
    jfns = jprof.stage_fns(cfg_j, tier="reference" if tier == "reference" else "pallas")
    tfns = tprof.stage_fns(cfg_t, tier=tier)
    assert [n for n, _f in tfns] == [n for n, _f in jfns]
    if tier == "reference":  # the JAX pallas tier runs interpret mode: hold the 5 stages to its reference chain
        want = _jax_chain(jfns, jp, x)
    else:
        want = _jax_chain(jstages.sentinel_stage_fns(cfg_j, tier="reference"), jp, x)
    tp, cur = tinit.params_from_jax(params, device="cpu"), torch.from_numpy(x)
    for (name, fn), w in zip(tfns, want):
        cur = fn(tp, cur)
        _within_fp32_budget(cur.numpy(), w, f"{tier} {name}")
    annotated = tprof.forward_annotated(tp, torch.from_numpy(x), cfg_t, tier=tier)
    assert torch.equal(annotated, cur)
    if tier == "reference":
        assert torch.equal(annotated, talex.forward_blocks12(tp, torch.from_numpy(x), cfg_t))


def test_layer_breakdown_rows_and_trace(tmp_path, monkeypatch):
    # one timed pass a layer: on a loaded CPU the amortized chains grow without bound, and no time is compared
    monkeypatch.setattr(tprof, "amortized_stats", lambda fn, *a, **kw: types.SimpleNamespace(per_call_ms=1.0))
    cfg_t = GEOMETRIES["SMALL"][1]
    p, x = tinit.init_params_deterministic(cfg_t, device="cpu"), tinit.deterministic_input(1, cfg_t, device="cpu")
    rows = tprof.layer_breakdown(p, x, cfg_t, repeats=1, warmup=1, compute="bf16", tier="reference")
    assert [r[0] for r in rows] == ["conv1", "relu1", "pool1", "conv2", "relu2", "pool2", "lrn2"]
    assert rows[-1][2] == (1, 1, 1, 256) and all(ms == 1.0 for _n, ms, _s in rows)
    with pytest.raises(ValueError, match="fp32|bf16"):
        tprof.layer_breakdown(p, x, cfg_t, compute="int8w")
    with pytest.raises(ValueError, match="reference|kernels"):
        tprof.stage_fns(cfg_t, tier="pallas")
    with tprof.trace(str(tmp_path / "prof")):
        tprof.forward_annotated(p, x, cfg_t)
    events = json.loads((tmp_path / "prof" / tprof.TRACE_FILE).read_text())["traceEvents"]
    assert {"conv1", "lrn2"} <= {e.get("name") for e in events}


# ------------------------------------------------- metrics, policy, journal


def _fill(reg, seed):
    rng = random.Random(seed)
    reg.counter("serve.ok").inc(3)
    reg.counter("serve.ok").inc()
    reg.gauge("queue.depth").set(rng.random() * 10)
    reg.gauge("never.set")
    h = reg.histogram("latency_ms", cap=50)
    for _ in range(73):
        h.observe(rng.lognormvariate(1.0, 0.5))
    reg.histogram("empty")


def test_metrics_registry_equals_jax(tmp_path):
    jr, tr = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    _fill(jr, 11)
    _fill(tr, 11)
    assert tr.snapshot() == jr.snapshot()
    assert tr.summary() == jr.summary()
    assert tr.prometheus() == jr.prometheus()
    for q in (0, 1, 25, 50, 90, 99, 100):
        assert tr.histogram("latency_ms").percentile(q) == jr.histogram("latency_ms").percentile(q)
    tr.export(tmp_path / "t.jsonl")
    jr.export(tmp_path / "j.jsonl")
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    with pytest.raises(ValueError, match="already registered"):
        tr.gauge("serve.ok")
    assert tmetrics.registry() is tmetrics.registry()


POLICIES = [
    dict(),
    dict(max_retries=5, base_delay_s=30.0, max_delay_s=300.0),
    dict(max_retries=4, base_delay_s=0.25, backoff=3.0, jitter=0.5, seed=7),
    dict(max_retries=3, jitter=0.0, max_delay_s=1.0),
]


@pytest.mark.parametrize("kw", POLICIES, ids=[str(i) for i in range(len(POLICIES))])
def test_retry_schedule_and_fault_log_equal_jax(kw):
    jp, tp = jpolicy.RetryPolicy(**kw), tpolicy.RetryPolicy(**kw)
    assert [tp.delay_s(k) for k in range(0, 9)] == [jp.delay_s(k) for k in range(0, 9)]

    def trail(mod, policy, fail_times):
        log, slept, calls = mod.FaultLog(site="bench"), [], itertools.count()

        def fn():
            if next(calls) < fail_times:
                raise RuntimeError("device lost")
            return "ok"

        try:
            out = mod.retry_call(fn, policy=policy, fault_log=log, sleep=slept.append)
        except RuntimeError:
            out = "raised"
        return out, [(a.attempt, a.outcome, a.cause, a.backoff_s) for a in log.attempts], slept, log.summary()

    for fails in (0, 1, tp.max_retries, tp.max_retries + 1):
        assert trail(tpolicy, tp, fails) == trail(jpolicy, jp, fails)


def test_retry_call_respects_retry_on_and_deadline():
    log = tpolicy.FaultLog()
    with pytest.raises(KeyError):
        tpolicy.retry_call(lambda: {}["x"], policy=tpolicy.RetryPolicy(max_retries=3),
                           retry_on=lambda e: not isinstance(e, KeyError), fault_log=log, sleep=lambda s: None)
    assert [a.outcome for a in log.attempts] == ["fail"]
    log = tpolicy.FaultLog()
    with pytest.raises(RuntimeError):
        tpolicy.retry_call(lambda: (_ for _ in ()).throw(RuntimeError("x")), policy=tpolicy.RetryPolicy(max_retries=3),
                           deadline=tpolicy.Deadline.after(1e-9), fault_log=log, sleep=lambda s: None)
    assert log.attempts[-1].outcome == "fail" and log.n_attempts <= 2


def test_journal_completed_equals_jax(tmp_path):
    recs = [{"kind": "bench_row", "key": "v1_jit", "row": {"value": 1.0}},
            {"kind": "bench_row", "key": "", "row": {}}, {"kind": "gate_pass", "key": "v1_jit"},
            {"kind": "bench_row", "key": "v3_pallas", "row": {"value": 2.0}},
            {"kind": "bench_row", "key": "v1_jit", "row": {"value": 3.0}}, {"key": "orphan"}]
    assert tjournal.Journal.completed(recs, "bench_row") == jjournal.Journal.completed(recs, "bench_row")
    path = tmp_path / "j.jsonl"
    with tjournal.Journal(path) as j:
        for r in recs:
            if "kind" in r:
                j.append(r["kind"], key=r["key"], **{k: v for k, v in r.items() if k not in ("kind", "key")})
    with open(path, "a") as fh:
        fh.write('{"kind": "bench_row", "key": "torn"')  # a kill mid-append
    loaded = tjournal.Journal.load(path)
    assert tjournal.Journal.completed(loaded, "bench_row") == jjournal.Journal.completed(
        jjournal.Journal.load(path), "bench_row")
    assert tjournal.Journal.completed(loaded, "bench_row")["v1_jit"]["row"] == {"value": 3.0}


# ----------------------------------------------------------- env and probe


def test_env_info_and_probe_never_raise_without_a_gpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(tenv, "SMI_QUERY", ["nvidia-smi-that-does-not-exist"])
    info = tenv.collect(probe_devices=True)
    assert info["torch"] == torch.__version__ and "packages" in info
    assert "note" in info["nvidia_smi"]
    assert tenv.main(["--out", str(tmp_path / "env.json")]) == 0
    assert json.loads((tmp_path / "env.json").read_text())["python"] == info["python"]
    assert json.loads(capsys.readouterr().out)["python"] == info["python"]
    if not torch.cuda.is_available():
        ok, why = tprobe.probe(120)
        assert not ok and "is_available() is False" in why
