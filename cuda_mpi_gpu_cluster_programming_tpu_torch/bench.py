"""Headline benchmark of the port: AlexNet Blocks 1-2 inference throughput.

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.bench
    BENCH_CONFIGS=v1_jit,v3_pallas python -m cuda_mpi_gpu_cluster_programming_tpu_torch.bench
    BENCH_DEVICE=cpu BENCH_BATCH=1 python -m cuda_mpi_gpu_cluster_programming_tpu_torch.bench

The measure mode of the JAX package's root ``bench.py``, for one GPU. Prints
ONE JSON row per config, always parseable and always exit 0: when the GPU
does not answer, or a config fails, the row carries ``error`` and a
``value`` of 0.0. Nothing is then measured on the CPU in its place: the CPU
is measured only when ``BENCH_DEVICE=cpu`` asks for it.

Baseline: the course code's best GPU number, V4 MPI+CUDA at np=1 on an RTX
3090-class card, 0.183 s per 227x227x3 image (``BASELINE.md``) = 5.4645
images/sec; ``vs_baseline`` is the ratio to it.

A row (as the JAX bench's): ``metric``, ``value`` (img/s), ``unit``,
``vs_baseline``, ``per_pass_ms`` and the estimator's ``timing_*`` fields
(``utils/timing.amortized_stats``, ``n_small=10, n_large=10+REPEATS``),
``mfu``, ``fp32_ceiling_fraction``, ``compute``, ``dtype`` (the precision
policy the row ran), ``plan_policy`` (the tuned dtype winner in
``BENCH_PLAN``, "" when none), ``gate_margin`` (the tolerance-gate headroom
recorded for the row's dtype, null when ungated), ``assumed_peak_tflops``,
``device_kind``, ``flops_per_image``, ``matmul_flops_per_image``,
``platform`` (``gpu`` or ``cpu``), ``config``, ``batch``; the ``breakdown``
(``observability.stages``) and ``roofline`` (``observability.roofline``)
sub-objects; with an fp32 primary on the GPU the ``bf16`` sub-object; and
``attempts`` (plus ``resilience`` when a pass was retried).

The two shares, on one H100:

- ``mfu``: conv FLOPs x img/s over the bf16 tensor-core peak of the card
  (``observability.specs``: 989 TFLOP/s for the SXM part), the JAX meaning;
  ``assumed_peak_tflops`` is that peak.
- ``fp32_ceiling_fraction`` (fp32 rows only): the same over the card's
  FFMA peak (67 TFLOP/s for the SXM part), because the port's fp32 never
  runs on the tensor cores. The JAX package divides by peak/6 instead, the
  TPU's emulation of fp32 on its bf16 units.

A row's ``mfu`` counts the direct convolution's FLOPs. cuDNN may do fewer
(its fp32 conv2 is an FFT), so on ``v1_jit`` a share reads the library's
speed, not a utilization: the roofline marks such a stage with a ``note``.

Knobs (environment), each with its meaning in the JAX bench:
``BENCH_CONFIG`` (v1_jit), ``BENCH_CONFIGS`` (comma list: one row each),
``BENCH_BATCH`` (128), ``BENCH_REPEATS`` (200), ``BENCH_COMPUTE`` (fp32),
``BENCH_DTYPE`` (fp32|bf16|int8w, default BENCH_COMPUTE), ``BENCH_PLAN``
(a tuned plan: rows gain ``plan_hash`` and ``tuned_vs_default``),
``BENCH_JOURNAL`` (journal each good row; a rerun replays them and measures
only the missing configs), ``BENCH_DEADLINE_S``, ``BENCH_MAX_RETRIES`` (1),
``BENCH_RETRY_BACKOFF`` (30 s), ``BENCH_PROBE_TIMEOUT`` (120 s),
``BENCH_TIMEOUT`` (900 s, the measuring child's limit, the kernels' first
build included), ``BENCH_BREAKDOWN`` (0 turns the breakdown off),
``BENCH_BREAKDOWN_REPEATS`` (3), ``BENCH_BF16`` (0 drops the bf16
sub-object), ``BENCH_CONTINUITY_BATCH`` (one more measurement at that
batch, single-config runs). ``BENCH_DEVICE`` (cuda|cpu) is the port's
``--device``.

``BENCH_MODE=serve`` and ``saturate`` run the inference service
(``serving/``) in this process, after the probe, with the JAX bench's knobs
and row keys (:func:`_serve_main`, :func:`_saturate_main`). The JAX serve
row's ``trips`` and ``entry`` come with ``BENCH_SERVE_SUPERVISE=1`` (the
service under the elastic supervisor); its ``drill`` (the in-load fault
drills, which ``chip_smoke.py`` phase 3j runs on the card) is not here: the
row names it in its ``skipped`` sub-object. Its ``health`` is the JAX row's,
the serve journal's fold (:func:`_health_obj`). ``BENCH_MODE=replay``,
``control`` and ``gate`` are the JAX bench's journal replay, serving
controller drill and regression gate (:func:`_replay_main`,
:func:`_control_main`, :func:`_gate_main`); each prints one row and exits
3 when its verdict fails. ``BENCH_MODE=route`` and ``fleetcontrol`` are
the JAX bench's fleet drills (:func:`_route_main`: the host-loss drill
over N backend processes behind the router; :func:`_fleetcontrol_main`:
the fleet controller's A/B under a correlated swell, exit 3 on a failed
clause), with backends of ``BENCH_CONFIG`` (``v1_jit`` by default, as the
JAX package's always are) on ``BENCH_DEVICE``.

The JAX bench attaches the last committed row (``perf/bench_latest.json``,
taken on a TPU) to an error row as ``last_good``, and asks for a
continuity batch from it. The port does neither: no number taken on a TPU
enters a port row.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

BASELINE_IMG_PER_SEC = 1.0 / 0.183  # the course code's V4 best, RTX 3090 (BASELINE.md)
METRIC = "alexnet_blocks12_images_per_sec"
SERVE_METRIC = "alexnet_blocks12_serve_images_per_sec"
SATURATE_METRIC = "alexnet_blocks12_serve_saturation"
REPLAY_METRIC = "alexnet_blocks12_serve_replay"
GATE_METRIC = "alexnet_blocks12_bench_gate"
CONTROL_METRIC = "alexnet_blocks12_serve_autopilot"
ROUTE_METRIC = "alexnet_blocks12_route_host_loss"
FLEETCONTROL_METRIC = "alexnet_blocks12_fleet_control"
PACKAGE = __package__  # the child runs ``python -m <PACKAGE>.bench``

MODE = os.environ.get("BENCH_MODE", "measure")
CONFIG = os.environ.get("BENCH_CONFIG", "v1_jit")
CONFIGS = [c.strip() for c in os.environ.get("BENCH_CONFIGS", "").split(",") if c.strip()] or [CONFIG]
PLAN_PATH = os.environ.get("BENCH_PLAN", "")
COMPUTE = os.environ.get("BENCH_COMPUTE", "fp32")
DTYPE = os.environ.get("BENCH_DTYPE", "") or COMPUTE
BATCH = int(os.environ.get("BENCH_BATCH", "128"))
REPEATS = int(os.environ.get("BENCH_REPEATS", "200"))
PROBE_TIMEOUT = float(os.environ.get("BENCH_PROBE_TIMEOUT", "120"))
BENCH_TIMEOUT = float(os.environ.get("BENCH_TIMEOUT", "900"))
DEVICE = os.environ.get("BENCH_DEVICE", "cuda")

# The repository root, the child's working directory.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _error_obj(msg: str, platform: str = "unknown", config: str = None) -> dict:
    """The row of a config that measured nothing: ``value`` 0.0 and why."""
    return {
        "metric": METRIC,
        "value": 0.0,
        "unit": "img/s",
        "vs_baseline": 0.0,
        "error": msg,
        "platform": platform,
        "config": config or CONFIG,
        "compute": COMPUTE,
        "dtype": DTYPE,
        "batch": BATCH,
    }


def _stage_breakdown(tier: str, dtype: str, params, x, platform: str, model_cfg=None, plan=None) -> dict:
    """The ``breakdown`` sub-object: the pass attributed at the sentinel
    stage boundaries (``observability.stages``), after the headline
    measurement. A visible note instead of a mislabelled split: int8w has
    no staged chain, and on the CPU the kernels tier runs its kernels'
    plain versions, which would attribute PyTorch's CPU ops, not kernels.
    A pass whose resolved variants fuse whole blocks is attributed per
    block (``granularity="block"``): it has no interior stage boundary."""
    if dtype not in ("fp32", "bf16"):
        return {"skipped": f"no staged-chain analogue for dtype {dtype!r}"}
    if tier == "kernels" and platform == "cpu":
        return {"skipped": "the kernels tier runs its kernels' plain versions on the cpu (attribute on the gpu)"}
    from .observability.stages import attribute_blocks, attribute_stages

    try:
        repeats = int(os.environ.get("BENCH_BREAKDOWN_REPEATS", "3"))
        if tier == "kernels":
            from .configs import _resolve_variants
            from .ops.kernel_model import _layer_variants

            kv = _resolve_variants(plan)
            if any(_layer_variants(kv, n).fuse == "block" for n in ("conv1", "conv2")):
                return attribute_blocks(params, x, model_cfg, compute=dtype, variants=kv,
                                        repeats=repeats, warmup=1).to_obj()
        return attribute_stages(params, x, model_cfg, tier=tier, compute=dtype, repeats=repeats, warmup=1).to_obj()
    except Exception as e:  # evidence beside the headline: degrade visibly
        return {"error": f"{type(e).__name__}: {e}"[:200]}


def _roofline_obj(breakdown: dict, dtype: str, device_kind: str, model_cfg=None) -> dict:
    """The ``roofline`` sub-object beside ``breakdown``: the measured stage
    times joined with the FLOP/byte ledger and the card's spec. A skipped
    or failed breakdown skips the join too, with its reason."""
    if not isinstance(breakdown, dict) or "stages" not in breakdown:
        note = (breakdown.get("skipped") or breakdown.get("error")) if isinstance(breakdown, dict) else None
        return {"skipped": f"no per-stage breakdown to join ({note})"}
    from .observability.roofline import attribute_roofline

    try:
        return attribute_roofline(
            breakdown["stages"], dtype=dtype, batch=int(breakdown.get("batch") or 1), device_kind=device_kind,
            cfg=model_cfg, source="breakdown", total_ms=breakdown.get("total_ms"),
        ).to_obj()
    except Exception as e:  # evidence beside the headline: degrade visibly
        return {"error": f"{type(e).__name__}: {e}"[:200]}


def _child() -> int:
    """The measurement, in a bounded subprocess of :func:`main`."""
    import torch

    from .configs import REGISTRY, build_forward, resolve_device
    from .models.alexnet import BLOCKS12, flops_per_image, matmul_flops_per_image
    from .models.init import deterministic_input, init_params_deterministic
    from .observability.specs import peak_tflops
    from .utils.timing import amortized_stats

    device = resolve_device(DEVICE)
    platform = "gpu" if device.type == "cuda" else "cpu"
    device_kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if device.type == "cuda" and any(REGISTRY[c].tier == "kernels" for c in CONFIGS if c in REGISTRY):
        from .ops import _build

        info = _build.build()  # the kernels' first build, before any timed region
        print(f"bench: kernel library {info.path} {'built' if info.built else 'cached'} in {info.seconds:.1f} s",
              file=sys.stderr, flush=True)
    params = init_params_deterministic(device=device)
    x = deterministic_input(BATCH, device=device)
    mxu_flops = matmul_flops_per_image()
    peak = peak_tflops(device_kind, "bf16")
    fp32_peak = peak_tflops(device_kind, "fp32")

    plan, plan_note = None, ""
    plan_policy, gate_margins = "", {}
    if PLAN_PATH:
        # A requested plan that cannot be used is a note on every row, never
        # a silent run of untuned numbers labelled tuned.
        try:
            from .tuning.plan import load_plan, load_policy

            plan = load_plan(PLAN_PATH, device_kind=device_kind, model_cfg=BLOCKS12, dtype=DTYPE, batch=BATCH)
            if plan is None:
                plan_note = f"no matching plan in {PLAN_PATH} (untuned)"
            rec = load_policy(PLAN_PATH, device_kind=device_kind, model_cfg=BLOCKS12, batch=BATCH)
            if rec is not None:
                plan_policy = rec.get("dtype", "")
                gate_margins = {dt: g.get("margin") for dt, g in rec.get("gates", {}).items() if isinstance(g, dict)}
        except Exception as e:
            plan_note = f"plan load failed: {type(e).__name__}: {e}"[:160]

    def measure(compute: str, batch: int = BATCH, config: str = CONFIG, use_plan: bool = True) -> dict:
        fwd = build_forward(REGISTRY[config], policy=compute, device=device, plan=plan if use_plan else None)
        xb = x if batch == BATCH else deterministic_input(batch, device=device)
        st = amortized_stats(fwd, params, xb, n_small=10, n_large=10 + REPEATS)
        img_per_sec = batch / (st.per_call_ms / 1e3)
        # No peak for a CPU: both shares are null there.
        mfu = round(img_per_sec * mxu_flops / (peak * 1e12), 4) if platform != "cpu" else None
        fp32_frac = (round(img_per_sec * mxu_flops / (fp32_peak * 1e12), 4)
                     if platform != "cpu" and compute == "fp32" else None)
        return {
            "value": round(img_per_sec, 1),
            "unit": "img/s",
            "vs_baseline": round(img_per_sec / BASELINE_IMG_PER_SEC, 1),
            "mfu": mfu,
            "fp32_ceiling_fraction": fp32_frac,
            "compute": compute,
            "dtype": compute,
            "plan_policy": plan_policy,
            "gate_margin": gate_margins.get(compute),
            "per_pass_ms": round(st.per_call_ms, 4),
            "timing_n": st.n_samples,
            "timing_ci95_ms": round(st.ci95_ms, 4),
            "timing_chain": st.n_chain,
            "timing_shadowed": st.shadowed,
            "timing_underconverged": st.underconverged,
        }

    for cfg_key in CONFIGS:
        # One row per config; a config that fails gives an error row and the
        # sweep goes on.
        try:
            row = measure(DTYPE, config=cfg_key)
        except Exception as e:
            print(json.dumps(_error_obj(f"{type(e).__name__}: {e}"[:200], platform, cfg_key)), flush=True)
            continue
        out = {
            "metric": METRIC,
            **row,
            "assumed_peak_tflops": peak if platform != "cpu" else None,
            "device_kind": device_kind,
            "flops_per_image": flops_per_image(),
            "matmul_flops_per_image": mxu_flops,
            "platform": platform,
            "config": cfg_key,
            "batch": BATCH,
        }
        if os.environ.get("BENCH_BREAKDOWN", "1") != "0":
            out["breakdown"] = _stage_breakdown(REGISTRY[cfg_key].tier, DTYPE, params, x, platform, plan=plan)
            out["roofline"] = _roofline_obj(out["breakdown"], DTYPE, device_kind)
        if plan is not None:
            # Tuned against default on one estimator: the row above ran the
            # plan; measure again without it (the reference tier ignores it).
            out["plan_hash"] = plan.plan_hash()
            try:
                tuned_ms = row["per_pass_ms"]
                default_ms = measure(DTYPE, config=cfg_key, use_plan=False)["per_pass_ms"]
                out["tuned_vs_default"] = {
                    "tuned_per_pass_ms": tuned_ms,
                    "default_per_pass_ms": default_ms,
                    "speedup": round(default_ms / tuned_ms, 4) if tuned_ms else None,
                }
            except Exception as e:
                out["tuned_vs_default"] = {"error": f"{type(e).__name__}: {e}"[:200]}
        elif plan_note:
            out["plan_error"] = plan_note
        # Flush the primary now: if a later pass outlives BENCH_TIMEOUT, the
        # parent salvages this line from the killed child's output.
        print(json.dumps(out), flush=True)
        if DTYPE == "fp32" and platform != "cpu" and os.environ.get("BENCH_BF16", "1") != "0":
            try:
                out["bf16"] = measure("bf16", config=cfg_key)
            except Exception as e:
                out["bf16"] = {"error": f"{type(e).__name__}: {e}"[:200]}
            print(json.dumps(out), flush=True)  # the newest line per config wins
        cont = int(os.environ.get("BENCH_CONTINUITY_BATCH", "0"))
        if cont and cont != BATCH and platform != "cpu" and len(CONFIGS) == 1:
            try:
                out[f"continuity_b{cont}"] = {**measure(DTYPE, batch=cont, config=cfg_key), "batch": cont}
            except Exception as e:
                out[f"continuity_b{cont}"] = {"error": f"{type(e).__name__}: {e}"[:200]}
            print(json.dumps(out), flush=True)
    return 0


# The JAX serve row's keys the port row does not fill, each named in its ``skipped``.
SERVE_SKIPPED = {
    "drill": "the in-load device_loss, mesh_shrink and grow-back drills are not on the bench row "
             "(chip_smoke.py phase 3j runs them on a supervised server)",
}
# The keys a supervised serve row adds (BENCH_SERVE_SUPERVISE=1), as the JAX row does.
SUPERVISED_KEYS = ("trips", "entry")


def _plan_policy_for(model_cfg, device) -> str:
    """The saved dtype-sweep winner at this geometry and batch in
    ``BENCH_PLAN``, or "" when no plan file is named or no record matches
    (never fatal)."""
    if not PLAN_PATH:
        return ""
    try:
        from .tuning.plan import device_kind, load_policy

        rec = load_policy(PLAN_PATH, device_kind=device_kind(device), model_cfg=model_cfg, batch=BATCH)
        return rec.get("dtype", "") if rec else ""
    except Exception:
        return ""


def _serve_error(metric: str, msg: str, platform: str = "unknown") -> int:
    """Print a serve mode's row that measured nothing (``value`` 0.0 and
    why); the mode still exits 0."""
    row = _error_obj(msg, platform)
    row["metric"] = metric
    print(json.dumps(row))
    return 0


def _serve_platform() -> tuple:
    """``(platform, "")`` for the serve modes, or ``(None, why)`` when the
    GPU does not answer the bounded probe (the CPU only when asked for)."""
    if DEVICE == "cpu":
        return "cpu", ""
    from .utils.probe import probe

    ok, info = probe(PROBE_TIMEOUT)
    return (info, "") if ok else (None, f"device {info}")


def _serve_model_cfg():
    import dataclasses

    from .models.alexnet import BLOCKS12

    return dataclasses.replace(
        BLOCKS12,
        in_height=int(os.environ.get("BENCH_SERVE_HEIGHT", "227")),
        in_width=int(os.environ.get("BENCH_SERVE_WIDTH", "227")),
    )


def _build_library(config: str) -> None:
    """The kernels' first build, before the warmup's timed captures (on the
    card, for the kernels tier)."""
    from .configs import REGISTRY

    if DEVICE != "cpu" and config in REGISTRY and REGISTRY[config].tier == "kernels":
        from .ops import _build

        info = _build.build()
        print(f"bench: kernel library {info.path} {'built' if info.built else 'cached'} in {info.seconds:.1f} s",
              file=sys.stderr, flush=True)


def _serve_main() -> int:
    """BENCH_MODE=serve: one JSON row for a journaled Poisson serve run.

    Knobs (environment), the JAX bench's: BENCH_SERVE_CONFIG (BENCH_CONFIG),
    BENCH_SERVE_SHARDS (1: a sharded config's shard slots, all on the card),
    BENCH_SERVE_RATE (50 req/s), BENCH_SERVE_DURATION (3 s), BENCH_SERVE_MAX_BATCH (8),
    BENCH_SERVE_DEADLINE_S (30), BENCH_SERVE_SUPERVISE (0 here, 1 in the JAX
    bench: 1 serves under the elastic supervisor and adds ``trips`` and
    ``entry``), BENCH_SERVE_JOURNAL (a temp file),
    BENCH_SERVE_HEIGHT/WIDTH (227), BENCH_SERVE_SEED (0). Always exactly one
    JSON line, exit 0.
    """
    import tempfile

    platform, why = _serve_platform()
    if platform is None:
        return _serve_error(SERVE_METRIC, why)
    try:
        from .configs import REGISTRY
        from .models.init import deterministic_input, init_params_deterministic
        from .observability.metrics import registry as metrics_registry
        from .observability.trace import Tracer, set_tracer
        from .serving.loadgen import percentile, run_load
        from .serving.server import InferenceServer, ServeConfig, request_latencies_from_journal
        from .tuning.plan import device_kind

        model_cfg = _serve_model_cfg()
        journal_path = os.environ.get("BENCH_SERVE_JOURNAL") or os.path.join(
            tempfile.gettempdir(), f"serve_journal_{os.getpid()}.jsonl")
        rate = float(os.environ.get("BENCH_SERVE_RATE", "50"))
        scfg = ServeConfig(
            config=os.environ.get("BENCH_SERVE_CONFIG", CONFIG),
            n_shards=int(os.environ.get("BENCH_SERVE_SHARDS", "1")),
            compute=DTYPE,
            max_batch=int(os.environ.get("BENCH_SERVE_MAX_BATCH", "8")),
            plan_path=PLAN_PATH,
            journal_path=journal_path,
            default_deadline_s=float(os.environ.get("BENCH_SERVE_DEADLINE_S", "30")) or None,
            supervise=os.environ.get("BENCH_SERVE_SUPERVISE", "0") != "0",
            model_cfg=model_cfg,
            device=DEVICE,
        )
        server = InferenceServer(scfg)
        _build_library(scfg.config)
        # spans over the serve journal: the row's journal holds the queue-wait and dispatch spans
        tracer = Tracer(journal=server.journal)
        set_tracer(tracer)
        try:
            server.start()
            try:
                report = run_load(server, rate_rps=rate,
                                  duration_s=float(os.environ.get("BENCH_SERVE_DURATION", "3")),
                                  seed=int(os.environ.get("BENCH_SERVE_SEED", "0")))
            finally:
                server.stop()
        finally:
            set_tracer(None)
        dev = server.device
        server.close()
        # p50/p99 from the journal, the crash-consistent trail
        jlat = request_latencies_from_journal(journal_path)
        row = {
            "metric": SERVE_METRIC,
            "value": round(report.sustained_img_s, 1),
            "unit": "img/s",
            "p50_ms": percentile(jlat, 50),
            "p99_ms": percentile(jlat, 99),
            "n_requests": report.n_requests,
            "n_ok": report.n_ok,
            "n_shed": report.n_shed,
            "n_failed": report.n_failed,
            "n_rejected": report.n_rejected,
            "cache_misses_post_warmup": server.stats.cache_misses,
            "warmup_compiles": server.stats.warmup_compiles,
            "buckets": list(server.buckets),
            "rate_rps": rate,
            "duration_s": round(report.duration_s, 3),
            "config": scfg.config,
            "shards": scfg.n_shards,
            "compute": scfg.compute,
            "dtype": scfg.compute,
            "plan_policy": _plan_policy_for(model_cfg, dev),
            "supervise": scfg.supervise,
            "platform": platform,
            "journal": journal_path,
            "trace_id": tracer.trace_id,
        }
        if server.sup is not None:
            row["trips"] = [t.kind for t in server.sup.trips]
            row["entry"] = server.sup.entry.key
        if os.environ.get("BENCH_BREAKDOWN", "1") != "0":
            # per-stage attribution at the largest bucket the service dispatches
            bucket = server.buckets[-1]
            row["breakdown"] = _stage_breakdown(
                REGISTRY[scfg.config].tier, scfg.compute,
                init_params_deterministic(model_cfg, device=dev),
                deterministic_input(bucket, model_cfg, device=dev),
                platform, model_cfg=model_cfg,
            )
            row["roofline"] = _roofline_obj(row["breakdown"], scfg.compute, device_kind(dev), model_cfg=model_cfg)
        row["metrics"] = metrics_registry().summary()
        if os.environ.get("BENCH_METRICS"):
            metrics_registry().export(os.environ["BENCH_METRICS"])
        row["health"] = _health_obj(journal_path)
        row["skipped"] = dict(SERVE_SKIPPED)
        print(json.dumps(row))
        return 0
    except Exception as e:
        return _serve_error(SERVE_METRIC, f"{type(e).__name__}: {e}"[:200], platform)


def _saturate_main() -> int:
    """BENCH_MODE=saturate: sweep offered load past capacity on one server
    and print one JSON row per rate, each with the located p99 knee
    (``knee_rate_img_s``, null when the sweep never crossed it).

    Per rate the metrics registry is reset, and the row reports the journal
    slice's p99 and the registry's ``serve.request_ms`` p99: one
    nearest-rank estimator over one population, so ``percentiles_agree``
    must hold. Arrivals and classes are seeded (BENCH_SERVE_SEED).

    Knobs (environment), the JAX bench's: BENCH_SAT_RATES ("10,20,40,80"
    req/s), BENCH_SAT_DURATION (2 s a rate), BENCH_SAT_SHAPE ("steady"),
    BENCH_SAT_KNEE (3.0: the p99 multiple over the lowest rate's p99 that
    marks the knee), and the BENCH_SERVE_* service knobs. Always one JSON
    line per rate, exit 0. The default rates offer at most about 250 img/s;
    an H100 dispatches thousands a second, so under them the sweep never
    reaches capacity and a knee it reports is a p99 outlier, not a limit:
    set BENCH_SAT_RATES past the card's dispatch rate to find one.
    """
    import dataclasses
    import tempfile

    platform, why = _serve_platform()
    if platform is None:
        return _serve_error(SATURATE_METRIC, why)
    try:
        from .observability.trace import Tracer, set_tracer
        from .serving.loadgen import saturation_sweep
        from .serving.server import InferenceServer, ServeConfig
        from .serving.traffic import default_class_mix, slo_policy

        model_cfg = _serve_model_cfg()
        journal_path = os.environ.get("BENCH_SERVE_JOURNAL") or os.path.join(
            tempfile.gettempdir(), f"saturate_journal_{os.getpid()}.jsonl")
        rates = [float(r) for r in os.environ.get("BENCH_SAT_RATES", "10,20,40,80").split(",") if r.strip()]
        seed = int(os.environ.get("BENCH_SERVE_SEED", "0"))
        scfg = ServeConfig(
            config=os.environ.get("BENCH_SERVE_CONFIG", CONFIG),
            n_shards=int(os.environ.get("BENCH_SERVE_SHARDS", "1")),
            compute=DTYPE,
            max_batch=int(os.environ.get("BENCH_SERVE_MAX_BATCH", "8")),
            plan_path=PLAN_PATH,
            journal_path=journal_path,
            supervise=os.environ.get("BENCH_SERVE_SUPERVISE", "0") != "0",
            model_cfg=model_cfg,
            device=DEVICE,
        )
        # the class mix's SLO policy is the sweep's admission policy: past
        # capacity the service sheds by class, attributably
        classes = list(default_class_mix(InferenceServer(scfg).buckets))
        scfg = dataclasses.replace(scfg, slo=slo_policy(classes))
        server = InferenceServer(scfg)
        _build_library(scfg.config)
        tracer = Tracer(journal=server.journal)
        set_tracer(tracer)
        try:
            server.start()
            try:
                rows = saturation_sweep(
                    server, rates,
                    duration_s=float(os.environ.get("BENCH_SAT_DURATION", "2")),
                    classes=classes,
                    shape=os.environ.get("BENCH_SAT_SHAPE", "steady"),
                    seed=seed,
                    knee_factor=float(os.environ.get("BENCH_SAT_KNEE", "3.0")),
                    journal_path=journal_path,
                )
            finally:
                server.stop()
        finally:
            set_tracer(None)
        server.close()
        for row in rows:
            print(json.dumps({
                "metric": SATURATE_METRIC,
                "unit": "img/s",
                **row,
                "cache_misses_post_warmup": server.stats.cache_misses,
                "config": scfg.config,
                "shards": scfg.n_shards,
                "dtype": scfg.compute,
                "supervise": scfg.supervise,
                "buckets": list(server.buckets),
                "platform": platform,
                "journal": journal_path,
                "trace_id": tracer.trace_id,
            }), flush=True)
        return 0
    except Exception as e:
        return _serve_error(SATURATE_METRIC, f"{type(e).__name__}: {e}"[:200], platform)


def _replay_main() -> int:
    """BENCH_MODE=replay: re-drive a recorded serve journal through a live
    server on this device and print ONE JSON row: the replay's per-class
    accounting against the record, both percentile pairs and the
    divergence verdict (``observability.replay``).

    Knobs (environment): BENCH_REPLAY_JOURNAL (required: the recorded
    journal), BENCH_REPLAY_TRAFFIC_MULT (1.0), BENCH_REPLAY_DEVICES (unset =
    recorded; N rebuilds a sharded config at N slots on this device),
    BENCH_REPLAY_SLO_SCALE (1.0), BENCH_REPLAY_OUT (the replay's own
    journal; default a temp file), BENCH_DEVICE.

    Exit 0 with a parseable row; exit 2 (after an error row) when the
    device does not answer or the journal cannot be replayed here; exit 3
    on a neutral replay's divergence: this mode is a gate."""
    def fail(msg: str, platform: str = "unknown") -> int:
        row = _error_obj(msg, platform)
        row["metric"] = REPLAY_METRIC
        print(json.dumps(row))
        return 2

    src = os.environ.get("BENCH_REPLAY_JOURNAL", "")
    if not src:
        return fail("BENCH_REPLAY_JOURNAL not set (the recorded journal)")
    platform, why = _serve_platform()
    if platform is None:
        return fail(why)
    from .observability.replay import ReplayKnobs, load_recorded_run, replay_recorded

    try:
        recorded = load_recorded_run(src)
    except ValueError as e:
        return fail(f"unreplayable journal: {e}"[:300], platform)
    devices = os.environ.get("BENCH_REPLAY_DEVICES", "")
    try:
        _build_library(str(recorded.config.get("config", "")))
        report = replay_recorded(recorded, ReplayKnobs(
            traffic_mult=float(os.environ.get("BENCH_REPLAY_TRAFFIC_MULT", "1")),
            devices=int(devices) if devices else None,
            slo_scale=float(os.environ.get("BENCH_REPLAY_SLO_SCALE", "1")),
            journal_path=os.environ.get("BENCH_REPLAY_OUT", ""),
            device=DEVICE,
        ))
    except Exception as e:
        return fail(f"{type(e).__name__}: {e}"[:300], platform)
    print(json.dumps({"metric": REPLAY_METRIC, "unit": "img/s", **report.to_obj(), "platform": platform}))
    return 3 if report.diverged else 0


def _control_main() -> int:
    """BENCH_MODE=control: the serving controller's acceptance drill, ONE
    JSON row and a gate exit.

    Three journaled phases on this device:

    1. CALM: a controller-ON serve run far below capacity with generous
       SLOs: the controller must journal ZERO actions.
    2. RECORD: a controller-OFF saturating class-mixed run, the trace both
       replays re-drive. Its rate comes from a short saturated, SLO-free
       probe of the service (``loadgen.saturating_rate``: about 1.5x the
       service rate the probe measured, where the off side burns while the
       protected class alone still fits).
    3. A/B: ``replay`` with the controller off, then on, over the SAME
       record under the SAME ``slo_scale`` pressure. Both sides must close
       per-class accounting, neither may report a divergence, the ON side
       must journal actions, and the protected class's error-budget burn
       (``health_from_journal(...).classes`` of each replay's journal)
       must be strictly lower with the controller on. The row's ``health``
       is the ON replay journal's fold.

    Knobs (environment): BENCH_CTL_CONFIG (BENCH_CONFIG), BENCH_DTYPE,
    BENCH_CTL_HEIGHT/WIDTH (227 on the card, 63 on the CPU),
    BENCH_CTL_MAX_BATCH (8 on the card, 4 on the CPU), BENCH_CTL_CALM_RATE
    (8 req/s), BENCH_CTL_SAT_RATE (default: the probe's; a number forces it
    and skips the probe), BENCH_CTL_DURATION (1.5 s), BENCH_CTL_SLO_SCALE
    (0.15), BENCH_CTL_SEED (0), BENCH_CTL_JOURNAL_DIR (a temp dir),
    BENCH_DEVICE.

    Always one parseable JSON row; exit 3 when an acceptance clause fails
    (each named in the row's ``failures``), 2 when the device does not
    answer or the drill raised, 0 otherwise."""
    import dataclasses
    import tempfile

    def fail(msg: str, platform: str = "unknown") -> int:
        row = _error_obj(msg, platform)
        row["metric"] = CONTROL_METRIC
        print(json.dumps(row))
        return 2

    platform, why = _serve_platform()
    if platform is None:
        return fail(why)
    try:
        from .models.alexnet import BLOCKS12
        from .observability.health import health_from_journal
        from .observability.replay import ReplayKnobs, load_recorded_run, replay_recorded
        from .serving.controller import ControllerConfig
        from .serving.loadgen import run_shaped_load, saturating_rate
        from .serving.server import InferenceServer, ServeConfig
        from .serving.traffic import default_class_mix, slo_policy

        on_card = DEVICE != "cpu"
        size = "227" if on_card else "63"
        model_cfg = dataclasses.replace(
            BLOCKS12,
            in_height=int(os.environ.get("BENCH_CTL_HEIGHT", size)),
            in_width=int(os.environ.get("BENCH_CTL_WIDTH", size)),
        )
        seed = int(os.environ.get("BENCH_CTL_SEED", "0"))
        duration = float(os.environ.get("BENCH_CTL_DURATION", "1.5"))
        out_dir = os.environ.get("BENCH_CTL_JOURNAL_DIR") or tempfile.mkdtemp(prefix="bench_control_")
        os.makedirs(out_dir, exist_ok=True)
        base = ServeConfig(
            config=os.environ.get("BENCH_CTL_CONFIG", CONFIG),
            compute=DTYPE,
            max_batch=int(os.environ.get("BENCH_CTL_MAX_BATCH", "8" if on_card else "4")),
            model_cfg=model_cfg,
            default_deadline_s=30.0,
            device=DEVICE,
        )
        _build_library(base.config)
        mix = list(default_class_mix(InferenceServer(base).buckets))
        policy = slo_policy(mix)
        # the default ladder and thresholds, with dwell and cooldown cut to the drill's sub-2 s windows
        # (which makes the calm phase's zero-action clause harder to meet, not easier)
        ctl_cfg = ControllerConfig(eval_s=0.05, cooldown_s=0.2, min_dwell_s=0.3, min_completed=10)

        def serve(journal: str, *, rate: float, slo, controller):
            srv = InferenceServer(dataclasses.replace(base, journal_path=journal, slo=slo, controller=controller))
            srv.start()
            try:
                run_shaped_load(srv, shape="steady", rate_rps=rate, duration_s=duration, classes=mix, seed=seed)
            finally:
                srv.stop()
                state = srv.controller.state_obj() if srv.controller is not None else None
                srv.close()
            return state

        failures = []
        # 1. CALM, controller ON: zero journaled actions
        calm_jp = os.path.join(out_dir, "calm.jsonl")
        calm_state = serve(calm_jp, rate=float(os.environ.get("BENCH_CTL_CALM_RATE", "8")), slo=policy,
                           controller=ctl_cfg)
        calm_actions = sum((calm_state or {}).get("actions", {}).values())
        if calm_actions:
            failures.append(f"calm trace journaled {calm_actions} action(s)")

        # 2. RECORD a controller-OFF saturating trace at the probe's rate (or BENCH_CTL_SAT_RATE)
        sat_jp = os.path.join(out_dir, "recorded.jsonl")
        env_rate = os.environ.get("BENCH_CTL_SAT_RATE", "")
        if env_rate:
            sat_rate = float(env_rate)
        else:
            probe_jp = os.path.join(out_dir, "probe.jsonl")
            psrv = InferenceServer(dataclasses.replace(base, journal_path=probe_jp))
            psrv.start()
            try:
                run_shaped_load(psrv, shape="steady", rate_rps=2000.0, duration_s=0.3, classes=mix, seed=seed)
            finally:
                psrv.stop()
                psrv.close()
            sat_rate = saturating_rate(probe_jp, mix)
        serve(sat_jp, rate=sat_rate, slo=policy, controller=None)
        recorded = load_recorded_run(sat_jp)

        # 3. the A/B replay under equal SLO pressure
        slo_scale = float(os.environ.get("BENCH_CTL_SLO_SCALE", "0.15"))
        reports = {
            mode: replay_recorded(recorded, ReplayKnobs(
                controller=mode, controller_cfg=ctl_cfg.to_obj(), slo_scale=slo_scale,
                journal_path=os.path.join(out_dir, f"replay_{mode}.jsonl"), device=DEVICE,
            ))
            for mode in ("off", "on")
        }
        off, on = reports["off"], reports["on"]
        for mode, rep in reports.items():
            if not rep.accounting_closed:
                failures.append(f"replay --controller {mode}: accounting open")
            if rep.diverged:
                failures.append(f"replay --controller {mode}: diverged")
        if not on.controller_active or not sum((on.controller_state or {}).get("actions", {}).values()):
            failures.append("controller-on replay journaled no actions")

        def burn(journal: str):
            for c in health_from_journal(journal).classes:
                if c.name == ctl_cfg.protected_cls:
                    return c.burn
            return None

        burn_off, burn_on = burn(off.journal_path), burn(on.journal_path)
        if burn_off is None or burn_on is None or not burn_on < burn_off:
            failures.append(
                f"{ctl_cfg.protected_cls} burn not strictly lower with controller on ({burn_on} vs {burn_off})")
        print(json.dumps({
            "metric": CONTROL_METRIC,
            "value": round(on.sustained_img_s, 1),
            "unit": "img/s",
            "ok": not failures,
            "failures": failures,
            "calm_actions": calm_actions,
            "calm_state": calm_state,
            "on_actions": (on.controller_state or {}).get("actions", {}),
            "controller_state": on.controller_state,
            "burn_protected_off": burn_off,
            "burn_protected_on": burn_on,
            "protected_cls": ctl_cfg.protected_cls,
            "sat_rate_rps": round(sat_rate, 1),
            "slo_scale": slo_scale,
            "accounting_closed": {m: r.accounting_closed for m, r in reports.items()},
            "diverged": {m: r.diverged for m, r in reports.items()},
            "journals": {"calm": calm_jp, "recorded": sat_jp, "replay_off": off.journal_path,
                         "replay_on": on.journal_path},
            "config": base.config,
            "dtype": base.compute,
            "height": model_cfg.in_height,
            "width": model_cfg.in_width,
            "max_batch": base.max_batch,
            "platform": platform,
            "health": _health_obj(on.journal_path),
        }))
        return 3 if failures else 0
    except Exception as e:
        return fail(f"{type(e).__name__}: {e}"[:300], platform)


def _gate_main() -> int:
    """BENCH_MODE=gate: the regression gate (``observability.gate``) over
    the round files BENCH_GATE_PATHS names (comma-separated paths or
    globs, taken in path-name order), ONE JSON row with the full verdict.
    With no paths the verdict is over zero rounds: the repository's
    ``BENCH_r*.json`` are the JAX package's TPU rounds, which no verdict
    on the port reads. Exit 3 on any regression, 0 otherwise."""
    import glob

    from .observability.gate import evaluate

    spec = os.environ.get("BENCH_GATE_PATHS", "")
    paths = [p for part in spec.split(",") if part.strip() for p in sorted(glob.glob(part.strip()))]
    verdict = evaluate(paths)
    print(json.dumps({"metric": GATE_METRIC, **verdict.to_obj()}))
    return 0 if verdict.ok else 3


def _health_obj(journal_path) -> dict:
    """A row's ``health`` sub-object: the journal's (or journal
    directory's) ``HealthReport`` with its one-line summary, or ``error``
    when the fold raises: evidence beside the headline, never a lost row."""
    try:
        from .observability.health import health_from_journal

        rep = health_from_journal(journal_path)
        return {"summary": rep.summary_line(), **rep.to_obj()}
    except Exception as e:  # noqa: BLE001
        return {"error": f"{type(e).__name__}: {e}"[:200]}


@contextlib.contextmanager
def _chaos_armed(spec: str):
    """``CHAOS_SPEC=spec`` in this process alone for the block (the fleet
    drops it from its children's environment), restored after."""
    from .resilience import chaos

    prev = os.environ.get(chaos.CHAOS_ENV)
    if spec:
        os.environ[chaos.CHAOS_ENV] = spec
    chaos.reset()
    try:
        yield
    finally:
        if spec:
            if prev is None:
                os.environ.pop(chaos.CHAOS_ENV, None)
            else:
                os.environ[chaos.CHAOS_ENV] = prev
        chaos.reset()


def _route_main() -> int:
    """BENCH_MODE=route: one JSON row for the fleet router's host-loss
    drill. N backend serving processes of BENCH_CONFIG on BENCH_DEVICE
    behind ``serving.router.FleetRouter``: a load window before the loss,
    the seeded backend SIGKILLed between windows (chaos ``host_loss``, armed
    in this process alone), a window after it riding retry-with-redirect,
    then the restart and its re-admission through probation. The row
    carries the img/s before and after the loss, redirects, unroutable
    requests, ``recovery_ms`` (kill to the replacement's readmission) and
    the router's per-class accounting; ``health`` is the fold of the
    journal directory (the router's and every backend's journal).

    Knobs (environment), the JAX bench's: BENCH_ROUTE_N (3),
    BENCH_ROUTE_RATE (30 req/s), BENCH_ROUTE_DURATION (2 s a window),
    BENCH_ROUTE_HEIGHT/WIDTH (63), BENCH_ROUTE_MAX_BATCH (4),
    BENCH_ROUTE_SEED (0), BENCH_ROUTE_JOURNAL (a temp dir),
    BENCH_ROUTE_CHAOS (seed=<seed>,host_loss=1; "" measures steady routing
    with no kill), BENCH_CONFIG, BENCH_DEVICE. Always exactly one JSON line,
    exit 0."""
    import tempfile
    from pathlib import Path

    platform, why = _serve_platform()
    if platform is None:
        return _serve_error(ROUTE_METRIC, why)
    try:
        from .serving.batcher import power_of_two_buckets
        from .serving.fleet import BackendFleet, maybe_host_loss
        from .serving.frontend import http_fleet_load
        from .serving.router import UP, FleetRouter, drill_config
        from .serving.traffic import default_class_mix

        n = int(os.environ.get("BENCH_ROUTE_N", "3"))
        rate = float(os.environ.get("BENCH_ROUTE_RATE", "30"))
        duration = float(os.environ.get("BENCH_ROUTE_DURATION", "2"))
        height = int(os.environ.get("BENCH_ROUTE_HEIGHT", "63"))
        width = int(os.environ.get("BENCH_ROUTE_WIDTH", "63"))
        max_batch = int(os.environ.get("BENCH_ROUTE_MAX_BATCH", "4"))
        seed = int(os.environ.get("BENCH_ROUTE_SEED", "0"))
        journal_dir = Path(os.environ.get("BENCH_ROUTE_JOURNAL") or tempfile.mkdtemp(prefix="route_bench_"))
        journal_dir.mkdir(parents=True, exist_ok=True)
        spec = os.environ.get("BENCH_ROUTE_CHAOS", f"seed={seed},host_loss=1")
        mix = list(default_class_mix(power_of_two_buckets(max_batch)))
        fleet = BackendFleet(n, journal_dir, height=height, width=width, max_batch=max_batch, config=CONFIG,
                             device=DEVICE)
        router = None
        with _chaos_armed(spec):
            try:
                fleet.start()
                router = FleetRouter(fleet.urls(), drill_config(str(journal_dir / "router.jsonl"))).start()
                pre = http_fleet_load(router.url, (height, width, 3), shape="steady", rate_rps=rate,
                                      duration_s=duration, classes=mix, seed=seed)
                killed = maybe_host_loss(fleet) if spec else None
                t_kill = time.monotonic()
                post = http_fleet_load(router.url, (height, width, 3), shape="steady", rate_rps=rate,
                                       duration_s=duration, classes=mix, seed=seed + 1)
                recovery_ms = None
                if killed is not None:
                    router.replace_backend(killed, fleet.restart(killed))
                    wait_until = time.monotonic() + 60.0
                    while time.monotonic() < wait_until and router.backend_states()[f"b{killed}"] != UP:
                        time.sleep(0.05)
                    if router.backend_states()[f"b{killed}"] == UP:
                        recovery_ms = round((time.monotonic() - t_kill) * 1e3, 1)
                rrep = router.report()
                spawn_s = {b.name: round(b.spawn_s, 3) for b in fleet.backends if b is not None}
            finally:
                if router is not None:
                    router.stop()
                fleet.stop()
        print(json.dumps({
            "metric": ROUTE_METRIC,
            # the headline: what the fleet still delivers while one host is dead
            "value": round(post.sustained_img_s, 1),
            "unit": "img/s",
            "n_backends": n,
            "pre_loss_img_s": round(pre.sustained_img_s, 1),
            "post_loss_img_s": round(post.sustained_img_s, 1),
            "killed": f"b{killed}" if killed is not None else None,
            "recovery_ms": recovery_ms,
            "redirects": rrep.redirects,
            "unroutable": rrep.n_unroutable,
            "accounting_closed": rrep.closed,
            "backends": dict(rrep.backends),
            "router": rrep.to_obj(),
            "rate_rps": rate,
            "duration_s": duration,
            "chaos": spec,
            "journal_dir": str(journal_dir),
            "platform": platform,
            "config": CONFIG,
            "height": height,
            "width": width,
            "max_batch": max_batch,
            "spawn_s": spawn_s,
            "health": _health_obj(journal_dir),
        }))
        return 0
    except Exception as e:
        return _serve_error(ROUTE_METRIC, f"{type(e).__name__}: {e}"[:200], platform)


def _fleetcontrol_main() -> int:
    """BENCH_MODE=fleetcontrol: the fleet control plane's acceptance drill,
    ONE JSON row and a gate exit. N controlled backend processes of
    BENCH_CONFIG on BENCH_DEVICE behind the router, four journaled phases:

    1. CAPACITY: N uncontrolled backends behind a plain router take a short
       saturated burst with the swell's own client concurrency; the
       completed requests a second are the fleet's capacity, so the swell
       below is sized against this host and this stack, not a constant.
    2. CALM, fleet ON: steady load far below capacity; the FleetController
       must journal ZERO fleet actions.
    3. PRESSURE, fleet ON: chaos ``fleet_pressure`` swaps the load for a
       correlated diurnal swell (base 0.65x fleet capacity, crest ~1.24x):
       forecast pre-shedding, staggered downshift tokens and drain-vs-shed
       must keep the most backends degraded at once below N.
    4. PRESSURE, fleet OFF: a FRESH fleet, the SAME swell and seed with N
       serving controllers and no fleet tier: all N degrade at once.

    Acceptance (each failed clause named in ``failures``, exit 3 on any):
    calm journals zero fleet actions; ON's most degraded at once < N while
    OFF's == N; the ON side journals fleet actions; the protected class's
    fleet-wide burn is strictly lower ON than OFF; the router closes
    per-class accounting both ways. Degradation is read from the journaled
    ``router_probe`` scrape trail (``health.fleet_summary``) and the burn
    from the backends' journals (``health_from_journal(...).classes``): the
    evidence is the journal. ``health`` is the fold of the ON side's
    directory.

    Knobs (environment), the JAX bench's: BENCH_FLEETCTL_N (3),
    BENCH_FLEETCTL_DURATION (8 s: swell period == window),
    BENCH_FLEETCTL_CALM_RATE (6 req/s), BENCH_FLEETCTL_CALM_DURATION (1 s),
    BENCH_FLEETCTL_CAP_RPS (default: the capacity probe; a fleet-wide req/s
    skips it), BENCH_FLEETCTL_SLO_SCALE (0.2: the children's class budgets
    tightened, both sides equally), BENCH_FLEETCTL_WORKERS (64 client
    threads), BENCH_FLEETCTL_HEIGHT/WIDTH (63), BENCH_FLEETCTL_MAX_BATCH
    (4), BENCH_FLEETCTL_SEED (0), BENCH_FLEETCTL_JOURNAL (a temp dir),
    BENCH_FLEETCTL_CHAOS (seed=<seed>,fleet_pressure=1; "" drives the swell
    without the chaos site), BENCH_CONFIG, BENCH_DEVICE. Always one JSON
    line; exit 2 when the device does not answer or the drill raised."""
    import tempfile
    from pathlib import Path

    def fail(msg: str, platform: str = "unknown") -> int:
        _serve_error(FLEETCONTROL_METRIC, msg, platform)
        return 2

    platform, why = _serve_platform()
    if platform is None:
        return fail(why)
    try:
        from .observability.export import load_records
        from .observability.health import fleet_summary, health_from_journal
        from .serving.batcher import power_of_two_buckets
        from .serving.controller import ControllerConfig
        from .serving.fleet import BackendFleet
        from .serving.fleet_controller import FleetControllerConfig
        from .serving.frontend import http_fleet_load
        from .serving.loadgen import correlated_pressure, maybe_fleet_pressure
        from .serving.router import FleetRouter, drill_config
        from .serving.traffic import default_class_mix

        n = int(os.environ.get("BENCH_FLEETCTL_N", "3"))
        duration = float(os.environ.get("BENCH_FLEETCTL_DURATION", "8"))
        calm_rate = float(os.environ.get("BENCH_FLEETCTL_CALM_RATE", "6"))
        calm_s = float(os.environ.get("BENCH_FLEETCTL_CALM_DURATION", "1.0"))
        height = int(os.environ.get("BENCH_FLEETCTL_HEIGHT", "63"))
        width = int(os.environ.get("BENCH_FLEETCTL_WIDTH", "63"))
        max_batch = int(os.environ.get("BENCH_FLEETCTL_MAX_BATCH", "4"))
        seed = int(os.environ.get("BENCH_FLEETCTL_SEED", "0"))
        slo_scale = float(os.environ.get("BENCH_FLEETCTL_SLO_SCALE", "0.2"))
        n_workers = int(os.environ.get("BENCH_FLEETCTL_WORKERS", "64"))
        out_dir = Path(os.environ.get("BENCH_FLEETCTL_JOURNAL") or tempfile.mkdtemp(prefix="fleetctl_bench_"))
        out_dir.mkdir(parents=True, exist_ok=True)
        mix = list(default_class_mix(power_of_two_buckets(max_batch)))
        img_shape = (height, width, 3)
        # the same short-cadence serving controller on every backend, BOTH sides: the A/B isolates the fleet tier
        ctl_cfg = ControllerConfig(eval_s=0.05, cooldown_s=0.2, min_dwell_s=0.3, min_completed=10)
        spec = os.environ.get("BENCH_FLEETCTL_CHAOS", f"seed={seed},fleet_pressure=1")
        failures = []

        def fleet_of(tag: str, **kw) -> BackendFleet:
            return BackendFleet(n, out_dir / tag, height=height, width=width, max_batch=max_batch, config=CONFIG,
                                device=DEVICE, **kw)

        with _chaos_armed(spec):
            env_cap = os.environ.get("BENCH_FLEETCTL_CAP_RPS", "")
            if env_cap:
                cap_rps = float(env_cap)
            else:
                # capacity as completed requests a second through the whole serving path, at the swell's concurrency
                pfleet, prouter = fleet_of("probe", slo=False), None
                try:
                    pfleet.start()
                    prouter = FleetRouter(pfleet.urls(), drill_config(str(out_dir / "probe" / "router.jsonl")))
                    prouter.start()
                    prep = http_fleet_load(prouter.url, img_shape, shape="steady", rate_rps=2500.0, duration_s=0.5,
                                           classes=mix, seed=seed, n_workers=n_workers)
                finally:
                    if prouter is not None:
                        prouter.stop()
                    pfleet.stop()
                if not prep.n_ok or prep.duration_s <= 0:
                    return fail("capacity probe completed nothing", platform)
                cap_rps = prep.n_ok / prep.duration_s
            # crest = 0.65 x (1 + 0.9) = 1.24x capacity: the OFF side must all-degrade, while the ON side's
            # admitted protected share stays under capacity through the crest
            base_rate = 0.65 * cap_rps
            fleet_cfg = FleetControllerConfig(
                eval_s=0.1, max_concurrent_degraded=1, token_cooldown_s=0.5, drain_burn_high=1.0,
                drain_after_s=0.5, drain_min_s=0.5, max_drained=1, min_active=max(1, n - 1), forecast=True,
                forecast_period_s=duration,
                # pre-shed early: the plane cannot walk a controller back up its ladder
                forecast_horizon_s=1.5, forecast_capacity_rps=cap_rps, forecast_min_samples=6,
                forecast_burn_high=0.7, forecast_burn_low=0.55,
            )

            def run_side(tag: str, fleet_on: bool, shape):
                """One fleet's life: the calm window, then the swell."""
                fleet, router = fleet_of(tag, slo_scale=slo_scale, controller=ctl_cfg), None
                try:
                    fleet.start()
                    router = FleetRouter(fleet.urls(), drill_config(
                        str(out_dir / tag / "router.jsonl"), fleet=fleet_cfg if fleet_on else None)).start()
                    http_fleet_load(router.url, img_shape, shape="steady", rate_rps=calm_rate, duration_s=calm_s,
                                    classes=mix, seed=seed)
                    fc = router.fleet_controller
                    calm_actions = sum(fc.action_counts.values()) if fc else 0
                    if shape is None:
                        shape = (maybe_fleet_pressure(base_rate, duration) if spec else None) or \
                            correlated_pressure(duration)
                    rep = http_fleet_load(router.url, img_shape, shape=shape, rate_rps=base_rate,
                                          duration_s=duration, classes=mix, seed=seed + 1, n_workers=n_workers)
                    return calm_actions, rep, router.report(), (fc.state_obj() if fc else None), shape
                finally:
                    if router is not None:
                        router.stop()
                    fleet.stop()

            calm_actions, on_rep, on_rrep, fleet_state, shape = run_side("on", True, None)
            if calm_actions:
                failures.append(f"calm trace journaled {calm_actions} fleet action(s)")
            _, off_rep, off_rrep, _, _ = run_side("off", False, shape)

        fs_on = fleet_summary(load_records(str(out_dir / "on")))
        fs_off = fleet_summary(load_records(str(out_dir / "off")))
        max_deg_on = fs_on.get("max_simultaneous_degraded")
        max_deg_off = fs_off.get("max_simultaneous_degraded")
        if max_deg_on is None or not max_deg_on < n:
            failures.append(f"fleet ON: {max_deg_on} of {n} backends degraded simultaneously (want < N)")
        if max_deg_off != n:
            failures.append(f"fleet OFF: max simultaneous degraded {max_deg_off} != {n} (uncoordinated side never "
                            "all-degraded: swell too weak to prove anything)")
        if not fs_on.get("total"):
            failures.append("fleet ON journaled no fleet actions under the swell")

        def burn(tag: str):
            for c in health_from_journal(str(out_dir / tag)).classes:
                if c.name == fleet_cfg.protected_cls:
                    return c.burn
            return None

        burn_on, burn_off = burn("on"), burn("off")
        if burn_on is None or burn_off is None or not burn_on < burn_off:
            failures.append(f"{fleet_cfg.protected_cls} fleet-wide burn not strictly lower with fleet control on "
                            f"({burn_on} vs {burn_off})")
        for tag, rrep in (("on", on_rrep), ("off", off_rrep)):
            if not rrep.closed:
                failures.append(f"fleet {tag}: router accounting open")
        print(json.dumps({
            "metric": FLEETCONTROL_METRIC,
            # the headline: what the coordinated fleet sustains through the correlated swell
            "value": round(on_rep.sustained_img_s, 1),
            "unit": "img/s",
            "ok": not failures,
            "failures": failures,
            "n_backends": n,
            "calm_actions": calm_actions,
            "fleet_actions": fs_on.get("actions", {}),
            "fleet_refusals": fs_on.get("refusals", 0),
            "fleet_state": fleet_state,
            "max_degraded": {"on": max_deg_on, "off": max_deg_off},
            "burn_protected": {"on": burn_on, "off": burn_off},
            "protected_cls": fleet_cfg.protected_cls,
            "off_img_s": round(off_rep.sustained_img_s, 1),
            "capacity_rps": round(cap_rps, 1),
            "base_rate_rps": round(base_rate, 1),
            "slo_scale": slo_scale,
            "shape": shape,
            "duration_s": duration,
            "accounting_closed": {"on": on_rrep.closed, "off": off_rrep.closed},
            "drains": fs_on.get("drains", []),
            "chaos": spec,
            "journal_dir": str(out_dir),
            "platform": platform,
            "config": CONFIG,
            "height": height,
            "width": width,
            "max_batch": max_batch,
            "health": _health_obj(out_dir / "on"),
        }))
        return 3 if failures else 0
    except Exception as e:
        return fail(f"{type(e).__name__}: {e}"[:300], platform)


def _measure_once(configs=None) -> list:
    """One probe and measurement pass: the row list to print, one per
    ``configs`` entry (default all of ``CONFIGS``; a journal resume passes
    the missing ones). A row with ``error`` is one the retry loop may run
    again."""
    configs = list(configs) if configs is not None else CONFIGS
    if DEVICE == "cpu":
        platform = "cpu"
    else:
        # A bounded probe first: a hung card hangs the first CUDA call.
        from .utils.probe import probe

        ok, info = probe(PROBE_TIMEOUT)
        if not ok:
            return [_error_obj(f"device {info}", config=c) for c in configs]
        platform = info

    child_env = dict(os.environ)
    child_env["BENCH_CONFIGS"] = ",".join(configs)
    # Popen, not run(): on a timeout the rows the child flushed before it
    # was killed are drained from its pipe and kept.
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", f"{PACKAGE}.bench", "--child"],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        cwd=ROOT,
        env=child_env,
    )
    timed_out = False
    try:
        stdout, stderr = proc.communicate(timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        timed_out = True
        proc.kill()
        stdout, stderr = proc.communicate()
    sys.stderr.write(stderr or "")
    # Any parseable row beats an error row; the newest line per config wins
    # (a kill can truncate the last line; flushed rows are whole).
    by_config = {}
    for line in (stdout or "").splitlines():
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        by_config[obj.get("config")] = obj
    died = timed_out or proc.returncode != 0
    why = f"timed out after {BENCH_TIMEOUT:.0f}s" if timed_out else f"rc={proc.returncode}"
    if any(c in by_config for c in configs):
        rows = []
        for c in configs:
            row = by_config.get(c)
            if row is None:
                rows.append(_error_obj(f"child died before {c} ({why})", platform, c))
            else:
                if died:
                    row["salvaged"] = f"child killed mid-sweep ({why})"
                rows.append(row)
        return rows
    if timed_out:
        return [_error_obj(f"benchmark timed out after {BENCH_TIMEOUT:.0f}s", platform, c) for c in configs]
    tail = ((stderr or stdout or "").strip().splitlines() or ["no output"])[-1:]
    return [_error_obj(f"benchmark failed (rc={proc.returncode}): {tail[0]}", platform, c) for c in configs]


def main() -> int:
    """Probe and measure, retrying a pass with a row that measured nothing
    (``error``, or ``value`` not above 0) up to ``BENCH_MAX_RETRIES`` times
    within ``BENCH_DEADLINE_S``; rows then carry ``attempts`` and, when a
    pass was retried, ``resilience``. Prints exactly one JSON row per config
    and exits 0. With ``BENCH_JOURNAL``, each good row is journaled as it is
    measured and journaled rows are replayed, not measured again."""
    if MODE == "serve":
        return _serve_main()
    if MODE == "saturate":
        return _saturate_main()
    if MODE == "replay":
        return _replay_main()
    if MODE == "control":
        return _control_main()
    if MODE == "gate":
        return _gate_main()
    if MODE == "route":
        return _route_main()
    if MODE == "fleetcontrol":
        return _fleetcontrol_main()
    if MODE != "measure":
        print(f"bench: unknown BENCH_MODE {MODE!r} (measure, serve, saturate, replay, control, gate, route, "
              "fleetcontrol)", file=sys.stderr)
        return 2
    from .resilience.journal import Journal
    from .resilience.policy import Deadline, FaultLog, RetryPolicy

    policy = RetryPolicy(
        max_retries=int(os.environ.get("BENCH_MAX_RETRIES", "1")),
        base_delay_s=float(os.environ.get("BENCH_RETRY_BACKOFF", "30")),
        max_delay_s=300.0,
    )
    deadline = Deadline.after(float(os.environ.get("BENCH_DEADLINE_S", "0")) or None)
    flog = FaultLog(site="bench")

    journal = None
    replayed: dict = {}
    journal_path = os.environ.get("BENCH_JOURNAL", "")
    if journal_path:
        replayed = {key: rec["row"] for key, rec in Journal.completed(Journal.load(journal_path), "bench_row").items()
                    if isinstance(rec.get("row"), dict)}
        journal = Journal(journal_path)

    def _row_wedged(row: dict) -> bool:
        value = row.get("value")
        return bool(row.get("error")) or not (isinstance(value, (int, float)) and value > 0)

    fresh: dict = {}
    latest: dict = {}  # the newest row per config, good or bad
    try:
        for attempt in range(max(0, policy.max_retries) + 1):
            pending = [c for c in CONFIGS if c not in replayed and c not in fresh]
            if not pending:
                if attempt == 0:
                    flog.record("ok", duration_s=0.0)
                break
            t0 = time.monotonic()
            rows = _measure_once(pending)
            bad = []
            for c, row in zip(pending, rows):
                latest[c] = row
                if _row_wedged(row):
                    bad.append(row)
                else:
                    fresh[c] = row
                    if journal is not None:
                        journal.append("bench_row", key=c, row=row)
            if not bad:
                flog.record("ok", duration_s=time.monotonic() - t0)
                break
            cause = str(bad[0].get("error") or f"value={bad[0].get('value')!r} (nothing measured)")[:160]
            if len(bad) > 1:
                cause += f" (+{len(bad) - 1} more rows)"
            if attempt >= policy.max_retries or deadline.expired:
                flog.record("fail", cause, time.monotonic() - t0)
                break
            pause = min(policy.delay_s(attempt + 1), deadline.remaining())
            flog.record("retry", cause, time.monotonic() - t0, backoff_s=pause)
            time.sleep(pause)
    finally:
        if journal is not None:
            journal.close()
    for c in CONFIGS:
        if c in replayed:
            print(json.dumps(replayed[c]))  # measured by an earlier run, as it was then
            continue
        row = latest.get(c) or _error_obj("never measured (retry budget)", config=c)
        row["attempts"] = flog.n_attempts
        if flog.retried:
            row["resilience"] = flog.summary()
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(_child() if "--child" in sys.argv else main())
