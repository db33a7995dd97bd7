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
``--device``. The JAX bench's other modes (serve, saturate, replay, gate,
route, control, fleetcontrol) wait for ROADMAP Queue 1 item 1.

The JAX bench attaches the last committed row (``perf/bench_latest.json``,
taken on a TPU) to an error row as ``last_good``, and asks for a
continuity batch from it. The port does neither: no number taken on a TPU
enters a port row.
"""

import json
import os
import subprocess
import sys
import time

BASELINE_IMG_PER_SEC = 1.0 / 0.183  # the course code's V4 best, RTX 3090 (BASELINE.md)
METRIC = "alexnet_blocks12_images_per_sec"
PACKAGE = __package__  # the child runs ``python -m <PACKAGE>.bench``

MODE = os.environ.get("BENCH_MODE", "measure")
LATER_MODES = ("serve", "saturate", "replay", "gate", "route", "control", "fleetcontrol")
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
    if MODE in LATER_MODES:
        print(f"bench: BENCH_MODE={MODE} waits for ROADMAP Queue 1 item 1 (serving); only 'measure' runs",
              file=sys.stderr)
        return 2
    if MODE != "measure":
        print(f"bench: unknown BENCH_MODE {MODE!r} (measure)", file=sys.stderr)
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
