"""CLI runner for the port: one single-device configuration, Blocks 1-2
(``v1_jit``, ``v3_pallas``) or full AlexNet (``v6_full_jit``, ``v6_full_pallas``).

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v3_pallas --batch 128

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v3_pallas --tune

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v3_pallas --batch 128 --breakdown --profile prof

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v6_full_pallas --init random --save-params w.npz

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v6_full_pallas --params w.npz --input native \
        --fallback-chain auto --trace run.jsonl

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v3_pallas --serve --serve-frontend 0 \
        --traffic-shape diurnal+burst

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v3_pallas --dtype bf16 --serve \
        --serve-controller --traffic-shape burst --serve-journal serve.jsonl

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --serve-replay serve.jsonl --replay-mult 2

Runs on the GPU unless ``--device cpu`` is given; with no CUDA device and
no ``--device cpu`` it raises. Prints the JAX package's stdout contract
(``Tune plan:``, ``Precision:``, ``Compile time:``, ``Final Output Shape:``,
``Final Output (first 10 values):``, ``... completed in X ms``, ``Timing
stats:``; with ``--profile``, ``Profiler trace written to ...``; with
``--breakdown``, one ``Layer <name> completed in X ms -> HxWxC`` line per
layer of the config's op tier), which the harness regexes read.

``--tune`` sweeps {fp32, bf16, int8w} x the kernel variants of each conv
layer (``tuning.autotune.autotune_precision``: every dtype screened by the
journaled, preflighted tolerance gate first; full AlexNet: the run's dtype
alone, ``autotune``, over its five conv layers), saves the plan and the
winning dtype in ``--plan`` (default ``<package>/_build/tune_plan.json``,
git-ignored) and runs with them; a fresh matching plan is loaded instead
of swept. ``--plan`` alone loads a plan; ``--policy tuned`` runs the
saved winning dtype. Precedence of the run's dtype: ``--dtype`` or a preset
``--policy`` pins it (and pins the sweep to it); else ``--policy tuned`` or
``--tune`` adopt the sweep's winner; else ``--compute``.

Weights: ``--init`` draws them (a ``torch.Generator`` seeded by ``--seed``;
the input has its own, seeded by ``--seed`` + 1), ``--params`` loads an npz checkpoint in the
JAX package's key layout (``conv1/w``, ...), so a file either package saved
runs in the other, and ``--save-params`` writes the weights used. Input:
``--input torch`` (the port's generator; the JAX package calls its own
``jax``) or ``native`` (``native.fill_batch``: ones, or the seeded LCG
stream, bit for bit the JAX package's). ``--trace PATH`` journals spans
(``run.tune``, ``run.measure``) to a jsonl file and prints ``Trace:``.

Faults: ``--max-retries N`` retries a failed build and first pass with
backoff; ``--fallback-chain k1,k2`` (or ``auto``: the JAX package's tier
ladder, ``v6_full_pallas`` -> ``v6_full_jit``, ``v3_pallas`` -> ``v1_jit``)
degrades to the next config, printing ``DEGRADED(a -> b): cause`` on
stdout; the tier that ran is the one reported. ``--deadline-s`` bounds the
retries as well as the tuner. Without ``--fallback-chain`` a failed build
exits non-zero: the port never falls back on its own. A kernel-tier build
is the ``kernel_compile`` site of ``CHAOS_SPEC`` (``resilience/chaos.py``).

Serving: ``--serve`` runs the continuous-batching service (``serving/``)
under a seeded Poisson load instead of the one-shot forward: each bucket's
forward captured once as a CUDA graph at warmup, journaled dispatch
(``--serve-journal``, which also takes the spans unless ``--trace`` is
given), ``--traffic-shape`` for a shaped load with its class mix and
shed-by-class, ``--serve-frontend PORT`` (0: an ephemeral port) for the
HTTP front end driven by a threaded client fleet, ``--serve-controller``
for the serving controller (``serving/controller.py``: it sheds bulk, then
batch, narrows the buckets and downshifts to int8w under pressure, and
reverses each in turn on recovery; its signals come from the class mix's
SLO policy, so it pairs with ``--traffic-shape`` and is inert without it).
Prints ``Serve buckets:``, ``Serve load:``, ``Serve class:`` (shaped),
``Serve:``, ``Serve frontend:``, ``Serve transport:`` and ``Serve
controller:`` lines. ``--serve-replay JOURNAL`` re-drives a recorded serve
journal through a live server (``observability/replay.py``; the journal's
``serve_config`` record is the build, so the build flags are ignored) with
the what-if knobs ``--replay-mult`` and ``--replay-slo-scale``, and prints
``Replay:`` and ``Replay class:`` lines: exit 3 when a neutral replay
diverges from the record, 2 on a journal it cannot replay
(``--replay-devices`` above 1 waits for item 3, a supervised recording for
item 8). ``--serve --supervise`` exits 2 (the supervisor, ROADMAP Queue 1
item 8); ``--route`` and ``--route-dir`` exit 2 (the fleet router, item
1's third step).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
from pathlib import Path

import torch

from .precision.policy import POLICY_NAMES


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="v1_jit", help="execution config key (see --list-configs)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--init", choices=["deterministic", "random"], default="deterministic")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=10, help="fenced passes for amortized timing")
    p.add_argument("--warmup", type=int, default=5, help="short-chain passes subtracted by the estimator")
    p.add_argument("--compute", choices=["fp32", "bf16"], default="fp32",
                   help="precision policy (legacy spelling; --dtype supersedes it)")
    p.add_argument("--dtype", choices=POLICY_NAMES, default="",
                   help="precision policy: fp32, bf16, or int8w (per-channel int8 weights); "
                        "with --tune it pins the sweep to this dtype")
    p.add_argument("--policy", choices=["", "tuned", *POLICY_NAMES], default="",
                   help="'tuned' runs the winning dtype of the saved dtype sweep (falls back to "
                        "--compute with a note when none matches); a preset name acts as --dtype")
    p.add_argument("--tune", action="store_true",
                   help="autotune the per-layer kernel variants (and the dtype) for this geometry "
                        "and batch, save the plan in --plan and run with it")
    p.add_argument("--tune-force", action="store_true", help="with --tune: sweep even when a fresh plan exists")
    p.add_argument("--tune-repeats", type=int, default=5, help="timed chain length per tuning candidate")
    p.add_argument("--tune-warmup", type=int, default=2, help="warmup chain length per tuning candidate")
    p.add_argument("--plan", default="",
                   help="TunePlan JSON path: with --tune the cache target (default "
                        "<package>/_build/tune_plan.json), otherwise load per-layer kernel variants "
                        "from it; explicit TPU_FRAMEWORK_* env knobs still win")
    p.add_argument("--gate-journal", default="",
                   help="with --tune: journal every tolerance-gate verdict to this jsonl path "
                        "(default: <plan>_gate.jsonl next to the plan file)")
    p.add_argument("--deadline-s", type=float, default=0.0,
                   help="wall-clock budget (0 = unbounded) of the build's retries and, with --tune, of the "
                        "sweep: when it runs out the remaining candidates are skipped and the plan says so")
    p.add_argument("--height", type=int, default=227)
    p.add_argument("--width", type=int, default=227)
    p.add_argument("--lrn-form", choices=["cuda", "cpu"], default="cuda",
                   help="LRN alpha convention: cuda = alpha*sum (golden), cpu = alpha*sum/size")
    p.add_argument("--list-configs", action="store_true")
    p.add_argument("--breakdown", action="store_true",
                   help="also print a fenced per-layer timing breakdown on the config's op tier")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a torch.profiler trace of the timed passes into DIR/trace.json")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--input", choices=["torch", "native"], default="torch",
                   help="input source: torch = the port's generator (the JAX package's 'jax'), "
                        "native = the C++ data pipeline (native/), the JAX package's stream bit for bit")
    p.add_argument("--params", help="load weights from this .npz checkpoint instead of --init")
    p.add_argument("--save-params", help="save the weights used to this .npz checkpoint")
    p.add_argument("--trace", default="",
                   help="journal spans (observability.trace: run.tune, run.measure, the tuner's) to this jsonl path")
    p.add_argument("--max-retries", type=int, default=0,
                   help="retry the build and first pass on a fault, with exponential backoff (0 = fail at once)")
    p.add_argument("--fallback-chain", default="",
                   help="comma-separated config keys to degrade to when the requested config cannot build or run "
                        "its first pass, or 'auto' for the tier ladder; each step prints DEGRADED(from -> to)")
    # The JAX run.py's flags whose subsystems the port has not yet: accepted,
    # and refused with the ROADMAP Queue 1 item they wait for (_waiting).
    p.add_argument("--shards", type=int, default=1, help="row-shard count: waits for the distribution tiers (item 3)")
    p.add_argument("--supervise", action="store_true", help="the elastic supervisor: waits for item 8")
    p.add_argument("--serve", action="store_true",
                   help="run the continuous-batching inference service under a seeded Poisson load instead of "
                        "the one-shot forward: admission queue with per-request deadlines, bucketed batches, a "
                        "CUDA graph per bucket, journaled dispatch. Blocks 1-2 configs only; prints "
                        "machine-parsed 'Serve load:' and 'Serve:' lines")
    p.add_argument("--serve-rate", type=float, default=20.0, help="with --serve: Poisson arrival rate (requests/s)")
    p.add_argument("--serve-duration", type=float, default=2.0, help="with --serve: load-generation window (s)")
    p.add_argument("--serve-max-batch", type=int, default=8,
                   help="with --serve: largest dispatch bucket (powers of two below it form the default set)")
    p.add_argument("--serve-deadline-s", type=float, default=0.0,
                   help="with --serve: per-request deadline (0 = none); expired requests are shed, journaled")
    p.add_argument("--serve-journal", default="",
                   help="with --serve: journal every warm/batch/shed record to this jsonl path")
    p.add_argument("--serve-buckets", default="",
                   help="with --serve: comma-separated bucket sizes (overrides the powers of two or the plan's)")
    p.add_argument("--serve-frontend", type=int, default=None, metavar="PORT",
                   help="with --serve: expose the service over HTTP on 127.0.0.1:PORT (0 = ephemeral) and drive "
                        "the load through a threaded HTTP client fleet; prints a 'Serve frontend:' line")
    p.add_argument("--traffic-shape", default="",
                   help="with --serve: a shaped load instead of plain Poisson: steady | diurnal | burst | flash, "
                        "composable with '+' ('diurnal+burst'), params as key=value; requests draw a seeded "
                        "interactive/batch/bulk class mix with per-class deadlines and shed-by-class")
    p.add_argument("--serve-controller", action="store_true",
                   help="with --serve: run the serving controller on the dispatch loop: journaled, "
                        "hysteresis-bounded degrade and restore off the protected class's error-budget burn and "
                        "the queue knee (shed bulk -> shed batch -> narrow buckets -> int8w downshift; reversed "
                        "in LIFO order on recovery). Its signals come from --traffic-shape's SLO policy; "
                        "without one it is inert. Prints a 'Serve controller:' line")
    p.add_argument("--route", type=int, default=0,
                   help="the fleet router over N backend processes: waits for item 1's third step")
    p.add_argument("--route-dir", default="", help="with --route: its journal directory (item 1's third step)")
    p.add_argument("--serve-replay", default="", metavar="JOURNAL",
                   help="re-drive a recorded serve journal through a live server on --device (its serve_config "
                        "record is the build: --config et al. are ignored); prints 'Replay:' and 'Replay class:' "
                        "lines, exit 3 when a neutral replay diverges from the record, 2 when it cannot replay")
    p.add_argument("--replay-mult", type=float, default=1.0,
                   help="with --serve-replay: offer the recorded schedule at this traffic multiple")
    p.add_argument("--replay-devices", type=int, default=None,
                   help="with --serve-replay: rebuild at this shard width (above 1 waits for item 3)")
    p.add_argument("--replay-slo-scale", type=float, default=1.0,
                   help="with --serve-replay: scale every class SLO budget and request deadline (0.5 = twice as tight)")
    p.add_argument("--replay-journal", default="",
                   help="with --serve-replay: journal the replay here (itself replayable; default a temp file)")
    return p


def _waiting(args) -> str:
    """Why a flag given cannot run yet ('' = none given)."""
    if args.shards != 1:
        return "--shards waits for the distribution tiers (ROADMAP Queue 1 item 3)"
    if args.supervise:
        return "--supervise waits for the elastic supervisor (ROADMAP Queue 1 item 8)"
    if args.route or args.route_dir:
        return "--route and --route-dir wait for the fleet router (ROADMAP Queue 1 item 1's third step)"
    if args.serve and args.fallback_chain:
        return "--serve degrades through the elastic supervisor, not --fallback-chain (ROADMAP Queue 1 item 8)"
    return ""


def _chaos_build_faults(exec_cfg) -> None:
    """The ``kernel_compile`` chaos site of a kernel-tier build (a no-op
    with chaos off): the JAX package's ``_chaos_build_faults`` for the
    single-device tiers, where a Mosaic lowering is a CUDA kernel build."""
    from .resilience import chaos

    ch = chaos.active()
    if ch is not None and exec_cfg.tier == "kernels":
        ch.maybe_raise("kernel_compile", f"{exec_cfg.key} CUDA kernel build")


def _tuning(args, model_cfg, device, pinned: str, run_dtype: str, source: str):
    """The JAX package's ``--tune``/``--plan``/``--policy tuned`` handling:
    returns ``(run_dtype, source, gate_info, plan)`` and prints the
    ``Policy:``/``Gate pruned:``/``Tune plan:`` lines."""
    from .observability.trace import span as obs_span
    from .resilience.policy import Deadline
    from .tuning.autotune import DTYPES, AllDtypesPruned, autotune, autotune_precision
    from .tuning.plan import device_kind, load_plan, load_policy

    plan_path = args.plan or str(Path(__file__).resolve().parent / "_build" / "tune_plan.json")
    kind = device_kind(device)
    gate_info = plan = None
    if args.policy == "tuned" and not args.tune:
        rec = load_policy(plan_path, device_kind=kind, model_cfg=model_cfg, batch=args.batch)
        if rec is None:
            print(f"Policy: no tuned dtype record in {plan_path} "
                  f"(falling back to --compute {args.compute}; run --tune to sweep)")
        else:
            run_dtype, source = rec["dtype"], "tuned"
            gate_info = rec.get("gates", {}).get(run_dtype)
    if args.tune and model_cfg.family == "alexnet_full":
        # Full AlexNet: the run's dtype alone (the gate screens Blocks 1-2).
        with obs_span("run.tune", config=args.config, batch=args.batch):
            plan, cached = autotune(
                plan_path, model_cfg, dtype=run_dtype, batch=args.batch, force=args.tune_force,
                deadline=Deadline.after(args.deadline_s or None), repeats=args.tune_repeats,
                warmup=args.tune_warmup, device=device, device_kind=kind,
            )
        print(f"Tune plan: {'cache' if cached else 'swept'} hash={plan.plan_hash()} key={plan.key} "
              f"path={plan_path}" + (f" DEGRADED({plan.degraded})" if plan.degraded else ""))
    elif args.tune:
        res = None
        try:
            with obs_span("run.tune", config=args.config, batch=args.batch):
                res = autotune_precision(
                    plan_path, model_cfg, batch=args.batch, dtypes=(run_dtype,) if pinned else DTYPES,
                    force=args.tune_force, deadline=Deadline.after(args.deadline_s or None),
                    repeats=args.tune_repeats, warmup=args.tune_warmup, device=device, device_kind=kind,
                    gate_journal=args.gate_journal, seed=args.seed,
                )
        except AllDtypesPruned as e:
            # Every requested dtype gate-pruned: say so and run the forced
            # dtype untuned (the gate blocks saved winners, not forced runs).
            # A build or launch error is no verdict of the gate: it propagates.
            print(f"Gate pruned: {e}")
        if res is not None:
            for dt, why in sorted(res.pruned.items()):
                print(f"Gate pruned: {dt} ({why})")
            if not pinned:
                run_dtype, source = res.winner, "tuned"
            gate_info = res.gates.get(run_dtype)
            plan = res.plans.get(run_dtype)
        if plan is not None:
            print(f"Tune plan: {'cache' if res.cached else 'swept'} hash={plan.plan_hash()} key={plan.key} "
                  f"path={plan_path}" + (f" DEGRADED({plan.degraded})" if plan.degraded else ""))
        else:
            print(f"Tune plan: none for dtype {run_dtype} (gate-pruned; untuned defaults)")
    else:  # --plan and/or --policy tuned: load, never sweep
        plan = load_plan(plan_path, device_kind=kind, model_cfg=model_cfg, dtype=run_dtype, batch=args.batch)
        if plan is None:
            print(f"Tune plan: none matching in {plan_path} (untuned defaults; run --tune to sweep)")
        else:
            print(f"Tune plan: loaded hash={plan.plan_hash()} key={plan.key}")
        if gate_info is None:
            rec = load_policy(plan_path, device_kind=kind, model_cfg=model_cfg, batch=args.batch)
            if rec is not None:
                gate_info = rec.get("gates", {}).get(run_dtype)
    return run_dtype, source, gate_info, plan


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if not args.trace:
        return _run(args)
    from .observability.trace import Tracer, set_tracer
    from .resilience.journal import Journal

    tracer = Tracer(journal=Journal(args.trace))
    previous = set_tracer(tracer)
    print(f"Trace: id={tracer.trace_id} journal={args.trace}")
    try:
        return _run(args)
    finally:
        set_tracer(previous)
        tracer.journal.close()


def _fallback_chain(args, exec_cfg, registry):
    """The configs to try in order, or an error message (exit 2): unknown
    keys, or a chain that crosses model families (it would run another
    network on this run's params and input)."""
    from .resilience.policy import tier_fallback_chain

    chain = [args.config]
    if args.fallback_chain.strip() == "auto":
        chain = tier_fallback_chain(args.config)
    elif args.fallback_chain:
        chain += [k.strip() for k in args.fallback_chain.split(",") if k.strip()]
    chain = list(dict.fromkeys(chain))
    unknown = [k for k in chain if k not in registry]
    if unknown:
        return None, f"unknown configs in --fallback-chain: {unknown}"
    mixed = [k for k in chain if registry[k].model != exec_cfg.model]
    if mixed:
        return None, f"--fallback-chain crosses model families: {mixed} (primary is {exec_cfg.model})"
    return chain, ""


def _run(args) -> int:
    from .configs import REGISTRY, build_forward, resolve_device
    from .models.alexnet import BLOCKS12
    from .models.alexnet_full import AlexNetConfig, init_full_deterministic, init_full_random
    from .models.init import (
        deterministic_input,
        init_params_deterministic,
        init_params_random,
        params_to,
        random_input,
    )
    from .observability.trace import span as obs_span
    from .ops import cuda_kernels
    from .resilience import chaos
    from .resilience.policy import Deadline, DegradationExhausted, Degrader, RetryPolicy, retry_call
    from .utils.timing import amortized_stats, fence

    if args.list_configs:
        for c in REGISTRY.values():
            print(f"{c.key:18s} {c.version_name:22s} {c.description}")
        return 0
    waiting = _waiting(args)
    if waiting:
        print(waiting, file=sys.stderr)
        return 2
    if args.serve_replay:
        return _serve_replay(args)
    if args.config not in REGISTRY:
        print(f"unknown config {args.config!r}; try --list-configs", file=sys.stderr)
        return 2
    exec_cfg = REGISTRY[args.config]
    chain, why = _fallback_chain(args, exec_cfg, REGISTRY)
    if why:
        print(why, file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    blocks_cfg = dataclasses.replace(
        BLOCKS12,
        in_height=args.height,
        in_width=args.width,
        lrn2=dataclasses.replace(BLOCKS12.lrn2, alpha_over_size=(args.lrn_form == "cpu")),
    )
    full = exec_cfg.model == "alexnet_full"
    model_cfg = AlexNetConfig(blocks12=blocks_cfg) if full else blocks_cfg
    label = "GPU" if device.type == "cuda" else "CPU"
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"--- AlexNet {label} {exec_cfg.version_name} [{exec_cfg.key}] (batch={args.batch}) ---")
    print(f"Devices: 1 x {dev_name} ({device.type})")

    if args.dtype and args.policy:
        print("--dtype and --policy are mutually exclusive", file=sys.stderr)
        return 2
    pinned = args.dtype or (args.policy if args.policy not in ("", "tuned") else "")
    run_dtype = pinned or args.compute
    source = "dtype" if args.dtype else ("policy" if pinned else "compute")
    gate_info = None
    plan = None
    if args.tune or args.plan or args.policy == "tuned":
        run_dtype, source, gate_info, plan = _tuning(args, model_cfg, device, pinned, run_dtype, source)
    if run_dtype == "fp32":
        gate_str = "ref"  # fp32 IS the oracle: nothing to gate against
    elif isinstance(gate_info, dict):
        margin = gate_info.get("margin")
        gate_str = ("pass" if gate_info.get("passed") else "fail") + (
            f" margin={margin:.4f}" if isinstance(margin, (int, float)) else ""
        )
    else:
        gate_str = "none"
    print(f"Precision: dtype={run_dtype} source={source} gate={gate_str}")

    # Params and input each from a generator of their own, so --params w.npz --seed S
    # gives the saving run's input without drawing params it will not use.
    init_det, init_rnd = (
        (init_full_deterministic, init_full_random) if full else (init_params_deterministic, init_params_random)
    )
    if args.params:
        from .utils.checkpoint import load_params_npz

        params = params_to(load_params_npz(args.params), device=device)
        print(f"Loaded params from {args.params}")
    elif args.init == "deterministic":
        params = init_det(model_cfg, device=device)
    else:
        params = init_rnd(torch.Generator().manual_seed(args.seed), model_cfg, device=device)
    if args.serve:
        if exec_cfg.model != "blocks12":
            print("--serve supports the Blocks 1-2 configs only", file=sys.stderr)
            return 2
        return _serve(args, blocks_cfg, params, plan, run_dtype)
    if args.input == "native":
        try:
            from . import native

            shape = (args.batch, blocks_cfg.in_height, blocks_cfg.in_width, blocks_cfg.in_channels)
            mode = "ones" if args.init == "deterministic" else "uniform"
            x = torch.from_numpy(native.fill_batch(shape, mode=mode, seed=args.seed)).to(device)
        except RuntimeError as e:  # no toolchain, or the native build broke
            print(f"cannot build native input tier: {e}", file=sys.stderr)
            return 2
    elif args.init == "deterministic":
        x = deterministic_input(args.batch, blocks_cfg, device=device)
    else:
        x = random_input(torch.Generator().manual_seed(args.seed + 1), args.batch, blocks_cfg, device=device)
    if args.save_params:
        from .utils.checkpoint import save_params_npz

        save_params_npz(args.save_params, params)
        print(f"Saved params to {args.save_params}")

    passes = 0

    def counted(f):
        def call(p, xx):
            nonlocal passes
            passes += 1
            return f(p, xx)

        return call

    def build_and_first_pass(key):
        cfg = REGISTRY[key]
        _chaos_build_faults(cfg)
        f = counted(build_forward(cfg, model_cfg, policy=run_dtype, device=device, plan=plan))
        t0 = time.perf_counter()
        f(params, x)
        fence(device)
        return f, (time.perf_counter() - t0) * 1e3  # first call: kernel build/load included

    before = dict(cuda_kernels.LAUNCHES)
    retry = RetryPolicy(max_retries=max(0, args.max_retries), base_delay_s=1.0)
    deadline = Deadline.after(args.deadline_s or None)
    # With no chain to walk, a refused config or a chaos drill exits 2 and any
    # other fault keeps its traceback. DEGRADED events go to stdout, where the
    # harness reads them.
    degrader = Degrader(
        chain, should_degrade=(lambda e: isinstance(e, (ValueError, chaos.InjectedFault))) if len(chain) == 1 else None,
        on_event=lambda ev: print(ev, flush=True),
    )
    try:
        ran_key, (fwd, compile_ms) = degrader.run(
            lambda key: retry_call(lambda: build_and_first_pass(key), policy=retry, deadline=deadline)
        )
    except DegradationExhausted as e:
        print(f"cannot build config {chain[-1]!r}: {e.last}", file=sys.stderr)
        return 2
    exec_cfg = REGISTRY[ran_key]  # what follows reports the tier that ran

    n_small = max(1, args.warmup)
    if args.profile:
        from .utils.profiling import TRACE_FILE
        from .utils.profiling import trace as profile_ctx
    else:
        profile_ctx = lambda _dir: contextlib.nullcontext()  # noqa: E731
    with profile_ctx(args.profile):
        with obs_span("run.measure", config=exec_cfg.key, batch=args.batch, dtype=run_dtype) as sp:
            st = amortized_stats(fwd, params, x, n_small=n_small, n_large=n_small + max(1, args.repeats))
            if sp is not None:
                sp.set(per_pass_ms=round(st.per_call_ms, 4))
    if args.profile:
        print(f"Profiler trace written to {Path(args.profile) / TRACE_FILE}")
    out = fwd(params, x).cpu().numpy()
    per_pass_ms = st.per_call_ms

    shape_str = "x".join(str(d) for d in out.shape[1:])
    first10 = " ".join(f"{v:.4f}" for v in out[0].reshape(-1)[:10])
    print(f"Compile time: {compile_ms:.1f} ms")
    print(f"Final Output Shape: {shape_str}")
    print(f"Final Output (first 10 values): {first10}")
    print(
        f"AlexNet {label} Forward Pass completed in {per_pass_ms:.3f} ms "
        f"(amortized over {args.repeats} fenced passes; "
        f"{args.batch / (per_pass_ms / 1e3):.1f} img/s)"
    )
    print(
        f"Timing stats: n={st.n_samples} ci95={st.ci95_ms:.4f} ms chain={st.n_chain}"
        + (" SHADOWED" if st.shadowed else "")
        + (" UNDERCONVERGED" if st.underconverged else "")
    )
    launches = " ".join(f"{k}={v - before[k]}" for k, v in cuda_kernels.LAUNCHES.items())
    print(f"Kernel launches: {launches} passes={passes}")
    if args.breakdown and run_dtype == "int8w":
        print("--breakdown does not support the int8w policy "
              "(the quantized lowering has no per-layer staged analogue); skipped")
    elif args.breakdown:
        from .utils.profiling import layer_breakdown

        # Per-layer costs on the config's op tier (the one that ran), after
        # the headline's launch count: a kernels-tier breakdown times the kernels.
        for name, ms, shape in layer_breakdown(params, x, model_cfg, repeats=max(1, args.repeats),
                                               warmup=n_small, compute=run_dtype, tier=exec_cfg.tier):
            print(f"Layer {name} completed in {ms:.3f} ms -> {'x'.join(str(d) for d in shape[1:])}")
    return 0


def _serve(args, blocks_cfg, params, plan, run_dtype: str) -> int:
    """``--serve``: the service owns the build (a CUDA graph per bucket at
    warmup), so the one-shot build and timing are bypassed."""
    from .observability.trace import Tracer, get_tracer, set_tracer
    from .observability.trace import span as obs_span
    from .serving.loadgen import run_load, run_shaped_load
    from .serving.server import InferenceServer, ServeConfig
    from .serving.traffic import default_class_mix, parse_shape, slo_policy

    buckets = tuple(int(b) for b in args.serve_buckets.split(",") if b.strip())
    if args.traffic_shape:
        try:
            parse_shape(args.traffic_shape)  # fail loudly before building
        except ValueError as e:
            print(f"--traffic-shape: {e}", file=sys.stderr)
            return 2
    scfg = ServeConfig(
        config=args.config,
        compute=run_dtype,
        max_batch=args.serve_max_batch,
        buckets=buckets or None,
        plan_path=args.plan,
        journal_path=args.serve_journal,
        default_deadline_s=args.serve_deadline_s or None,
        model_cfg=blocks_cfg,
        device=args.device,
    )
    # a shaped load carries a class mix whose SLO policy is the admission policy (shed-by-class)
    mix = None
    if args.traffic_shape:
        mix = list(default_class_mix(InferenceServer(scfg, params=params, plan=plan).buckets))
        scfg = dataclasses.replace(scfg, slo=slo_policy(mix))
    if args.serve_controller:
        from .serving.controller import ControllerConfig

        scfg = dataclasses.replace(scfg, controller=ControllerConfig())
        if scfg.slo is None:
            print("Serve controller: inert (no SLO policy: pair with --traffic-shape for the class-mix signals)")
    server = InferenceServer(scfg, params=params, plan=plan)
    # without --trace the serve journal takes the spans too: one file, one timeline
    serve_tracer = None
    if get_tracer() is None and server.journal is not None:
        serve_tracer = Tracer(journal=server.journal)
        set_tracer(serve_tracer)
        print(f"Trace: id={serve_tracer.trace_id} journal={scfg.journal_path}")
    frontend = None
    try:
        server.start()
        try:
            if args.serve_frontend is not None:
                from .serving.frontend import ServingFrontend, http_fleet_load

                frontend = ServingFrontend(server, port=args.serve_frontend).start()
                print(f"Serve frontend: url={frontend.url}", flush=True)
                with obs_span("serve.load", rate_rps=args.serve_rate, duration_s=args.serve_duration,
                              transport="http"):
                    report = http_fleet_load(
                        frontend.url, (blocks_cfg.in_height, blocks_cfg.in_width, blocks_cfg.in_channels),
                        shape=args.traffic_shape or "steady", rate_rps=args.serve_rate,
                        duration_s=args.serve_duration, classes=mix or list(default_class_mix(server.buckets)),
                        seed=args.seed,
                    )
            elif args.traffic_shape:
                with obs_span("serve.load", rate_rps=args.serve_rate, duration_s=args.serve_duration,
                              shape=args.traffic_shape):
                    report = run_shaped_load(server, shape=args.traffic_shape, rate_rps=args.serve_rate,
                                             duration_s=args.serve_duration, classes=mix, seed=args.seed)
            else:
                with obs_span("serve.load", rate_rps=args.serve_rate, duration_s=args.serve_duration):
                    report = run_load(server, rate_rps=args.serve_rate, duration_s=args.serve_duration,
                                      seed=args.seed)
        finally:
            if frontend is not None:
                frontend.stop()
            server.close()
    finally:
        if serve_tracer is not None:
            set_tracer(None)  # in-process callers must not inherit a tracer
    print(f"Serve buckets: {','.join(str(b) for b in server.buckets)}")
    print(f"Serve load: {report.summary()}")
    if hasattr(report, "class_lines"):
        for line in report.class_lines():
            print(line)
    print(f"Serve: {server.summary()}")
    if frontend is not None:
        print(f"Serve transport: {' '.join(f'http_{c}={n}' for c, n in sorted(frontend.http_codes.items()))}")
    if server.controller is not None:
        print(f"Serve controller: {server.controller.summary()}")
    return 0


def _serve_replay(args) -> int:
    """``--serve-replay``: the journal's ``serve_config`` record is the
    build, so the build flags are ignored; re-drive, report, judge."""
    from .observability.replay import ReplayKnobs, load_recorded_run, replay_recorded

    if args.replay_mult <= 0 or args.replay_slo_scale <= 0:
        print("--replay-mult/--replay-slo-scale must be > 0", file=sys.stderr)
        return 2
    try:
        recorded = load_recorded_run(args.serve_replay)
        report = replay_recorded(recorded, ReplayKnobs(
            traffic_mult=args.replay_mult, devices=args.replay_devices, slo_scale=args.replay_slo_scale,
            journal_path=args.replay_journal, device=args.device,
        ))
    except ValueError as e:  # unreplayable, or waiting for a ROADMAP item it names
        print(f"--serve-replay: {e}", file=sys.stderr)
        return 2
    print(f"Replay source: {args.serve_replay}")
    print(f"Replay journal: {report.journal_path}")
    print(f"Replay: {report.summary()}")
    for line in report.class_lines():
        print(line)
    if report.diverged:
        print("replay divergence: a neutral replay broke the recorded accounting/percentile contract",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
