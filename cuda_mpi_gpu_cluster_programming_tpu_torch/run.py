"""CLI runner for the port: one single-device Blocks 1-2 configuration.

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v3_pallas --batch 128

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v3_pallas --tune

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v3_pallas --batch 128 --breakdown --profile prof

Runs on the GPU unless ``--device cpu`` is given; with no CUDA device and
no ``--device cpu`` it raises. Prints the JAX package's stdout contract
(``Tune plan:``, ``Precision:``, ``Compile time:``, ``Final Output Shape:``,
``Final Output (first 10 values):``, ``... completed in X ms``, ``Timing
stats:``; with ``--profile``, ``Profiler trace written to ...``; with
``--breakdown``, one ``Layer <name> completed in X ms -> HxWxC`` line per
layer of the config's op tier), which the harness regexes read.

``--tune`` sweeps {fp32, bf16, int8w} x the kernel variants of each conv
layer (``tuning.autotune.autotune_precision``: every dtype screened by the
journaled, preflighted tolerance gate first), saves the plan and the
winning dtype in ``--plan`` (default ``<package>/_build/tune_plan.json``,
git-ignored) and runs with them; a fresh matching plan is loaded instead
of swept. ``--plan`` alone loads a plan; ``--policy tuned`` runs the
saved winning dtype. Precedence of the run's dtype: ``--dtype`` or a preset
``--policy`` pins it (and pins the sweep to it); else ``--policy tuned`` or
``--tune`` adopt the sweep's winner; else ``--compute``.
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
                   help="wall-clock budget of the --tune sweep (0 = unbounded); when it runs out the "
                        "remaining candidates are skipped and the plan says so")
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
    return p


def _tuning(args, model_cfg, device, pinned: str, run_dtype: str, source: str):
    """The JAX package's ``--tune``/``--plan``/``--policy tuned`` handling:
    returns ``(run_dtype, source, gate_info, plan)`` and prints the
    ``Policy:``/``Gate pruned:``/``Tune plan:`` lines."""
    from .observability.trace import span as obs_span
    from .resilience.policy import Deadline
    from .tuning.autotune import DTYPES, AllDtypesPruned, autotune_precision
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
    if args.tune:
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

    from .configs import REGISTRY, build_forward, resolve_device
    from .models.alexnet import BLOCKS12
    from .models.init import (
        deterministic_input,
        init_params_deterministic,
        init_params_random,
        random_input,
    )
    from .ops import cuda_kernels
    from .utils.timing import amortized_stats, fence

    if args.list_configs:
        for c in REGISTRY.values():
            print(f"{c.key:18s} {c.version_name:22s} {c.description}")
        return 0
    if args.config not in REGISTRY:
        print(f"unknown config {args.config!r}; try --list-configs", file=sys.stderr)
        return 2
    exec_cfg = REGISTRY[args.config]
    device = resolve_device(args.device)

    model_cfg = dataclasses.replace(
        BLOCKS12,
        in_height=args.height,
        in_width=args.width,
        lrn2=dataclasses.replace(BLOCKS12.lrn2, alpha_over_size=(args.lrn_form == "cpu")),
    )
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

    # One generator, params first and input second: --seed S reproduces both.
    gen = torch.Generator().manual_seed(args.seed)
    if args.init == "deterministic":
        params = init_params_deterministic(model_cfg, device=device)
        x = deterministic_input(args.batch, model_cfg, device=device)
    else:
        params = init_params_random(gen, model_cfg, device=device)
        x = random_input(gen, args.batch, model_cfg, device=device)

    try:
        fwd = build_forward(exec_cfg, model_cfg, policy=run_dtype, device=device, plan=plan)
    except ValueError as e:
        print(f"cannot build config {exec_cfg.key!r}: {e}", file=sys.stderr)
        return 2

    passes = 0

    def counted(p, xx):
        nonlocal passes
        passes += 1
        return fwd(p, xx)

    before = dict(cuda_kernels.LAUNCHES)
    t0 = time.perf_counter()
    counted(params, x)
    fence(device)
    compile_ms = (time.perf_counter() - t0) * 1e3  # first call: kernel build/load included

    n_small = max(1, args.warmup)
    if args.profile:
        from .utils.profiling import TRACE_FILE
        from .utils.profiling import trace as profile_ctx
    else:
        profile_ctx = lambda _dir: contextlib.nullcontext()  # noqa: E731
    with profile_ctx(args.profile):
        st = amortized_stats(counted, params, x, n_small=n_small, n_large=n_small + max(1, args.repeats))
    if args.profile:
        print(f"Profiler trace written to {Path(args.profile) / TRACE_FILE}")
    out = counted(params, x).cpu().numpy()
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

        # Per-layer costs on the selected config's op tier, after the
        # headline's launch count: a v3_pallas breakdown times the kernels.
        for name, ms, shape in layer_breakdown(params, x, model_cfg, repeats=max(1, args.repeats),
                                               warmup=n_small, compute=run_dtype, tier=exec_cfg.tier):
            print(f"Layer {name} completed in {ms:.3f} ms -> {'x'.join(str(d) for d in shape[1:])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
