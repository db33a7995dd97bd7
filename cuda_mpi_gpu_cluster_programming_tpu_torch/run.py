"""CLI runner for the port: one configuration of Blocks 1-2 (``v1_jit``,
``v3_pallas``, and the sharded ``v2.1_replicated``, ``v2.2_sharded``,
``v4_hybrid``, ``v5_collective``, ``v7_tp``) or full AlexNet
(``v6_full_jit``, ``v6_full_pallas``, ``v6_full_sharded``).

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v3_pallas --batch 128

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v5_collective --shards 4 --breakdown

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

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v3_pallas --serve --route 3 --route-dir fleet

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v5_collective --serve --shards 2

    CHAOS_SPEC=seed=3,stage_sdc=1 python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v5_collective \
        --shards 4 --supervise --supervisor-journal sup.jsonl

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v5_collective --shards 4 --serve --supervise

Runs on the GPU unless ``--device cpu`` is given; with no CUDA device and
no ``--device cpu`` it raises. ``--shards N`` runs a sharded config on a mesh
of N shard slots (``parallel/mesh.py``: slot i on GPU i mod the visible
GPUs, so on one card every slot shares it) and prints the placement on a
``Mesh:`` line ("Mesh: 4 shards on 1 device: cuda:0"); a single-device
config runs on one device whatever ``--shards`` says, as in the JAX package. Prints the JAX package's stdout contract
(``Tune plan:``, ``Precision:``, ``Compile time:``, ``Final Output Shape:``,
``Final Output (first 10 values):``, ``... completed in X ms``, ``Timing
stats:``; with ``--profile``, ``Profiler trace written to ...``; with
``--breakdown``, one ``Layer <name> completed in X ms -> HxWxC`` line per
layer of the config's op tier, and for a halo, staged or tensor-parallel
config the static comm/compute plan, one ``Comm <layer>`` line per layer),
which the harness regexes read.

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
controller:`` lines, and with ``--serve-journal`` the journal's ``Health:``
fold (``observability/health.py``). ``--serve --shards N`` serves a sharded config at N
shard slots, all on the server's card (``serving.server.serve_mesh``), each
bucket's graph capturing the sharded forward. ``--serve --route N`` runs
the fleet instead of one in-process server (``serving/fleet.py``,
``serving/router.py``): N backend processes of ``--config`` on the run's
device, each with every bucket captured before it announces itself, behind
a ``FleetRouter``, the HTTP client fleet driven through the router, and
every journal (one per backend and the router's) in ``--route-dir``; with
``CHAOS_SPEC=seed=S,host_loss=1`` backend ``S % N`` is SIGKILLed mid-load,
then restarted and re-admitted through the router's probation. It prints
``Route fleet:``, ``Route load:``, ``Route class:``, ``Route host loss:``,
``Route recovery:``, ``Route:`` and ``Health:`` lines (the JAX package's
backends are always ``v1_jit``; the port's are ``--config``'s).
``--serve-replay JOURNAL`` re-drives a recorded serve journal through a
live server (``observability/replay.py``; the journal's ``serve_config``
record is the build, so the build flags are ignored) with the what-if
knobs ``--replay-mult``, ``--replay-slo-scale`` and ``--replay-devices``,
and prints ``Replay:`` and ``Replay class:`` lines: exit 3 when a neutral
replay diverges from the record, 2 on a journal it cannot replay; a
supervised recording replays through the supervisor, its recorded slot
losses scripted at their steps.

Supervision: ``--supervise`` runs a Blocks 1-2 config under the elastic
supervisor (``resilience/supervisor.py``): the forward of each rung of
its ladder (the config's strategy at N, N/2, ... shards, replicated, the
single-device reference floor; ``--dtype`` fp32 or bf16) carries the
sentinel's digest taps, every screened batch is checked off the timed
path, and a trip degrades a rung and replays the batch, printing
``DEGRADED(halo@4:pallas -> halo@2:pallas): cause`` on stdout and, after
the timed passes (taps included), one ``Supervisor: attempts=...
entry=... kinds=...`` line. ``--supervisor-journal PATH`` journals every
transition. ``--supervise`` refuses full AlexNet and ``--fallback-chain``
(exit 2, the JAX package's words). ``--serve --supervise`` serves under the
supervisor: a trip's batch replays on the new rung after every bucket's
graph is captured again there, and the controller gains its
``degrade_capacity`` rung. ``--route`` backends are not supervised.

Ranks: launched as one rank of a cluster (``parallel/distributed.py``'s
``launch_local`` or ``launch_plan``, or ``torchrun``: torch's
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` set), the run
joins the process group first, before any CUDA use, under
``--dist-backend`` (default: the launcher's ``TPU_FRAMEWORK_DIST_BACKEND``,
else nccl on CUDA and gloo on the CPU; several ranks on one card take
gloo, as nccl refuses them). ``--shards N`` over R ranks needs N % R == 0
and gives each rank N/R consecutive slots; a single-device config runs
whole on each rank. Rank 0 prints the contract lines and ``Output sha256:``
(its output's float32 bytes); every rank then prints one ``Rank i/R:``
line (its slots, per_pass_ms, kernel launches, collectives and bytes across
ranks a forward). The serving, supervision, tuning, fallback, profile, trace and
save-params modes run in one process (exit 2 across ranks).

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.distributed --local-cluster 2 --device cpu --backend gloo
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import re
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
    p.add_argument("--shards", type=int, default=1,
                   help="shard count of a sharded config (mpirun -np analogue): slots of a mesh over the visible "
                        "GPUs, several to a card where there are fewer GPUs; printed on the 'Mesh:' line")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="as a rank of a cluster (torch's MASTER_ADDR/WORLD_SIZE/RANK set): the process group's "
                        "backend (default $TPU_FRAMEWORK_DIST_BACKEND, else nccl on CUDA, gloo on the CPU; nccl "
                        "refuses two ranks on one card)")
    p.add_argument("--supervise", action="store_true",
                   help="run under the elastic supervisor: each rung's forward carries per-stage digest taps, every "
                        "screened batch is checked off the timed path, and a trip (stage_digest / shard_divergence / "
                        "device_loss / mesh_shrink) degrades down the shard ladder and replays the batch. Blocks 1-2 "
                        "configs only; prints one machine-parsed 'Supervisor: ...' line")
    p.add_argument("--supervisor-journal", default="",
                   help="with --supervise: journal every build/trip/degrade/ok transition to this jsonl path")
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
    p.add_argument("--route", type=int, default=0, metavar="N",
                   help="with --serve: fleet mode, N backend serving processes of --config on --device "
                        "(serving.fleet) behind a FleetRouter, the HTTP client fleet driven through the router: "
                        "crc32-of-rid routing, probe-driven up/probation/quarantine hysteresis, journaled "
                        "retry-with-redirect; prints 'Route fleet:', 'Route load:', 'Route class:' and 'Route:' "
                        "lines")
    p.add_argument("--route-dir", default="logs/route",
                   help="with --route: the journal directory, one backend_<i>.jsonl per backend and router.jsonl")
    p.add_argument("--serve-replay", default="", metavar="JOURNAL",
                   help="re-drive a recorded serve journal through a live server on --device (its serve_config "
                        "record is the build: --config et al. are ignored); prints 'Replay:' and 'Replay class:' "
                        "lines, exit 3 when a neutral replay diverges from the record, 2 when it cannot replay")
    p.add_argument("--replay-mult", type=float, default=1.0,
                   help="with --serve-replay: offer the recorded schedule at this traffic multiple")
    p.add_argument("--replay-devices", type=int, default=None,
                   help="with --serve-replay: rebuild at this shard width (a sharded config's slots share the card)")
    p.add_argument("--replay-slo-scale", type=float, default=1.0,
                   help="with --serve-replay: scale every class SLO budget and request deadline (0.5 = twice as tight)")
    p.add_argument("--replay-journal", default="",
                   help="with --serve-replay: journal the replay here (itself replayable; default a temp file)")
    return p


def _waiting(args) -> str:
    """Why a flag given cannot run yet ('' = none given)."""
    if args.shards < 1:
        return f"--shards must be >= 1, got {args.shards}"
    if args.route < 0:
        return f"--route must be >= 0, got {args.route}"
    if args.serve and args.fallback_chain:
        return "--serve degrades through the supervisor ladder (--supervise); drop --fallback-chain"
    if args.serve and args.route and args.supervise:
        return ("--route serves unsupervised backends (the fleet's router is what survives a backend's loss); "
                "drop --supervise")
    return ""


def _supervisor(args, exec_cfg, model_cfg, plan, run_dtype: str, device):
    """``(Supervisor, '')`` over the config's default ladder at
    ``--shards``, DEGRADED events printed to stdout; ``(None, why)`` when
    the config has no ladder."""
    from .resilience.journal import Journal
    from .resilience.supervisor import Supervisor, default_ladder

    try:
        ladder = default_ladder(exec_cfg.strategy, exec_cfg.tier, args.shards)
    except ValueError as e:
        return None, f"cannot supervise config {exec_cfg.key!r}: {e}"
    journal = Journal(args.supervisor_journal) if args.supervisor_journal else None
    return Supervisor(model_cfg, ladder, plan=plan, journal=journal, on_event=lambda ev: print(ev, flush=True),
                      policy=run_dtype, device=device), ""


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
    # Join a cluster when launched as a rank (a no-op otherwise), before any CUDA use, as the JAX run.py does.
    from .parallel.distributed import maybe_initialize_from_env

    if maybe_initialize_from_env(backend=args.dist_backend, device=args.device):
        return _run_rank(args)
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


class _Tee(io.TextIOBase):
    """Writes to every stream it holds."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self) -> None:
        for st in self.streams:
            st.flush()


def _run_rank(args) -> int:
    """``_run`` as one rank of the process group: the same run on every
    rank (each builds the params and the whole input from the seed), rank
    0's contract lines printed and the others' kept, then one ``Rank i/R:``
    line a rank. The group is left at the end."""
    from .configs import REGISTRY
    from .parallel import halo

    dist = torch.distributed
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        modes = (("--serve", args.serve), ("--serve-replay", args.serve_replay), ("--supervise", args.supervise),
                 ("--tune", args.tune), ("--fallback-chain", args.fallback_chain), ("--profile", args.profile),
                 ("--trace", args.trace), ("--save-params", args.save_params))
        refused = [flag for flag, on in modes if on]
        sharded = args.config in REGISTRY and REGISTRY[args.config].strategy != "single"
        why = ""
        if refused:
            why = (f"{', '.join(refused)} run in one process, not across ranks (a sharded server over cards and the "
                   "elastic pool over cards are ROADMAP Queue 1 item 17)")
        elif sharded and args.shards % world:
            why = (f"--shards {args.shards} does not split over {world} ranks: each rank takes N/R consecutive "
                   "slots, so N % R must be 0")
        if why:
            print(why, file=sys.stderr)
            return 2
        halo.reset_collectives()
        kept = io.StringIO()
        with contextlib.redirect_stdout(_Tee(sys.stdout, kept) if rank == 0 else kept):
            rc = _run(args)
        print(f"Rank {rank}/{world}: {_rank_summary(kept.getvalue(), args, rank, world, sharded)}", flush=True)
        return rc
    finally:
        dist.destroy_process_group()


def _rank_summary(text: str, args, rank: int, world: int, sharded: bool) -> str:
    """A rank's slots and what its run's contract lines say, a forward."""
    from .parallel import halo

    per = args.shards // world
    where = (f"slots {rank * per}-{rank * per + per - 1} of {args.shards}" if sharded
             else "the whole forward (a single-device config)")
    ms = re.search(r"Forward Pass completed in ([0-9.]+) ms", text)
    launches = re.search(r"^Kernel launches: (.*) passes=(\d+)$", text, re.M)
    digest = re.search(r"^Output sha256: (\w+)$", text, re.M)
    passes = int(launches.group(2)) if launches else 0
    kernels = " ".join(f"{k}={int(v) / passes:g}" for k, v in re.findall(r"(\w+)=(\d+)", launches.group(1))
                       if int(v)) if passes else ""
    coll = " ".join(f"{k}={v / passes:g}" for k, v in halo.COLLECTIVES.items() if v) if passes else ""
    wire = " ".join(f"{k}={v / passes:.0f}" for k, v in halo.WIRE.items()) if passes else ""
    return (f"{where} ({torch.distributed.get_backend()}); per_pass_ms={ms.group(1) if ms else 'none'}; "
            f"a forward: launches {kernels or 'none'}; collectives {coll or 'none'}; bytes across ranks "
            f"{wire or 'none'}; "
            f"output {'sha256 ' + digest.group(1) if digest else 'on rank 0'}; passes={passes}")


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
    if args.supervise and exec_cfg.model != "blocks12":
        print("--supervise supports the Blocks 1-2 configs only", file=sys.stderr)
        return 2
    if args.supervise and args.fallback_chain:
        print("--supervise has its own degradation ladder; drop --fallback-chain", file=sys.stderr)
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
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"--- AlexNet {label} {exec_cfg.version_name} [{exec_cfg.key}] (batch={args.batch}) ---")
    print(f"Devices: {n_devices} x {dev_name} ({device.type})")
    mesh = None
    if exec_cfg.strategy != "single":
        from .parallel.mesh import make_mesh
        from .serving.server import serve_mesh

        mesh = serve_mesh(args.shards, device) if args.serve else make_mesh(args.shards, device=device.type)
        print(f"Mesh: {mesh.describe()}")
    elif args.shards != 1:
        print(f"Mesh: none ({exec_cfg.key} runs on one device; --shards {args.shards} does not apply)")

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
    if args.supervise and run_dtype not in ("fp32", "bf16"):
        print(f"--supervise runs fp32 or bf16 (its ladder's rungs have no {run_dtype} form)", file=sys.stderr)
        return 2

    if args.serve and exec_cfg.model != "blocks12":
        print("--serve supports the Blocks 1-2 configs only", file=sys.stderr)
        return 2
    if args.serve and args.route:
        # fleet mode: each backend process builds its own server; the router owns the accounting
        return _run_route(args, blocks_cfg)
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
        f = counted(build_forward(cfg, model_cfg, policy=run_dtype, device=device, plan=plan, n_shards=args.shards,
                                  mesh=mesh if cfg.strategy != "single" else None))
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
    sup = None
    if args.supervise:
        # the supervisor owns the build, its chaos draws and its ladder: the retry and Degrader path is bypassed
        sup, why = _supervisor(args, exec_cfg, model_cfg, plan, run_dtype, device)
        if sup is None:
            print(why, file=sys.stderr)
            return 2

        def run_counted(f, p, xx):
            nonlocal passes
            passes += 1
            return f(p, xx)

        try:
            sup.execute(params, x, runner=run_counted)
        except DegradationExhausted as e:
            print(f"supervisor: every ladder rung failed: {e.last}", file=sys.stderr)
            return 2
        fwd = counted(sup.fwd())  # (params, x) -> (out, digests): the taps ride the timed path
        compile_ms = sup.compile_ms or 0.0
    else:
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
            st = amortized_stats(fwd, params, x, n_small=n_small, n_large=n_small + max(1, args.repeats),
                                 lockstep=mesh is not None and mesh.owners is not None)
            if sp is not None:
                sp.set(per_pass_ms=round(st.per_call_ms, 4))
    if args.profile:
        print(f"Profiler trace written to {Path(args.profile) / TRACE_FILE}")
    if sup is not None:
        # a screened pass (off the timed path), then the machine-parsed supervisor line
        out = sup.execute(params, x, runner=run_counted).cpu().numpy()
        print(f"Supervisor: {sup.summary()}")
    else:
        res = fwd(params, x)
        out = None if res is None else res.cpu().numpy()  # None: a rank of a cluster whose output rank 0 holds
    per_pass_ms = st.per_call_ms

    print(f"Compile time: {compile_ms:.1f} ms")
    if out is not None:
        print(f"Final Output Shape: {'x'.join(str(d) for d in out.shape[1:])}")
        print(f"Final Output (first 10 values): {' '.join(f'{v:.4f}' for v in out[0].reshape(-1)[:10])}")
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            print(f"Output sha256: {hashlib.sha256(out.astype('float32').tobytes()).hexdigest()}")
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
        _comm_table(exec_cfg, blocks_cfg, args, run_dtype)
    return 0


def _comm_table(exec_cfg, blocks_cfg, args, run_dtype: str) -> None:
    """The static comm/compute plan of a halo, staged or tensor-parallel
    config (``parallel/breakdown.py``), as the JAX run prints it."""
    from .parallel.breakdown import comm_compute_breakdown, format_table, tp_comm_compute_breakdown

    dtype_bytes = 2 if run_dtype in ("bf16", "int8w") else 4
    if exec_cfg.strategy in ("halo", "staged_halo"):
        staged = exec_cfg.strategy == "staged_halo"
        rows = comm_compute_breakdown(blocks_cfg, args.shards, batch=args.batch, dtype_bytes=dtype_bytes,
                                      staged=staged)
        print(format_table(rows, staged=staged))
    elif exec_cfg.strategy == "tp":
        rows = tp_comm_compute_breakdown(blocks_cfg, args.shards, batch=args.batch, dtype_bytes=dtype_bytes)
        print(format_table(rows, transport="all_gather + channel-halo ppermute"))


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
        n_shards=args.shards,
        compute=run_dtype,
        max_batch=args.serve_max_batch,
        buckets=buckets or None,
        plan_path=args.plan,
        supervise=args.supervise,
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
    if server.sup is not None:
        print(f"Supervisor: {server.sup.summary()}")  # the one-shot --supervise line
    if scfg.journal_path:
        _print_health(scfg.journal_path)
    return 0


def _print_health(journal) -> None:
    """The ``Health:`` line: the journal's health fold (``observability
    health --journal`` renders it whole). A fold that raises prints the JAX
    CLI's ``unavailable`` form: the fold is evidence, not the run's result."""
    from .observability.health import health_from_journal

    try:
        print(f"Health: {health_from_journal(journal).summary_line()}")
    except Exception as e:  # noqa: BLE001
        print(f"Health: unavailable ({type(e).__name__}: {e})")


def _run_route(args, blocks_cfg) -> int:
    """``--serve --route N``: N backend serving processes of ``--config``
    on ``--device`` behind a ``FleetRouter``, the HTTP client fleet driven
    through the router, every journal in ``--route-dir``. With ``host_loss``
    chaos armed, the seeded backend is SIGKILLed mid-load, restarted after
    the load window, and must re-admit through probation."""
    import threading

    from .serving.batcher import power_of_two_buckets
    from .serving.fleet import BackendFleet, maybe_host_loss
    from .serving.frontend import http_fleet_load
    from .serving.router import UP, FleetRouter, drill_config
    from .serving.traffic import default_class_mix

    route_dir = Path(args.route_dir)
    route_dir.mkdir(parents=True, exist_ok=True)
    fleet = BackendFleet(args.route, route_dir, height=blocks_cfg.in_height, width=blocks_cfg.in_width,
                         max_batch=args.serve_max_batch, config=args.config, device=args.device)
    router = None
    killed = [None]
    try:
        fleet.start()
        router = FleetRouter(fleet.urls(), drill_config(str(route_dir / "router.jsonl"),
                                                        deadline_s=args.serve_deadline_s or None)).start()
        print(f"Route fleet: n={args.route} url={router.url} dir={route_dir}", flush=True)
        mix = list(default_class_mix(power_of_two_buckets(args.serve_max_batch)))
        # host_loss fires mid-window from a timer: the load keeps offering while the victim dies
        timer = threading.Timer(max(0.05, args.serve_duration / 2),
                                lambda: killed.__setitem__(0, maybe_host_loss(fleet)))
        timer.start()
        t_kill = time.monotonic()
        report = http_fleet_load(
            router.url, (blocks_cfg.in_height, blocks_cfg.in_width, blocks_cfg.in_channels),
            shape=args.traffic_shape or "steady", rate_rps=args.serve_rate, duration_s=args.serve_duration,
            classes=mix, seed=args.seed,
        )
        timer.cancel()
        timer.join()
        recovery_ms = None
        if killed[0] is not None:
            idx = killed[0]
            print(f"Route host loss: killed=b{idx} (chaos host_loss)")
            router.replace_backend(idx, fleet.restart(idx))
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and router.backend_states()[f"b{idx}"] != UP:
                time.sleep(0.05)
            if router.backend_states()[f"b{idx}"] == UP:
                recovery_ms = (time.monotonic() - t_kill) * 1e3
        print(f"Route load: {report.summary()}")
        rrep = router.report()
        for line in rrep.class_lines():
            print(line)
        if recovery_ms is not None:
            print(f"Route recovery: killed=b{killed[0]} ms={recovery_ms:.0f}")
        print(f"Route: {rrep.summary()}")
    finally:
        if router is not None:
            router.stop()
        fleet.stop()
    _print_health(route_dir)
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
