"""The Blocks 1-2 training CLI: the JAX package's ``train.py``.

Synthetic teacher-student training: the native C++ data pipeline
(``native/``, the JAX package's batch stream bit for bit) feeds batches, a
randomly initialised student is fitted to a fixed deterministic teacher's
outputs by the training step of ``training.py`` (single device, ``--sp``
row-sharded or ``--tp`` tensor-parallel, ``--dp`` replicas), the loss is
printed per step in a machine-parseable line, and the weights checkpoint to
npz so a run can resume. Every flag, printed line and exit code is the JAX
CLI's, plus ``--device`` (``cuda`` unless the CPU is asked for; without a
GPU the run exits 2):

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.train --steps 20 --batch 8
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.train --sp 8 --device cpu

The mesh puts the ``--dp`` x ``--sp`` (or ``--tp``) shard slots round-robin
on the visible devices (``parallel/mesh.py``): slots are not bounded by
devices, so the JAX CLI's "need N devices ... use --fake-devices" guard has
no counterpart, and the run prints the mesh's placement on a ``Mesh:`` line
instead (``4 shards on 1 device: cuda:0``), so sharing a card is never
silent. ``--fake-devices N`` still parses, so JAX command lines run
unchanged, and changes nothing.

The training step launches no CUDA kernel of the port: the JAX package has
no backward kernel for Blocks 1-2, so the step differentiates the reference
forward (``training.py``), and the teacher is ``v1_jit``.

Resilience: the sentinel (``resilience/sentinel.py``) screens every step's
loss, gradient norm and params for NaN/Inf and norm spikes
(``--no-sentinel`` opts out). ``--checkpoint-every N`` makes the run
preemption- and corruption-tolerant: the training state (params, optimizer
state, step) is checkpointed atomically every N steps into ``--work-dir``
beside a crash-consistent journal, a sentinel trip rolls back to the last
good checkpoint and re-enters (at most ``--max-rollbacks`` times in a row,
then exit 3), and relaunching the same command resumes at the last
checkpointed step. Batches in this mode come from the step index
(``fill_batch(shape, "uniform", batch_seed(seed, k))``, the loader's stream),
so a resumed or rolled-back run replays exactly the batches an
uninterrupted run sees:

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.train --steps 200 \\
        --checkpoint-every 20 --work-dir logs/train_work

``--supervise-steps`` puts every step under the elastic supervisor
(``resilience/supervisor.py``): a lost shard slot or a sentinel trip during
a step degrades down the shard ladder, rebuilds the step over the surviving
slots, reshards params and optimizer state onto them and replays the same
batch; rollback is the floor once the ladder is spent. It prints an
``Elastic: ...`` line and the work-dir journal's ``Health: ...`` fold.
"""

from __future__ import annotations

import argparse
import sys
import time


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuda_mpi_gpu_cluster_programming_tpu_torch.train")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", choices=["sgd", "adam"], default="sgd")
    p.add_argument("--dp", type=int, default=1, help="data-parallel mesh axis size")
    p.add_argument("--sp", type=int, default=0, help="spatial/context-parallel shards (0 = off)")
    p.add_argument("--tp", type=int, default=0, help="tensor-parallel (K-axis) shards (0 = off)")
    p.add_argument("--remat", action="store_true", help="rematerialize activations in backward")
    p.add_argument("--height", type=int, default=63, help="input H (default small for fast demo)")
    p.add_argument("--width", type=int, default=63)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--loader-workers", type=int, default=2)
    p.add_argument("--checkpoint", help="save trained params to this .npz")
    p.add_argument("--resume", help="initialize student from this .npz")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--fake-devices", type=int, default=0,
                   help="accepted so JAX command lines parse; changes nothing (the mesh's shard slots share the "
                        "visible devices, printed on the Mesh: line)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="atomically checkpoint the full training state every N steps into --work-dir and journal "
                        "progress; enables idempotent resume (relaunch the same command) and sentinel rollback "
                        "(0 = off, the run-once behavior)")
    p.add_argument("--work-dir", default="logs/train_work",
                   help="state directory for --checkpoint-every: last-good checkpoint + crash-consistent "
                        "journal.jsonl")
    p.add_argument("--checkpoint-shards", type=int, default=0,
                   help="with --checkpoint-every: save the training state as a crash-consistent SHARDED tree (N "
                        "atomic shard files + a manifest-last commit, utils.checkpoint.save_train_state_sharded) "
                        "instead of one npz (0 = single-file npz)")
    p.add_argument("--supervise-steps", action="store_true",
                   help="supervisor-managed training steps (requires --checkpoint-every): a sentinel trip or a "
                        "lost shard slot DURING a step degrades down the elastic ladder (halo@n -> halo@n/2 -> ... "
                        "-> single@1), rebuilds the step over the surviving slots, reshards params+opt-state onto "
                        "them and replays the SAME batch; rollback remains the floor once the ladder or "
                        "--max-rollbacks is exhausted. Prints one machine-parseable 'Elastic: ...' line")
    p.add_argument("--max-rollbacks", type=int, default=2,
                   help="consecutive sentinel-trip rollbacks tolerated before aborting (the counter resets at every "
                        "successful checkpoint)")
    p.add_argument("--no-sentinel", action="store_true",
                   help="disable the SDC sentinel (NaN/Inf + norm-spike screening of loss/grads/params each step)")
    p.add_argument("--sentinel-window", type=int, default=8,
                   help="rolling history length per watched scalar for spike detection")
    p.add_argument("--sentinel-spike", type=float, default=1e3,
                   help="trip when a watched scalar exceeds this factor times its window median")
    p.add_argument("--oracle-every", type=int, default=0,
                   help="run the golden-oracle conv spot check every N-th param check; a mismatch trips the "
                        "sentinel (0 = off)")
    return p


def _home(tree):
    """The device of ``tree``'s first tensor leaf."""
    from .utils.tree import tree_leaves

    return tree_leaves(tree)[0].device


def _run_resilient_loop(
    args, jr, save_state, load_state, start_step, get_batch, teacher_fwd, teacher,
    step_fn, student, opt_state, sentinel, mesh, flog, device, sup=None,
):
    """The quarantine-capable training loop (``--checkpoint-every`` > 0).

    Every committed step is journaled; every N-th commit atomically
    checkpoints (params, opt_state, step) as the last-good state through
    ``save_state``. A sentinel trip rolls the loop back to that state
    (``load_state``) and re-enters; ``--max-rollbacks`` consecutive trips
    without a checkpoint in between end the run with rc 3. Returns an exit
    code (int) or ``(first_loss, last_loss, steps_run, params, opt_state)``.

    With ``sup`` (``--supervise-steps``) the cheap recovery comes first: a
    lost slot caught by ``supervise_step``, or a sentinel trip routed
    through ``trip_external``, degrades the ladder, reshards the state onto
    the surviving slots and replays the same step's batch; the checkpoint
    rollback runs only once the ladder is spent."""
    import torch

    from .observability.trace import current_ids
    from .observability.trace import span as obs_span
    from .resilience import chaos
    from .resilience.policy import DegradationExhausted
    from .resilience.sentinel import SDC

    first = last = None
    last_good_step = start_step
    rollbacks = 0
    steps_run = 0
    i = start_step

    def _rollback(cause: str):
        """The floor: one rollback spent, the last-good state restored, the
        step rewound. rc 3 once the budget is spent, else None."""
        nonlocal rollbacks, student, opt_state, i
        rollbacks += 1
        flog.record("retry", cause=cause[:160])
        jr.append("rollback", key=f"rollback:{i + 1}", step=i + 1, cause=cause[:200], **current_ids())
        print(f"{cause} -> rollback to last-good step {last_good_step} "
              f"(rollback {rollbacks}/{args.max_rollbacks})", flush=True)
        if rollbacks > args.max_rollbacks:
            flog.record("fail", cause="rollback budget exhausted")
            print(f"sentinel: {args.max_rollbacks} consecutive rollbacks exhausted without progress; aborting",
                  file=sys.stderr)
            return 3
        student, opt_state, _ = load_state(student, opt_state)
        i = last_good_step
        return None

    while i < args.steps:
        # supervised, the batch follows the supervisor's resharded params (its surviving slots), never a
        # device fixed at the start
        x = torch.from_numpy(get_batch(i)).to(_home(student) if sup is not None else device)
        y = teacher_fwd(teacher, x.to(device))
        try:
            # one span a step (a no-op untraced): the supervisor's trip -> degrade -> reshard -> replay spans
            # nest under it, so an incident reads as one tree in the exported timeline
            with obs_span("train.step", step=i + 1):
                if sup is not None:
                    out = sup.supervise_step(student, opt_state, x, y.to(x.device), step=i)
                else:
                    out = step_fn(student, opt_state, x, y)
        except DegradationExhausted as e:
            rc = _rollback(f"elastic ladder exhausted: {str(e)[:120]}")
            if rc is not None:
                return rc
            continue
        new_student, new_opt, loss = out[0], out[1], float(out[2])
        gnorm = float(out[3]) if len(out) > 3 else None
        ch = chaos.active()
        if ch is not None:
            if ch.draw("nan_loss"):
                print(f"chaos: injected nan_loss at step {i + 1}", flush=True)
                loss = float("nan")
            if ch.draw("sdc"):
                from .resilience.sentinel import inject_bit_flip

                new_student, loc = inject_bit_flip(new_student, seed=ch.spec.seed)
                print(f"chaos: injected sdc bit-flip at step {i + 1} (leaf/elem {loc})", flush=True)
        try:
            if sentinel is not None:
                sentinel.check_scalar(i, loss, "loss")
                if gnorm is not None:
                    sentinel.check_scalar(i, gnorm, "grad_norm")
                sentinel.check_tree(i, new_student, "params")
                if mesh is not None:
                    sentinel.check_divergence(i, new_student, "params")
        except SDC as e:
            if sup is not None:
                # step-level replay first: degrade, reshard the pre-step state, re-run the same batch; no
                # rollback spent, no checkpoint touched
                try:
                    student, opt_state = sup.trip_external(e, student, opt_state)
                    print(f"{e} -> elastic replay of step {i + 1} on {sup.entry.key} (no rollback consumed)",
                          flush=True)
                    continue
                except DegradationExhausted:
                    pass  # the ladder is spent: the floor
            rc = _rollback(str(e))
            if rc is not None:
                return rc
            continue
        student, opt_state = new_student, new_opt
        if first is None:
            first = loss
        last = loss
        steps_run += 1
        print(f"Step {i + 1}/{args.steps}: loss = {loss:.6f}")
        jr.append("step", key=f"step:{i + 1}", step=i + 1, loss=loss, **current_ids())
        i += 1
        if i % args.checkpoint_every == 0 or i == args.steps:
            save_state(student, opt_state, i)
            jr.append("ckpt", key=f"ckpt:{i}", step=i, **current_ids())
            last_good_step = i
            rollbacks = 0  # progress made: the consecutive-trip budget starts again
        if sup is not None:
            # grow-back between steps: once a rejoined slot passes probation the supervisor climbs back up,
            # the live state resharded onto the promoted rung
            promoted = sup.maybe_promote(student, opt_state)
            if promoted is not None:
                student, opt_state = promoted
                print(f"Elastic promote: climbed back to {sup.entry.key} (pool={sup.pool.summary()})", flush=True)
    flog.record("ok")
    if flog.retried:
        print(f"Sentinel fault log: {flog.summary()}")
    return first, last, steps_run, student, opt_state


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.steps < 1:
        print(f"--steps must be >= 1, got {args.steps}", file=sys.stderr)
        return 2
    import dataclasses

    import torch

    from . import native
    from .configs import REGISTRY, build_forward, resolve_device
    from .models.alexnet import BLOCKS12, output_shape
    from .models.init import init_params_deterministic, init_params_random
    from .parallel.mesh import make_mesh
    from .training import make_train_step
    from .utils.optim import adam, sgd
    from .utils.tree import tree_map

    cfg = dataclasses.replace(BLOCKS12, in_height=args.height, in_width=args.width)
    oh, ow, _oc = output_shape(cfg)
    if min(oh, ow) <= 0:
        print(f"degenerate model for H={args.height} W={args.width}", file=sys.stderr)
        return 2
    if args.sp and args.tp:
        print("--sp and --tp are mutually exclusive strategies", file=sys.stderr)
        return 2
    if args.tp and args.dp > 1:
        print("--tp does not compose with --dp yet (TP builds its own 1-D mesh)", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2

    mesh = tp_mesh = None
    if args.sp or args.dp > 1:
        mesh = make_mesh(args.sp or 1, dp=args.dp, device=device.type)
    elif args.tp:
        tp_mesh = make_mesh(args.tp, axis_name="tp", device=device.type)
    sentinel = None
    if not args.no_sentinel:
        from .resilience.sentinel import SDC, Sentinel, SentinelConfig

        sentinel = Sentinel(SentinelConfig(window=args.sentinel_window, spike_factor=args.sentinel_spike,
                                           oracle_every=args.oracle_every))

    opt = adam(args.lr) if args.optimizer == "adam" else sgd(args.lr)
    opt_init, step_fn = make_train_step(
        cfg, mesh=mesh or tp_mesh, optimizer=opt, sp_shards=args.sp, tp_shards=args.tp, remat=args.remat,
        with_grad_norm=sentinel is not None, device=device.type,
    )

    teacher = init_params_deterministic(cfg, device=device)
    if args.resume:
        from .utils.checkpoint import load_params_npz

        student = tree_map(lambda t: t.to(device), load_params_npz(args.resume))
        print(f"Resumed student from {args.resume}")
    else:
        student = init_params_random(torch.Generator().manual_seed(args.seed), cfg, device=device)
    opt_state = opt_init(student)

    teacher_fwd = build_forward(REGISTRY["v1_jit"], cfg, device=device)

    print(f"--- Training (teacher-student, {args.optimizer}, lr={args.lr}, batch={args.batch}, dp={args.dp}, "
          f"sp={args.sp or 'off'}, remat={args.remat}, H={args.height}) ---")
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"Devices: {n_devices} x {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    if (mesh or tp_mesh) is not None:
        print(f"Mesh: {(mesh or tp_mesh).describe()}")

    shape = (args.batch, cfg.in_height, cfg.in_width, cfg.in_channels)
    resilient = args.checkpoint_every > 0
    if args.supervise_steps and not resilient:
        print("--supervise-steps requires --checkpoint-every (checkpoint rollback is the floor below the elastic "
              "ladder)", file=sys.stderr)
        return 2

    from .resilience import chaos
    from .resilience.policy import FaultLog

    jr = None
    save_state = load_state = None
    start_step = 0
    if resilient:
        from pathlib import Path

        from .resilience.journal import Journal

        work = Path(args.work_dir)
        work.mkdir(parents=True, exist_ok=True)
        jr = Journal(work / "journal.jsonl")
        if args.checkpoint_shards > 0:
            # a crash-consistent sharded tree: N atomic shard files, the manifest committed last, so a kill
            # mid-save leaves the previous generation loadable
            from .utils.checkpoint import MANIFEST_NAME, load_train_state_sharded, save_train_state_sharded

            ckpt_path = work / "ckpt_last_good"
            ckpt_exists = (ckpt_path / MANIFEST_NAME).exists()

            def save_state(p, o, s):
                return save_train_state_sharded(ckpt_path, p, o, s, n_shards=args.checkpoint_shards)

            def load_state(lp, lo):
                p, o, s = load_train_state_sharded(ckpt_path, lp, lo, device=device.type)
                return tree_map(lambda t: t.to(_home(lp)), p), tree_map(lambda t: t.to(_home(lp)), o), s
        else:
            from .utils.checkpoint import load_train_state, save_train_state

            ckpt_path = work / "ckpt_last_good.npz"
            ckpt_exists = ckpt_path.exists()

            def save_state(p, o, s):
                return save_train_state(ckpt_path, p, o, s)

            def load_state(lp, lo):
                return load_train_state(ckpt_path, lp, lo)

        if ckpt_exists:
            try:
                student, opt_state, start_step = load_state(student, opt_state)
                print(f"Resumed training state from {ckpt_path} at step {start_step}")
                jr.append("resume", key=f"resume:{start_step}", step=start_step)
            except (ValueError, KeyError) as e:
                # a corrupt or mismatched checkpoint must not brick the run: report it and start fresh (the
                # atomic saver replaces it at the next boundary)
                print(f"ignoring unusable checkpoint {ckpt_path}: {e}", file=sys.stderr)
        if start_step == 0:
            # the rollback target exists before the first step, so a trip at step 1 has a state to return to
            save_state(student, opt_state, 0)
            jr.append("ckpt", key="ckpt:0", step=0)

    first = last = None
    t0 = time.perf_counter()
    if resilient:
        try:
            native.fill_batch((1, 1, 1, 1))
        except RuntimeError as e:
            print(f"cannot build native input tier: {e}", file=sys.stderr)
            return 2

        def get_batch(k: int):
            return native.fill_batch(shape, "uniform", native.batch_seed(args.seed, k))

        sup = None
        train_tracer = None
        if args.supervise_steps:
            # the spans ride the work-dir journal the step/ckpt records use, so one export covers the run
            from .observability.trace import Tracer, set_tracer

            train_tracer = Tracer(journal=jr)
            set_tracer(train_tracer)
            print(f"Trace: id={train_tracer.trace_id} journal={jr.path}")
            from .resilience.supervisor import Supervisor, train_ladder
            from .training import make_elastic_step_builder

            # the elastic step ladder replaces the bare step: one optimizer (its state keeps its structure
            # across rungs), every sharded rung rebuilt over the pool's surviving slots
            sup = Supervisor(
                cfg, train_ladder(sp_shards=args.sp, tp_shards=args.tp),
                step_builder=make_elastic_step_builder(cfg, optimizer=opt, remat=args.remat,
                                                       with_grad_norm=sentinel is not None, device=device.type),
                journal=jr, site="train", device=device.type,
            )
        try:
            rc = _run_resilient_loop(
                args, jr, save_state, load_state, start_step, get_batch, teacher_fwd, teacher, step_fn, student,
                opt_state, sentinel, mesh, FaultLog(site="train-sentinel"), device, sup=sup,
            )
        finally:
            if train_tracer is not None:
                from .observability.trace import set_tracer

                set_tracer(None)  # in-process callers must not inherit a tracer
        if isinstance(rc, int):
            return rc
        # the trained state comes back from the loop: --checkpoint saves what the run learned
        first, last, steps_run, student, opt_state = rc
        if sup is not None:
            print(f"Elastic: {sup.summary()}")
            from .observability.health import health_from_journal

            try:
                print(f"Health: {health_from_journal(jr.path).summary_line()}")
            except Exception as e:  # noqa: BLE001 — the fold is evidence, not the result
                print(f"Health: unavailable ({type(e).__name__}: {e})")
    else:
        try:
            loader_cm = native.NativeDataLoader(shape, mode="uniform", seed=args.seed, workers=args.loader_workers)
        except RuntimeError as e:  # the toolchain is missing or the native build broke
            print(f"cannot build native input tier: {e}", file=sys.stderr)
            return 2
        with loader_cm as loader:
            for i in range(args.steps):
                x = torch.from_numpy(next(loader)).to(device)
                y = teacher_fwd(teacher, x)
                out = step_fn(student, opt_state, x, y)
                student, opt_state, loss = out[0], out[1], float(out[2])
                gnorm = float(out[3]) if len(out) > 3 else None
                ch = chaos.active()
                if ch is not None and ch.draw("nan_loss"):
                    print(f"chaos: injected nan_loss at step {i + 1}", flush=True)
                    loss = float("nan")
                if sentinel is not None:
                    try:
                        sentinel.check_scalar(i, loss, "loss")
                        if gnorm is not None:
                            sentinel.check_scalar(i, gnorm, "grad_norm")
                    except SDC as e:  # no checkpoint: abort loudly
                        print(f"{e} (no checkpoint to roll back to; run with --checkpoint-every)", file=sys.stderr)
                        return 3
                if first is None:
                    first = loss
                last = loss
                print(f"Step {i + 1}/{args.steps}: loss = {loss:.6f}")
        steps_run = args.steps
    wall = time.perf_counter() - t0
    if last is None:
        print(f"Training already complete at step {start_step}/{args.steps} (resumed)")
    else:
        print(f"Training completed in {wall * 1e3:.1f} ms ({steps_run} steps, loss {first:.6f} -> {last:.6f})")

    if args.checkpoint:
        from .utils.checkpoint import save_params_npz

        save_params_npz(args.checkpoint, student)
        print(f"Saved params to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
