"""Byte-LM training demo: the transformer LM end to end.

Trains the tiny decoder-only LM on a synthetic repeating-byte corpus until
the pattern is memorized: the loss must fall below a threshold or the run
FAILs (and ``--generate N`` must continue the pattern).

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.lm --attn flash
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.lm --attn flash --compute bf16 --generate 16
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.lm --device cpu --seq-len 64 --batch 2
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.lm --attn ring --shards 4 --sp-engine flash
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.lm --attn flash --fsdp --fake-devices 4
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.lm --attn flash --pp-stages 2 --microbatches 4

The port of the JAX package's ``examples/lm.py``, with the same flags plus
``--device`` and the same stdout contract lines. Runs on the GPU unless
``--device cpu`` is given. ``--attn flash`` trains through the
hand-written flash kernels (per layer and step: one ``flash_fwd``, one
``flash_dq``, one ``flash_dkv``; ``--remat`` adds a second ``flash_fwd``).
``--attn ring|ulysses`` trains with sequence-parallel attention over
``--shards`` slots (``parallel/sequence_parallel.py``), each slot's block
through ``--sp-engine`` (``einsum``, or ``flash``: per layer and step the
causal ring launches n(n+1)/2 of each flash kernel, Ulysses n).
``--pp-stages S`` pipelines the decoder stack over S "pp" slots
(``parallel/pipeline.py``, ``--microbatches`` M: each microbatch's layers
on their stage's slot, the bubbles skipped). ``--fsdp`` splits every param
and the batch over the "dp" slots (``parallel/fsdp.py``), on a ``(dp, sp)``
mesh with ``--attn ring|ulysses``. ``--experts E`` runs a mixture of
experts, its expert stacks split over the "ep" slots
(``parallel/expert.py``) when the slot count divides E (and no pipeline
runs), else whole on the home device. The slots of every tier share the
visible devices round-robin (``parallel/mesh.py``), printed on a ``Mesh:``
line, so the JAX CLI's "exceeds N available device(s)" guards have no
counterpart. The slot count of the tiers the JAX CLI sizes by its device
count (fsdp's dp = slots / sp, ep's ep) is ``--fake-devices N`` when given
and otherwise the visible GPU count (1 on the CPU), so the JAX command
lines (``--fsdp --fake-devices 4``) run the JAX geometry; for ``--shards``
it changes nothing. The weights are drawn from a seeded
``torch.Generator`` (JAX's PRNG is not reproduced).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuda_mpi_gpu_cluster_programming_tpu_torch.examples.lm")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=128, help="training context length")
    p.add_argument("--attn", choices=["reference", "flash", "ring", "ulysses"], default="reference")
    p.add_argument("--shards", type=int, default=1, help="sp shards for ring/ulysses")
    p.add_argument("--sp-engine", choices=["einsum", "flash"], default="einsum",
                   help="within-shard engine for ring/ulysses (both train: ulysses via the whole-sequence "
                   "VJP, ring via the joint (out, lse) VJP)")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--period", type=int, default=8, help="repeating-pattern period")
    p.add_argument("--experts", type=int, default=0,
                   help="MoE experts per FFN (0 = dense); the expert axis ep-shards over the slots when the slot "
                   "count (--fake-devices, else the visible GPUs) divides it, else runs whole on the home device")
    p.add_argument("--pp-stages", type=int, default=0,
                   help="pipeline stages for the decoder stack (0 = no pipeline)")
    p.add_argument("--microbatches", type=int, default=2, help="pp microbatches")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO/FSDP: shard params+optimizer over 'dp' and split the batch over the same axis. "
                   "Composes with --attn ring/ulysses --shards N on a (dp, sp) mesh (dp = slots/N). Not combinable "
                   "with --pp-stages or ep-sharded --experts")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize each decoder block (torch.utils.checkpoint): activation "
                   "memory O(1) in depth at ~1 extra forward of work")
    p.add_argument("--compute", choices=["fp32", "bf16"], default="fp32",
                   help="bf16 = mixed precision: forward/backward in bfloat16, fp32 master weights + optimizer")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer step")
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, greedy-decode N tokens from the first 16 of the pattern via "
                   "the KV-cache path and verify the continuation")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target-loss", type=float, default=1.0, help="PASS threshold")
    p.add_argument("--save-params", help="save trained params to this .npz")
    p.add_argument("--resume", help="load initial params from this .npz checkpoint")
    p.add_argument("--fake-devices", type=int, default=0,
                   help="the slot count of --fsdp and ep-sharded --experts (the JAX CLI's device count; default the "
                   "visible GPUs, 1 on the CPU); the slots share the visible devices, and --shards is not bounded by it")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def _slot_count(args) -> int:
    """The slots of the tiers the JAX CLI sizes by its device count: ``--fake-devices``, else the visible GPUs."""
    from ..parallel.mesh import device_count

    return args.fake_devices or max(1, device_count(args.device))


def _guard(args, max_len: int, n_heads: int, n_layers: int, n_dev: int) -> str | None:
    """The JAX CLI's argument checks, in its words and order (but the
    device-count ones: slots are not bounded by devices here)."""
    from ..ops.flash_attention import flash_block

    def flash_len_err(flag: str):
        bq = flash_block(args.seq_len)
        if args.seq_len % bq:
            return f"{flag} needs --seq-len divisible by {bq} (got {args.seq_len})"
        return None

    err = None
    if args.attn == "flash":
        err = flash_len_err("--attn flash")
    elif args.attn in ("ring", "ulysses"):
        if args.shards < 1:
            err = f"--shards must be >= 1, got {args.shards}"
        elif args.seq_len % args.shards:
            err = f"--attn {args.attn} needs --seq-len divisible by --shards ({args.seq_len} % {args.shards} != 0)"
        elif args.attn == "ulysses" and n_heads % args.shards:
            err = f"--attn ulysses needs --shards dividing n_heads={n_heads} (got {args.shards})"
        elif args.sp_engine == "flash":
            if args.attn == "ring":
                # the ring's rule is per shard: each hop's block is seq-len/shards rows
                lb = args.seq_len // args.shards
                if lb % flash_block(lb):
                    err = (f"--sp-engine flash with --attn ring needs the per-shard block (seq-len/shards = {lb}) "
                           f"to divide by the flash block ({flash_block(lb)})")
            else:  # ulysses: the slot's flash attends the full sequence
                err = flash_len_err("--sp-engine flash")
    if err is not None:
        return err
    if args.pp_stages:
        if n_layers % args.pp_stages:
            return f"--pp-stages must divide n_layers={n_layers}, got {args.pp_stages}"
        if args.microbatches < 1 or args.batch % args.microbatches:
            return f"--microbatches must divide --batch ({args.batch} % {args.microbatches} != 0)"
    if args.fsdp:
        sp = args.shards if args.attn in ("ring", "ulysses") else 1
        if args.pp_stages:
            return "--fsdp is not combinable with --pp-stages"
        if args.experts and n_dev > 1 and args.experts % n_dev == 0:
            return "--fsdp is not combinable with ep-sharded --experts"
        if n_dev % sp:
            return (f"--fsdp with --attn {args.attn} --shards {sp} needs the device count ({n_dev}) divisible by "
                    f"the sp shards")
        if args.batch % (n_dev // sp):
            return f"--fsdp needs --batch divisible by the dp axis ({n_dev}//{sp} = {n_dev // sp} device(s))"
    if args.accum_steps < 1:
        return f"--accum-steps must be >= 1, got {args.accum_steps}"
    if args.batch % args.accum_steps:
        return f"--accum-steps must divide --batch ({args.batch} % {args.accum_steps} != 0)"
    if args.pp_stages and (args.batch // args.accum_steps) % args.microbatches:
        return (f"--accum-steps {args.accum_steps} with --pp-stages leaves microbatches of "
                f"{args.batch // args.accum_steps} rows, not divisible by --microbatches {args.microbatches}")
    plen = min(16, args.seq_len)
    if args.generate > 0 and plen + args.generate > max_len:
        return f"--generate {args.generate} exceeds max_len {max_len} - prompt {plen}"
    return None


def _resume(args, cfg, device):
    """``(params, error)``: the checkpoint's params, or the reason it does not fit this run's config."""
    from ..models.transformer import init_transformer
    from ..utils.checkpoint import load_params_npz
    from ..utils.tree import tree_paths

    like = init_transformer(cfg, generator=torch.Generator().manual_seed(args.seed), device=device)
    try:
        params = load_params_npz(args.resume, like=like)
    except KeyError as e:
        # a structurally different config (a dense checkpoint and --experts, ...)
        return None, f"--resume {args.resume} does not match this run's config: {e}"
    mismatches = [
        f"{path}: checkpoint {tuple(got.shape)} vs config {tuple(want.shape)}"
        for (path, got), (_, want) in zip(tree_paths(params), tree_paths(like))
        if tuple(got.shape) != tuple(want.shape)
    ]
    if mismatches:
        return None, f"--resume {args.resume} does not match this run's config:\n  " + "\n  ".join(mismatches[:8])
    return params, None


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.steps < 1:
        print(f"--steps must be >= 1, got {args.steps}", file=sys.stderr)
        return 2
    from ..models.transformer import TINY_LM, init_transformer, make_lm_train_step

    eff_max_len = max(TINY_LM.max_len, args.seq_len)
    n_dev = _slot_count(args)
    err = _guard(args, eff_max_len, TINY_LM.n_heads, TINY_LM.n_layers, n_dev)
    if err is not None:
        print(err, file=sys.stderr)
        return 2

    from ..configs import resolve_device
    from ..ops import cuda_kernels
    from ..parallel.mesh import Mesh, make_mesh

    device = resolve_device(args.device)
    cfg = dataclasses.replace(TINY_LM, attn_impl=args.attn, attn_engine=args.sp_engine, sp_shards=args.shards,
                              max_len=eff_max_len, n_experts=args.experts, remat=args.remat)
    mesh = None
    if args.attn in ("ring", "ulysses"):
        mesh = make_mesh(args.shards, device=device.type)
    if args.resume:
        params, err = _resume(args, cfg, device)
        if err is not None:
            print(err, file=sys.stderr)
            return 2
        print(f"Resumed params from {args.resume}")
    else:
        params = init_transformer(cfg, generator=torch.Generator().manual_seed(args.seed), device=device)
    # expert parallelism when the slot count divides the expert count (and no pipeline runs), as the JAX CLI
    ep_note, ep_mesh = "", None
    if args.experts and not args.pp_stages and n_dev > 1 and args.experts % n_dev == 0:
        from ..parallel.expert import shard_moe_params

        ep_mesh = make_mesh(n_dev, axis_name="ep", device=device.type)
        params = shard_moe_params(params, ep_mesh)
        ep_note = f", ep-sharded over {n_dev} devices"
    # +1 token: the next-token shift leaves seq-len positions to predict
    base = torch.arange(args.seq_len + 1, dtype=torch.int64) % args.period
    tokens = base[None].repeat(args.batch, 1).to(device)
    fsdp_note = ""
    if args.fsdp:
        from ..parallel.fsdp import shard_params_fsdp, sharded_fraction

        if args.attn in ("ring", "ulysses") and args.shards > 1:
            # the (dp, sp) mesh: params and batch over dp, each dp row's ring or all-to-all over its sp slots
            dp = n_dev // args.shards
            slots = make_mesh(args.shards, dp=dp, device=device.type).devices
            mesh = Mesh(("dp", "sp"), (dp, args.shards), slots)
            mesh_note = f"(dp={dp}) x sp={args.shards}"
        else:
            mesh = make_mesh(n_dev, axis_name="dp", device=device.type)
            mesh_note = f"over {n_dev} devices"
        params = shard_params_fsdp(params, mesh)
        fsdp_note = f", fsdp {mesh_note} ({sharded_fraction(params):.0%} of param bytes sharded)"

    extras = (
        (f", experts={cfg.n_experts}{ep_note}" if cfg.n_experts else "")
        + (f", pp={args.pp_stages}x{args.microbatches}mb" if args.pp_stages else "")
        + fsdp_note
        + (", remat" if args.remat else "")
        + (", bf16-mixed" if args.compute == "bf16" else "")
        + (f", accum={args.accum_steps}" if args.accum_steps > 1 else "")
    )
    print(
        f"--- Byte-LM training [{args.attn}] (shards={args.shards}, "
        f"L={args.seq_len}, batch={args.batch}, layers={cfg.n_layers}, "
        f"d={cfg.d_model}{extras}) ---"
    )
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    n_gpu = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"Devices: {n_gpu} x {dev_name} ({device.type})")

    step_kw = dict(lr=args.lr, accum_steps=args.accum_steps,
                   compute_dtype=torch.bfloat16 if args.compute == "bf16" else None)
    if args.pp_stages:
        # the same loss through the shared step factory, the GPipe schedule inside it
        from ..parallel.pipeline import pipeline_lm_loss

        pp_mesh = make_mesh(args.pp_stages, axis_name="pp", device=device.type)
        print(f"Mesh: {pp_mesh.describe()}")
        opt_init, step = make_lm_train_step(
            cfg, loss_fn=lambda p, t: pipeline_lm_loss(p, t, cfg, n_stages=args.pp_stages,
                                                       n_microbatches=args.microbatches, mesh=pp_mesh),
            **step_kw)
    else:
        for m in (mesh, ep_mesh):
            if m is not None:
                print(f"Mesh: {m.describe()}")
        opt_init, step = make_lm_train_step(cfg, mesh=mesh, **step_kw)
    opt_state = opt_init(params)
    before = dict(cuda_kernels.LAUNCHES)
    first = last = None
    t0 = time.perf_counter()
    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state, tokens)
        last = float(loss)  # waits for the step on the device
        if first is None:
            first = last
        if (i + 1) % 10 == 0 or i == 0:
            print(f"Step {i + 1}/{args.steps}: loss = {last:.4f}")
    wall = time.perf_counter() - t0
    tok_s = args.steps * args.batch * args.seq_len / wall
    print(f"Training completed in {wall * 1e3:.1f} ms ({tok_s:.0f} tok/s)")
    launches = " ".join(f"{name}={n - before[name]}" for name, n in cuda_kernels.LAUNCHES.items())
    print(f"Kernel launches: {launches} steps={args.steps}")
    if args.save_params:
        from ..parallel.fsdp import gather_params
        from ..utils.checkpoint import save_params_npz

        save_params_npz(args.save_params, gather_params(params))  # whole leaves, as the JAX CLI writes
        print(f"Saved params to {args.save_params}")
    ok = last <= args.target_loss
    print(
        f"Verification: loss {first:.4f} -> {last:.4f} "
        f"(target {args.target_loss}) -> {'PASSED' if ok else 'FAILED'}"
    )
    if args.generate > 0:
        # MoE configs serve too: capacity-infinite routing, the training routing whenever
        # nothing was dropped, which a memorized repeating pattern gives
        from ..models.transformer import generate as lm_generate

        plen = min(16, args.seq_len)
        seq = lm_generate(params, tokens[:1, :plen], cfg, steps=args.generate)
        got = [int(v) for v in seq[0, plen:]]
        want = [int((plen + i) % args.period) for i in range(args.generate)]
        gen_ok = got == want
        print(f"Generated {args.generate} tokens: {got[:24]}")
        print(f"Generation continuation: {'PASSED' if gen_ok else 'FAILED'}")
        ok = ok and gen_ok
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
