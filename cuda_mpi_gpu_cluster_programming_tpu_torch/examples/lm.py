"""Byte-LM training demo: the transformer LM end to end.

Trains the tiny decoder-only LM on a synthetic repeating-byte corpus until
the pattern is memorized: the loss must fall below a threshold or the run
FAILs (and ``--generate N`` must continue the pattern).

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.lm --attn flash
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.lm --attn flash --compute bf16 --generate 16
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.lm --device cpu --seq-len 64 --batch 2
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.lm --attn ring --shards 4 --sp-engine flash

The port of the JAX package's ``examples/lm.py``, with the same flags plus
``--device`` and the same stdout contract lines. Runs on the GPU unless
``--device cpu`` is given. ``--attn flash`` trains through the
hand-written flash kernels (per layer and step: one ``flash_fwd``, one
``flash_dq``, one ``flash_dkv``; ``--remat`` adds a second ``flash_fwd``).
``--attn ring|ulysses`` trains with sequence-parallel attention over
``--shards`` slots (``parallel/sequence_parallel.py``), each slot's block
through ``--sp-engine`` (``einsum``, or ``flash``: per layer and step the
causal ring launches n(n+1)/2 of each flash kernel, Ulysses n). The slots
share the visible devices round-robin (``parallel/mesh.py``), printed on a
``Mesh:`` line, so the JAX CLI's "--shards exceeds the device count" guard
has no counterpart; ``--fake-devices N`` parses, so the JAX command lines
run unchanged, and changes nothing. ``--experts`` runs the mixture of
experts replicated on the home device. ``--pp-stages`` and ``--fsdp`` are
not ported yet and exit 2 before any work. The weights are drawn from a
seeded ``torch.Generator`` (JAX's PRNG is not reproduced).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

_NOT_PORTED = "{} is not ported yet: it waits for ROADMAP Queue 1 item {}"


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
                   help="MoE experts per FFN (0 = dense), replicated on the one device")
    p.add_argument("--pp-stages", type=int, default=0, help="pipeline stages (not ported yet)")
    p.add_argument("--microbatches", type=int, default=2, help="pp microbatches")
    p.add_argument("--fsdp", action="store_true", help="ZeRO/FSDP sharding (not ported yet)")
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
                   help="accepted for the JAX command lines; the --shards slots share the visible devices")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def _unported(args) -> str | None:
    """The first flag of a tier not ported yet, with the ROADMAP item it waits for."""
    if args.pp_stages:
        return _NOT_PORTED.format("--pp-stages (pipeline parallel)", 9)
    if args.fsdp:
        return _NOT_PORTED.format("--fsdp", 9)
    return None


def _guard(args, max_len: int, n_heads: int) -> str | None:
    """The JAX CLI's argument checks, in its words (but the device-count
    one: slots are not bounded by devices here)."""
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
    if args.accum_steps < 1:
        return f"--accum-steps must be >= 1, got {args.accum_steps}"
    if args.batch % args.accum_steps:
        return f"--accum-steps must divide --batch ({args.batch} % {args.accum_steps} != 0)"
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
    err = _unported(args) or _guard(args, eff_max_len, TINY_LM.n_heads)
    if err is not None:
        print(err, file=sys.stderr)
        return 2

    from ..configs import resolve_device
    from ..ops import cuda_kernels

    device = resolve_device(args.device)
    cfg = dataclasses.replace(TINY_LM, attn_impl=args.attn, attn_engine=args.sp_engine, sp_shards=args.shards,
                              max_len=eff_max_len, n_experts=args.experts, remat=args.remat)
    mesh = None
    if args.attn in ("ring", "ulysses"):
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(args.shards, device=device.type)
    if args.resume:
        params, err = _resume(args, cfg, device)
        if err is not None:
            print(err, file=sys.stderr)
            return 2
        print(f"Resumed params from {args.resume}")
    else:
        params = init_transformer(cfg, generator=torch.Generator().manual_seed(args.seed), device=device)
    # +1 token: the next-token shift leaves seq-len positions to predict
    base = torch.arange(args.seq_len + 1, dtype=torch.int64) % args.period
    tokens = base[None].repeat(args.batch, 1).to(device)

    extras = (
        (f", experts={cfg.n_experts}" if cfg.n_experts else "")
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
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"Devices: {n_dev} x {dev_name} ({device.type})")
    if mesh is not None:
        print(f"Mesh: {mesh.describe()}")

    opt_init, step = make_lm_train_step(
        cfg, mesh=mesh, lr=args.lr, accum_steps=args.accum_steps,
        compute_dtype=torch.bfloat16 if args.compute == "bf16" else None,
    )
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
        from ..utils.checkpoint import save_params_npz

        save_params_npz(args.save_params, params)
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
