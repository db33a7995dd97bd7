"""Long-context attention demo/bench on one device: the O(L^2) reference
op against the flash kernel.

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.long_context --strategy flash --verify

The port of the JAX package's ``examples/long_context.py``, with the same
flags plus ``--device`` and the same stdout contract lines. Runs on the
GPU unless ``--device cpu`` is given. ``--strategy single`` is the
reference op, ``flash`` the hand-written flash kernel (one ``flash_fwd``
launch per call). The sequence-parallel strategies ``ring`` and
``ulysses`` are not ported yet: they exit 2 before any work. Inputs are
standard normal from a seeded ``torch.Generator`` (JAX's PRNG is not
reproduced).
"""

from __future__ import annotations

import argparse
import sys

import torch

_SP_MISSING = ("strategy {!r} (sequence parallel over several devices) is not ported yet: "
               "it waits for ROADMAP Queue 1 item 3; use --strategy single or flash")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuda_mpi_gpu_cluster_programming_tpu_torch.examples.long_context")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=4096)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--shards", type=int, default=1)
    p.add_argument(
        "--strategy", choices=["single", "flash", "ring", "ulysses"], default="ring",
        help="single = O(L^2) reference op; flash = the hand-written flash kernel; "
        "ring/ulysses = sequence parallel (not ported yet: exits 2)",
    )
    p.add_argument("--causal", action="store_true", default=True)
    p.add_argument("--no-causal", dest="causal", action="store_false")
    p.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--engine", choices=["einsum", "flash"], default="einsum",
                   help="within-shard engine for ring/ulysses (not ported yet)")
    p.add_argument("--verify", action="store_true",
                   help="also run the reference op and report max |delta|")
    p.add_argument("--fake-devices", type=int, default=0,
                   help="virtual devices for ring/ulysses (not ported yet)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.strategy in ("ring", "ulysses"):
        print(_SP_MISSING.format(args.strategy), file=sys.stderr)
        return 2

    from ..configs import resolve_device
    from ..ops import cuda_kernels
    from ..ops.attention import attention
    from ..ops.flash_attention import flash_attention
    from ..ops.reference import true_fp32
    from ..utils.timing import amortized_ms

    device = resolve_device(args.device)
    true_fp32(device)
    dtype = torch.float32 if args.dtype == "fp32" else torch.bfloat16
    shape = (args.batch, args.seq_len, args.heads, args.head_dim)
    gen = torch.Generator().manual_seed(args.seed)
    q, k, v = (torch.randn(shape, generator=gen).to(device=device, dtype=dtype) for _ in range(3))

    op = attention if args.strategy == "single" else flash_attention
    calls = 0

    @torch.inference_mode()
    def fn(q, k, v):
        nonlocal calls
        calls += 1
        return op(q, k, v, causal=args.causal)

    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"--- Long-context attention [{args.strategy}] "
        f"(shards={args.shards}, L={args.seq_len}, B={args.batch}, "
        f"H={args.heads}, D={args.head_dim}, {args.dtype}, "
        f"causal={args.causal}) ---"
    )
    print(f"Devices: 1 x {dev_name} ({device.type})")
    # one device keeps every token and head
    kv_bytes = 2 * args.batch * args.seq_len * args.heads * args.head_dim * q.element_size()
    print(f"KV resident per device: {args.seq_len} tokens x {args.heads} heads ({kv_bytes / 2**20:.2f} MiB)")

    before = dict(cuda_kernels.LAUNCHES)
    out = fn(q, k, v)
    n_small = max(1, args.warmup)
    ms = amortized_ms(fn, q, k, v, n_small=n_small, n_large=n_small + max(1, args.repeats))
    toks = args.batch * args.seq_len / (ms / 1e3)
    print(f"Final Output Shape: {'x'.join(str(d) for d in out.shape)}")
    flat = out[0, :, 0, :].float().reshape(-1).cpu()
    print("Final Output (first 10 values): " + " ".join(f"{x:.4f}" for x in flat[:10].tolist()))
    print(f"Attention completed in {ms:.3f} ms ({toks:.0f} tok/s)")
    launches = " ".join(f"{name}={n - before[name]}" for name, n in cuda_kernels.LAUNCHES.items())
    print(f"Kernel launches: {launches} calls={calls}")

    if args.verify:
        with torch.inference_mode():
            want = attention(q, k, v, causal=args.causal).float()
        delta = float((want - out.float()).abs().max())
        tol = 1e-4 if args.dtype == "fp32" else 3e-2
        ok = delta <= tol
        print(f"Verification: max|delta| = {delta:.2e} (tol {tol:.0e}) -> {'PASSED' if ok else 'FAILED'}")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
