"""On-chip A/B of the max-pool lowerings at AlexNet's pool1 and pool2.

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.pool_ab [--batch 128] [--dtype fp32] [--pool pool1]

The port of the JAX package's ``scripts/pool_ab.py``, with the same flags
plus ``--device`` (cuda unless ``--device cpu`` is given; without a GPU it
raises), the same output and the same exit code. The JAX script chose the
main path's pool lowering (sep2). Strategies, in the JAX order:

  xla     ``F.max_pool2d`` over the NCHW view of the NHWC input: the oracle
          (the JAX script's ``lax.reduce_window``)
  current the phases pool kernel (``csrc/maxpool_phases.cu``), the JAX
          package's ``_maxpool_phases``
  phases  only the phase-stack repack of ``current`` (``pool_phases_pack``,
          the same file's pack kernel), not compared
  s2d128  the space-to-depth pool kernel (``csrc/maxpool_s2d.cu``): C padded
          to a multiple of 128, repacked, pooled from aligned channel blocks
  sep2    the main path's pool kernel (``csrc/maxpool.cu``): the TPU's
          separable two-pass pool is one 2-D pass here
  sep2p   sep2 after padding C to a multiple of 128, cropped after

Prints one JSON row per strategy: ``strategy``, ``pool``, ``batch``,
``dtype``, ``ms_per_pass`` (``utils.timing.amortized_ms``, fenced on the
device), and ``"mismatch": true`` where a compared strategy's output is
not bitwise the oracle's. A strategy that raises prints an ``error`` row.
Exits 1 on any mismatch or error, else 0. Nothing falls back to another
strategy or device. The input is standard normal from a seeded
``torch.Generator`` (JAX's PRNG is not reproduced).
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

POOL_SHAPES = {
    # pool1/pool2 geometries of the model: ((H, W, C), window, stride)
    "pool1": ((55, 55, 96), 3, 2),
    "pool2": ((27, 27, 256), 3, 2),
}
SEED = 0


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def strategies(x: torch.Tensor, window: int, stride: int) -> dict:
    """name -> a call of that strategy on ``x`` (NHWC), in the JAX order."""
    from .ops import cuda_kernels as ck
    from .ops import packing

    c = x.shape[3]

    def sep2p():
        return ck.maxpool2d(packing.pad_channels(x, ck.S2D_LANES), window=window, stride=stride)[..., :c]

    return {
        "xla": lambda: F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1),
        "current": lambda: ck.maxpool_phases(x, window=window, stride=stride),
        "phases": lambda: ck.pool_phases_pack(x, window=window, stride=stride),
        "s2d128": lambda: ck.maxpool_s2d(x, window=window, stride=stride),
        "sep2": lambda: ck.maxpool2d(x, window=window, stride=stride),
        "sep2p": sep2p,
    }


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuda_mpi_gpu_cluster_programming_tpu_torch.pool_ab")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    p.add_argument("--pool", choices=tuple(POOL_SHAPES), default="pool1")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> int:
    from .configs import resolve_device
    from .utils.timing import amortized_ms

    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    (h, w, c), window, stride = POOL_SHAPES[args.pool]
    dtype = torch.float32 if args.dtype == "fp32" else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((args.batch, h, w, c), generator=gen, device=device).to(dtype)

    fns = strategies(x, window, stride)
    oracle = _bits(fns["xla"]())
    rc = 0
    for name, fn in fns.items():
        try:
            ms = amortized_ms(lambda _x, fn=fn: fn(), x, n_small=10, n_large=60)
            row = {"strategy": name, "pool": args.pool, "batch": args.batch,
                   "dtype": args.dtype, "ms_per_pass": round(ms, 4)}
            if name != "phases":
                if not torch.equal(_bits(fn()), oracle):
                    row["mismatch"] = True
                    rc = 1
        except Exception as e:  # noqa: BLE001 — report per-strategy failures, as the JAX script does
            row = {"strategy": name, "pool": args.pool, "error": repr(e)[:200]}
            rc = 1
        print(json.dumps(row), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
