"""Distributed matrix multiply with self-verification (the course's hw1/hw2/hw3 study).

The port of the JAX package's ``examples/matmul.py``. The original course
code's ``homeworks/hw1/src/template.c`` scatters rows of A point to point,
broadcasts B, lets each rank compute its row block, gathers C at the root
and checks it against a serial recompute with tolerance 1e-6; its three
homework variants are three communication styles (HW1 point to point, HW2
collective, HW3 one-sided). Here they are three strategies over the shard
slots of a one-axis mesh (``parallel/mesh.py``), all computing C = A @ B
with A's rows split over the slots:

- ``scatter`` (HW1): each slot is handed its row block of A and the whole
  of B by hand (``.to()`` copies), multiplies them, and the row blocks of
  C are joined on the home device (the gather);
- ``collective`` (HW2): the same placement through :func:`place` (A split
  on rows, B replicated, as ``NamedSharding`` annotations place them in the
  JAX package), and one product a slot with no hand-written hand-offs;
- ``ring`` (HW3): B split on its contraction rows too; at each of n steps a
  slot multiplies the matching columns of its A block by the B block it
  holds, then passes that block to its predecessor (one ``ppermute`` a
  step, counted in ``halo.COLLECTIVES``).

The product is a plain matrix product (``lax.dot`` in the JAX package,
outside any Pallas kernel), so each slot's is ``torch.matmul`` in true fp32
(TF32 off on the card). The operands are integers 0-9 (template.c:211-216),
drawn from a seeded ``torch.Generator`` (JAX's PRNG is not reproduced): for
n <= 4096 every product and partial sum is an integer below 2^24, exact in
fp32, so every strategy is bitwise ``mat_mult_serial`` and the check's 1e-6
tolerance (template.c:222) is exact.

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.matmul 4096 --shards 4 --strategy ring
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.matmul 64 --shards 2 --device cpu
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.reference import true_fp32
from ..parallel.halo import COLLECTIVES
from ..parallel.mesh import Mesh, make_mesh

MAXDIM = 1 << 12  # 4096 (template.c:20)
TOLERANCE = 1e-6  # template.c:222
STRATEGIES = ("scatter", "collective", "ring")


def validate_n(n: int, num_shards: int) -> int:
    """Reference argument contract: positive power of two (template.c:48-55),
    clamped to MAXDIM (:56-63), divisible by the process count (:65-72)."""
    if n <= 0 or (n & (n - 1)) != 0:
        raise ValueError(f"matrix dimension n ({n}) must be a positive power of two")
    if n > MAXDIM:
        n = MAXDIM
    if n % num_shards != 0:
        raise ValueError(f"matrix dimension n ({n}) must be divisible by the shard count ({num_shards})")
    return n


def init_data(generator: torch.Generator, n: int, device="cuda") -> torch.Tensor:
    """Random integers 0-9 as fp32 (template.c:211-216), drawn on the CPU
    from ``generator`` and moved to ``device``: exact in fp32."""
    return torch.randint(0, 10, (n, n), generator=generator).to(device=device, dtype=torch.float32)


def mat_mult_serial(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The single-device verification oracle (template.c:195-208 with my_work=n), true fp32."""
    true_fp32(a.device)
    return torch.matmul(a, b)


def _join(blocks: List[torch.Tensor], device) -> torch.Tensor:
    """C's row blocks joined on ``device`` (the gather)."""
    return torch.cat([blk.to(device, non_blocking=True) for blk in blocks], dim=0)


def mat_mult_scatter(a: torch.Tensor, b: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """HW1: A's row blocks and B handed to the slots by hand, a product a slot."""
    true_fp32(a.device)
    devs, rows = mesh.shard_devices, a.shape[0] // mesh.n_shards
    blocks = []
    for i, dev in enumerate(devs):
        a_blk = a[i * rows:(i + 1) * rows].to(dev, non_blocking=True)  # the point-to-point scatter
        b_all = b.to(dev, non_blocking=True)  # the broadcast
        blocks.append(torch.matmul(a_blk, b_all))
    return _join(blocks, a.device)


def place(t: torch.Tensor, mesh: Mesh, split_rows: bool) -> List[torch.Tensor]:
    """``t`` placed on the mesh's slots: its row blocks (``split_rows``) or a
    copy of the whole (replicated), one a slot: the port's ``device_put``
    with a ``NamedSharding`` of ``P(axis, None)`` or ``P(None, None)``."""
    devs = mesh.shard_devices
    if not split_rows:
        return [t.to(dev, non_blocking=True) for dev in devs]
    return [blk.to(dev, non_blocking=True) for blk, dev in zip(torch.chunk(t, len(devs), dim=0), devs)]


def mat_mult_collective(a: torch.Tensor, b: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """HW2: placement by :func:`place` only; each slot's product of what it holds."""
    true_fp32(a.device)
    return _join([torch.matmul(x, y) for x, y in zip(place(a, mesh, True), place(b, mesh, False))], a.device)


def mat_mult_ring(a: torch.Tensor, b: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """HW3: B stays split on its contraction rows; the blocks rotate.

    Slot d holds A's row block d and B's k-block d. At step s it multiplies
    its A columns ``[owner*blk, (owner+1)*blk)`` by the B block it holds
    (``owner = (d + s) % n``), then passes the block to its ring predecessor:
    n steps, n ``ppermute`` operations (the last one returns every block to
    its owner, as the JAX package's loop does)."""
    true_fp32(a.device)
    devs = mesh.shard_devices
    n = len(devs)
    a_blks, b_cur = place(a, mesh, True), place(b, mesh, True)
    blk = a.shape[1] // n
    acc = [torch.zeros((x.shape[0], b.shape[1]), dtype=a.dtype, device=x.device) for x in a_blks]
    for s in range(n):
        for d in range(n):
            owner = (d + s) % n
            acc[d] = acc[d] + torch.matmul(a_blks[d][:, owner * blk:(owner + 1) * blk], b_cur[d])
        COLLECTIVES["ppermute"] += 1
        b_cur = [b_cur[(d + 1) % n].to(devs[d], non_blocking=True) for d in range(n)]
    return _join(acc, a.device)


_IMPLS = {"scatter": mat_mult_scatter, "collective": mat_mult_collective, "ring": mat_mult_ring}


def mat_mult_distributed(a: torch.Tensor, b: torch.Tensor, n_shards: int, strategy: str = "scatter",
                         mesh: Optional[Mesh] = None) -> torch.Tensor:
    if strategy not in _IMPLS:
        raise ValueError(f"unknown strategy {strategy!r}; choose from {STRATEGIES}")
    mesh = mesh or make_mesh(n_shards, device=a.device.type)
    return _IMPLS[strategy](a, b, mesh)


def check_result(c: torch.Tensor, d: torch.Tensor, tolerance: float = TOLERANCE) -> bool:
    """Epsilon compare (template.c:220-238). True = mismatch (their flag)."""
    return bool(torch.max(torch.abs(c - d)) > tolerance)


def _synced(device, fn):
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def main(argv=None) -> int:
    import argparse
    import time

    from ..configs import resolve_device

    p = argparse.ArgumentParser(prog="cuda_mpi_gpu_cluster_programming_tpu_torch.examples.matmul")
    p.add_argument("n", type=int, nargs="?", default=64, help="matrix dimension (power of two)")
    p.add_argument("--shards", type=int, default=1, help="row-shard count (mpirun -np analogue)")
    p.add_argument("--strategy", choices=STRATEGIES, default="scatter")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    try:
        n = validate_n(args.n, args.shards)
    except ValueError as e:
        print(f"Error: {e}")
        return 1
    if n != args.n:
        print(f"Warning: n ({args.n}) exceeds MAXDIM ({MAXDIM}). Clamping to MAXDIM.")
    device = resolve_device(args.device)

    my_work = n // args.shards
    print(f"pid=0: num_procs={args.shards} n={n} my_work={my_work} (rows per proc)")

    gen = torch.Generator().manual_seed(args.seed)
    a, b = init_data(gen, n, device), init_data(gen, n, device)
    mesh = make_mesh(args.shards, device=device.type)

    # a warm-up call outside the timed region (the reference times only the distribute + compute + gather
    # phase, after MPI_Barrier: template.c:114-116)
    _synced(device, lambda: mat_mult_distributed(a, b, args.shards, args.strategy, mesh))
    t0 = time.perf_counter()
    c = _synced(device, lambda: mat_mult_distributed(a, b, args.shards, args.strategy, mesh))
    elapsed = time.perf_counter() - t0
    print(f"pid=0: Parallel computation finished in {elapsed:f} seconds.")

    print("pid=0: Performing serial computation for verification...")
    _synced(device, lambda: mat_mult_serial(a, b))
    t0 = time.perf_counter()
    d = _synced(device, lambda: mat_mult_serial(a, b))
    print(f"pid=0: Serial computation finished in {time.perf_counter() - t0:f} seconds.")

    if check_result(c, d):
        print("--------------------------------------")
        print("pid=0: Test: FAILED")
        print("--------------------------------------")
        return 1
    print("--------------------------------------")
    print("pid=0: Test: PASSED")
    print(f"pid=0: Total PARALLEL time: {elapsed:f} seconds.")
    print("--------------------------------------")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
