"""Neighbour halo exchange over the shard axis, as device-to-device copies.

The JAX package's ``parallel/halo.py`` moves boundary rows with
``ppermute`` inside ``shard_map``; the original course code posts
nonblocking MPI sends and receives. Here every shard's block is a tensor on
its slot's device, and a halo is a slice of a neighbour's block copied to
the receiver (``.to(device, non_blocking=True)``; on one card a slice and a
copy). A shard with no source at a hop receives zeros, ``ppermute``'s
missing-source rule, which doubles as the conv's zero padding.

:func:`halo_exchange_gathered` is the staged variant (``v4_hybrid``): every
block goes to every shard, which slices what it needs; it moves n*B rows a
shard where :func:`halo_exchange` moves h_top + h_bot.

Each collective run adds one to :data:`COLLECTIVES` under its JAX name,
once for the whole mesh as one ``ppermute`` or ``all_gather`` is one
operation of the SPMD program (the JAX tests count them in the jaxpr).
The LM's tiers count theirs here too: the ring's K and V rotations
(``ppermute``, ``parallel/sequence_parallel.py``), Ulysses' reshards
(``all_to_all``) and the Megatron block's two reductions (``psum``,
``parallel/tensor_parallel.py``), FSDP's gathers of a leaf and their
gradients' ``reduce_scatter`` (``parallel/fsdp.py``), the expert layer's
dispatch and return (``all_to_all``, ``parallel/expert.py``) and the
pipeline's hand-offs (``ppermute``, ``parallel/pipeline.py``). A copy to
the slot's own device is a no-op ``.to()`` and still counts: the program
ran the collective.

Across ranks (a mesh from ``parallel/distributed.py``'s process group) a
rank holds only its own slots' blocks; the others' entries of ``blocks``
are None. :func:`shift` then sends a slot's rows to a slot of another
rank with point-to-point operations (``batch_isend_irecv``; V5's
neighbour exchange) and :func:`halo_exchange_gathered` is one
``all_gather`` across the ranks (V4's staged halo). Under ``gloo`` the
rows are staged through host memory, counted in :data:`WIRE` ``staged``;
under ``nccl`` CUDA tensors go device to device (``device``). Each rank
counts one collective a call, as the one-process mesh does, so every
rank's counts are the one-process counts at the same N.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

# Collectives run since the last reset, by the JAX primitive each stands for.
COLLECTIVES = {"ppermute": 0, "all_gather": 0, "all_to_all": 0, "psum": 0, "reduce_scatter": 0}
# Bytes this rank sent and received across ranks since the last reset: through host memory (gloo) or not (nccl).
WIRE = {"staged": 0, "device": 0}


def reset_collectives() -> None:
    for counts in (COLLECTIVES, WIRE):
        for name in counts:
            counts[name] = 0


def to_wire(t: torch.Tensor, mesh, sent: bool = True) -> torch.Tensor:
    """``t`` as the group's backend takes it (contiguous; on the host under
    gloo), its bytes counted in :data:`WIRE` when it is ``sent``."""
    staged = mesh.backend == "gloo"
    WIRE["staged" if staged else "device"] += t.numel() * t.element_size() if sent else 0
    return t.contiguous().cpu() if staged else t.contiguous()


def wire_buffer(like: torch.Tensor, mesh) -> torch.Tensor:
    """An empty receive buffer of ``like``'s shape and dtype where the
    backend writes it, its bytes counted in :data:`WIRE`."""
    staged = mesh.backend == "gloo"
    WIRE["staged" if staged else "device"] += like.numel() * like.element_size()
    return torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device)


def is_ranked(mesh) -> bool:
    return mesh is not None and mesh.owners is not None


def shift(blocks: Sequence[Optional[torch.Tensor]], k: int, take, mesh=None) -> List[Optional[torch.Tensor]]:
    """One ``ppermute`` by ``k`` slots: shard ``j`` receives ``take(blocks[j - k])``
    on its device (zeros of that shape where ``j - k`` is off the mesh).
    Across ranks: the entries of this rank's slots (None for the others'),
    a slot's rows sent to another rank's slot point to point."""
    n = len(blocks)
    COLLECTIVES["ppermute"] += 1
    if not is_ranked(mesh):
        return [take(blocks[j - k]).to(own.device, non_blocking=True) if 0 <= j - k < n
                else torch.zeros_like(take(own)) for j, own in enumerate(blocks)]
    dist = torch.distributed
    out: List[Optional[torch.Tensor]] = [None] * n
    ops, recv = [], {}
    for j in range(n):  # every rank walks the slots in one order, so the pairs' messages line up
        src = j - k
        if mesh.is_local(j):
            own = blocks[j]
            if not 0 <= src < n:
                out[j] = torch.zeros_like(take(own))
            elif mesh.is_local(src):
                out[j] = take(blocks[src]).to(own.device, non_blocking=True)
            else:
                recv[j] = wire_buffer(take(own), mesh)
                ops.append(dist.P2POp(dist.irecv, recv[j], mesh.owners[src], tag=j))
        elif 0 <= src < n and mesh.is_local(src):
            ops.append(dist.P2POp(dist.isend, to_wire(take(blocks[src]), mesh), mesh.owners[j], tag=j))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for j, buf in recv.items():
        out[j] = buf.to(blocks[j].device)
    return out


def halo_exchange(blocks: Sequence[Optional[torch.Tensor]], h_top: int, h_bot: int,
                  mesh=None) -> List[Optional[torch.Tensor]]:
    """Each shard's (N, B, W, C) block with its neighbours' halos on axis 1:
    (N, h_top + B + h_bot, W, C). Shard 0's top and shard n-1's bottom are
    zeros. A halo wider than one block is fetched multi-hop: hop ``k``
    takes from the shard ``k`` away, the farthest only the rows still
    missing. Across ranks (``mesh``), this rank's slots' entries."""
    b = next(t for t in blocks if t is not None).shape[1]
    parts: List[List[torch.Tensor]] = []
    if h_top > 0:
        k_top = -(-h_top // b)
        for k in range(k_top, 0, -1):  # the farthest neighbour first (the topmost rows)
            rows = h_top - (k - 1) * b if k == k_top else b
            parts.append(shift(blocks, k, lambda t, r=rows: t[:, t.shape[1] - r:], mesh))
    parts.append(list(blocks))
    if h_bot > 0:
        k_bot = -(-h_bot // b)
        for k in range(1, k_bot + 1):
            rows = h_bot - (k - 1) * b if k == k_bot else b
            parts.append(shift(blocks, -k, lambda t, r=rows: t[:, :r], mesh))
    if len(parts) == 1:
        return list(blocks)
    return [None if blocks[j] is None else torch.cat([p[j] for p in parts], dim=1) for j in range(len(blocks))]


def halo_exchange_gathered(blocks: Sequence[Optional[torch.Tensor]], h_top: int, h_bot: int,
                           mesh=None) -> List[Optional[torch.Tensor]]:
    """The staged halo: one ``all_gather`` of every block to every shard,
    zero rows at both ends, then each shard slices its rows and halos.
    Moves n*B rows a shard instead of h_top + h_bot. Across ranks
    (``mesh``): each rank's run of blocks, joined, gathered from every rank
    once (:func:`gather_rows`)."""
    if h_top == 0 and h_bot == 0:
        return list(blocks)
    COLLECTIVES["all_gather"] += 1
    b = next(t for t in blocks if t is not None).shape[1]
    whole = gather_rows(blocks, mesh, blocks[mesh.local_slots[0]].device) if is_ranked(mesh) else None
    out = []
    for j, own in enumerate(blocks):
        if own is None:
            out.append(None)
            continue
        full = (whole.to(own.device, non_blocking=True) if whole is not None
                else torch.cat([t.to(own.device, non_blocking=True) for t in blocks], dim=1))
        padded = torch.nn.functional.pad(full, (0, 0, 0, 0, h_top, h_bot))
        out.append(padded[:, j * b : j * b + h_top + b + h_bot])
    return out


def gather_rows(parts: Sequence[Optional[torch.Tensor]], mesh, device, dim: int = 1) -> torch.Tensor:
    """Every slot's part, joined on ``dim`` in slot order, on ``device``:
    this rank's run (its slots' parts joined) all-gathered from every rank
    (one ``torch.distributed.all_gather``; not counted in
    :data:`COLLECTIVES`, whose callers count the SPMD collective)."""
    mine = torch.cat([parts[i].to(device, non_blocking=True) for i in mesh.local_slots], dim=dim)
    wire = to_wire(mine, mesh)
    bufs = [wire_buffer(mine, mesh) if r != mesh.rank else wire for r in range(mesh.world)]
    torch.distributed.all_gather(bufs, wire)
    return torch.cat([t.to(device) for t in bufs], dim=dim)


def gather_to_rank0(parts: Sequence[Optional[torch.Tensor]], mesh, device, dim: int = 1) -> Optional[torch.Tensor]:
    """Every slot's part joined on ``dim`` in slot order on rank 0's
    ``device`` (a ``torch.distributed.gather`` of each rank's run); None on
    the other ranks. The output's gather: the JAX program's out_specs, not a
    collective of its body, so not counted."""
    mine = to_wire(torch.cat([parts[i].to(device, non_blocking=True) for i in mesh.local_slots], dim=dim), mesh,
                   sent=mesh.rank != 0)
    if mesh.rank != 0:
        torch.distributed.gather(mine, None, dst=0)
        return None
    bufs = [mine] + [wire_buffer(mine, mesh) for _ in range(mesh.world - 1)]
    torch.distributed.gather(mine, bufs, dst=0)
    return torch.cat([t.to(device) for t in bufs], dim=dim)


def exchange(staged: bool):
    return halo_exchange_gathered if staged else halo_exchange
