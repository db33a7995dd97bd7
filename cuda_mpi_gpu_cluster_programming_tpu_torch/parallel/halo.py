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
"""

from __future__ import annotations

from typing import List, Sequence

import torch

# Collectives run since the last reset, by the JAX primitive each stands for.
COLLECTIVES = {"ppermute": 0, "all_gather": 0, "all_to_all": 0, "psum": 0, "reduce_scatter": 0}


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def _shift(blocks: Sequence[torch.Tensor], k: int, take) -> List[torch.Tensor]:
    """One ``ppermute`` by ``k`` slots: shard ``j`` receives ``take(blocks[j - k])``
    on its device (zeros of that shape where ``j - k`` is off the mesh)."""
    n = len(blocks)
    COLLECTIVES["ppermute"] += 1
    out = []
    for j, own in enumerate(blocks):
        if 0 <= j - k < n:
            out.append(take(blocks[j - k]).to(own.device, non_blocking=True))
        else:
            out.append(torch.zeros_like(take(own)))
    return out


def halo_exchange(blocks: Sequence[torch.Tensor], h_top: int, h_bot: int) -> List[torch.Tensor]:
    """Each shard's (N, B, W, C) block with its neighbours' halos on axis 1:
    (N, h_top + B + h_bot, W, C). Shard 0's top and shard n-1's bottom are
    zeros. A halo wider than one block is fetched multi-hop: hop ``k``
    takes from the shard ``k`` away, the farthest only the rows still
    missing."""
    b = blocks[0].shape[1]
    parts: List[List[torch.Tensor]] = []
    if h_top > 0:
        k_top = -(-h_top // b)
        for k in range(k_top, 0, -1):  # the farthest neighbour first (the topmost rows)
            rows = h_top - (k - 1) * b if k == k_top else b
            parts.append(_shift(blocks, k, lambda t, r=rows: t[:, t.shape[1] - r:]))
    parts.append(list(blocks))
    if h_bot > 0:
        k_bot = -(-h_bot // b)
        for k in range(1, k_bot + 1):
            rows = h_bot - (k - 1) * b if k == k_bot else b
            parts.append(_shift(blocks, -k, lambda t, r=rows: t[:, :r]))
    if len(parts) == 1:
        return list(blocks)
    return [torch.cat([p[j] for p in parts], dim=1) for j in range(len(blocks))]


def halo_exchange_gathered(blocks: Sequence[torch.Tensor], h_top: int, h_bot: int) -> List[torch.Tensor]:
    """The staged halo: one ``all_gather`` of every block to every shard,
    zero rows at both ends, then each shard slices its rows and halos.
    Moves n*B rows a shard instead of h_top + h_bot."""
    if h_top == 0 and h_bot == 0:
        return list(blocks)
    COLLECTIVES["all_gather"] += 1
    b = blocks[0].shape[1]
    out = []
    for j, own in enumerate(blocks):
        full = torch.cat([t.to(own.device, non_blocking=True) for t in blocks], dim=1)
        padded = torch.nn.functional.pad(full, (0, 0, 0, 0, h_top, h_bot))
        out.append(padded[:, j * b : j * b + h_top + b + h_bot])
    return out


def exchange(staged: bool):
    return halo_exchange_gathered if staged else halo_exchange
