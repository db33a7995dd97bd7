"""FSDP / ZeRO-style parameter sharding over a ``dp`` mesh axis.

Plain data parallelism replicates every parameter (and its optimizer
state) on every slot; FSDP splits each leaf over the same axis the batch
is split over, so parameter, gradient and optimizer-state memory scale as
1/dp while the math stays data parallelism. The JAX package's
``parallel/fsdp.py`` annotates each leaf with a ``PartitionSpec`` and lets
GSPMD insert the collectives. Here the placement is explicit, as in
``tensor_parallel.shard_lm_params_tp``: a sharded leaf becomes
:class:`Pieces`, the list of its dp slots' contiguous pieces (piece ``j``
on the ``j``-th "dp" slot), which records the dim it was split on. The
list is a node of the params tree, so ``utils/tree``, ``utils/optim.adam``
and the checkpoint see one leaf a slot, and Adam (elementwise) updates
each piece as its part of the whole leaf would be updated.

The step (``models.transformer.lm_loss`` and ``forward_lm`` on such a
tree): the batch is split over the dp slots; each slot gathers every
sharded leaf whole onto itself (:func:`all_gather`, one ``all_gather`` a
leaf for the mesh, counted in ``halo.COLLECTIVES``) and runs the loss on
its B/dp rows; the step's loss is the mean of the slots' losses. The
gradients flow back through the gather: each piece receives the sum over
the slots of its slice of their gradients, in slot order, which is the
reduce-scatter (one ``reduce_scatter`` a leaf). On a ``(dp, sp)`` mesh
each dp row's slots run the row's ring or Ulysses attention. A leaf with
no dp-divisible dim stays whole on the home slot, as the JAX package
replicates it.

A MoE layer under FSDP routes each slot's tokens on that slot (its
capacity from the slot's B/dp rows), as the pipelined MoE routes a
microbatch: GSPMD's routing over the global batch is not reproduced.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..utils.tree import tree_leaves, tree_map
from .halo import COLLECTIVES
from .mesh import Mesh, make_mesh

Params = Any


class Pieces(list):
    """A leaf split over the slots of mesh axis ``axis`` ("dp" for FSDP,
    "ep" for ``parallel.expert``'s expert stacks): its contiguous pieces
    along ``dim``, piece ``j`` on the ``j``-th slot of that axis."""

    def __init__(self, pieces: Sequence[torch.Tensor] = (), dim: int = 0, axis: str = "dp"):
        super().__init__(pieces)
        self.dim, self.axis = dim, axis

    def rebuild(self, children) -> "Pieces":
        return Pieces(children, self.dim, self.axis)

    def whole(self, device=None) -> torch.Tensor:
        """The leaf, its pieces joined on ``device`` (default the first piece's)."""
        dev = device if device is not None else self[0].device
        return torch.cat([p.to(dev) for p in self], dim=self.dim)


def fsdp_spec(shape, dp: int, axis_name: str = "dp") -> Tuple[Optional[str], ...]:
    """The partition spec of a leaf of ``shape``: ``axis_name`` on its
    LARGEST dp-divisible dim, ``None`` elsewhere (the JAX package's
    ``PartitionSpec`` as a tuple); ``()`` for a leaf with no divisible dim
    or no dims, which stays replicated."""
    if not shape:
        return ()
    order = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
    for i in order:
        if shape[i] % dp == 0 and shape[i] >= dp:
            return tuple(axis_name if j == i else None for j in range(len(shape)))
    return ()


def shard_params_fsdp(params: Params, mesh: Optional[Mesh] = None, *, n_shards: int = 0,
                      axis_name: str = "dp") -> Params:
    """Every leaf split per :func:`fsdp_spec` over the mesh's ``axis_name``
    slots (default: a mesh of ``n_shards`` slots on the params' device
    type): a sharded leaf becomes :class:`Pieces`, piece ``j`` on the
    ``j``-th ``axis_name`` slot; a replicated one moves whole to the mesh's
    first slot."""
    if mesh is None:
        mesh = make_mesh(n_shards, axis_name=axis_name, device=tree_leaves(params)[0].device.type)
    dp = mesh.axis_size(axis_name)
    if dp is None:
        raise ValueError(f"axis {axis_name!r} not in mesh axes {tuple(mesh.axis_names)}")
    devs, home = mesh.axis_groups(axis_name)[0], mesh.devices[0]

    def put(leaf):
        spec = fsdp_spec(tuple(leaf.shape), dp, axis_name)
        if not spec:
            return leaf.to(home)
        return split_leaf(leaf, spec.index(axis_name), devs, axis_name)

    return tree_map(put, params)


def split_leaf(leaf: torch.Tensor, dim: int, devices: Sequence[torch.device], axis: str) -> Pieces:
    """``leaf`` in ``len(devices)`` contiguous pieces along ``dim``, piece ``j`` on ``devices[j]``."""
    return Pieces([piece.to(dev, memory_format=torch.contiguous_format, copy=True)
                   for piece, dev in zip(torch.chunk(leaf, len(devices), dim=dim), devices)], dim, axis)


def _pieces_leaves(params: Params) -> List[Any]:
    """The tree's leaves with each :class:`Pieces` whole (one entry)."""
    if isinstance(params, Pieces):
        return [params]
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _pieces_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [x for v in params for x in _pieces_leaves(v)]
    return [params]


def _map_pieces(fn, params: Params) -> Params:
    """``fn`` over the tree's leaves, a :class:`Pieces` taken whole."""
    if isinstance(params, Pieces):
        return fn(params)
    if isinstance(params, dict):
        return {k: _map_pieces(fn, v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_map_pieces(fn, v) for v in params)
    return fn(params)


def has_pieces(params: Params, axis: Optional[str] = None) -> bool:
    """Whether the tree holds a leaf split over ``axis`` (any axis: None)."""
    return any(isinstance(leaf, Pieces) and axis in (None, leaf.axis) for leaf in _pieces_leaves(params))


def sharded_fraction(params: Params, axis_name: str = "dp") -> float:
    """The fraction of parameter BYTES whose leaf is split over
    ``axis_name`` (:class:`Pieces`), replicated stragglers counted against
    it: the honest memory-scaling number."""
    total = sharded = 0
    for leaf in _pieces_leaves(params):
        parts = leaf if isinstance(leaf, Pieces) else [leaf]
        n = sum(p.numel() * p.element_size() for p in parts)
        total += n
        if isinstance(leaf, Pieces) and leaf.axis == axis_name:
            sharded += n
    return sharded / total if total else 0.0


def gather_params(params: Params, device=None) -> Params:
    """The whole tree: each :class:`Pieces` joined (on ``device``, default
    its first piece's), the rest as it is; a tree without pieces comes back
    unchanged. Not counted: this is the tree leaving the mesh (decode,
    ``--save-params``), not a step's collective."""
    return _map_pieces(lambda leaf: leaf.whole(device) if isinstance(leaf, Pieces) else leaf, params)


class _AllGather(torch.autograd.Function):
    """One leaf's pieces gathered whole onto every slot of ``devices``; the
    backward is the reduce-scatter: piece ``j``'s gradient is the sum, in
    slot order, of slice ``j`` of every slot's gradient."""

    @staticmethod
    def forward(ctx, dim, devices, *pieces):
        ctx.dim, ctx.sizes, ctx.piece_devices = dim, [p.shape[dim] for p in pieces], [p.device for p in pieces]
        COLLECTIVES["all_gather"] += 1
        return tuple(torch.cat([p.to(dev) for p in pieces], dim=dim) for dev in devices)

    @staticmethod
    def backward(ctx, *grads):
        COLLECTIVES["reduce_scatter"] += 1
        out = []
        for j, (size, dev) in enumerate(zip(ctx.sizes, ctx.piece_devices)):
            start = sum(ctx.sizes[:j])
            total = None
            for g in grads:
                if g is None:
                    continue
                part = g.narrow(ctx.dim, start, size).to(dev)
                total = part if total is None else total + part
            out.append(total)
        return (None, None, *out)


class _PerSlot:
    """One leaf's copies, one a slot (a leaf of the tree, not a node)."""

    def __init__(self, copies):
        self.copies = copies


def all_gather(params: Params, devices: Sequence[torch.device]) -> List[Params]:
    """One whole tree a slot of ``devices``: every :class:`Pieces` gathered
    onto each slot (:class:`_AllGather`, differentiable), every other leaf
    moved there."""
    def gather(leaf):
        if isinstance(leaf, Pieces):
            return _PerSlot(_AllGather.apply(leaf.dim, tuple(devices), *leaf))
        return _PerSlot([leaf.to(dev) for dev in devices])

    gathered = _map_pieces(gather, params)
    return [_map_pieces(lambda leaf, s=s: leaf.copies[s], gathered) for s in range(len(devices))]


def run_slots(params: Params, tokens: torch.Tensor, mesh: Optional[Mesh], fn) -> List[Any]:
    """``fn(whole_params, rows, row_mesh)`` on every dp slot of an FSDP
    tree (its "dp" pieces' devices, piece ``j`` on slot ``j``): slot ``i``
    takes block ``i`` of the batch's rows and the tree gathered onto it
    (:func:`all_gather`), and its dp row's mesh (:func:`row_meshes`).
    Returns the slots' results in slot order."""
    first = next(leaf for leaf in _pieces_leaves(params) if isinstance(leaf, Pieces) and leaf.axis == "dp")
    devices = tuple(p.device for p in first)
    rows = split_batch(tokens, devices)
    trees = all_gather(params, devices)
    return [fn(tree, blk, m) for tree, blk, m in zip(trees, rows, row_meshes(mesh, len(devices)))]


def row_meshes(mesh: Optional[Mesh], dp: int) -> List[Optional[Mesh]]:
    """The mesh each dp row's attention runs over: on a ``(dp, sp)`` mesh
    row ``i``'s "sp" slots, as a one-axis mesh; otherwise none."""
    if mesh is None or "sp" not in mesh.axis_names or len(mesh.shape) == 1:
        return [None] * dp
    groups = mesh.axis_groups("sp")
    if len(groups) != dp:
        raise ValueError(f"mesh has {len(groups)} dp rows, the params {dp} dp pieces")
    return [Mesh(("sp",), (len(g),), tuple(g)) for g in groups]


def split_batch(tokens: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The batch's rows in ``len(devices)`` contiguous blocks, block ``i`` on slot ``i``."""
    b, dp = tokens.shape[0], len(devices)
    if b % dp:
        raise ValueError(f"batch {b} not divisible by the dp axis ({dp} slots)")
    return [blk.to(dev) for blk, dev in zip(torch.chunk(tokens, dp, dim=0), devices)]
