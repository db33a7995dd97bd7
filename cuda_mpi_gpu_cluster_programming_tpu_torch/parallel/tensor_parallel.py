"""Tensor parallelism: the conv filter bank split on its output-channel (K)
axis, ``v7_tp``.

The dual of the row-sharded tier (``sharded.py``): there the activations
are split on H and the weights replicated, with halos in image rows; here
each shard owns K/n output channels of every conv, so the weights are split
and the activations gathered at the block boundary, with the "halo" on the
channel axis (the LRN's window needs ``size//2`` neighbour channels). The
JAX package's ``parallel/tensor_parallel.py`` (``build_tp_forward``), as one
controller over the mesh's shard slots:

- block 1 on each shard's filter slice: (B, h, w, K1/n);
- one ``all_gather`` of pool1's channels to every shard (conv2 needs all of
  conv1's channels);
- block 2 on each shard's slice; a channel halo (two ``ppermute``: the
  previous shard's last ``half`` channels, the next shard's first) before
  the LRN, zeros at the ends, which is the LRN's edge-cut window; the owned
  slice is kept.

Every output channel is computed by one shard in the single-device order,
so the result is the reference forward's. Reference ops on every shard.
Across ranks (a mesh of ``parallel/distributed.py``'s process group) each
rank computes its slots' channels, the ``all_gather`` and the two
``ppermute`` cross the ranks (``halo.gather_rows``, ``halo.shift``), and
rank 0 gathers the output's channels; with no ``psum`` on this path the
output stays bitwise the one-process one.

The transformer LM's Megatron layout (:func:`shard_lm_params_tp`, the JAX
package's function of that name): column-parallel ``wqkv`` and ``w_up``,
row-parallel ``wo`` and ``w_down``, the rest replicated. In the JAX
package the placement is the whole implementation and GSPMD inserts the
two all-reduces a block; here a sharded leaf becomes a list of its tp
slots' pieces, each on its slot's device, and ``models.transformer``'s
decoder block runs each slot's heads and ``d_ff/tp`` slice of the FFN and
sums the partial products of ``wo`` and ``w_down`` over the slots
(:func:`psum`). The list is a node of the params tree, so ``tree_leaves``
and the optimizer see one leaf a slot; Adam is elementwise, so each piece
updates as its part of the whole leaf would. The ``psum`` adds the slots'
partials in slot order, so the TP forward is the unsharded one within
rounding, not bit for bit (the JAX package holds its TP forward to rtol
2e-5, atol 1e-5 of the unsharded one). :func:`gather_lm_params_tp` joins
the pieces back into the JAX tree's layout.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from ..models.alexnet import BLOCKS12
from ..models.init import params_to
from ..ops import reference as ops
from .halo import COLLECTIVES, shift, gather_rows, gather_to_rank0
from .mesh import Mesh, make_mesh


def _channel_halo(zs, half: int, mesh=None):
    """Each shard's (..., C) slice with ``half`` neighbour channels on each
    side: the previous shard's last, the next shard's first; zeros at the
    ends of the mesh. Two ``ppermute``s (across ranks, this rank's slots)."""
    left = shift(zs, 1, lambda t: t[..., -half:], mesh)
    right = shift(zs, -1, lambda t: t[..., :half], mesh)
    return [None if z is None else torch.cat([a, z, b], dim=-1) for a, z, b in zip(left, zs, right)]


def build_tp_forward(
    model_cfg=BLOCKS12, n_shards: int = 1, mesh: Optional[Mesh] = None, axis_name: str = "tp",
    with_digests: bool = False, device: str = "cuda", differentiable: bool = False,
) -> Callable:
    """``(params, x) -> out`` with the conv filters split n ways on K.

    Refuses (``ValueError``) a K not divisible by ``n_shards``, an LRN
    half-window wider than conv2's local channels, and a mesh whose shard
    axis is not ``n_shards`` long. ``with_digests``: also return the JAX
    package's taps, ``{layer: (n_shards,) float32}``, one ``tree_digest``
    of each shard's local channel slice at every Conv1/Pool1/Conv2/Pool2/
    LRN2 boundary, on the input's device (the output's bits do not move).
    ``differentiable``: autograd on (the training step's forward). A mesh
    across ranks: rank 0 returns the output, the others None (neither
    digests nor autograd there)."""
    cfg = model_cfg
    for name, spec in (("conv1", cfg.conv1), ("conv2", cfg.conv2)):
        if spec.out_channels % n_shards:
            raise ValueError(f"{name} K={spec.out_channels} not divisible by {n_shards} TP shards")
    half = cfg.lrn2.size // 2
    local1, local2 = cfg.conv1.out_channels // n_shards, cfg.conv2.out_channels // n_shards
    if n_shards > 1 and local2 < half:
        raise ValueError(f"LRN window half-width {half} exceeds the {local2} local channels "
                         f"at {n_shards} shards — channel halo would need multi-hop")
    if mesh is None:
        mesh = make_mesh(n_shards, axis_name=axis_name, device=device)
    elif mesh.n_shards != n_shards:
        raise ValueError(f"mesh axis {mesh.axis_names[-1]!r} has {mesh.n_shards} devices but "
                         f"tp n_shards={n_shards}; the filter slices would not line up")
    devs = mesh.shard_devices
    ranked = mesh.owners is not None
    if ranked and (with_digests or differentiable):
        raise ValueError("the sentinel digests and autograd run in one process; a mesh across ranks has neither")
    local = mesh.local_slots
    c1, p1, c2, p2, n2 = cfg.conv1, cfg.pool1, cfg.conv2, cfg.pool2, cfg.lrn2

    if with_digests:
        from ..resilience.sentinel import shard_digests

    def block(x, p, i, local, cspec, pspec, taps=None):
        sl = slice(i * local, (i + 1) * local)
        y = ops.conv2d(x, p["w"][..., sl], p["b"][sl], stride=cspec.stride, padding=cspec.padding)
        if taps is not None:
            taps.append(ops.relu(y))  # the conv's tap after its ReLU; the pooled value below is unchanged
        return ops.relu_maxpool(y, window=pspec.window, stride=pspec.stride)

    def fwd(params, x):
        digs, t1, t2 = {}, ([] if with_digests else None), ([] if with_digests else None)
        on = {d: params_to(params, device=d) for d in mesh.distinct_devices}
        ys = [block(x.to(d, non_blocking=True), on[d]["conv1"], i, local1, c1, p1, t1) if i in local else None
              for i, d in enumerate(devs)]
        if with_digests:
            digs["conv1"], digs["pool1"] = shard_digests(t1).to(x.device), shard_digests(ys).to(x.device)
        COLLECTIVES["all_gather"] += 1  # conv2 contracts over every conv1 channel
        if ranked:
            whole = gather_rows(ys, mesh, devs[local[0]], dim=-1)
            ys = [whole.to(d, non_blocking=True) if i in local else None for i, d in enumerate(devs)]
        else:
            ys = [torch.cat([y.to(d, non_blocking=True) for y in ys], dim=-1) for d in devs]
        zs = [block(y, on[d]["conv2"], i, local2, c2, p2, t2) if i in local else None
              for i, (y, d) in enumerate(zip(ys, devs))]
        if with_digests:
            digs["conv2"], digs["pool2"] = shard_digests(t2).to(x.device), shard_digests(zs).to(x.device)
        if n_shards > 1:
            zs = _channel_halo(zs, half, mesh)
        outs = [None if z is None else ops.lrn(z, size=n2.size, alpha=n2.alpha, beta=n2.beta, k=n2.k,
                                               alpha_over_size=n2.alpha_over_size) for z in zs]
        if n_shards > 1:
            outs = [None if o is None else o[..., half:-half] for o in outs]
        if with_digests:
            digs["lrn2"] = shard_digests(outs).to(x.device)
        if ranked:
            return gather_to_rank0(outs, mesh, x.device, dim=-1)
        out = torch.cat([o.to(x.device, non_blocking=True) for o in outs], dim=-1)
        return (out, digs) if with_digests else out

    return fwd if differentiable else torch.inference_mode()(fwd)


# --- Megatron-style tensor parallelism for the transformer LM family ----

_LM_TP_SPECS = {
    "wqkv": "tp_col",  # (D, 3, D) -> shard the last (per-projection) dim
    "w_up": "tp_col",  # (D, F)    -> shard the output dim
    "wo": "tp_row",  # (D, D)    -> shard the input dim
    "w_down": "tp_row",  # (F, D)    -> shard the input dim
}


def _lm_tp_dim(key, leaf) -> Optional[int]:
    """The dim a leaf splits on, None for a replicated one. The ndim rules
    keep this the dense Megatron layout: ``wqkv`` is the (D, 3, D) rank-3
    exception (split on the last dim, so the q/k/v boundaries stay aligned);
    MoE expert stacks share the ``w_up``/``w_down`` names at rank 3 but
    belong to the "ep" axis, so they stay replicated."""
    if key == "wqkv" and leaf.ndim == 3:
        return 2
    kind = _LM_TP_SPECS.get(key)
    if kind is not None and leaf.ndim == 2:
        return 1 if kind == "tp_col" else 0
    return None


def _map_keyed(fn, tree, key=None):
    """``fn(key, leaf)`` over a params tree, ``key`` the dict key a leaf (or
    a list of tp pieces, which ``fn`` receives whole) hangs from."""
    if isinstance(tree, dict):
        return {k: (fn(k, v) if k in _LM_TP_SPECS and isinstance(v, (list, tuple)) else _map_keyed(fn, v, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_keyed(fn, v, key) for v in tree)
    return fn(key, tree)


def shard_lm_params_tp(params, mesh: Optional[Mesh] = None, *, n_shards: int = 0, axis_name: str = "tp"):
    """The transformer LM's params in the Megatron TP layout over the mesh's
    ``axis_name`` slots (default: a mesh of ``n_shards`` slots on the
    params' device type).

    Column-parallel matrices split their last dim, row-parallel their
    first, into a list of contiguous pieces, piece ``j`` on the ``j``-th
    ``axis_name`` slot of the mesh's first row; embeddings, the position
    table, norms and MoE expert stacks stay whole on the mesh's first
    device. Divisibility is validated leaf by leaf, in the JAX package's
    words."""
    if mesh is None:
        mesh = make_mesh(n_shards, axis_name=axis_name, device=params["embed"].device.type)
    tp = mesh.axis_size(axis_name)
    if tp is None:
        raise ValueError(f"axis {axis_name!r} not in mesh axes {tuple(mesh.axis_names)}")
    devs, home = mesh.axis_groups(axis_name)[0], mesh.devices[0]

    def put(key, leaf):
        dim = _lm_tp_dim(key, leaf)
        if dim is None:
            return leaf.to(home)
        if leaf.shape[dim] % tp:
            raise ValueError(f"{key} dim {dim} size {leaf.shape[dim]} not divisible by {tp} '{axis_name}' shards")
        return [piece.to(dev, memory_format=torch.contiguous_format, copy=True)
                for piece, dev in zip(torch.chunk(leaf, tp, dim=dim), devs)]

    return _map_keyed(put, params)


def gather_lm_params_tp(params, device=None) -> Any:
    """The whole params tree of :func:`shard_lm_params_tp`'s pieces: each
    sharded leaf the concatenation of its pieces (on ``device``, default the
    first piece's), the rest as they are; a tree without pieces comes back
    unchanged."""

    def join(key, leaf):
        if not isinstance(leaf, (list, tuple)):
            return leaf
        dev = device if device is not None else leaf[0].device
        return torch.cat([p.to(dev) for p in leaf], dim=_lm_tp_dim(key, leaf[0]))

    return _map_keyed(join, params)


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The tensor-parallel all-reduce of one block's row-parallel product:
    the slots' partial sums added in slot order on ``device`` (one ``psum``
    of the SPMD program; its broadcast half is each slot's next read)."""
    COLLECTIVES["psum"] += 1
    total = parts[0].to(device, non_blocking=True)
    for part in parts[1:]:
        total = total + part.to(device, non_blocking=True)
    return total
