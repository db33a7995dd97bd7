"""Expert parallelism: the MoE expert axis split over an ``ep`` mesh axis.

The JAX package's ``parallel/expert.py`` annotates the expert-stacked
weights (E, D, F) / (E, F, D) as sharded over "ep" and lets GSPMD
partition ``models.transformer.moe_ffn``'s einsums, inserting the
all-to-alls that move token slots to their expert's device and back. Here
the placement is explicit: :func:`shard_moe_params` splits each expert
stack along E into ``parallel.fsdp.Pieces`` (axis "ep"; piece ``j``, the
``j``-th E/ep experts, on the ``j``-th "ep" slot), and ``moe_ffn`` runs such
a layer through :func:`expert_ffn`: the ``(E, C, D)`` dispatch tensor goes
to the slots (one ``all_to_all``), each slot runs its experts' two
einsums, and the ``(E, C, D)`` outputs come back (a second ``all_to_all``)
before the combine. Routing, capacity and the aux loss stay on the home
slot, unchanged. Each expert's products are the unsharded layer's, so the
ep forward is the replicated one up to the einsums' summation order.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from .fsdp import Pieces, split_leaf
from .halo import COLLECTIVES
from .mesh import Mesh, make_mesh

Params = Any

# Expert-stacked param leaves (leading axis = expert) by key name.
_EXPERT_KEYS = {"w_up", "w_down"}


def shard_moe_params(params: Params, mesh: Optional[Mesh] = None, *, n_shards: int = 0,
                     axis_name: str = "ep") -> Params:
    """The LM params with every expert leaf (``w_up``/``w_down`` of rank
    >= 3) split along E over the mesh's ``axis_name`` slots (default: a
    mesh of ``n_shards`` slots on the params' device type) and every other
    leaf whole on the mesh's first slot. For a dense model (no expert
    leaves) this is the whole tree on that slot. The expert count must
    divide by the axis size, raised eagerly."""
    if mesh is None:
        mesh = make_mesh(n_shards, axis_name=axis_name, device=params["embed"].device.type)
    ep = mesh.axis_size(axis_name)
    if ep is None:
        raise ValueError(f"axis {axis_name!r} not in mesh axes {tuple(mesh.axis_names)}")
    devs, home = mesh.axis_groups(axis_name)[0], mesh.devices[0]

    def put(node, key=None):
        if isinstance(node, dict):
            return {k: put(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(put(v, key) for v in node)
        if key in _EXPERT_KEYS and node.ndim >= 3:
            if node.shape[0] % ep:
                raise ValueError(f"{node.shape[0]} experts not divisible by {ep} '{axis_name}' shards")
            return split_leaf(node, 0, devs, axis_name)
        return node.to(home)

    return put(params)


def expert_ffn(xin: torch.Tensor, w_up: Sequence[torch.Tensor], w_down: Sequence[torch.Tensor],
               act: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The experts' FFN on the ``(E, C, D)`` dispatch tensor with the
    expert stacks in ep pieces: slot ``j`` takes its E/ep experts' rows
    (``all_to_all``), computes ``act(x @ w_up) @ w_down`` for each, and the
    ``(E, C, D)`` outputs come back to ``xin``'s device (``all_to_all``)."""
    COLLECTIVES["all_to_all"] += 1
    outs, start = [], 0
    for wu, wd in zip(w_up, w_down):
        n = wu.shape[0]
        x = xin[start:start + n].to(wu.device, non_blocking=True)
        outs.append(torch.einsum("ecf,efd->ecd", act(torch.einsum("ecd,edf->ecf", x, wu)), wd))
        start += n
    COLLECTIVES["all_to_all"] += 1
    return torch.cat([o.to(xin.device, non_blocking=True) for o in outs], dim=0)


def is_expert_sharded(leaf: Any) -> bool:
    return isinstance(leaf, Pieces) and leaf.axis != "dp"


def make_ep_train_step(cfg, mesh: Mesh, optimizer=None, lr: float = 1e-3):
    """``(init_fn, step_fn)`` for expert-sharded params
    (:func:`shard_moe_params`). EP needs no step code of its own, only the
    placement, which the params carry (``mesh`` is taken for the JAX
    package's signature): the shared step factory's autograd reaches each
    expert piece on its slot, and Adam keeps the pieces on their slots."""
    from ..models.transformer import make_lm_train_step

    return make_lm_train_step(cfg, optimizer=optimizer, lr=lr)
