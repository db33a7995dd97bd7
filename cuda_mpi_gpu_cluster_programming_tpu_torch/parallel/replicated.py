"""Replicate-all execution: V2.1, the anti-baseline.

The original course code's V2.1 broadcasts the whole input and every
parameter to every rank, and every rank computes the whole forward pass: it
exists to show negative scaling. The JAX package replicates the operands
over an N-device mesh; here every shard slot runs the whole forward on its
own device, in order. On one card that costs N times one pass, which is the
point of the configuration and is kept. Across ranks (a mesh of
``parallel/distributed.py``'s process group) rank 0 broadcasts the input
and every parameter, each rank's slots run the whole forward, and rank 0's
output is the result (the other ranks return None).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.alexnet import BLOCKS12, forward_blocks12
from ..models.init import params_to
from .mesh import Mesh, make_mesh


def build_replicated_forward(
    model_cfg=BLOCKS12, n_shards: int = 1, mesh: Optional[Mesh] = None, quantized: bool = False,
    device: str = "cuda", with_digests: bool = False,
) -> Callable:
    """``(params, x) -> out``: every slot copies the params and the input to
    its device (the broadcast) and runs the whole forward; slot 0's result
    comes back to the input's device. ``quantized``: the int8w forward
    (``precision.quantize.forward_blocks12_int8w``, reference tier) on every
    replica, each quantizing the same fp32 tree to the same int8 values.
    ``with_digests``: ``(out, {"out": (n_shards,) float32})``, one
    ``tree_digest`` of each replica's output (copies that must agree: the
    supervisor screens their spread); one process's only."""
    mesh = mesh or make_mesh(n_shards, device=device)
    if mesh.n_shards != n_shards:
        raise ValueError(f"mesh {mesh.shape} does not give {n_shards} replicas")
    ranked = mesh.owners is not None
    if ranked and with_digests:
        raise ValueError("the sentinel digests run in one process; a mesh across ranks has none")
    if quantized:
        from ..precision.quantize import forward_blocks12_int8w

        def model_fwd(p, x):
            return forward_blocks12_int8w(p, x, model_cfg, tier="reference")
    else:
        def model_fwd(p, x):
            return forward_blocks12(p, x, model_cfg)

    @torch.inference_mode()
    def fwd(params, x):
        if ranked:
            params, x = _broadcast_from_rank0((params, x), mesh)
            outs = [model_fwd(params_to(params, device=mesh.devices[i]), x.to(mesh.devices[i], non_blocking=True))
                    for i in mesh.local_slots]
            return outs[0].to(x.device) if mesh.rank == 0 else None
        outs = [model_fwd(params_to(params, device=d), x.to(d, non_blocking=True)) for d in mesh.shard_devices]
        if with_digests:
            from ..resilience.sentinel import shard_digests

            return outs[0].to(x.device), {"out": shard_digests(outs).to(x.device)}
        return outs[0].to(x.device)

    return fwd


def _broadcast_from_rank0(tree, mesh):
    """``tree`` (dicts, tuples, tensors) as rank 0 holds it, on every rank:
    one ``torch.distributed.broadcast`` a tensor (through host memory under
    gloo, counted in ``halo.WIRE``) into a new tensor on each receiving
    rank, moved to the device of that rank's own tensor."""
    from .halo import to_wire, wire_buffer

    if isinstance(tree, dict):
        return {k: _broadcast_from_rank0(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_broadcast_from_rank0(v, mesh) for v in tree)
    wire = to_wire(tree, mesh) if mesh.rank == 0 else wire_buffer(tree, mesh)
    torch.distributed.broadcast(wire, src=0)
    return wire.to(tree.device)
