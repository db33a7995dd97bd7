"""Replicate-all execution: V2.1, the anti-baseline.

The original course code's V2.1 broadcasts the whole input and every
parameter to every rank, and every rank computes the whole forward pass: it
exists to show negative scaling. The JAX package replicates the operands
over an N-device mesh; here every shard slot runs the whole forward on its
own device, in order. On one card that costs N times one pass, which is the
point of the configuration and is kept.
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
    supervisor screens their spread)."""
    mesh = mesh or make_mesh(n_shards, device=device)
    if mesh.n_shards != n_shards:
        raise ValueError(f"mesh {mesh.shape} does not give {n_shards} replicas")
    if quantized:
        from ..precision.quantize import forward_blocks12_int8w

        def model_fwd(p, x):
            return forward_blocks12_int8w(p, x, model_cfg, tier="reference")
    else:
        def model_fwd(p, x):
            return forward_blocks12(p, x, model_cfg)

    @torch.inference_mode()
    def fwd(params, x):
        outs = [model_fwd(params_to(params, device=d), x.to(d, non_blocking=True)) for d in mesh.shard_devices]
        if with_digests:
            from ..resilience.sentinel import shard_digests

            return outs[0].to(x.device), {"out": shard_digests(outs).to(x.device)}
        return outs[0].to(x.device)

    return fwd
