"""Row-sharded forward pass with exact ownership: V2.2, V4, V5 and the
spatial half of V6 sharded.

The JAX package's ``parallel/sharded.py`` runs the layer chain inside
``shard_map``; the original course code scatters image rows, exchanges
halos over MPI and trims. Here one controller walks the chain layer by
layer over the list of per-shard blocks (``mesh.py``), and each spatial
layer is:

1. exchange the halos of every block (``halo.py``: neighbour copies, or
   the all_gather staged variant);
2. append ``pad_bot`` zero rows, take each shard's window at
   ``s0 = i*s0_coef + s0_const`` (a Python int, :func:`shard_windows`) and
   run the op VALID on H (W padding stays inside the op);
3. zero the rows the shard does not own (the mask invariant that makes the
   halo zeros the conv's global zero padding).

Each shard computes exactly the output rows it owns (``plan.py``), so
nothing is trimmed. Shards that share a device run in order on its current
stream.

Across ranks (a mesh of ``parallel/distributed.py``'s process group: the
course's ``mpirun`` layer), each rank takes the whole input, as each JAX
process does, keeps the rows of its own slots and computes only those;
the halos cross rank boundaries (``halo.py``) and rank 0 gathers the
output. The other ranks' forward returns None.

Tiers: ``reference`` (``ops/reference.py``: cuDNN on the card) or
``kernels`` (the conv and pool kernels of ``ops/kernel_model.py`` on every
shard, the counterpart of the JAX package's Pallas tier). The LRN is the
reference op on both tiers and ReLU follows the mask, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..models.alexnet import BLOCKS12
from ..models.init import params_to
from ..ops import reference as ops
from .halo import exchange, gather_to_rank0
from .mesh import Mesh, make_mesh
from .plan import LayerPlan, make_shard_plan

AXIS = "sp"


def _row_mask(b_out: int, l_out: int, i: int, dtype, device) -> Optional[torch.Tensor]:
    """(1, b_out, 1, 1) 1/0 mask of the output rows shard ``i`` owns, or
    None where it owns all of them (multiplying by 1 changes no bit)."""
    if (i + 1) * b_out <= l_out:
        return None
    g = i * b_out + torch.arange(b_out, device=device)
    return (g < l_out).to(dtype).reshape(1, b_out, 1, 1)


def shard_windows(lp: LayerPlan, blocks, staged: bool = False, mesh=None):
    """Each shard's contiguous (N, win_rows, W, C) input window of layer
    ``lp``: its block with the halos exchanged and ``pad_bot`` zero rows
    appended, from the row ``s0`` (clamped into the buffer, as
    ``lax.dynamic_slice`` clamps it; only a shard that owns nothing needs
    the clamp). Across ranks (``mesh``), None for another rank's slot."""
    wins = []
    for i, buf in enumerate(exchange(staged)(blocks, lp.h_top, lp.h_bot, mesh)):
        if buf is None:
            wins.append(None)
            continue
        if lp.pad_bot:
            buf = F.pad(buf, (0, 0, 0, 0, 0, lp.pad_bot))
        s0 = min(max(i * lp.s0_coef + lp.s0_const, 0), buf.shape[1] - lp.win_rows)
        wins.append(buf[:, s0 : s0 + lp.win_rows].contiguous())
    return wins


def _apply_spatial(lp: LayerPlan, blocks, params_on, spec, conv_fn: Callable, pool_fn: Callable, staged: bool,
                   mesh=None):
    """One conv or pool layer over every shard's (N, b_in, W, C) block (this
    rank's, across ranks)."""
    out = []
    for i, win in enumerate(shard_windows(lp, blocks, staged, mesh)):
        if win is None:
            out.append(None)
            continue
        if lp.kind == "conv":
            p = params_on[win.device][lp.name]
            if "scale" in p:
                # int8w: int8-valued weights in bf16 (exact), a zero bias, then
                # the fp32 rescale and bias BEFORE the mask (the mask zeroes the
                # rows a shard does not own; a bias after it would revive them)
                zb = torch.zeros(p["b"].shape, dtype=torch.bfloat16, device=win.device)
                y = conv_fn(win.to(torch.bfloat16), p["w"].to(torch.bfloat16), zb, stride=spec.stride,
                            padding_w=spec.padding).float()
                y = y * p["scale"] + p["b"].float()
            else:
                y = conv_fn(win, p["w"], p["b"], stride=spec.stride, padding_w=spec.padding)
        else:
            y = pool_fn(win, window=spec.window, stride=spec.stride)
        # y has exactly b_out rows: (win_rows - F) // S + 1 == b_out
        mask = _row_mask(lp.b_out, lp.l_out, i, y.dtype, y.device)
        out.append(y if mask is None else y * mask)
    return out


def _conv_hvalid(x, w, b, *, stride: int, padding_w: int):
    """The reference tier's conv: VALID on H (the halos hold the rows),
    padded on W, bias added, no ReLU."""
    return ops.conv2d(x, w, b, stride=stride, padding=(0, padding_w))


def _pool_hvalid(x, *, window: int, stride: int):
    return ops.maxpool(x, window=window, stride=stride)


def _kernel_fns(v):
    """The kernels tier's conv (VALID on H, padded on W, ReLU off: the mask
    comes first) and pool under one layer's variants."""
    from ..ops import kernel_model as km

    def conv(x, w, b, *, stride, padding_w):
        return km.conv(x, w, b, stride=stride, padding=0, padding_w=padding_w, relu=False,
                       variant=v.conv, k_block=v.k_block)

    return conv, functools.partial(km.pool, variant=v.pool)


def build_sharded_forward(
    model_cfg=BLOCKS12,
    n_shards: int = 1,
    mesh: Optional[Mesh] = None,
    tier: str = "reference",
    staged: bool = False,
    with_digests: bool = False,
    plan=None,
    quantized: bool = False,
    variants=None,
    device: str = "cuda",
    differentiable: bool = False,
) -> Callable:
    """``(params, x) -> out`` running row-sharded over ``n_shards`` slots.

    ``x`` is the whole (N, H, W, C) batch on its home device and the output
    the whole (N, H', W', C') result there: each shard's rows go to its
    slot's device and come back (scatter and gather). ``params`` are copied
    once a call to each distinct device of the mesh (no copy on the home
    device). ``mesh`` defaults to ``make_mesh(n_shards, device=device)``.

    ``model_cfg``: Blocks 1-2, or full AlexNet's spatial chain (conv1..pool5).
    ``tier``: ``reference`` or ``kernels``. ``staged``: the all_gather halo
    (``v4_hybrid``) instead of neighbour copies (``v5_collective``).
    ``variants`` (kernels tier): a ``KernelVariants`` or ``LayerVariants``;
    None resolves the ``TPU_FRAMEWORK_*`` environment now, overlaid with
    ``plan`` (a ``tuning.plan.TunePlan``); a conv's variants also govern the
    pool it feeds. ``fuse`` does not apply on this path and is ignored, as in
    the JAX package; the reference tier ignores them all.

    ``quantized``: the int8w policy sharded. Conv params quantize inside the
    call from the fp32 tree; each shard convolves bf16 activations with the
    int8 values in bf16 and a zero bias, rescales in fp32 and adds the bias
    before the mask; activations are bf16 between stages, and the LRN and
    the output fp32.

    ``with_digests``: the JAX package's sentinel taps. The function returns
    ``(out, {layer: (n_shards,) float32})``: one ``tree_digest`` of each
    shard's block at every Conv1/Pool1/Conv2/Pool2/LRN2 boundary (the
    conv's after its ReLU), on the home device, computed on the device
    beside the forward (no host sync; ``resilience.sentinel.StageDigests``
    screens them off the timed path). The output's bits are the same with
    and without them.

    ``differentiable``: run with autograd (the training step's forward,
    ``training.make_train_step``); by default the forward runs in
    inference mode.

    A mesh across ranks: each rank keeps its slots' rows of ``x`` and
    computes them; rank 0 returns the whole output, the others None. The
    digests and autograd are one process's (ValueError across ranks)."""
    if tier not in ("reference", "kernels"):
        raise ValueError(f"tier must be reference|kernels, got {tier!r}")
    mesh = mesh or make_mesh(n_shards, axis_name=AXIS, device=device)
    if mesh.n_shards != n_shards or mesh.dp != 1:
        raise ValueError(f"mesh {mesh.shape} does not give {n_shards} row shards on one data-parallel replica")
    ranked = mesh.owners is not None
    if ranked and (with_digests or differentiable):
        raise ValueError("the sentinel digests and autograd run in one process; a mesh across ranks has neither")
    n = n_shards
    splan = make_shard_plan(model_cfg, n)
    devs = mesh.shard_devices

    if tier == "kernels":
        from ..ops.variants import KernelVariants, LayerVariants

        kv = variants
        if kv is None:
            kv = KernelVariants.resolve()
            if plan is not None:
                from ..tuning.plan import effective_layer_variants

                kv = effective_layer_variants(plan, base=kv)
        layer_fns = {}
        governing = kv.default if isinstance(kv, LayerVariants) else kv
        for lp in splan.layers:
            if lp.kind == "conv":
                governing = kv.for_layer(lp.name) if isinstance(kv, LayerVariants) else kv
            layer_fns[lp.name] = _kernel_fns(governing)
    else:
        layer_fns = {lp.name: (_conv_hvalid, _pool_hvalid) for lp in splan.layers}

    specs = dict(model_cfg.layer_chain())
    h_pad = n * splan.layers[0].b_in  # equal blocks: H padded to n * b0
    b0, l_final = splan.layers[0].b_in, splan.l_final

    if with_digests:
        from ..resilience.sentinel import shard_digests

    def fwd(params, x):
        if quantized:
            from ..precision.quantize import quantize_conv_params

            # "w" carries the int8 values, "scale" marks the entry quantized
            params = {name: {"w": e["q"], "scale": e["scale"], "b": e["b"]}
                      for name, e in quantize_conv_params(params).items()}
            x = x.to(torch.bfloat16)
        params_on = {d: params_to(params, device=d) for d in mesh.distinct_devices}
        if x.shape[1] < h_pad:
            x = F.pad(x, (0, 0, 0, 0, 0, h_pad - x.shape[1]))
        blocks = [x[:, i * b0 : (i + 1) * b0].to(d, non_blocking=True) if mesh.is_local(i) else None
                  for i, d in enumerate(devs)]

        def each(fn, bs):
            return [None if b is None else fn(b) for b in bs]

        digs = {}
        for lp in splan.layers:
            spec = specs[lp.name]
            if lp.kind == "pointwise":
                # int8w: the LRN computes in fp32 (squares and pow need the headroom)
                blocks = each(lambda b: ops.lrn(b.float() if quantized else b, size=spec.size, alpha=spec.alpha,
                                                beta=spec.beta, k=spec.k, alpha_over_size=spec.alpha_over_size),
                              blocks)
            else:
                conv_fn, pool_fn = layer_fns[lp.name]
                blocks = _apply_spatial(lp, blocks, params_on, spec, conv_fn, pool_fn, staged, mesh)
                if lp.kind == "conv":
                    blocks = each(ops.relu, blocks)
                    if quantized:
                        blocks = each(lambda b: b.to(torch.bfloat16), blocks)  # bf16 between quantized stages
            if with_digests:
                digs[lp.name] = shard_digests(blocks).to(x.device, non_blocking=True)
        home = x.device
        if ranked:
            out = gather_to_rank0(blocks, mesh, home)
            return None if out is None else out[:, :l_final]
        out = torch.cat([b.to(home, non_blocking=True) for b in blocks], dim=1)[:, :l_final]
        return (out, digs) if with_digests else out

    return fwd if differentiable else torch.inference_mode()(fwd)
