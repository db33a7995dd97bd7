"""Symmetric per-output-channel int8 weight quantization and the
dequant-free forward (the ``int8w`` policy).

The JAX package's ``precision/quantize.py`` with the same cast points:

- **Calibration** from the weights themselves (no dataset): the forward
  quantizes its fp32 params every call, so two runs with the same params
  quantize identically.
- **Per output channel, symmetric**: for weights whose last axis is the
  output channel, ``scale[k] = max|w[..., k]| / 127`` (1.0 for an all-zero
  channel) and ``q = clip(round(w / scale), -127, 127)`` as int8;
  ``torch.round`` rounds half to even, as ``jnp.round`` does.
- **Dequant-free compute**: the contraction runs on the raw int8 values
  widened to bf16-exact fp32 with bf16 activations and fp32 accumulation;
  ``scale`` multiplies the conv's fp32 output once, before bias and ReLU:
  ``relu(conv(x_bf16, q) * scale + b)``, then bf16 for the next stage.

Tiers: ``reference`` runs ``ops.reference.conv2d`` with an fp32
accumulator; ``kernels`` runs the conv kernel of the layer's ``v.conv``
(with ``v.k_block``) with its epilogue off (``relu=False``, zero bf16
bias), which writes bf16, then rescales in fp32 here, then the pool kernel
of ``v.pool``, as the JAX package passes its variants on. The staged chain
ends in the reference LRN in fp32, as the JAX package's does: per forward
the kernel tier launches two convs, two pools and no LRN kernel. With
``fuse="block"`` each block is one ``conv_block`` launch instead
(``ops.megakernel.int8w_conv_block``). hpool is not an int8w route: its
epilogue would pool before the rescale (``tuning.space`` prunes it).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.alexnet import BLOCKS12, Blocks12Config
from ..ops import kernel_model as km
from ..ops import megakernel as mk
from ..ops import reference as ops
from ..ops.kernel_model import _layer_variants
from ..ops.shapes import conv_out_dim
from ..ops.variants import KernelVariants

QMAX = 127  # symmetric int8: [-127, 127]; -128 is unused (no zero-point)


def quantize_channelwise(w: torch.Tensor, qmax: int = QMAX) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q_int8, scale_fp32)`` for a weight tensor whose LAST axis is the
    output-channel axis."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(w.dim() - 1)))
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 reconstruction (for error checks; the forward never calls it)."""
    return q.float() * scale


def quantize_conv_params(params) -> dict:
    """Per-layer ``{"q", "scale", "b"}`` for every conv entry of a Blocks
    1-2 param dict; biases stay as they are (added after the rescale)."""
    out = {}
    for name, p in params.items():
        if isinstance(p, dict) and "w" in p:
            q, scale = quantize_channelwise(p["w"])
            out[name] = {"q": q, "scale": scale, "b": p["b"]}
    return out


def int8w_conv(
    x: torch.Tensor,
    q: torch.Tensor,
    scale: torch.Tensor,
    b: torch.Tensor,
    *,
    stride: int,
    padding: int,
    relu: bool = True,
    tier: str = "reference",
    variants: KernelVariants | None = None,
) -> torch.Tensor:
    """One dequant-free int8-weight conv: ``relu(conv(x, q)*scale + b)`` in
    fp32, returned in bf16. ``x`` enters in (or is cast to) bf16."""
    xq = x.to(torch.bfloat16)
    wq = q.to(torch.bfloat16)  # exact for |q| <= 127
    if tier == "kernels":
        v = variants if variants is not None else KernelVariants()
        # Epilogue off: the rescale lands between accumulation and bias.
        y = km.conv(
            xq, wq, torch.zeros(q.shape[-1], dtype=torch.bfloat16, device=x.device),
            stride=stride, padding=padding, relu=False, variant=v.conv, k_block=v.k_block,
        ).float()
    else:
        y = ops.conv2d(
            xq, wq, torch.zeros(q.shape[-1], dtype=torch.float32, device=x.device),
            stride=stride, padding=padding, preferred_element_type=torch.float32,
        )
    y = y * scale + b.float()
    if relu:
        y = ops.relu(y)
    return y.to(torch.bfloat16)


def _lrn_fp32(x: torch.Tensor, lrn) -> torch.Tensor:
    return ops.lrn(
        x.float(), size=lrn.size, alpha=lrn.alpha, beta=lrn.beta, k=lrn.k,
        alpha_over_size=lrn.alpha_over_size,
    )


def _pool(x: torch.Tensor, pspec, tier: str, v: KernelVariants | None) -> torch.Tensor:
    """The pool of :func:`int8w_conv`'s ReLU output; on the reference tier
    ``relu_maxpool``, whose ReLU leaves that output as it is and takes the
    place of ``maxpool``'s zero-sign fix."""
    if tier == "kernels":
        return km.pool(x, window=pspec.window, stride=pspec.stride, variant=v.pool if v is not None else "sep2")
    return ops.relu_maxpool(x, window=pspec.window, stride=pspec.stride)


def int8w_conv_then_pool(x, q, scale, b, cspec, pspec, v=None, *, tier="kernels", lrn=None):
    """The int8w block: conv + rescale + bias + ReLU, the max-pool, and the
    trailing LRN when ``lrn`` is given. ``v.fuse == "block"`` on the kernel
    tier runs the whole block as one ``conv_block`` launch where the gate
    allows it; otherwise the staged chain with the reference LRN in fp32."""
    if tier == "kernels" and v is not None and v.fuse == "block":
        ho = conv_out_dim(x.shape[1], cspec.filter_size, cspec.padding, cspec.stride)
        if not mk.block_fusible_reason(
            variant=v.conv, row_block=v.row_block, k_block=v.k_block,
            pool=v.pool, out_h=ho, pool_window=pspec.window,
        ):
            return mk.int8w_conv_block(
                x, q, scale, b, stride=cspec.stride, padding=cspec.padding,
                pool_window=pspec.window, pool_stride=pspec.stride,
                lrn=lrn, variant=v.conv, row_block=v.row_block,
            )
    y = int8w_conv(
        x, q, scale, b, stride=cspec.stride, padding=cspec.padding,
        relu=True, tier=tier, variants=v,
    )
    out = _pool(y, pspec, tier, v)
    return _lrn_fp32(out, lrn) if lrn is not None else out


def forward_blocks12_int8w(
    params,
    x: torch.Tensor,
    cfg: Blocks12Config = BLOCKS12,
    variants=None,
    tier: str = "reference",
    taps: bool = False,
):
    """Blocks 1-2 forward under ``int8w`` on either tier (``reference`` or
    ``kernels``), from fp32 params quantized here. Activations are bf16
    between stages; LRN computes in fp32 and the output is fp32.

    ``taps=True`` also returns ``{stage: fp32 tensor}`` at every layer
    boundary (the surface ``ToleranceGate.screen`` compares); taps always
    take the staged chain, which has those boundaries."""
    qp = quantize_conv_params(params)
    c1, p1, c2, p2, n2 = cfg.conv1, cfg.pool1, cfg.conv2, cfg.pool2, cfg.lrn2
    v = variants if variants is not None else KernelVariants()
    stages = {}

    if tier == "kernels" and not taps and any(
        _layer_variants(v, n).fuse == "block" for n in ("conv1", "conv2")
    ):
        e1, e2 = qp["conv1"], qp["conv2"]
        cur = int8w_conv_then_pool(
            x.to(torch.bfloat16), e1["q"], e1["scale"], e1["b"], c1, p1, _layer_variants(v, "conv1"), tier=tier,
        )
        return int8w_conv_then_pool(
            cur, e2["q"], e2["scale"], e2["b"], c2, p2, _layer_variants(v, "conv2"), tier=tier, lrn=n2,
        )

    cur = x.to(torch.bfloat16)
    for cname, cspec, pname, pspec in (("conv1", c1, "pool1", p1), ("conv2", c2, "pool2", p2)):
        e = qp[cname]
        cur = int8w_conv(
            cur, e["q"], e["scale"], e["b"], stride=cspec.stride, padding=cspec.padding,
            relu=True, tier=tier, variants=_layer_variants(v, cname),
        )
        if taps:
            stages[cname] = cur.float()
        cur = _pool(cur, pspec, tier, _layer_variants(v, cname))
        if taps:
            stages[pname] = cur.float()
    out = _lrn_fp32(cur, n2)
    if taps:
        stages["lrn2"] = out
        return out, stages
    return out


def roundtrip_error_bound(w: torch.Tensor) -> torch.Tensor:
    """Elementwise quantization error bound, ``scale/2`` broadcast to the
    weight shape."""
    _q, scale = quantize_channelwise(w)
    return torch.broadcast_to(scale / 2.0, w.shape)
