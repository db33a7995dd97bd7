"""Decoder-only transformer LM: forward, loss, training step and KV-cache decode.

The port of the JAX package's ``models/transformer.py``. Pre-norm decoder
blocks with RMSNorm, learned positions, a weight-tied head, and a
pluggable attention op:

- ``attn_impl="reference"``: the O(L^2) oracle (``ops.attention``);
- ``attn_impl="flash"``: the hand-written flash kernels
  (``ops.flash_attention``: one ``flash_fwd`` launch per layer forward,
  one ``flash_dq`` and one ``flash_dkv`` per layer backward);
- ``attn_impl="ring"``/``"ulysses"``: sequence parallel over ``sp_shards``
  slots of the mesh (``parallel.sequence_parallel``), each slot's block
  through ``attn_engine`` (``einsum``, or ``flash``: the flash kernels on
  every hop or slot), heads split over ``sp_head_axis`` when it is set.

``forward_lm``, ``lm_loss`` and ``make_lm_train_step`` take the mesh the
sequence-parallel attention runs over, and params in either layout: the
whole tree, or ``parallel.tensor_parallel.shard_lm_params_tp``'s Megatron
layout, whose decoder block runs each tp slot's heads and FFN slice and
sums the row-parallel products over the slots (two ``psum`` reductions a dense
block). ``parallel.fsdp.shard_params_fsdp``'s FSDP layout (every leaf in
its dp slots' pieces) splits the batch over the dp slots, each slot
running the forward on its rows with the params gathered onto it;
``parallel.expert.shard_moe_params``' layout runs each MoE layer's experts
on their "ep" slots; ``parallel.pipeline`` stages the decoder blocks.
Decode and generation run on one device, as in the JAX package (split
params are joined first).

The FFN is dense, or a Switch-style top-1 mixture of experts
(``n_experts > 0``) with a capacity limit and dense one-hot dispatch.

Params keep the JAX tree's layout: a dict of tensors with the same keys
and shapes (``wqkv`` is (D, 3, D)), so ``lm_params_from_jax`` carries a
JAX tree over as is. :class:`TransformerLM` owns them as ``nn.Parameter``s.
The plain matrix products stay ``torch.matmul``/``einsum``, as the JAX
package leaves them to XLA. Norms and softmax statistics are fp32; fp32
products are true fp32 on the card (TF32 off, set by each entry point).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import NEG_INF, attention
from ..ops.reference import true_fp32
from ..utils.optim import adam, apply_updates
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .init import _tensor_from_array

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256  # byte-level LM by default
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_len: int = 1024
    attn_impl: str = "reference"  # reference | flash | ring | ulysses
    sp_shards: int = 1  # ring/ulysses mesh size
    sp_head_axis: Optional[str] = None
    attn_engine: str = "einsum"  # within-shard engine for ring/ulysses

    def __post_init__(self):
        if self.attn_engine not in ("einsum", "flash"):
            raise ValueError(f"attn_engine must be einsum|flash, got {self.attn_engine!r}")
    # Mixture-of-experts FFN (0 = dense): top-1 (Switch) routing with a capacity limit.
    n_experts: int = 0
    capacity_factor: float = 1.25
    # Rematerialization: each decoder block runs under torch.utils.checkpoint
    # (the JAX package's jax.checkpoint), so the backward recomputes the
    # block's activations instead of keeping them: one more forward of work
    # for activation memory O(B L D) instead of O(n_layers B L D).
    remat: bool = False

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


TINY_LM = TransformerConfig()


def init_transformer(
    cfg: TransformerConfig = TINY_LM, *, generator: torch.Generator, dtype=torch.float32, device="cuda",
) -> Params:
    """Scaled-normal init (1/sqrt(fan_in); output projections /sqrt(2 L)),
    the JAX package's distributions, drawn on the CPU from ``generator``
    (so the draw does not depend on the device) and moved to ``device``
    (CUDA unless the caller asks for the CPU; without a GPU it raises).
    JAX's PRNG is not reproduced: ``lm_params_from_jax`` carries a JAX
    tree over where the same weights are needed."""
    from ..configs import resolve_device

    device = resolve_device(device)

    def dense(fan_in, shape, scale=1.0):
        w = torch.randn(shape, generator=generator, dtype=torch.float32) * scale / math.sqrt(fan_in)
        return w.to(device=device, dtype=dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    d = cfg.d_model
    params: Params = {
        "embed": dense(1, (cfg.vocab, d)),
        "pos": dense(1, (cfg.max_len, d)) * 0.02,
        "final_norm": {"g": ones(d)},
        "layers": [],
    }
    resid_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": {"g": ones(d)},
            "wqkv": dense(d, (d, 3, d)),
            "wo": dense(d, (d, d), resid_scale),
            "mlp_norm": {"g": ones(d)},
        }
        if cfg.n_experts:
            e = cfg.n_experts
            layer["router"] = dense(d, (d, e))
            layer["w_up"] = dense(d, (e, d, cfg.d_ff))
            layer["w_down"] = dense(cfg.d_ff, (e, cfg.d_ff, d), resid_scale)
        else:
            layer["w_up"] = dense(d, (d, cfg.d_ff))
            layer["w_down"] = dense(cfg.d_ff, (cfg.d_ff, d), resid_scale)
        params["layers"].append(layer)
    return params


def lm_params_from_jax(tree: Any, device="cuda") -> Params:
    """The JAX package's LM params (its tree, leaves as numpy arrays or
    anything ``np.asarray`` takes) as the port's: the same nesting, each
    leaf a tensor of the same shape and dtype (bf16 through fp32, exact)."""
    return tree_map(lambda a: _tensor_from_array(a, device), tree)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS layer norm, statistics in fp32; cast back to x's dtype, then
    times ``g`` (the JAX package's order)."""
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * g


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default is the exact erf
    return F.gelu(x, approximate="tanh")


def _attend(q, k, v, cfg: TransformerConfig, mesh=None):
    if cfg.attn_impl == "reference":
        return attention(q, k, v, causal=True)
    if cfg.attn_impl == "flash":
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True)
    if cfg.attn_impl == "ring":
        from ..parallel.sequence_parallel import ring_attention

        return ring_attention(q, k, v, n_shards=cfg.sp_shards, causal=True, mesh=mesh,
                              head_axis=cfg.sp_head_axis, engine=cfg.attn_engine)
    if cfg.attn_impl == "ulysses":
        from ..parallel.sequence_parallel import ulysses_attention

        return ulysses_attention(q, k, v, n_shards=cfg.sp_shards, causal=True, mesh=mesh,
                                 head_axis=cfg.sp_head_axis, engine=cfg.attn_engine)
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def moe_ffn(layer: Params, h: torch.Tensor, cfg: TransformerConfig, return_aux: bool = False):
    """Top-1 (Switch) mixture-of-experts FFN with a capacity limit.

    Routing is fp32/int throughout (the queue positions come from an fp32
    cumsum); tokens past an expert's capacity ``max(1, int(cf * T / E))``
    are dropped (the residual carries them). Dispatch and combine are
    dense one-hot einsums in h's dtype; experts in "ep" pieces
    (``parallel.expert``) run on their slots. ``return_aux`` also returns
    the Switch load-balance loss ``E * sum_e f_e * P_e``."""
    b, l, d = h.shape
    e = cfg.n_experts
    t = b * l
    cap = max(1, int(cfg.capacity_factor * t / e))
    hf = h.reshape(t, d)
    router_logits = hf.float() @ layer["router"].float()
    gates = torch.softmax(router_logits, dim=-1)  # (T, E) fp32
    idx = torch.argmax(gates, dim=-1)  # (T,) top-1 expert
    gate = torch.gather(gates, 1, idx[:, None])[:, 0]  # (T,) fp32
    onehot = F.one_hot(idx, e).float()  # (T, E)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - onehot) * onehot, dim=-1).to(torch.int64)
    keep = (pos < cap).float()
    # jax.nn.one_hot gives a zero row for an index past cap; F.one_hot would raise
    slot = (pos[:, None] == torch.arange(cap, device=h.device)[None, :]).float()  # (T, C)
    dispatch = (onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]).to(h.dtype)
    xin = torch.einsum("tec,td->ecd", dispatch, hf)  # (E, C, D)
    from ..parallel.expert import expert_ffn, is_expert_sharded

    if is_expert_sharded(layer["w_up"]):  # the experts on their "ep" slots
        out_e = expert_ffn(xin, layer["w_up"], layer["w_down"], _gelu)
    else:
        hidden = _gelu(torch.einsum("ecd,edf->ecf", xin, layer["w_up"]))
        out_e = torch.einsum("ecf,efd->ecd", hidden, layer["w_down"])  # (E, C, D)
    combine = dispatch * gate[:, None, None].to(h.dtype)
    out = torch.einsum("tec,ecd->td", combine, out_e).reshape(b, l, d)
    if not return_aux:
        return out
    f_e = torch.mean(onehot, dim=0)  # fraction routed to each expert (pre-capacity)
    p_e = torch.mean(gates, dim=0)  # mean router probability
    return out, e * torch.sum(f_e * p_e)


def _qkv(h: torch.Tensor, wqkv: torch.Tensor, cfg: TransformerConfig):
    """q, k, v of shape (B, L, H, Dh): views into one (B, L, 3, D) product,
    whose last axis is contiguous (the flash kernel reads them in place)."""
    b, l, d = h.shape
    qkv = (h @ wqkv.reshape(d, 3 * d)).view(b, l, 3, d)
    shape = (b, l, cfg.n_heads, cfg.head_dim)
    return qkv[:, :, 0].view(shape), qkv[:, :, 1].view(shape), qkv[:, :, 2].view(shape)


def _tp_attention(layer: Params, h: torch.Tensor, cfg: TransformerConfig, mesh):
    """The column-parallel half of a TP block: each tp slot's q, k, v for
    its H/tp heads (from its ``wqkv`` piece) and their attention, on that
    slot; a sequence-parallel attention gets the heads joined on h's
    device and splits them over its own slot groups. Returns each slot's
    (B, L, D/tp) output, on its slot."""
    b, l, d = h.shape
    tp = len(layer["wqkv"])
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads {cfg.n_heads} not divisible by {tp} tp shards: a head would span two slots")
    dl, shape = d // tp, (b, l, cfg.n_heads // tp, cfg.head_dim)
    qkvs = []
    for w in layer["wqkv"]:
        qkv = (h.to(w.device, non_blocking=True) @ w.reshape(d, 3 * dl)).view(b, l, 3, dl)
        qkvs.append(tuple(qkv[:, :, i].view(shape) for i in range(3)))
    if cfg.attn_impl in ("reference", "flash"):
        return [_attend(q, k, v, cfg).reshape(b, l, dl) for q, k, v in qkvs]
    joined = [torch.cat([t[i].to(h.device, non_blocking=True) for t in qkvs], dim=2) for i in range(3)]
    out = _attend(*joined, cfg, mesh).reshape(b, l, d)
    return [out[..., j * dl:(j + 1) * dl].to(w.device, non_blocking=True) for j, w in enumerate(layer["wqkv"])]


def decoder_block(layer: Params, x: torch.Tensor, *, cfg: TransformerConfig, mesh=None, return_aux: bool = False):
    """One pre-norm decoder block: attention + (dense | MoE) FFN. ``mesh``:
    the slots a ring or Ulysses attention runs over. A layer in the TP
    layout (pieces a slot) runs its heads and its dense FFN's ``d_ff/tp``
    slice on each tp slot and sums the row-parallel products of ``wo`` and
    ``w_down`` over the slots (``psum``) on x's device, where the
    replicated norms and a MoE FFN (its experts belong to "ep", not "tp")
    run whole."""
    from ..parallel.tensor_parallel import psum

    b, l, _ = x.shape
    tp = isinstance(layer["wqkv"], list)
    h = rmsnorm(x, layer["attn_norm"]["g"])
    if tp:
        x = x + psum([o @ w for o, w in zip(_tp_attention(layer, h, cfg, mesh), layer["wo"])], x.device)
    else:
        out = _attend(*_qkv(h, layer["wqkv"], cfg), cfg, mesh)
        x = x + out.reshape(b, l, cfg.d_model) @ layer["wo"]
    h = rmsnorm(x, layer["mlp_norm"]["g"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.n_experts:
        ffn, aux = moe_ffn(layer, h, cfg, return_aux=True)
        x = x + ffn
    elif tp:
        x = x + psum([_gelu(h.to(wu.device, non_blocking=True) @ wu) @ wd
                      for wu, wd in zip(layer["w_up"], layer["w_down"])], x.device)
    else:
        x = x + _gelu(h @ layer["w_up"]) @ layer["w_down"]
    return (x, aux) if return_aux else x


def forward_lm(params: Params, tokens: torch.Tensor, cfg: TransformerConfig = TINY_LM, mesh=None,
               return_aux: bool = False):
    """tokens (B, L) integers -> logits (B, L, vocab). Causal, weight-tied
    head. ``mesh``: the slots of a ring or Ulysses attention (default: a
    mesh of ``sp_shards`` slots on the tokens' device type). ``return_aux``
    also returns the mean MoE load-balance loss over layers (0.0 for dense
    configs). FSDP params: the batch split over their dp slots, each
    slot's rows through the gathered tree on that slot, over its dp row of
    a ``(dp, sp)`` mesh; the logits joined on the tokens' device, the aux
    the slots' mean."""
    from ..parallel import fsdp

    if fsdp.has_pieces(params, "dp"):
        outs = fsdp.run_slots(params, tokens, mesh, lambda p, t, m: forward_lm(p, t, cfg, m, return_aux=True))
        logits = torch.cat([o.to(tokens.device) for o, _ in outs], dim=0)
        if return_aux:
            return logits, torch.stack([a.to(tokens.device) for _, a in outs]).mean()
        return logits
    l = tokens.shape[1]
    if l > cfg.max_len:
        raise ValueError(f"sequence length {l} exceeds max_len {cfg.max_len}")
    true_fp32(params["embed"].device)
    x = params["embed"][tokens.long()] + params["pos"][:l][None]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(lyr, h):
        return decoder_block(lyr, h, cfg=cfg, mesh=mesh, return_aux=True)

    for layer in params["layers"]:
        if cfg.remat:
            x, aux = torch.utils.checkpoint.checkpoint(block, layer, x, use_reentrant=False)
        else:
            x, aux = block(layer, x)
        aux_total = aux_total + aux
    x = rmsnorm(x, params["final_norm"]["g"])
    logits = x @ params["embed"].T  # weight-tied LM head
    if return_aux:
        return logits, aux_total / max(1, cfg.n_layers)
    return logits


def lm_loss(params: Params, tokens: torch.Tensor, cfg: TransformerConfig = TINY_LM, mesh=None,
            aux_coef: float = 0.01):
    """Next-token cross-entropy (fp32), mean over (B, L-1); MoE configs add
    ``aux_coef`` x the Switch load-balance loss. FSDP params: each dp
    slot's loss on its rows, as :func:`forward_lm` splits them, and their
    mean on the tokens' device."""
    from ..parallel import fsdp

    if fsdp.has_pieces(params, "dp"):
        losses = fsdp.run_slots(params, tokens, mesh, lambda p, t, m: lm_loss(p, t, cfg, m, aux_coef))
        return torch.stack([x.to(tokens.device) for x in losses]).mean()
    logits, aux = forward_lm(params, tokens[:, :-1], cfg, mesh, return_aux=True)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, tokens[:, 1:].long()[..., None])[..., 0]
    loss = -torch.mean(ll)
    if cfg.n_experts:
        loss = loss + aux_coef * aux
    return loss


def make_lm_train_step(
    cfg: TransformerConfig = TINY_LM, mesh=None, optimizer=None, lr: float = 1e-3, loss_fn=None,
    accum_steps: int = 1, compute_dtype=None,
):
    """``(init_fn, step_fn)`` for LM training.

    ``mesh``: the slots of a ring or Ulysses attention, as in
    :func:`forward_lm`. TP params (``shard_lm_params_tp``) train as they
    are: the gradient of each piece is its slot's, and the optimizer
    updates the pieces (Adam is elementwise). As in the JAX package's step
    on a ``(dp, ...)`` mesh, the whole batch is one step's: for params that
    are not FSDP's the data-parallel axis only places it (here on the
    mesh's first row of slots). FSDP params (``parallel.fsdp``) split it:
    each dp slot runs the loss on its B/dp rows with the params gathered
    onto it, the step's loss is the slots' mean, the gradients reach each
    piece through the gather (the reduce-scatter) and Adam updates the
    pieces. Expert-sharded params (``parallel.expert``) train as they are.

    ``optimizer`` is an ``(init, update)`` pair in optax's convention
    (default ``utils.optim.adam(lr)``, optax's arithmetic). ``loss_fn(params,
    tokens)`` overrides ``lm_loss``. ``step_fn(params, opt_state, tokens)``
    returns ``(params, opt_state, loss)``: new param tensors (the old ones
    are left as they were) and the fp32 loss.

    ``accum_steps > 1``: the batch is split into that many microbatches;
    their gradients are summed at the params' (master) precision, then
    divided by ``accum_steps``, before one optimizer update: the full-batch
    step up to rounding, at one microbatch's activation memory.

    ``compute_dtype=torch.bfloat16``: mixed precision with fp32 masters.
    The params are cast to bf16 once a step, the forward and backward run
    at bf16 (the flash kernels on bf16 operands), and the gradients are
    cast back to fp32 for the update, so small Adam steps are not rounded
    away. fp32 runs in true fp32 (TF32 off)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    opt_init, opt_update = optimizer if optimizer is not None else adam(lr)
    if loss_fn is None:
        loss_fn = lambda p, t: lm_loss(p, t, cfg, mesh)  # noqa: E731

    def value_and_grad(gp, tokens):
        leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(gp)]
        loss = loss_fn(tree_unflatten(gp, leaves), tokens)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr for x, gr in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(gp, grads)

    def step(params, opt_state, tokens):
        true_fp32(tokens.device)
        # cast once a step (not per microbatch) and differentiate at the low-precision point:
        # the cast's gradient is the final cast of the grads back to the fp32 masters
        gp = params if compute_dtype is None else tree_map(
            lambda a: a.to(compute_dtype) if a.is_floating_point() else a, params)
        if accum_steps == 1:
            loss, grads = value_and_grad(gp, tokens)
        else:
            b = tokens.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grads = tree_map(torch.zeros_like, params)
            for micro in tokens.reshape(accum_steps, b // accum_steps, *tokens.shape[1:]):
                l_mb, g_mb = value_and_grad(gp, micro)
                loss = loss + l_mb
                # accumulate at master precision: bf16 sums would lose the low bits
                grads = tree_map(lambda s, g: s + g.to(s.dtype), grads, g_mb)
            loss = loss / accum_steps
            grads = tree_map(lambda g: g / accum_steps, grads)
        if compute_dtype is not None:
            grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
        updates, opt_state = opt_update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return opt_init, step


class TransformerLM(nn.Module):
    """The LM's params as ``nn.Parameter``s in the JAX tree's layout;
    ``forward(tokens)`` is :func:`forward_lm` over them."""

    def __init__(self, params: Params, cfg: TransformerConfig = TINY_LM):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.pos = nn.Parameter(params["pos"])
        self.final_norm = nn.ParameterDict(params["final_norm"])
        self.layers = nn.ModuleList(_LayerParams(layer) for layer in params["layers"])

    def tree(self) -> Params:
        """The params as :func:`forward_lm` takes them (the Parameters themselves)."""
        return {"embed": self.embed, "pos": self.pos, "final_norm": dict(self.final_norm.items()),
                "layers": [layer.tree() for layer in self.layers]}

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward_lm(self.tree(), tokens, self.cfg)


class _LayerParams(nn.Module):
    def __init__(self, layer: Params):
        super().__init__()
        self.names = list(layer)
        for name, leaf in layer.items():
            if isinstance(leaf, dict):
                self.add_module(name, nn.ParameterDict(leaf))
            else:
                self.register_parameter(name, nn.Parameter(leaf))

    def tree(self) -> Params:
        out = {}
        for name in self.names:
            leaf = getattr(self, name)
            out[name] = dict(leaf.items()) if isinstance(leaf, nn.ParameterDict) else leaf
        return out


# ---------------------------------------------------------------------------
# Inference: KV-cache incremental decode + autoregressive generation
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: TransformerConfig, batch: int, dtype=torch.float32, device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Per-layer (B, max_len, H, Dh) zero K/V buffers for incremental decode."""
    shape = (batch, cfg.max_len, cfg.n_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _moe_ffn_decode(layer: Params, h: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Capacity-infinite Switch FFN for the decode path: every token goes to
    its argmax expert (one token at a time cannot know the training queue's
    drops). All E experts run for the token and one is selected."""
    b, l, d = h.shape
    hf = h.reshape(b * l, d)
    gates = torch.softmax(hf.float() @ layer["router"].float(), dim=-1)  # (T, E) fp32
    idx = torch.argmax(gates, dim=-1)
    gate = torch.gather(gates, 1, idx[:, None])[:, 0]
    onehot = F.one_hot(idx, cfg.n_experts).to(h.dtype)
    hidden = _gelu(torch.einsum("td,edf->tef", hf, layer["w_up"]))
    out_e = torch.einsum("tef,efd->ted", hidden, layer["w_down"])
    sel = onehot * gate.to(h.dtype)[:, None]  # (T, E): the gate on the argmax slot
    return torch.einsum("te,ted->td", sel, out_e).reshape(b, l, d)


def _decode_block(layer: Params, x: torch.Tensor, cache, pos: int, cfg: TransformerConfig):
    """One pre-norm decoder block for ONE token (B, 1, D) at ``pos``: q
    against the cached K/V prefix (positions > pos masked), fp32 softmax
    statistics. Writes the token's K/V into position ``pos`` of ``cache``
    in place (the caller owns the cache, as the JAX decode's scan carry:
    no per-token copy) and returns the new x and that same cache."""
    b = x.shape[0]
    q, k, v = _qkv(rmsnorm(x, layer["attn_norm"]["g"]), layer["wqkv"], cfg)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k[:, 0].to(ck.dtype)
    cv[:, pos] = v[:, 0].to(cv.dtype)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float()) * scale
    mask = (torch.arange(cfg.max_len, device=x.device) <= pos)[None, None, None, :]
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, cv.float()).to(x.dtype)
    x = x + out.reshape(b, 1, cfg.d_model) @ layer["wo"]
    h2 = rmsnorm(x, layer["mlp_norm"]["g"])
    if cfg.n_experts:
        x = x + _moe_ffn_decode(layer, h2, cfg)
    else:
        x = x + _gelu(h2 @ layer["w_up"]) @ layer["w_down"]
    return x, cache


@torch.inference_mode()
def _decode_scan(params, prompt, cfg, steps, temperature, generator, collect_logits=False):
    b, plen = prompt.shape
    total = plen + steps
    if total > cfg.max_len:
        raise ValueError(f"prompt + steps = {total} exceeds max_len {cfg.max_len}")
    from ..parallel.fsdp import gather_params
    from ..parallel.tensor_parallel import gather_lm_params_tp

    params = gather_lm_params_tp(gather_params(params))  # decode runs on one device
    embed = params["embed"]
    true_fp32(embed.device)
    caches = init_kv_cache(cfg, b, embed.dtype, embed.device)
    prompt = prompt.long().to(embed.device)
    tok = torch.zeros((b,), dtype=torch.int64, device=embed.device)
    toks, logits_all = [], []
    # Generation stops one step early: the last iteration's forward would
    # only sample a token that nothing consumes (steps >= 1 makes the last
    # position a generated one, appended from the final carry).
    n_iter = total if collect_logits else total - 1
    for t in range(n_iter):
        cur = prompt[:, t] if t < plen else tok  # teacher-force the prompt
        x = embed[cur][:, None, :] + params["pos"][t][None, None, :]
        for layer, cache in zip(params["layers"], caches):
            x, _ = _decode_block(layer, x, cache, t, cfg)
        x = rmsnorm(x, params["final_norm"]["g"])
        logits = (x[:, 0] @ embed.T).float()
        if temperature > 0:
            # categorical sampling by the Gumbel-max trick, as jax.random.categorical
            u = torch.rand(logits.shape, generator=generator, device=generator.device).to(logits.device)
            tok = torch.argmax(logits / temperature - torch.log(-torch.log(u)), dim=-1)
        else:
            tok = torch.argmax(logits, dim=-1)
        toks.append(cur)
        if collect_logits:
            logits_all.append(logits)
    if collect_logits:
        return torch.stack(toks, dim=1), torch.stack(logits_all, dim=1)
    return torch.stack([*toks, tok], dim=1), None


def decode_logits(params: Params, tokens: torch.Tensor, cfg: TransformerConfig = TINY_LM) -> torch.Tensor:
    """Teacher-forced logits (B, L, vocab) fp32 through the KV-cache decode
    path: the same values as ``forward_lm`` (the parity contract)."""
    _, logits = _decode_scan(params, tokens, cfg, 0, 0.0, None, collect_logits=True)
    return logits


def generate(
    params: Params, prompt: torch.Tensor, cfg: TransformerConfig = TINY_LM, *, steps: int,
    temperature: float = 0.0, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Autoregressive generation. prompt (B, P) -> (B, P + steps) int64.

    ``temperature == 0``: greedy argmax; otherwise categorical sampling at
    that temperature from ``generator`` (required; its draws are not
    JAX's). One pass per token through per-layer KV caches."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if temperature > 0 and generator is None:
        raise ValueError("temperature > 0 sampling needs an explicit generator")
    seq, _ = _decode_scan(params, prompt, cfg, steps, temperature, generator)
    return seq
