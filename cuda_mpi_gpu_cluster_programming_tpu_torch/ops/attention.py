"""Scaled dot-product attention: the single-device reference op.

The O(L^2) oracle that the flash kernel (``ops.flash_attention``) and the
LM's ``attn_impl="reference"`` are held against, as in the JAX package's
``ops/attention.py``. Plain PyTorch ops: this is the reference tier, not a
kernel.

Layout ``(B, L, H, D)``: batch, sequence, heads, head_dim. The scores and
the softmax are fp32 whatever the input dtype; the output is cast to q's.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # finite mask value: keeps running-max math NaN-free


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
    """Full O(L^2) attention. q, k, v: (B, L, H, D) -> (B, L, H, D)."""
    lq, d = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale  # (B, H, Lq, Lk) fp32
    if causal:
        lk = k.shape[1]
        mask = torch.arange(lq, device=q.device)[:, None] >= torch.arange(lk, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", p, v.float()).to(q.dtype)
