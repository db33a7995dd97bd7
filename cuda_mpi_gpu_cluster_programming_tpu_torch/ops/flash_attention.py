"""Flash attention: fused online-softmax attention, O(L) memory.

The counterpart of the JAX package's ``ops/flash_attention.py``, over the
port's hand-written forward kernel (``ops.cuda_kernels.flash_fwd``,
``csrc/flash_fwd.cu``). The public functions keep the JAX signatures,
except ``vma`` (a ``shard_map`` notion with no counterpart here).

Each is a ``torch.autograd.Function`` whose forward launches the kernel: a
kernel that writes into a ``torch.empty`` output leaves no ``grad_fn``, so
without the Function a gradient would stop at the attention output without
a word. The backward (the FA-2 recompute, ``_dq_kernel`` and
``_dkv_kernel`` of the JAX package) is not ported yet and raises.
"""

from __future__ import annotations

import torch

from . import cuda_kernels

_BACKWARD_MISSING = (
    "flash attention backward is not ported yet (the _dq_kernel and _dkv_kernel "
    "of the JAX package, ROADMAP Queue 2 items 10-11): use attn_impl='reference' "
    "to differentiate"
)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        out, _lse = cuda_kernels.flash_fwd(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(_BACKWARD_MISSING)


class _FlashAttentionLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        return cuda_kernels.flash_fwd(q, k, v, causal=causal, block_q=block_q, block_k=block_k)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        raise NotImplementedError(_BACKWARD_MISSING)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False, block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Fused attention. q, k, v: (B, L, H, D) -> (B, L, H, D).

    ``L`` must be divisible by the blocks clamped to L (:func:`flash_block`);
    the kernel itself tiles by 64 x 64, so the blocks only validate. D is
    one of ``cuda_kernels.FLASH_HEAD_DIMS``. Forward only for now."""
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)


def flash_block(l: int, block_q: int = 128) -> int:
    """The clamped flash block size for sequence length ``l``: the shared
    source of the ``l % flash_block(l) == 0`` rule."""
    return min(block_q, l)


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False, block_q: int = 128,
    block_k: int = 128,
) -> tuple:
    """Fused attention returning ``(out, lse)``: out (B, L, H, D), lse
    (B, H, L) fp32, the per-row log-sum-exp of the scaled scores. Two
    partials over disjoint key sets merge through their LSEs::

        lse = logaddexp(lse1, lse2)
        out = exp(lse1 - lse) * out1 + exp(lse2 - lse) * out2
    """
    return _FlashAttentionLse.apply(q, k, v, causal, block_q, block_k)
