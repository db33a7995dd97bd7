"""Flash attention: fused online-softmax attention, O(L) memory.

The counterpart of the JAX package's ``ops/flash_attention.py``, over the
port's hand-written kernels (``ops.cuda_kernels``): the forward
``flash_fwd`` (``csrc/flash_fwd.cu``) and the FA-2 recompute backward,
``flash_dq`` and ``flash_dkv`` (``csrc/flash_dq.cu``, ``csrc/flash_dkv.cu``,
the JAX package's ``_dq_kernel`` and ``_dkv_kernel``). The public
functions keep the JAX signatures, except ``vma`` (a ``shard_map`` notion
with no counterpart here).

Both go through one ``torch.autograd.Function`` whose forward launches the
forward kernel and saves ``(q, k, v, out, lse)``; its backward computes the
rowwise ``delta = sum_d dO o`` (fp32, shifted by ``-g_lse`` when the lse
has a gradient) with plain torch ops, as the JAX package does outside its
kernels, then launches one ``flash_dq`` and one ``flash_dkv``. No (L, L)
tensor is kept between the two passes. On the card the two backward
kernels, like the forward, run on the tensor cores in bf16 (head dims up
to 128) and on FFMA in fp32. q, k and v may mix fp32 and bf16, as in the
JAX package: the kernels then compute in fp32, and out takes q's dtype,
dq, dk and dv their operand's.
"""

from __future__ import annotations

import torch

from . import cuda_kernels


class _Flash(torch.autograd.Function):
    """``(out, lse)`` of the flash forward kernel; the backward launches the
    two backward kernels. Gradients are not materialised: an output that
    takes no part in the loss comes in as None."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        ctx.set_materialize_grads(False)
        out, lse = cuda_kernels.flash_fwd(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = dict(causal=causal, block_q=block_q, block_k=block_k)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        """dq, dk, dv for the output gradient ``g_out`` (None: zeros) and the
        lse gradient ``g_lse`` (None: no shift). ``g_out`` may be an expanded
        zero-stride tensor (the gradient of ``out.sum()``) or any other
        layout: the kernels' wrappers take any strides."""
        q, k, v, out, lse = ctx.saved_tensors
        g = torch.zeros_like(out) if g_out is None else g_out.to(q.dtype)
        # delta_i = sum_d dO_i o_i (FA-2 eq. 4), (B, H, L) like the lse
        delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        if g_lse is not None:
            # d lse_i / d s_ij = p_ij: an lse cotangent adds p_ij g_lse_i to dS, which is the same
            # kernels with delta shifted by -g_lse (dV does not depend on lse)
            delta = delta - g_lse.float()
        dq = cuda_kernels.flash_dq(q, k, v, g, lse, delta, **ctx.blocks)
        dk, dv = cuda_kernels.flash_dkv(q, k, v, g, lse, delta, **ctx.blocks)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False, block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Fused attention. q, k, v: (B, L, H, D) -> (B, L, H, D).

    ``L`` must be divisible by the blocks clamped to L (:func:`flash_block`);
    the kernel itself tiles by 64 x 64, so the blocks only validate. Any D
    runs, as in the JAX package; on CUDA a D off the kernels' widths is
    zero-padded to ``cuda_kernels.flash_width(D)`` (a copy of q, k, v),
    with the scale of the true D. Differentiable with O(L)
    memory: the backward recomputes the probabilities blockwise from the
    saved lse (one ``flash_dq`` and one ``flash_dkv`` launch)."""
    return _Flash.apply(q, k, v, causal, block_q, block_k)[0]


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

    Differentiable jointly in both outputs: the lse gradient shifts the
    backward's delta term by -g_lse."""
    return _Flash.apply(q, k, v, causal, block_q, block_k)
