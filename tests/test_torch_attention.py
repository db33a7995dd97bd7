"""The port's attention ops, their gradients, and ReLU against the JAX package's.

On the CPU, ``flash_attention``/``flash_attention_with_lse`` run the plain
PyTorch version of the flash forward kernel (``cuda_kernels.flash_fwd_plain``,
the same online-softmax recurrence), their backward the plain versions of
the dQ and dK/dV kernels (``flash_dq_plain``, ``flash_dkv_plain``), and
``relu`` runs ``relu_plain``; the
JAX package's Pallas kernels run in interpret mode, as its own tests run
them. The kernels themselves run only on the card, where ``chip_smoke.py``
holds them against the same plain versions. Inputs are made with numpy from
a seed and handed to both packages.

Tolerances and why:
- fp32: 2e-5 abs and rel, as ``tests/test_flash_attention.py`` holds the
  Pallas kernel to the oracle: both accumulate in fp32 in other orders.
- bf16: 3e-2 abs and rel, the same file's bf16 tolerance: the inputs are
  the same bf16 values, and one fp32 result is rounded once to bf16 on
  each side.
- lse (fp32 in both dtypes): 2e-5 abs/rel, the fp32 rule.
- gradients: 5e-5 abs/rel in fp32 (``test_grad_matches_reference_blocked``'s),
  1e-4 for the joint (out, lse) VJP against the oracle
  (``test_with_lse_joint_vjp_matches_oracle``'s), 3e-2 in bf16.
- the bf16 backward's arithmetic on the card (p and dS split into two bf16
  terms for the tensor cores), emulated in torch: 1 bf16 ulp + 1e-5 of the
  max against the plain versions, the rule ``chip_smoke.py`` holds the
  kernels to; one term breaks it. The bf16 forward's (p split the same
  way for p v): out within 1 bf16 ulp + 2e-6 x max |v| of
  ``flash_fwd_plain``, lse within 1e-6 of its max; one term breaks it.
- operands the JAX kernel takes and the wrappers once refused (mixed
  fp32/bf16, a head axis of stride H, B or H past 65535): out and the VJP
  at the fp32 tolerances (bf16 3e-2 for a bf16 output), JAX's dtypes.
- relu: bitwise outside NaN (signed zeros and infinities included), NaN
  where the JAX package has NaN. A NaN keeps its bits here; XLA on the CPU
  gives a bf16 NaN the canonical payload (sign kept), so payloads are not
  compared across packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.ops import attention as jattn
from cuda_mpi_gpu_cluster_programming_tpu.ops import flash_attention as jflash
from cuda_mpi_gpu_cluster_programming_tpu.ops import pallas_kernels as pk
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import attention as tattn
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import flash_attention as tflash

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 2e-5, "bf16": 3e-2}
# tests/test_flash_attention.py's (L, block_q, block_k) cases
CASES = [(128, 128, 128), (256, 64, 64), (256, 64, 128), (24, 8, 12), (192, 48, 64)]


def _qkv(l: int, dtype: str, *, b: int = 1, h: int = 2, d: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3)]
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a).astype(jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [24, 128])
def test_reference_attention_matches_jax(l, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(l, dtype, seed=l)
    got = tattn.attention(tq, tk, tv, causal=causal)
    assert got.dtype == DTYPES[dtype][1] and got.shape == tq.shape
    _close(got, jattn.attention(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,block_q,block_k", CASES)
def test_flash_matches_jax_flash(l, block_q, block_k, causal, dtype):
    """out and lse of both public functions against the JAX package's
    Pallas kernel, at its own tests' block cases (non-dividing ratios among them)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(l, dtype, seed=block_q + block_k)
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    want_out, want_lse = jflash.flash_attention_with_lse(jq, jk, jv, **kw)
    out, lse = tflash.flash_attention_with_lse(tq, tk, tv, **kw)
    assert out.dtype == DTYPES[dtype][1] and lse.dtype == torch.float32
    assert tuple(lse.shape) == tuple(want_lse.shape) == (1, 2, l)
    _close(out, want_out, dtype)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=TOL["fp32"], atol=TOL["fp32"])
    _close(tflash.flash_attention(tq, tk, tv, **kw), want_out, dtype)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_flash_function_and_oracle(causal):
    (jq, jk, jv), (tq, tk, tv) = _qkv(192, "fp32", b=2, h=3, d=32, seed=5)
    got = tflash.flash_attention(tq, tk, tv, causal=causal, block_q=48, block_k=64)
    _close(got, jflash.flash_attention(jq, jk, jv, causal=causal, block_q=48, block_k=64), "fp32")
    _close(got, tattn.attention(tq, tk, tv, causal=causal), "fp32")


def test_small_sequence_clamps_blocks():
    (jq, jk, jv), (tq, tk, tv) = _qkv(32, "fp32", seed=1)
    assert tflash.flash_block(32) == 32 and tflash.flash_block(4096) == 128
    got = tflash.flash_attention(tq, tk, tv, causal=True)  # blocks clamp 128 -> 32
    _close(got, jattn.attention(jq, jk, jv, causal=True), "fp32")


def test_indivisible_rejected_in_the_jax_words():
    (jq, jk, jv), (tq, tk, tv) = _qkv(96, "fp32")
    with pytest.raises(ValueError) as want:
        jflash.flash_attention(jq, jk, jv, block_q=64, block_k=64)
    with pytest.raises(ValueError) as got:
        tflash.flash_attention(tq, tk, tv, block_q=64, block_k=64)
    assert str(got.value) == str(want.value) == "sequence length 96 not divisible by blocks (64, 64)"


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 24, 48, 200, 256, 300, 384])
def test_any_head_dim_matches_jax_flash_forward_and_vjp(d, causal):
    """Head dims off the kernels' instantiations (200, which the CUDA
    wrappers pad to 256, among them), the widest single window, 256, and
    the windowed widths above it (300, padded to 320, and 384: two windows
    of output columns on the card): out and dq, dk, dv of
    ``flash_attention`` against the JAX package's, at the fp32 forward
    (2e-5) and gradient (5e-5) tolerances."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(64, "fp32", d=d, seed=d)
    cot = np.random.default_rng(d + 1).standard_normal(tq.shape).astype(np.float32)
    kw = dict(causal=causal, block_q=32, block_k=32)
    want_out, want = _vjp_jax(lambda q, k, v: jflash.flash_attention(q, k, v, **kw), (jq, jk, jv),
                              jnp.asarray(cot))
    out, got = _grads_torch(lambda q, k, v: tflash.flash_attention(q, k, v, **kw), (tq, tk, tv),
                            torch.from_numpy(cot))
    assert tuple(out.shape) == (1, 64, 2, d)
    _close(out.detach(), want_out, "fp32")
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5, atol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [1, 8, 24, 48, 100, 200, 300])
def test_zero_padded_head_dim_with_the_true_scale_is_exact(d, causal):
    """What the CUDA wrappers do at such a D: the plain versions on the
    operands ``_flash_pad`` pads, with the true D's scale, sliced back,
    against the plain versions on the unpadded operands; out, lse, dq, dk
    and dv within 1e-6 of each one's max (the padded columns add exact zeros)."""
    _, (tq, tk, tv) = _qkv(48, "fp32", b=2, d=d, seed=40 + d)
    tg = torch.from_numpy(np.random.default_rng(d).standard_normal(tq.shape).astype(np.float32))
    pq, pk_, pv, pg = ck._flash_pad(tq, tk, tv, tg)
    dp = pq.shape[-1]
    assert dp == ck.flash_width(d)[0] and dp > d
    assert torch.equal(pq[..., :d], tq) and not pq[..., d:].any()
    kw = dict(causal=causal, block_q=16, block_k=24)
    out, lse = ck.flash_fwd_plain(tq, tk, tv, **kw)
    p_out, p_lse = ck.flash_fwd_plain(pq, pk_, pv, scale=1.0 / d**0.5, **kw)
    delta = (tg * out).sum(-1).permute(0, 2, 1).contiguous()
    want = [out, lse, ck.flash_dq_plain(tq, tk, tv, tg, lse, delta, **kw),
            *ck.flash_dkv_plain(tq, tk, tv, tg, lse, delta, **kw)]
    got = [p_out[..., :d], p_lse, ck.flash_dq_plain(pq, pk_, pv, pg, lse, delta, scale=1.0 / d**0.5, **kw)[..., :d],
           *(t[..., :d] for t in ck.flash_dkv_plain(pq, pk_, pv, pg, lse, delta, scale=1.0 / d**0.5, **kw))]
    assert not p_out[..., d:].any()
    for g, w, name in zip(got, want, ("out", "lse", "dq", "dk", "dv")):
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max()), name


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_kernel_head_dims_are_not_padded(d):
    """At an instantiated D the operands go to the kernel as they are (no
    copy: a packed qkv is read through its strides)."""
    _, (tq, tk, tv) = _qkv(32, "fp32", d=d)
    assert all(a is b for a, b in zip(ck._flash_pad(tq, tk, tv), (tq, tk, tv)))


@pytest.mark.parametrize("d", [1, 8, 48, 256, 512])
def test_flash_check_takes_any_head_dim_on_the_cpu(d):
    _, (tq, tk, tv) = _qkv(32, "fp32", d=d)
    assert ck._flash_check(tq, tk, tv).type == "cpu"
    out, lse = ck.flash_fwd(tq, tk, tv, causal=True)
    assert tuple(out.shape) == (1, 32, 2, d) and tuple(lse.shape) == (1, 2, 32)


@pytest.mark.parametrize("d, dp, windows", [(257, 320, 2), (300, 320, 2), (320, 320, 2), (384, 384, 2),
                                             (512, 512, 2), (513, 576, 3), (1024, 1024, 4)])
def test_head_dims_above_256_pad_to_whole_chunks_in_windows(d, dp, windows):
    """Above 256 the CUDA branch of each wrapper pads D to the next multiple
    of the 64-column chunk, which the kernels' windowed instance takes, a
    block owning 256 output columns; nothing is refused. The padded columns
    are zeros and the rest are the operand's."""
    assert ck.flash_width(d) == (dp, windows)
    _, (tq, tk, tv) = _qkv(16, "fp32", d=d)
    padded = ck._flash_pad(tq, tk, tv)
    for t, p in zip((tq, tk, tv), padded):
        assert tuple(p.shape) == (1, 16, 2, dp) and p.is_contiguous()
        assert torch.equal(p[..., :d], t) and not p[..., d:].any()
    if dp == d:
        assert all(a is b for a, b in zip(padded, (tq, tk, tv)))


@pytest.mark.parametrize("d, dp", [(1, 16), (17, 32), (100, 128), (200, 256), (256, 256)])
def test_head_dims_up_to_256_keep_their_widths(d, dp):
    """Up to 256 the widths are those of before: the next instantiated head
    dim, one window."""
    assert ck.flash_width(d) == (dp, 1)


def test_mismatched_operands_raise():
    """What the JAX kernel refuses or cannot run still raises: operands of
    two shapes, a dtype other than fp32 and bf16, an empty axis. (Mixed
    fp32/bf16 dtypes and a non-unit head stride compute, as in JAX: the
    tests below.)"""
    _, (tq, tk, tv) = _qkv(32, "fp32")
    with pytest.raises(ValueError, match="shape"):
        ck.flash_fwd(tq, tk[:, :16], tv, causal=True)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ck.flash_fwd(tq, tk.double(), tv, causal=True)
    with pytest.raises(ValueError, match="empty axis"):
        ck.flash_fwd(tq[:0], tk[:0], tv[:0], causal=True)


def _flash_grads(q, k, v, cot, kw):
    """out and (dq, dk, dv) of both packages' ``flash_attention`` on the
    same values: q, k, v and cot as torch tensors, JAX's inputs made from
    their values in their dtypes."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    jarrs = [jnp.asarray(t.float().numpy()).astype(jdt[t.dtype]) for t in (q, k, v)]
    want_out, want = _vjp_jax(lambda a, b, c: jflash.flash_attention(a, b, c, **kw), jarrs,
                              jnp.asarray(cot.float().numpy()).astype(jdt[cot.dtype]))
    out, got = _grads_torch(lambda a, b, c: tflash.flash_attention(a, b, c, **kw), (q, k, v), cot)
    return (out.detach(), got), (want_out, want)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtypes", [("fp32", "bf16", "fp32"), ("bf16", "fp32", "bf16")])
def test_mixed_dtypes_match_jax_forward_and_vjp(dtypes, causal):
    """q, k, v of mixed fp32/bf16, as the JAX kernel takes them (it widens
    every operand to fp32): out in q's dtype and dq, dk, dv in q's, k's and
    v's, each against the JAX package's at its dtype's tolerance (fp32 2e-5
    for out and 5e-5 for the gradients, bf16 3e-2: one fp32 result rounded
    once on each side)."""
    rng = np.random.default_rng(60 + causal)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 2, 16)).astype(np.float32)).to(DTYPES[dt][1])
               for dt in dtypes)
    cot = torch.from_numpy(rng.standard_normal((2, 64, 2, 16)).astype(np.float32)).to(q.dtype)
    (out, got), (want_out, want) = _flash_grads(q, k, v, cot, dict(causal=causal, block_q=32, block_k=32))
    assert out.dtype == q.dtype and [g.dtype for g in got] == [q.dtype, k.dtype, v.dtype]
    assert [np.asarray(w).dtype.itemsize for w in (want_out, *want)] == [t.element_size() for t in (q, q, k, v)]
    _close(out, want_out, dtypes[0])
    for g, w, dt in zip(got, want, dtypes):
        tol = 5e-5 if dt == "fp32" else TOL["bf16"]
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
def test_transposed_head_axis_matches_jax(causal):
    """q, k, v as (B, L, D, H).transpose(2, 3) views, whose head axis has
    stride H: out and dq, dk, dv against the JAX package's on the same
    values (fp32 2e-5 and 5e-5), and bitwise the port's on contiguous copies."""
    rng = np.random.default_rng(70 + causal)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 16, 3)).astype(np.float32)).transpose(2, 3)
               for _ in range(3))
    assert q.shape == (2, 64, 3, 16) and q.stride(-1) == 3
    cot = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    kw = dict(causal=causal, block_q=32, block_k=32)
    (out, got), (want_out, want) = _flash_grads(q, k, v, cot, kw)
    _close(out, want_out, "fp32")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5, atol=5e-5)
    out_c, got_c = _grads_torch(lambda a, b, c: tflash.flash_attention(a, b, c, **kw),
                                tuple(t.contiguous() for t in (q, k, v)), cot)
    assert torch.equal(out, out_c.detach()) and all(torch.equal(a, b) for a, b in zip(got, got_c))


@pytest.mark.parametrize("shape", [(65536, 1, 1, 1), (1, 1, 65536, 1)])
def test_batch_or_heads_above_65535_match_jax_attention(shape):
    """B or H of 65536, past the card's grid y/z limit, which the kernels no
    longer use: out and the VJP against the JAX package's ``ops.attention``
    (plain XLA). With L = 1, p = 1: out is v bitwise on both sides, dq and
    dk are 0 and dv is the cotangent."""
    rng = np.random.default_rng(80)
    q, k, v, cot = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    want_out, want = _vjp_jax(lambda a, b, c: jattn.attention(a, b, c, causal=True),
                              [jnp.asarray(a) for a in (q, k, v)], jnp.asarray(cot))
    out, got = _grads_torch(lambda a, b, c: tflash.flash_attention(a, b, c, causal=True),
                            tuple(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(cot))
    assert np.array_equal(out.detach().numpy(), v) and np.array_equal(np.asarray(want_out), v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5, atol=5e-5)
    assert np.array_equal(got[2].numpy(), cot) and not got[0].any() and not got[1].any()


def test_flash_operands_are_what_the_kernels_read():
    """The CUDA branch's preparation, on the CPU: mixed dtypes become fp32
    copies, a head axis with stride != 1 a contiguous copy, anything else
    passes as it is (a packed qkv slice keeps its strides), then the pad;
    ``_flash_out`` slices the pad away and casts to the caller's dtype."""
    _, (tq, tk, tv) = _qkv(32, "fp32", d=32)
    same = ck._flash_operands(tq, tk, tv)
    assert all(a is b for a, b in zip(same, (tq, tk, tv)))
    mixed = ck._flash_operands(tq, tk.to(torch.bfloat16), tv)
    assert all(t.dtype == torch.float32 for t in mixed) and torch.equal(mixed[1], tk.to(torch.bfloat16).float())
    packed = torch.zeros((1, 32, 3, 2 * 32))
    view = packed[:, :, 0].view(1, 32, 2, 32)
    wide = torch.zeros((1, 32, 32, 2)).transpose(2, 3)
    kept, copied = ck._flash_operands(view, wide)
    assert kept is view and copied.is_contiguous() and torch.equal(copied, wide)
    padded = ck._flash_operands(tq[..., :24], tk[..., :24].to(torch.bfloat16))
    assert all(t.shape[-1] == 32 and t.dtype == torch.float32 for t in padded)
    assert ck._flash_out(padded[0], 24, torch.bfloat16).shape == (1, 32, 2, 24)
    assert ck._flash_out(padded[0], 24, torch.bfloat16).dtype == torch.bfloat16


def test_strided_views_read_in_place():
    """q, k, v as slices of one packed (B, L, 3, H*D) tensor, as the LM passes them."""
    rng = np.random.default_rng(3)
    packed = torch.from_numpy(rng.standard_normal((2, 64, 3, 2 * 16)).astype(np.float32))
    q, k, v = (packed[:, :, i].view(2, 64, 2, 16) for i in range(3))
    assert not q.is_contiguous()
    out, lse = ck.flash_fwd(q, k, v, causal=True)
    want_out, want_lse = ck.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)


def _vjp_jax(fn, arrs, cot):
    out, vjp = jax.vjp(fn, *arrs)
    return out, vjp(cot)


def _grads_torch(fn, tensors, cot):
    leaves = [t.clone().requires_grad_(True) for t in tensors]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, cot)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,block_q,block_k", CASES)
def test_flash_grad_matches_jax_vjp(l, block_q, block_k, causal):
    """dq, dk, dv of ``flash_attention`` (the plain versions of flash_dq and
    flash_dkv on the CPU) against ``jax.vjp`` of the JAX package's (its
    Pallas _dq_kernel and _dkv_kernel in interpret mode), at 5e-5 abs/rel:
    the tolerance tests/test_flash_attention.py holds those kernels to."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(l, "fp32", b=2, d=32, seed=l + block_q)
    cot = np.random.default_rng(7).standard_normal(tq.shape).astype(np.float32)
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    _, want = _vjp_jax(lambda q, k, v: jflash.flash_attention(q, k, v, **kw), (jq, jk, jv), jnp.asarray(cot))
    _, got = _grads_torch(lambda q, k, v: tflash.flash_attention(q, k, v, **kw), (tq, tk, tv),
                          torch.from_numpy(cot))
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float32 and g.shape == tq.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5, atol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,block_q,block_k", [(24, 8, 12), (192, 48, 64)])
def test_flash_grad_bf16_matches_jax_vjp(l, block_q, block_k, causal):
    """bf16 q, k, v and cotangent: the gradients in bf16, against the JAX
    package's at the bf16 tolerance (3e-2), each an fp32 result rounded once."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(l, "bf16", b=2, d=32, seed=3 * l)
    cot = np.random.default_rng(8).standard_normal(tq.shape).astype(np.float32)
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    _, want = _vjp_jax(lambda q, k, v: jflash.flash_attention(q, k, v, **kw), (jq, jk, jv),
                       jnp.asarray(cot).astype(jnp.bfloat16))
    _, got = _grads_torch(lambda q, k, v: tflash.flash_attention(q, k, v, **kw), (tq, tk, tv),
                          torch.from_numpy(cot).to(torch.bfloat16))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w, "bf16")


@pytest.mark.parametrize("with_lse_grad", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_plain_versions_match_jax_flash_backward(causal, with_lse_grad):
    """flash_dq_plain and flash_dkv_plain against the JAX package's
    ``_flash_backward`` on the same (q, k, v, out, lse, g) and lse
    cotangent (the delta shift), at the fp32 kernel tolerance 5e-5."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(192, "fp32", b=2, h=3, d=16, seed=21)
    rng = np.random.default_rng(22)
    g = rng.standard_normal(tq.shape).astype(np.float32)
    g_lse = rng.standard_normal((2, 3, 192)).astype(np.float32) if with_lse_grad else None
    kw = dict(causal=causal, block_q=48, block_k=64)
    out, lse4 = jflash._flash_forward(jq, jk, jv, return_lse=True, **kw)  # lse (B, H, 1, L)
    want = jflash._flash_backward(jq, jk, jv, out, lse4, jnp.asarray(g),
                                  lse_grad=None if g_lse is None else jnp.asarray(g_lse), **kw)
    tout, tg = torch.from_numpy(np.array(out)), torch.from_numpy(g)
    lse = torch.from_numpy(np.asarray(lse4)[:, :, 0, :].copy())
    delta = (tg * tout).sum(-1).permute(0, 2, 1).contiguous()
    if g_lse is not None:
        delta = delta - torch.from_numpy(g_lse)
    dq = ck.flash_dq_plain(tq, tk, tv, tg, lse, delta, **kw)
    dk, dv = ck.flash_dkv_plain(tq, tk, tv, tg, lse, delta, **kw)
    assert torch.equal(dq, ck.flash_dq(tq, tk, tv, tg, lse, delta, **kw))  # the CPU wrapper is the plain version
    for got, w, name in zip((dq, dk, dv), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=5e-5, atol=5e-5, err_msg=f"d{name}")


def _oracle_with_lse(q, k, v, causal):
    l, d = q.shape[1], q.shape[-1]
    s = jnp.einsum("blhd,bmhd->bhlm", q, k) / jnp.sqrt(jnp.asarray(d, jnp.float32))
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((l, l), bool))[None, None], s, -1e30)
    out = jnp.einsum("bhlm,bmhd->blhd", jax.nn.softmax(s, -1), v)
    return out, jax.scipy.special.logsumexp(s, -1)


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_joint_vjp_matches_oracle(causal):
    """``flash_attention_with_lse`` differentiated through both outputs,
    ``sum(o^2) + sum(sin(lse))``, against the XLA oracle's gradients at
    1e-4, as tests/test_flash_attention.py holds the JAX package's joint VJP."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(64, "fp32", b=2, d=16, seed=11)

    def loss_o(q, k, v):
        o, s = _oracle_with_lse(q, k, v, causal)
        return jnp.sum(o**2) + jnp.sum(jnp.sin(s))

    want = jax.grad(loss_o, (0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o, s = tflash.flash_attention_with_lse(*leaves, causal=causal)
    got = torch.autograd.grad((o**2).sum() + torch.sin(s).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_grad_of_strided_views_and_a_zero_stride_cotangent(causal):
    """q, k, v as slices of one packed qkv tensor (the LM's layout) and the
    gradient of ``out.sum()`` (an expanded, zero-stride cotangent): the
    packed tensor's gradient against ``jax.vjp`` with a cotangent of ones."""
    rng = np.random.default_rng(31)
    packed = rng.standard_normal((2, 48, 3, 2 * 16)).astype(np.float32)
    jqkv = [jnp.asarray(packed[:, :, i].reshape(2, 48, 2, 16)) for i in range(3)]
    _, want = _vjp_jax(lambda q, k, v: jflash.flash_attention(q, k, v, causal=causal, block_q=16, block_k=16),
                       jqkv, jnp.ones((2, 48, 2, 16), jnp.float32))
    tp = torch.from_numpy(packed).requires_grad_(True)
    q, k, v = (tp[:, :, i].view(2, 48, 2, 16) for i in range(3))
    assert not q.is_contiguous()
    out = tflash.flash_attention(q, k, v, causal=causal, block_q=16, block_k=16)
    (grad,) = torch.autograd.grad(out.sum(), (tp,))
    for i, w in enumerate(want):
        np.testing.assert_allclose(grad[:, :, i].reshape(2, 48, 2, 16).numpy(), np.asarray(w), rtol=5e-5, atol=5e-5)


def test_backward_operands_are_checked():
    _, (tq, tk, tv) = _qkv(32, "fp32")
    lse = torch.zeros((1, 2, 32))
    with pytest.raises(ValueError, match="lse must be a contiguous fp32"):
        ck.flash_dq(tq, tk, tv, tq, lse[:, :, :16], lse, causal=True)
    with pytest.raises(ValueError, match="delta must be a contiguous fp32"):
        ck.flash_dkv(tq, tk, tv, tq, lse, lse.double(), causal=True)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ck.flash_dkv(tq, tk, tv, tq.half(), lse, lse, causal=True)
    with pytest.raises(ValueError, match="shape"):
        ck.flash_dq(tq, tk, tv, torch.zeros((1, 32, 2, 32))[..., ::3], lse, lse, causal=True)


def test_flash_plain_is_the_recurrence_of_the_oracle():
    """flash_fwd_plain's lse against a direct logsumexp of the masked scores."""
    _, (tq, tk, tv) = _qkv(24, "fp32", h=3)
    out, lse = ck.flash_fwd_plain(tq, tk, tv, causal=True, block_q=8, block_k=12)
    s = torch.einsum("blhd,bmhd->bhlm", tq * 0.25, tk)
    s = s.masked_fill(~torch.ones(24, 24, dtype=torch.bool).tril(), float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(out.numpy(), tattn.attention(tq, tk, tv, causal=True).numpy(), rtol=2e-6, atol=2e-6)


# The bf16 rule the card's flash_dq and flash_dkv are held to against their plain versions (chip_smoke.py's
# BWD_PLAIN_REL): per element, 1 bf16 ulp plus 1e-5 x max |plain|.
BWD_PLAIN_REL = 1e-5


def _share_of_bf16_rule(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (1 bf16 ulp of the larger + BWD_PLAIN_REL x max |want|): at most 1 within the rule."""
    g, w = got.float(), want.float()
    _m, e = torch.frexp(torch.maximum(g.abs(), w.abs()).clamp_min(2.0**-126))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)
    return float(((g - w).abs() / (ulp + BWD_PLAIN_REL * float(w.abs().max()))).max())


def _split_terms(x: torch.Tensor, terms: int) -> list:
    """x (fp32) as a sum of ``terms`` bf16 values: hi = bf16(x), lo = bf16(x - hi)."""
    out = []
    for _ in range(terms):
        hi = x.to(torch.bfloat16).float()
        out.append(hi)
        x = x - hi
    return out


def _bf16_backward_emulation(q, k, v, g, lse, delta, causal, terms):
    """The bf16 tensor-core arithmetic of the card's flash_dq and flash_dkv at D <= 128, in torch: the score
    products on the bf16 operands in fp32 (exact products), s scaled after; p and dS in fp32, each split
    into ``terms`` bf16 terms that feed the second products separately, in fp32; the outputs rounded once
    to bf16."""
    d = q.shape[-1]
    qf, kf, vf, gf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, g))  # (B, H, L, D)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / d**0.5)
    if causal:
        l = q.shape[1]
        s = s.masked_fill(~torch.ones(l, l, dtype=torch.bool).tril(), float("-inf"))
    p = torch.exp(s - lse[..., None])
    ds = p * (gf @ vf.transpose(-1, -2) - delta[..., None])
    dq = sum(t @ kf for t in _split_terms(ds, terms)) * (1.0 / d**0.5)
    dk = sum(t.transpose(-1, -2) @ qf for t in _split_terms(ds, terms)) * (1.0 / d**0.5)
    dv = sum(t.transpose(-1, -2) @ gf for t in _split_terms(p, terms))
    return tuple(t.permute(0, 2, 1, 3).to(torch.bfloat16) for t in (dq, dk, dv))


def _bf16_backward_emulation_wide(q, k, v, g, lse, delta, causal, terms):
    """The bf16 tensor-core arithmetic of the card's flash_dq and flash_dkv at D >= 256 (the D = 256 instance
    and the windowed one above it), in torch: the score products summed over D in 64-column chunks, each
    chunk's product of the bf16 operands in fp32 added to the running fp32 scores, s scaled after; p and dS
    in fp32, each split into ``terms`` bf16 terms; each window of 256 output columns takes its columns of
    k, q and dO through the second products on every term, in fp32; the outputs rounded once to bf16."""
    d = q.shape[-1]
    qf, kf, vf, gf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, g))  # (B, H, L, D)
    s = torch.zeros(qf.shape[:3] + (kf.shape[2],))
    dp = torch.zeros_like(s)
    for c in range(0, d, 64):
        s = s + qf[..., c : c + 64] @ kf[..., c : c + 64].transpose(-1, -2)
        dp = dp + gf[..., c : c + 64] @ vf[..., c : c + 64].transpose(-1, -2)
    s = s * (1.0 / d**0.5)
    if causal:
        l = q.shape[1]
        s = s.masked_fill(~torch.ones(l, l, dtype=torch.bool).tril(), float("-inf"))
    p = torch.exp(s - lse[..., None])
    ds = p * (dp - delta[..., None])
    p_terms, ds_terms = _split_terms(p, terms), _split_terms(ds, terms)
    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for w in range(0, d, 256):
        cols = slice(w, w + 256)
        dq[..., cols] = sum(t @ kf[..., cols] for t in ds_terms) * (1.0 / d**0.5)
        dk[..., cols] = sum(t.transpose(-1, -2) @ qf[..., cols] for t in ds_terms) * (1.0 / d**0.5)
        dv[..., cols] = sum(t.transpose(-1, -2) @ gf[..., cols] for t in p_terms)
    return tuple(t.permute(0, 2, 1, 3).to(torch.bfloat16) for t in (dq, dk, dv))


def _bf16_backward_case(shape, causal, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16) for _ in range(4))
    out, lse = ck.flash_fwd_plain(q, k, v, causal=causal)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, g, lse, delta)
    plain = (ck.flash_dq_plain(*args, causal=causal), *ck.flash_dkv_plain(*args, causal=causal))
    return args, plain


# the emulation of the kernels at a shape: D <= 128's, or that of D = 256 and the windowed instance above it
def _emulation(d):
    return _bf16_backward_emulation if d <= 128 else _bf16_backward_emulation_wide


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 256, 2, 32), (1, 512, 2, 64), (1, 256, 2, 256), (1, 256, 2, 384)])
def test_bf16_two_term_split_meets_the_plain_rule(shape, causal):
    """Why the card's bf16 backward splits p and dS into two bf16 terms:
    with hi + lo (16 significant bits) feeding the tensor-core products,
    dq, dk and dv stay within the rule chip_smoke.py holds the kernels to
    against flash_dq_plain/flash_dkv_plain (fp32 p and dS), 1 bf16 ulp +
    1e-5 x max |plain|; at D = 256 and the windowed D = 384 too, the scores
    summed in 64-column chunks and each window's columns on both terms."""
    args, plain = _bf16_backward_case(shape, causal, seed=shape[1] + causal)
    got = _emulation(shape[3])(*args, causal=causal, terms=2)
    for name, a, b in zip(("dq", "dk", "dv"), got, plain):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _share_of_bf16_rule(a, b) <= 1.0, name


@pytest.mark.parametrize("shape, causal", [
    pytest.param((1, 512, 2, 64), False, id="False"), pytest.param((1, 512, 2, 64), True, id="True"),
    pytest.param((1, 256, 2, 256), False, id="d256-False"), pytest.param((1, 256, 2, 256), True, id="d256-True"),
    pytest.param((1, 256, 2, 384), False, id="d384-False"), pytest.param((1, 256, 2, 384), True, id="d384-True"),
])
def test_one_bf16_term_breaks_the_plain_rule(shape, causal):
    """A single bf16 rounding of p and dS (what SDPA feeds its second
    products) takes dq, dk or dv well past that rule: the split is what keeps
    the kernels on the JAX package's fp32 arithmetic, at D >= 256 too."""
    args, plain = _bf16_backward_case(shape, causal, seed=shape[1] + causal)
    got = _emulation(shape[3])(*args, causal=causal, terms=1)
    assert max(_share_of_bf16_rule(a, b) for a, b in zip(got, plain)) > 4.0


# The bf16 rule the card's flash_fwd is held to against its plain version (chip_smoke.py's FLASH_PLAIN_V_REL):
# per element of out, 1 bf16 ulp plus 2e-6 x max |v| (out is a convex mix of v's rows)
FLASH_PLAIN_V_REL = 2e-6


def _bf16_forward_recurrence(q, k, v, causal, terms, scores, product):
    """The online recurrence of the card's bf16 flash_fwd, in torch: per 64-key tile, s = scores(q, k tile)
    (fp32 sums of the bf16 operands' exact products), scaled after, masked to -inf; m, corr = exp(m - m_new)
    (the exponent taken against 0 while a row has seen no key), den = den corr + sum p in fp32; p split into
    ``terms`` bf16 terms, acc = acc corr + product(terms, v tile); out = acc / max(den, 1e-30) rounded once to
    bf16, lse = m + log max(den, 1e-30)."""
    b, l, h, d = q.shape
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, L, D)
    m = torch.full((b, h, l), float("-inf"))
    den, acc = torch.zeros((b, h, l)), torch.zeros((b, h, l, d))
    rows = torch.arange(l)[:, None]
    for k0 in range(0, l, 64):
        kt, vt = kf[:, :, k0 : k0 + 64], vf[:, :, k0 : k0 + 64]
        s = scores(qf, kt) * (1.0 / d**0.5)
        if causal:
            s = s.masked_fill(rows < torch.arange(k0, k0 + kt.shape[2])[None, :], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        corr, p = torch.exp(m - m_use), torch.exp(s - m_use[..., None])
        den = den * corr + p.sum(-1)
        acc = acc * corr[..., None] + product(_split_terms(p, terms), vt)
        m = m_new
    den = den.clamp_min(1e-30)
    return (acc / den[..., None]).permute(0, 2, 1, 3).to(torch.bfloat16), m + torch.log(den)


def _bf16_forward_emulation(q, k, v, causal, terms):
    """The bf16 tensor-core arithmetic of the card's flash_fwd at D <= 128 (:func:`_bf16_forward_recurrence`):
    s one product over all of D, each p term times the v tile."""
    return _bf16_forward_recurrence(q, k, v, causal, terms, lambda qf, kt: qf @ kt.transpose(-1, -2),
                                    lambda p_terms, vt: sum(t @ vt for t in p_terms))


def _bf16_forward_emulation_wide(q, k, v, causal, terms):
    """The bf16 tensor-core arithmetic of the card's flash_fwd at D >= 256 (the D = 256 instance and the
    windowed one above it; :func:`_bf16_forward_recurrence`): the scores summed over D in 64-column chunks, each
    chunk's product of the bf16 operands in fp32 added to the running fp32 scores; each window of 256 output
    columns takes its columns of v through every p term, in fp32."""
    d = q.shape[-1]

    def scores(qf, kt):
        s = torch.zeros(qf.shape[:3] + (kt.shape[2],))
        for c in range(0, d, 64):
            s = s + qf[..., c : c + 64] @ kt[..., c : c + 64].transpose(-1, -2)
        return s

    def product(p_terms, vt):
        return torch.cat([sum(t @ vt[..., w : w + 256] for t in p_terms) for w in range(0, d, 256)], dim=-1)

    return _bf16_forward_recurrence(q, k, v, causal, terms, scores, product)


def _bf16_forward_case(shape, causal, terms):
    """The emulation at ``terms`` against flash_fwd_plain on seeded bf16 q, k, v: out's worst share of the
    rule (at most 1 within it), and lse's largest error over its max."""
    rng = np.random.default_rng(shape[1] + causal)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16) for _ in range(3))
    emulation = _bf16_forward_emulation if shape[3] <= 128 else _bf16_forward_emulation_wide
    out, lse = emulation(q, k, v, causal, terms)
    p_out, p_lse = ck.flash_fwd_plain(q, k, v, causal=causal)
    g, w = out.float(), p_out.float()
    _m, e = torch.frexp(torch.maximum(g.abs(), w.abs()).clamp_min(2.0**-126))
    slack = torch.ldexp(torch.ones_like(g), e - 8) + FLASH_PLAIN_V_REL * float(v.float().abs().max())
    assert out.dtype == p_out.dtype == torch.bfloat16 and out.shape == p_out.shape
    return float(((g - w).abs() / slack).max()), float((lse - p_lse).abs().max() / p_lse.abs().max())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 256, 2, 32), (1, 512, 2, 64), (1, 256, 2, 256), (1, 256, 2, 384)])
def test_bf16_forward_two_term_split_meets_the_plain_rule(shape, causal):
    """Why the card's bf16 flash_fwd splits p into two bf16 terms: with
    hi + lo (16 significant bits) feeding the tensor-core p v product, out
    stays within the rule chip_smoke.py holds the kernel to against
    flash_fwd_plain (fp32 p), 1 bf16 ulp + 2e-6 x max |v|, and lse within
    1e-6 of its max (chip_smoke.py's LSE_REL); at D = 256 and the windowed
    D = 384 too, the scores summed in 64-column chunks and each window's
    columns of v on both terms."""
    share, lse_rel = _bf16_forward_case(shape, causal, terms=2)
    assert share <= 1.0 and lse_rel <= 1e-6


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 256, 2, 32), (1, 512, 2, 64), (1, 256, 2, 256), (1, 256, 2, 384)])
def test_one_bf16_term_breaks_the_forward_plain_rule(shape, causal):
    """A single bf16 rounding of p takes out far past that rule (38-79x
    at D <= 64, 33-108x at D = 256 and 384 here): one term is not enough."""
    share, _lse_rel = _bf16_forward_case(shape, causal, terms=1)
    assert share > 4.0


def _bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or a JAX/numpy array (fp32 or bf16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy().view(
            np.uint16 if x.dtype == torch.bfloat16 else np.uint32)
    a = np.asarray(x)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(3,), (2, 9), (2, 5, 7), (2, 3, 5, 8)])
def test_relu_bitwise_equals_relu_pallas(shape, dtype):
    """Both packages get the same input bits (a NaN of each sign, signed
    zeros and infinities first)."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal(shape).astype(np.float32).reshape(-1)
    specials = [np.nan, -0.0, -np.inf, 0.0, np.inf, -np.nan]
    a[: min(a.size, len(specials))] = specials[: a.size]
    jdt, tdt = DTYPES[dtype]
    x = torch.from_numpy(a.reshape(shape)).to(tdt)
    want = pk.relu_pallas(jnp.asarray(_bits(x).view(jdt)))
    got = ck.relu(x)
    assert got.dtype == tdt and tuple(got.shape) == shape
    nan = np.isnan(_np(got))
    np.testing.assert_array_equal(nan, np.isnan(_np(want)))
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])
    assert nan.reshape(-1)[0] and not bool(torch.signbit(got.reshape(-1)[1]))
    # the NaN keeps its own bits (the kernel's plain version, which chip_smoke.py holds the kernel to bitwise)
    np.testing.assert_array_equal(_bits(got)[nan], _bits(x)[nan])
