"""The port's pools (``maxpool.cu`` and its siblings), their max rule on
signed zeros and NaN, their instance choice, and LRN (``lrn.cu``) at
lrn2's width, against the JAX package on the CPU.

On the CPU each wrapper of ``ops.cuda_kernels`` runs its plain PyTorch
version (the CUDA kernels run only on the card, where ``chip_smoke.py``
holds each one bitwise against the same plain version, signed zeros and
NaN included); the Pallas kernels run in interpret mode, as the JAX
package's tests run them, and ``scripts/pool_ab.py`` is loaded read-only
from its file. Inputs are made with numpy from a seed and handed to both.

The max rule is ``jnp.maximum``'s: +0.0 wins over -0.0 in either order,
and a NaN propagates. Tolerances:
- pools, the hpool conv + W stage, conv_block and the reference pool on
  inputs of signed zeros and negatives: bitwise, fp32 and bf16 (a max only
  selects; ReLU sends every value not above 0, -0.0 too, to +0.0);
- NaN windows: NaN where JAX has NaN, every other value bitwise (NaN
  payloads are not compared across packages);
- LRN fp32: 2e-6 rel (the window sum and the power are fp32 in both, in
  another order and with another ``pow``); bf16: one bf16 ulp (one cast
  of an fp32 result), as ``tests/test_torch_kernels.py`` states them.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.ops import megakernel as jmk
from cuda_mpi_gpu_cluster_programming_tpu.ops import pallas_kernels as pk
from cuda_mpi_gpu_cluster_programming_tpu.ops import reference as jref
from cuda_mpi_gpu_cluster_programming_tpu.precision import quantize as jq
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import reference as tref

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "pool_ab.py"
_spec = importlib.util.spec_from_file_location("jax_pool_ab_for_pool_lrn", SCRIPT)
jab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jab)

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_ULP_REL = 2.0**-7


def _both(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _bits(a) -> np.ndarray:
    """The raw bits of a torch tensor or JAX array (fp32 or bf16)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _signed_zeros(shape, seed) -> np.ndarray:
    """Windows of -0.0, +0.0 and negatives: most maxima are a zero of one sign or the other."""
    return np.random.default_rng(seed).choice(np.array([-0.0, 0.0, -1.0, -2.0], np.float32), size=shape)


def _assert_bitwise_with_both_zeros(got, want):
    gb, wb = _bits(got), _bits(want)
    np.testing.assert_array_equal(gb, wb)
    neg0 = -32768 if gb.dtype == np.int16 else np.iinfo(np.int32).min
    assert (wb == 0).any() and (wb == neg0).any()  # the input made +0.0 and -0.0 results both


def _assert_nan_like_jax(got, want):
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    assert np.isnan(w).any()
    keep = ~np.isnan(w)
    np.testing.assert_array_equal(_bits(got)[keep], _bits(want)[keep])


# ------------------------------------------------------------- signed zeros


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", ["sep2", "phases"])
@pytest.mark.parametrize("c", [7, 96])
def test_maxpool2d_signed_zeros_bitwise_jax(c, variant, dtype):
    jx, tx = _both(_signed_zeros((2, 11, 13, c), seed=c), dtype)
    _assert_bitwise_with_both_zeros(ck.maxpool2d(tx, window=3, stride=2),
                                    pk.maxpool_pallas(jx, window=3, stride=2, variant=variant))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_maxpool2d_w_signed_zeros_bitwise_jax(dtype):
    jx, tx = _both(_signed_zeros((2, 5, 13, 40), seed=3), dtype)
    _assert_bitwise_with_both_zeros(ck.maxpool2d_w(tx, window=3, stride=2),
                                    pk.maxpool_pallas_w(jx, window=3, stride=2))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_maxpool_phases_signed_zeros_bitwise_jax(dtype):
    jx, tx = _both(_signed_zeros((2, 11, 11, 20), seed=4), dtype)
    _assert_bitwise_with_both_zeros(ck.maxpool_phases(tx, window=3, stride=2),
                                    pk.maxpool_pallas(jx, window=3, stride=2, variant="phases"))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_maxpool_s2d_signed_zeros_bitwise_jax(dtype):
    jx, tx = _both(_signed_zeros((2, 11, 11, 20), seed=5), dtype)
    _assert_bitwise_with_both_zeros(ck.maxpool_s2d(tx, window=3, stride=2), jab.pool_s2d128(jx, window=3, stride=2))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window, stride", [(3, 2), (2, 2), (3, 1)])
def test_reference_maxpool_signed_zeros_bitwise_jax(window, stride, dtype):
    jx, tx = _both(_signed_zeros((2, 9, 10, 6), seed=6), dtype)
    _assert_bitwise_with_both_zeros(tref.maxpool(tx, window=window, stride=stride),
                                    jref.maxpool(jx, window=window, stride=stride))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_reference_relu_maxpool_bitwise_jax(dtype):
    """The model paths' ReLU and pool, pool first: every non-positive max,
    -0.0 included, comes out +0.0, as JAX's pool of ReLU's output."""
    x = _signed_zeros((2, 9, 10, 6), seed=7)
    x[0] = np.abs(x[0]) + 0.5  # positive windows in the first image, zero ones in the second
    x[1, :3] = -np.abs(x[1, :3]) - 0.5  # and windows of negatives only
    jx, tx = _both(x, dtype)
    want = jref.maxpool(jref.relu(jx), window=3, stride=2)
    got = tref.relu_maxpool(tx, window=3, stride=2)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (_bits(got) == 0).any() and not torch.signbit(got).any()
    np.testing.assert_array_equal(_bits(got), _bits(tref.maxpool(tref.relu(tx), window=3, stride=2)))
    x[1, 4, 4, 2] = np.nan
    jx, tx = _both(x, dtype)
    got = tref.relu_maxpool(tx, window=3, stride=2).float().numpy()
    want = np.asarray(jref.maxpool(jref.relu(jx), window=3, stride=2).astype(jnp.float32))
    assert np.isnan(got).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


# ------------------------------------------------------------- subnormals


def _subnormal_windows(shape, dtype, seed) -> np.ndarray:
    """Subnormals of both signs (bf16's, for bf16: the fp32 values whose low 16 bits are 0) mixed with +0.0
    and -0.0, so that windows hold only subnormals, subnormals and zeros of either sign, or only zeros."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(1, 1 << 23, size=shape, dtype=np.uint32)
    if dtype == "bf16":
        bits = ((bits >> 16) | 1) << 16  # a nonzero 7-bit mantissa in the high half
    bits |= rng.integers(0, 2, size=shape, dtype=np.uint32) << 31
    kind = rng.integers(0, 5, size=shape)
    bits = np.where(kind == 3, np.uint32(0), np.where(kind == 4, np.uint32(1 << 31), bits))
    return bits.view(np.float32)


def _assert_bitwise_or_flushed(got, want):
    """Every bit of ``got`` (the port) is ``want``'s (JAX's), except where the port's value is a subnormal
    and JAX's is that subnormal flushed to the zero of its sign; the two then differ by less than 2^-126."""
    wide = got.element_size() == 4
    ut = np.uint32 if wide else np.uint16
    gb, wb = _bits(got).view(ut), _bits(want).view(ut)
    sign, expo = (ut(1 << 31), ut(0xFF << 23)) if wide else (ut(1 << 15), ut(0xFF << 7))
    sub = ((gb & expo) == 0) & ((gb & ~sign) != 0)
    flushed = sub & (wb != gb)
    np.testing.assert_array_equal(np.where(flushed, gb & sign, gb), wb)
    diff = np.abs(got.double().numpy() - np.asarray(want.astype(jnp.float32)).astype(np.float64))
    assert (diff < 2.0**-126).all()
    assert sub.any()  # the windows made subnormal maxima


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pool", ["maxpool2d", "maxpool2d_w", "maxpool_phases", "reference"])
def test_subnormal_windows_match_jax_up_to_its_flush(pool, dtype):
    """The ruling on subnormal pool inputs: XLA's CPU backend reads a
    subnormal operand as a zero of its sign, the port (and the card, and XLA
    on a GPU, whose flush-to-zero is off by default) keeps it. So the port
    agrees with JAX bit for bit but where JAX flushed, and there its value
    is the port's subnormal flushed: a difference under 2^-126, far inside
    every stage budget (fp32 1e-4 abs / 1e-5 rel)."""
    x = _subnormal_windows((2, 11, 13, 24), dtype, seed=12)
    jx, tx = _both(x, dtype)
    fns = {
        "maxpool2d": (lambda: ck.maxpool2d(tx, window=3, stride=2),
                      lambda: pk.maxpool_pallas(jx, window=3, stride=2, variant="sep2")),
        "maxpool2d_w": (lambda: ck.maxpool2d_w(tx, window=3, stride=2),
                        lambda: pk.maxpool_pallas_w(jx, window=3, stride=2)),
        "maxpool_phases": (lambda: ck.maxpool_phases(tx, window=3, stride=2),
                           lambda: pk.maxpool_pallas(jx, window=3, stride=2, variant="phases")),
        "reference": (lambda: tref.maxpool(tx, window=3, stride=2).contiguous(),
                      lambda: jref.maxpool(jx, window=3, stride=2)),
    }
    got, want = (f() for f in fns[pool])
    _assert_bitwise_or_flushed(got, want)


def test_minus_zero_first_or_last_in_a_window_gives_plus_zero():
    """The two windows the max rule was repaired on: -0.0 at tap (0, 0) and
    +0.0 elsewhere, and -0.0 everywhere but one +0.0 (at the last tap)."""
    x = np.zeros((1, 3, 6, 1), np.float32)
    x[0, 0, 0, 0] = -0.0
    x[0, :, 3:, 0] = -0.0
    x[0, 2, 5, 0] = 0.0
    jx, tx = _both(x, "fp32")
    want = pk.maxpool_pallas(jx, window=3, stride=3, variant="sep2")
    for got in (ck.maxpool2d(tx, window=3, stride=3), tref.maxpool(tx, window=3, stride=3)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
        assert not torch.signbit(got).any()


def _zero_conv_case(dtype, c=3, k=16, f=11):
    """A zero input, negative weights and a -0.0 bias: every conv output is
    a zero, and ReLU must make each +0.0."""
    x = np.zeros((2, 43, 43, c), np.float32)
    w = -np.random.default_rng(8).uniform(0.25, 1.0, (f, f, c, k)).astype(np.float32)
    b = np.full((k,), -0.0, np.float32)
    return _both(x, dtype), _both(w, dtype), _both(b, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_conv_hpool_and_w_stage_zero_sign_bitwise_jax(dtype):
    (jx, tx), (jw, tw), (jb, tb) = _zero_conv_case(dtype)
    kw = dict(stride=4, padding=0)
    want = pk.maxpool_pallas_w(
        pk.conv2d_pallas(jx, jw, jb, relu=True, variant="vcol", row_block=64, k_block=0, hpool=(3, 2), **kw),
        window=3, stride=2)
    got = ck.maxpool2d_w(ck.conv2d_bias_relu(tx, tw, tb, hpool=(3, 2), **kw), window=3, stride=2)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (_bits(got) == 0).all()


@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8w"])
def test_conv_block_zero_sign_bitwise_jax(policy):
    (jx, tx), (jw, tw), (jb, tb) = _zero_conv_case("fp32" if policy == "int8w" else policy, k=96)
    kw = dict(stride=4, padding=0, pool_window=3, pool_stride=2)
    if policy == "int8w":
        q, s = jq.quantize_channelwise(jw)
        want = jmk.int8w_conv_block_pallas(jx, q, s, jb, lrn=None, **kw)
        got = ck.conv_block(tx.to(torch.bfloat16), torch.from_numpy(np.array(q)), tb,
                            scale=torch.from_numpy(np.array(s)), **kw)
    else:
        want = jmk.conv_block_pallas(jx, jw, jb, lrn=None, **kw)
        got = ck.conv_block(tx, tw, tb, **kw)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (_bits(got) == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_reference_relu_and_conv_zero_sign_bitwise_jax(dtype):
    v = np.array([-0.0, 0.0, -1.0, 2.5, -np.inf, np.inf], np.float32)
    jv, tv = _both(v, dtype)
    np.testing.assert_array_equal(_bits(tref.relu(tv)), _bits(jref.relu(jv)))
    (jx, tx), (jw, tw), (jb, tb) = _zero_conv_case(dtype, f=3)
    want = jref.relu(jref.conv2d(jx, jw, jb, stride=1, padding=1))
    got = tref.relu(tref.conv2d(tx, tw, tb, stride=1, padding=1))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (_bits(got) == 0).all()


# ---------------------------------------------------------------------- NaN


def _nan_input(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[3::29] = np.nan
    return x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pool", ["maxpool2d", "maxpool2d_w", "maxpool_phases", "maxpool_s2d", "reference"])
def test_nan_windows_give_nan_where_jax_does(pool, dtype):
    x = _nan_input((2, 11, 13, 24), seed=9)
    jx, tx = _both(x, dtype)
    fns = {
        "maxpool2d": (lambda: ck.maxpool2d(tx, window=3, stride=2),
                      lambda: pk.maxpool_pallas(jx, window=3, stride=2, variant="sep2")),
        "maxpool2d_w": (lambda: ck.maxpool2d_w(tx, window=3, stride=2),
                        lambda: pk.maxpool_pallas_w(jx, window=3, stride=2)),
        "maxpool_phases": (lambda: ck.maxpool_phases(tx, window=3, stride=2),
                           lambda: pk.maxpool_pallas(jx, window=3, stride=2, variant="phases")),
        "maxpool_s2d": (lambda: ck.maxpool_s2d(tx, window=3, stride=2),
                        lambda: jab.pool_s2d128(jx, window=3, stride=2)),
        "reference": (lambda: tref.maxpool(tx, window=3, stride=2).contiguous(),
                      lambda: jref.maxpool(jx, window=3, stride=2)),
    }
    got, want = (f() for f in fns[pool])
    _assert_nan_like_jax(got, want)


# ------------------------------------------------------- the instance choice


@pytest.mark.parametrize("c, dtype, want", [
    (96, torch.float32, 4), (96, torch.bfloat16, 8), (256, torch.float32, 4), (256, torch.bfloat16, 8),
    (40, torch.bfloat16, 8), (7, torch.float32, 1), (7, torch.bfloat16, 1), (3, torch.float32, 1),
    (1100, torch.bfloat16, 1),
])
def test_vector_width_by_channels_and_dtype(c, dtype, want):
    assert ck.vector_width(c, dtype, 0, 1 << 20) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_width_of_a_view_off_alignment_is_scalar(dtype):
    buf = torch.zeros(2 * 5 * 5 * 96 + 1, dtype=dtype)
    x = buf[1:].view(2, 5, 5, 96)  # 4 (fp32) or 2 (bf16) bytes past the buffer's start
    assert x.is_contiguous() and (x.data_ptr() - buf.data_ptr()) == x.element_size()
    assert ck.vector_width(96, dtype, buf.data_ptr()) == 16 // x.element_size()
    assert ck.vector_width(96, dtype, x.data_ptr()) == 1
    assert ck.vector_width(96, dtype, buf.data_ptr(), x.data_ptr()) == 1


# ---------------------------------------------------------------------- LRN


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("alpha_over_size", [False, True])
@pytest.mark.parametrize("size", [3, 5])
def test_lrn_at_256_channels_matches_pallas(size, alpha_over_size, dtype):
    # large values, so that a * sum(x^2) dominates k and the power moves every output
    x = (np.random.default_rng(size).standard_normal((2, 4, 5, 256)) * 100).astype(np.float32)
    jx, tx = _both(x, dtype)
    kw = dict(size=size, alpha=1e-4, beta=0.75, k=2.0, alpha_over_size=alpha_over_size)
    want = np.asarray(pk.lrn_pallas(jx, **kw).astype(jnp.float32))
    got = ck.lrn(tx, **kw)
    assert got.dtype == DTYPES[dtype][1]
    scale = 2.0 + kw["alpha"] / (size if alpha_over_size else 1) * np.square(x).max()
    assert scale > 4  # the scale term matters
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-7)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP_REL, atol=1e-6)
