"""The packs of the port's two stride-phase pools, the phases kernel alone
on its stack, and the order keys the three pool kernels share, against the
JAX package on the CPU.

On the CPU ``ck.pool_phases_pack``, ``ck.s2d_pool_pack`` and
``ck.maxpool_phases_packed`` run their plain PyTorch versions (the CUDA
kernels of ``csrc/maxpool_phases.cu`` and ``csrc/maxpool_s2d.cu`` run only
on the card, where ``chip_smoke.py`` holds each one bitwise against the same
plain version); the Pallas kernels run in interpret mode, as the JAX
package's tests run them, and ``scripts/pool_ab.py`` is loaded read-only
from its file. Inputs are made with numpy from a seed and handed to both.

Tolerance: bitwise (a pack only moves and zero-fills values; a max only
selects them), NaN payloads aside: where JAX has a NaN the port has one.

The order keys (``csrc/pool_keys.cuh`` ``key32``, ``key16x2``) are modelled
in numpy and held to ``jnp.maximum``: every bf16 bit pattern that is not a
NaN, and a seeded fp32 sample with +-0, +-inf, subnormals and the extremes.
XLA on the CPU flushes subnormal operands to zeros of their sign before it
takes the max (the card does not, nor do the port's plain versions), so
``jnp.maximum`` is compared on the operands so flushed, and the keys order
subnormals among themselves as IEEE does.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.ops import pallas_kernels as pk
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import packing

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "pool_ab.py"
_spec = importlib.util.spec_from_file_location("jax_pool_ab_for_pool_pack", SCRIPT)
jab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jab)

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


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


def _assert_bitwise(got, want):
    """Bitwise, NaN payloads aside: NaN where JAX has NaN, every other value's bits."""
    assert tuple(got.shape) == tuple(np.shape(want))
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    keep = ~np.isnan(w)
    np.testing.assert_array_equal(_bits(got)[keep], _bits(want)[keep])


def _hp_wp(h, w, window, stride):
    q = (window - 1) // stride
    return (h - window) // stride + 1 + q, (w - window) // stride + 1 + q


# ----------------------------------------------------- the phases kernel alone


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape, window, stride", [((2, 27, 27, 8), 3, 2), ((1, 13, 12, 5), 3, 2),
                                                   ((2, 9, 9, 3), 2, 2), ((1, 8, 8, 4), 3, 1)])
def test_maxpool_phases_packed_bitwise_pallas(shape, window, stride, dtype):
    """The kernel alone on the stack (the plain version on the CPU) against
    the JAX package's phases pool, at test_torch_variants' shapes."""
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    x[0, 0, 0, 0] = np.nan  # NaN propagates in both
    jx, tx = _both(x, dtype)
    want = pk.maxpool_pallas(jx, window=window, stride=stride, variant="phases")
    xph = packing.pool_phases(tx, stride, *_hp_wp(shape[1], shape[2], window, stride))
    got = ck.maxpool_phases_packed(xph, window=window, stride=stride)
    assert got.dtype == DTYPES[dtype][1] and got.is_contiguous()
    _assert_bitwise(got, want)
    assert torch.equal(_bits_t(got), _bits_t(ck.maxpool_phases(tx, window=window, stride=stride)))


def _bits_t(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("bad", ["rank", "phases", "hp", "wp", "dtype", "device"])
def test_maxpool_phases_packed_raises_on_a_bad_stack(bad):
    """A stack the kernel does not take raises. The entry takes one tensor,
    so a device the kernels do not run on (meta) stands for a device mix."""
    xph = torch.zeros((4, 2, 7, 7, 8))
    kw = dict(window=3, stride=2)
    if bad == "rank":
        xph = xph[0]
    elif bad == "phases":
        kw = dict(window=3, stride=3)  # 9 phases for 4
    elif bad == "hp":
        xph = xph[:, :, :1]  # hp 1: no output row for q = 1
    elif bad == "wp":
        xph = xph[:, :, :, :1].contiguous()
    elif bad == "dtype":
        xph = xph.double()
    else:
        xph = torch.zeros((4, 2, 7, 7, 8), device="meta")
    with pytest.raises((TypeError, ValueError)):
        ck.maxpool_phases_packed(xph.contiguous(), **kw)


def test_the_cpu_packs_launch_nothing():
    ck.reset_launches()
    x = torch.randn((1, 9, 9, 20))
    ck.pool_phases_pack(x, window=3, stride=2)
    ck.s2d_pool_pack(x, window=3, stride=2)
    ck.maxpool_phases_packed(ck.pool_phases_pack(x, window=3, stride=2), window=3, stride=2)
    assert ck.LAUNCHES == dict.fromkeys(ck.LAUNCHES, 0)


# ------------------------------------------------------------------ the packs

PACK_CASES = [((2, 15, 17, 20), 3, 2), ((2, 13, 11, 96), 3, 2), ((1, 9, 13, 128), 2, 2),
              ((1, 7, 9, 256), 3, 1), ((1, 17, 15, 20), 5, 3)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape, window, stride", PACK_CASES)
def test_pool_phases_pack_bitwise_jax(shape, window, stride, dtype):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    jx, tx = _both(x, dtype)
    hp, wp = _hp_wp(shape[1], shape[2], window, stride)
    got = ck.pool_phases_pack(tx, window=window, stride=stride)
    assert got.is_contiguous() and got.shape == (stride * stride, shape[0], hp, wp, shape[3])
    _assert_bitwise(got, pk._pool_phases(jx, stride, hp, wp))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape, window, stride", PACK_CASES)
def test_s2d_pool_pack_bitwise_jax(shape, window, stride, dtype):
    """The pack against ``pool_s2d128``'s own pad and ``_space_to_depth``."""
    n, h, w, c = shape
    x = np.random.default_rng(sum(shape) + 1).standard_normal(shape).astype(np.float32)
    jx, tx = _both(x, dtype)
    hs, ws = _hp_wp(h, w, window, stride)
    cp = -(-c // 128) * 128
    want = pk._space_to_depth(jnp.pad(jx, ((0, 0), (0, 0), (0, 0), (0, cp - c))), stride, hs, ws)
    got = ck.s2d_pool_pack(tx, window=window, stride=stride)
    assert got.is_contiguous()
    _assert_bitwise(got, want)
    _assert_bitwise(ck.maxpool_s2d_packed(got, c, window=window, stride=stride),
                    jab.pool_s2d128(jx, window=window, stride=stride))


# ------------------------------------------------------------ the order keys


def key32(b: np.ndarray) -> np.ndarray:
    """``pool_keys.cuh`` key32 on uint32 bits: the magnitude flipped where the sign is set."""
    b = b.astype(np.uint32)
    return b ^ (((b.view(np.int32) >> 31).view(np.uint32)) & np.uint32(0x7FFFFFFF))


def key16x2(w: np.ndarray) -> np.ndarray:
    """``pool_keys.cuh`` key16x2 on uint32 words of two bf16."""
    w = w.astype(np.uint32)
    return w ^ (((w >> np.uint32(15)) & np.uint32(0x00010001)) * np.uint32(0x7FFF))


def _key16(h: np.ndarray) -> np.ndarray:
    """The key of each bf16 (uint16 bits) as a signed 16-bit integer: key16x2's low half."""
    return (key16x2(h.astype(np.uint32)) & np.uint32(0xFFFF)).astype(np.uint16).view(np.int16)


def _flushed(bits: np.ndarray, dtype: str) -> np.ndarray:
    """Subnormal bits flushed to the zero of their sign, as XLA on the CPU reads its operands."""
    sign, mag = (0x8000, 0x7FFF) if dtype == "bf16" else (0x80000000, 0x7FFFFFFF)
    exp = 0x7F80 if dtype == "bf16" else 0x7F800000
    b = bits.astype(np.int64) & (0xFFFF if dtype == "bf16" else 0xFFFFFFFF)
    sub = ((b & exp) == 0) & ((b & mag) != 0)
    return np.where(sub, b & sign, b)


def _key_of(bits: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "bf16":
        return _key16(bits.astype(np.uint16)).astype(np.int64)
    return key32(bits.astype(np.uint32)).view(np.int32).astype(np.int64)


def _jnp_max_bits(a: np.ndarray, b: np.ndarray, dtype: str) -> np.ndarray:
    jdt = DTYPES[dtype][0]
    if dtype == "bf16":
        ja, jb = (jnp.asarray(v.astype(np.uint16).view(jdt)) for v in (a, b))
        return np.asarray(jnp.maximum(ja, jb)).view(np.uint16).astype(np.int64)
    ja, jb = (jnp.asarray(v.astype(np.uint32).view(np.float32)) for v in (a, b))
    return np.asarray(jnp.maximum(ja, jb)).view(np.uint32).astype(np.int64)


def _is_nan(bits: np.ndarray, dtype: str) -> np.ndarray:
    exp, man = (0x7F80, 0x7F) if dtype == "bf16" else (0x7F800000, 0x7FFFFF)
    return ((bits & exp) == exp) & ((bits & man) != 0)


def _fp32_sample() -> np.ndarray:
    """uint32 bits: seeded normals at several scales, subnormals of both
    signs, +-0, +-inf, the extremes, every one of them once."""
    rng = np.random.default_rng(2034)
    vals = np.concatenate([rng.standard_normal(3000) * s for s in (1e-30, 1.0, 1e30)]).astype(np.float32)
    bits = vals.view(np.uint32)
    sub = rng.integers(1, 0x800000, 1000, dtype=np.uint32)
    specials = np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 1, 0x80000001, 0x7FFFFF, 0x807FFFFF,
                         0x800000, 0x80800000, 0x7F7FFFFF, 0xFF7FFFFF], np.uint32)
    return np.unique(np.concatenate([bits, sub, sub | np.uint32(0x80000000), specials]))


def _every_bf16_but_nan() -> np.ndarray:
    h = np.arange(65536, dtype=np.int64)
    return h[~_is_nan(h, "bf16")]


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_order_keys_order_every_value_as_jnp_maximum(dtype):
    """Sorted by key, the values run up in ``jnp.maximum``'s order: of two
    neighbours, and of 200000 seeded pairs, the max takes the larger key
    (-0.0 below +0.0; subnormals flushed as XLA on the CPU reads them); on
    subnormals alone the keys follow the values; the key is one-to-one and
    its own inverse."""
    bits = _every_bf16_but_nan() if dtype == "bf16" else _fp32_sample().astype(np.int64)
    keys = _key_of(bits, dtype)
    assert len(np.unique(keys)) == len(bits)
    mask = 0xFFFF if dtype == "bf16" else 0xFFFFFFFF
    np.testing.assert_array_equal(_key_of(keys & mask, dtype) & mask, bits)  # its own inverse

    order = np.argsort(keys, kind="stable")
    lo, hi = bits[order[:-1]], bits[order[1:]]
    rng = np.random.default_rng(7)
    pa, pb = rng.choice(bits, 200_000), rng.choice(bits, 200_000)
    for a, b in ((lo, hi), (hi, lo), (pa, pb)):
        fa, fb = _flushed(a, dtype), _flushed(b, dtype)
        want = np.where(_key_of(fa, dtype) >= _key_of(fb, dtype), fa, fb)
        np.testing.assert_array_equal(_jnp_max_bits(a, b, dtype), want)

    vals = (bits.astype(np.uint16).view(np.int16).astype(np.int32) << 16).astype(np.int32).view(np.float32) \
        if dtype == "bf16" else bits.astype(np.uint32).view(np.float32)
    sub = (np.abs(vals) < np.finfo(np.float32).tiny) & (vals != 0)
    assert sub.sum() > 100
    by_key = vals[sub][np.argsort(keys[sub])]
    assert (np.diff(by_key.astype(np.float64)) > 0).all()


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_nan_keys_lie_outside_the_infinities(dtype):
    """A NaN's key lies above +inf's (positive sign) or below -inf's
    (negative): the min and max keys of a window show a NaN in it."""
    if dtype == "bf16":
        nan = np.arange(65536, dtype=np.int64)
        nan = nan[_is_nan(nan, "bf16")]
        pinf, ninf = 0x7F80, 0xFF80
        sign = nan >= 0x8000
    else:
        rng = np.random.default_rng(3)
        nan = (rng.integers(1, 0x800000, 5000) | 0x7F800000 | (rng.integers(0, 2, 5000) << 31)).astype(np.int64)
        pinf, ninf = 0x7F800000, 0xFF800000
        sign = nan >= 0x80000000
    keys = _key_of(nan, dtype)
    top, bottom = _key_of(np.array([pinf]), dtype)[0], _key_of(np.array([ninf]), dtype)[0]
    assert (keys[~sign] > top).all() and (keys[sign] < bottom).all()


def test_key16x2_is_key16_on_each_half():
    rng = np.random.default_rng(5)
    w = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    lo, hi = (w & np.uint32(0xFFFF)).astype(np.uint16), (w >> np.uint32(16)).astype(np.uint16)
    k_hi, k_lo = (_key16(h).view(np.uint16).astype(np.uint32) for h in (hi, lo))
    want = (k_hi << np.uint32(16)) | k_lo
    np.testing.assert_array_equal(key16x2(w), want)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_window_max_by_keys_is_the_pallas_pool(dtype):
    """A 3x3/2 pool taken as the kernels take it, the largest key of each
    window (no NaN), bitwise the JAX package's phases pool, on values drawn
    from +-0, +-inf, negatives and normals (no subnormal: XLA on the CPU
    would flush them)."""
    rng = np.random.default_rng(11)
    pool = np.array([-0.0, 0.0, -np.inf, np.inf, -1.5, 2.25, -3.0, 1e-3, -7e20], np.float32)
    x = rng.choice(pool, size=(2, 9, 11, 6))
    jx, tx = _both(x, dtype)
    want = pk.maxpool_pallas(jx, window=3, stride=2, variant="phases")
    bits = _bits(tx).astype(np.int64) & (0xFFFF if dtype == "bf16" else 0xFFFFFFFF)
    keys = _key_of(bits, dtype)
    taps = [(fy, fx) for fy in range(3) for fx in range(3)]
    win = np.stack([keys[:, fy : fy + 7 : 2, fx : fx + 9 : 2, :] for fy, fx in taps])
    got_keys = win.max(axis=0)
    got = _key_of(got_keys, dtype) if dtype == "fp32" else _key_of(got_keys & 0xFFFF, dtype)
    want_bits = _bits(want).astype(np.int64) & (0xFFFF if dtype == "bf16" else 0xFFFFFFFF)
    np.testing.assert_array_equal(got & (0xFFFF if dtype == "bf16" else 0xFFFFFFFF), want_bits)
