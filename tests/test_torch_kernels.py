"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``ops.cuda_kernels`` runs its plain PyTorch
version (the kernels themselves run only on the card, where
``chip_smoke.py`` holds each one against the same plain version). The
Pallas kernels run in interpret mode, as ``tests/test_pallas.py`` runs
them. Inputs are made with numpy from a seed and handed to both.

Tolerances and why:
- conv fp32: 1e-5 rel / 1e-5 abs. Both accumulate in fp32, in different
  orders (tap by tap here; per qh row over the packed (qw, c) axis there).
- conv/LRN bf16: one bf16 ulp (at most 2^-7 of the value). Both cast once
  from an fp32 result; a different fp32 summation order can flip that
  rounding.
- pool: bitwise (max is exact), fp32 and bf16, NaN included.
- LRN fp32: 2e-6 rel. The window sum and the power are fp32 in both, with
  another summation order and another ``pow``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.ops import pallas_kernels as pk
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import _build
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

BF16_ULP_REL = 2.0**-7

# (N, H, W, C, F, K, stride, pad)
CONV_CASES = {
    "conv1_like": (2, 23, 23, 3, 11, 8, 4, 0),
    "conv1_like_crop": (1, 25, 25, 3, 11, 8, 4, 0),  # (25 - 11) % 4 != 0: floor crop
    "conv2_like": (2, 9, 9, 12, 5, 16, 1, 2),
}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)


def _both(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _assert_close(got, want, dtype, rtol_fp32, atol_fp32):
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=rtol_fp32, atol=atol_fp32)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP_REL, atol=1e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_plain_matches_pallas(rng, case, dtype):
    n, h, w, c, f, k, s, p = CONV_CASES[case]
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((f, f, c, k)) / np.sqrt(f * f * c)).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = _both(x, dtype), _both(wt, dtype), _both(b, dtype)
    want = pk.conv2d_pallas(jx, jw, jb, stride=s, padding=p, relu=True, variant="vcol", row_block=64, k_block=0)
    got = ck.conv2d_bias_relu(tx, tw, tb, stride=s, padding=p, relu=True)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == tuple(want.shape)
    _assert_close(_np(got), _np(want), dtype, 1e-5, 1e-5)
    assert (_np(got) == 0).any()  # ReLU clamped something


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 15, 15, 8), (1, 13, 13, 32), (2, 8, 8, 4)])
def test_pool_plain_bitwise_pallas(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 1, 2, 0] = np.nan  # the max propagates NaN, as jnp.maximum does
    jx, tx = _both(x, dtype)
    want = pk.maxpool_pallas(jx, window=3, stride=2, variant="sep2")
    got = ck.maxpool2d(tx, window=3, stride=2)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(_np(got), _np(want))
    assert np.isnan(_np(got)[0, 0, 0, 0])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("alpha_over_size", [False, True])
def test_lrn_plain_matches_pallas(rng, alpha_over_size, dtype):
    x = (rng.standard_normal((2, 5, 5, 16)) * 30).astype(np.float32)
    jx, tx = _both(x, dtype)
    kw = dict(size=5, alpha=1e-4, beta=0.75, k=2.0, alpha_over_size=alpha_over_size)
    want = pk.lrn_pallas(jx, **kw)
    got = ck.lrn(tx, **kw)
    assert got.dtype == DTYPES[dtype][1]
    _assert_close(_np(got), _np(want), dtype, 2e-6, 1e-7)


def test_cpu_wrappers_take_the_plain_path_and_launch_nothing(rng):
    x = torch.from_numpy(rng.standard_normal((1, 9, 9, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 4, 8)).astype(np.float32))
    b = torch.zeros(8)
    ck.reset_launches()
    y = ck.conv2d_bias_relu(x, w, b, stride=1, padding=1)
    torch.testing.assert_close(y, ck.conv2d_bias_relu_plain(x, w, b, stride=1, padding=1), rtol=0, atol=0)
    p = ck.maxpool2d(y, window=3, stride=2)
    torch.testing.assert_close(p, ck.maxpool2d_plain(y, window=3, stride=2), rtol=0, atol=0)
    kw = dict(size=5, alpha=1e-4, beta=0.75, k=2.0)
    torch.testing.assert_close(ck.lrn(p, **kw), ck.lrn_plain(p, **kw), rtol=0, atol=0)
    assert set(ck.LAUNCHES) >= {"conv2d", "maxpool2d", "lrn", "conv_block"}
    assert ck.LAUNCHES == dict.fromkeys(ck.LAUNCHES, 0)


@pytest.mark.parametrize(
    "bad",
    ["x_fp16", "mixed_dtypes", "non_contiguous", "channel_mismatch", "bias_shape", "empty_output"],
)
def test_conv_wrapper_rejects_bad_input(bad):
    x, w, b = torch.zeros(1, 9, 9, 4), torch.zeros(3, 3, 4, 8), torch.zeros(8)
    kw = dict(stride=1, padding=0)
    if bad == "x_fp16":
        x, w, b = x.half(), w.half(), b.half()
    elif bad == "mixed_dtypes":
        w = w.to(torch.bfloat16)
    elif bad == "non_contiguous":
        x = x.transpose(1, 2)
    elif bad == "channel_mismatch":
        w = torch.zeros(3, 3, 5, 8)
    elif bad == "bias_shape":
        b = torch.zeros(7)
    elif bad == "empty_output":
        w, kw = torch.zeros(11, 11, 4, 8), dict(stride=1, padding=0)
    with pytest.raises((TypeError, ValueError)):
        ck.conv2d_bias_relu(x, w, b, **kw)


def test_pool_and_lrn_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        ck.maxpool2d(torch.zeros(1, 2, 2, 4), window=3, stride=2)  # window past the image
    with pytest.raises(ValueError):
        ck.maxpool2d(torch.zeros(4, 4, 4), window=3, stride=2)  # not NHWC
    with pytest.raises(TypeError):
        ck.lrn(torch.zeros(1, 2, 2, 4, dtype=torch.float64), size=5, alpha=1e-4, beta=0.75, k=2.0)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not any(tmp_path.iterdir())


def test_build_key_follows_the_sources(monkeypatch, tmp_path):
    assert {p.name for p in _build.sources()} == {
        "conv2d.cu", "maxpool.cu", "lrn.cu", "conv_block.cu",
        "conv_taps.cu", "conv_pairs.cu", "conv_im2col.cu", "conv_g8.cu", "maxpool_phases.cu",
        "maxpool_s2d.cu", "relu.cu", "flash_fwd.cu", "flash_dq.cu", "flash_dkv.cu",
    }
    for p in _build.CSRC_DIR.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.source_hash()
    header = tmp_path / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.source_hash() != before


HEADERS = ["common.cuh", "conv_sm90.cuh", "flash_bwd_sm90.cuh", "pool_keys.cuh", "sm90_ptx.cuh"]


@pytest.mark.parametrize("header", HEADERS)
def test_build_key_follows_each_header(header, monkeypatch, tmp_path):
    """Every header the sources include (conv_sm90.cuh: the mainloop of
    the six conv kernels; flash_bwd_sm90.cuh: the flash backward at every
    D and the forward at D <= 128; sm90_ptx.cuh: the PTX wrappers both share; pool_keys.cuh: the
    three max-pools' order keys) is part of the build key: editing one
    builds the library anew."""
    assert {p.name for p in _build.CSRC_DIR.glob("*.cuh")} == set(HEADERS)
    for p in _build.CSRC_DIR.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.source_hash()
    (tmp_path / header).write_text((tmp_path / header).read_text() + "\n// edited\n")
    assert _build.source_hash() != before


@pytest.mark.parametrize("h,w,pad,ok", [(227, 227, 0, True), (16383, 8, 2, True), (16384, 8, 0, False),
                                        (8, 16384, 0, False), (8, 8, 16384, False)])
def test_the_cuda_conv_mainloop_dims_limit(h, w, pad, ok):
    """conv_sm90.cuh packs a window origin into 16-bit halves: the CUDA
    branches of conv2d_bias_relu and conv_block refuse H, W or padding from
    2^14 on, before any launch (the CPU runs any size)."""
    if ok:
        ck._check_sm90_dims("conv2d_bias_relu", h, w, pad)
    else:
        with pytest.raises(ValueError, match="below 16384 on CUDA"):
            ck._check_sm90_dims("conv2d_bias_relu", h, w, pad)
