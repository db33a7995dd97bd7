"""The port's pool A/B (``pool_ab.py``) and its space-to-depth pool against
the JAX package's ``scripts/pool_ab.py``, on the CPU. ``pool_ab.main`` and
the wrapper's refusals are in ``tests/test_torch_pool_ab_main.py``.

On the CPU ``ck.maxpool_s2d`` runs its plain PyTorch version (the CUDA
kernel ``csrc/maxpool_s2d.cu`` runs only on the card, where
``chip_smoke.py`` holds it bitwise against the same plain version); the
JAX script's ``pool_s2d128`` runs its Pallas kernel in interpret mode, as
the JAX package's tests run theirs. The script is loaded read-only from its
file. Inputs are made with numpy from a seed and handed to both.

Tolerance: bitwise everywhere (a max only selects values; the pads and
repacks only move and zero-fill them). bf16 is compared by its bits.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu_torch import pool_ab
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import packing

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "pool_ab.py"
_spec = importlib.util.spec_from_file_location("jax_pool_ab", SCRIPT)
jab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jab)

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the JAX script's strategies, in its order (the keys of its ``strategies`` dict)
JAX_ORDER = tuple(re.findall(r'^\s+"(\w+)": lambda', SCRIPT.read_text(), re.M))

# name: ((N, H, W, C), window, stride)
S2D_CASES = {
    "pool1": ((2, 55, 55, 96), 3, 2),
    "pool2": ((2, 27, 27, 256), 3, 2),
    "c20": ((2, 15, 15, 20), 3, 2),
    "c128": ((2, 15, 15, 128), 3, 2),
    "c130": ((2, 15, 15, 130), 3, 2),
    "w2s2": ((2, 16, 16, 96), 2, 2),
    "w3s1": ((2, 9, 9, 130), 3, 1),
    "w5s3": ((2, 17, 17, 20), 5, 3),
    "h_ne_w": ((2, 13, 21, 96), 3, 2),
}


def _inputs(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _assert_bitwise(got, want):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(S2D_CASES))
def test_maxpool_s2d_bitwise_equals_pool_s2d128(case, dtype):
    """The wrapper (the plain version on the CPU) and the plain version
    against the JAX script's ``pool_s2d128``; the same as the main path's pool."""
    shape, window, stride = S2D_CASES[case]
    jx, tx = _inputs(shape, dtype, seed=len(case))
    want = jab.pool_s2d128(jx, window=window, stride=stride)
    got = ck.maxpool_s2d(tx, window=window, stride=stride)
    assert got.dtype == DTYPES[dtype][1] and got.is_contiguous()
    _assert_bitwise(got, want)
    _assert_bitwise(ck.maxpool_s2d_plain(tx, window=window, stride=stride), want)
    _assert_bitwise(ck.maxpool2d(tx, window=window, stride=stride), want)


@pytest.mark.parametrize("case", ["pool1", "c20", "w5s3"])
def test_s2d_operand_is_the_pad_and_repack_of_the_jax_script(case):
    """The kernel's operand, and the packed entry on it, against the JAX
    script's own pad and ``pk._space_to_depth``."""
    (n, h, w, c), window, stride = S2D_CASES[case]
    jx, tx = _inputs((n, h, w, c), "fp32", seed=3)
    q = (window - 1) // stride
    ho, wo = (h - window) // stride + 1, (w - window) // stride + 1
    cp = -(-c // 128) * 128
    want = jab.pk._space_to_depth(jnp.pad(jx, ((0, 0), (0, 0), (0, 0), (0, cp - c))), stride, ho + q, wo + q)
    xs = ck.s2d_pool_operand(tx, window=window, stride=stride)
    _assert_bitwise(xs, want)
    _assert_bitwise(ck.maxpool_s2d_packed(xs.contiguous(), c, window=window, stride=stride),
                    jab.pool_s2d128(jx, window=window, stride=stride))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_maxpool_s2d_specials_follow_the_kernels_max_step(dtype):
    """NaN wins and keeps its bits, -inf loses to everything, and +0.0 wins
    over -0.0 in either tap order, as ``common.cuh``'s ``max_step`` (and
    ``jnp.maximum``) take them; the same as the select written out here."""
    tdt = DTYPES[dtype][1]
    x = torch.full((1, 5, 5, 20), float("-inf"), dtype=tdt)
    x[0, 0, 0, 0], x[0, 0, 1, 0] = -0.0, 0.0  # output (0, 0), channel 0: -0.0 first
    x[0, 2, 2, 1] = 0.0
    x[0, 2, 3, 1] = -0.0  # output (1, 1), channel 1: +0.0 first
    int_t, nan_bits = (torch.int32, 0x7FC00123) if dtype == "fp32" else (torch.int16, 0x7FC1)
    x[0, 3, 3, 2] = torch.tensor([nan_bits], dtype=int_t).view(tdt)[0]  # a NaN with its own payload
    x[0, 4, 4, 2] = 5.0
    got = ck.maxpool_s2d(x, window=3, stride=2)
    assert not bool(torch.signbit(got[0, 0, 0, 0])) and not bool(torch.signbit(got[0, 1, 1, 1]))
    assert bool(torch.isneginf(got[0, 0, 0, 3]))
    assert _bits(got[0, 1, 1, 2]) == _bits(x[0, 3, 3, 2])  # the NaN's own payload, over the later 5.0

    want = x[:, 0:3:2, 0:3:2, :]
    for fy in range(3):
        for fx in range(3):
            v = x[:, fy : fy + 3 : 2, fx : fx + 3 : 2, :]
            takes = (v > want) | torch.isnan(v) | ((v == want) & torch.signbit(want) & ~torch.signbit(v))
            want = torch.where(takes, v, want)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pool", sorted(pool_ab.POOL_SHAPES))
def test_sep2p_and_phases_strategies_match_the_jax_script(pool, dtype):
    (h, w, c), window, stride = pool_ab.POOL_SHAPES[pool]
    jx, tx = _inputs((2, h, w, c), dtype, seed=7)
    fns = pool_ab.strategies(tx, window, stride)
    _assert_bitwise(fns["sep2p"](), jab.pool_sep2p(jx, window=window, stride=stride))
    q = (window - 1) // stride
    ho = (h - window) // stride + 1
    _assert_bitwise(fns["phases"](), jab.phases_only(jx, stride=stride, hp=ho + q, wp=ho + q))
    _assert_bitwise(fns["current"](), jab.pk._maxpool_phases(jx, window=window, stride=stride))
    _assert_bitwise(fns["xla"](), jab.pool_xla(jx, window=window, stride=stride))


@pytest.mark.parametrize("c, multiple", [(20, 128), (96, 128), (128, 128), (130, 128), (5, 8)])
def test_pad_channels_bitwise_equals_jnp_pad(c, multiple):
    x = np.random.default_rng(c).standard_normal((2, 3, 4, c)).astype(np.float32)
    cp = -(-c // multiple) * multiple
    tx = torch.from_numpy(x)
    got = packing.pad_channels(tx, multiple)
    _assert_bitwise(got, jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, 0), (0, cp - c))))
    assert (got is tx) == (cp == c)


def test_pool_shapes_are_the_jax_scripts():
    assert pool_ab.POOL_SHAPES == jab.POOL_SHAPES
    assert JAX_ORDER == ("xla", "current", "phases", "s2d128", "sep2", "sep2p")
