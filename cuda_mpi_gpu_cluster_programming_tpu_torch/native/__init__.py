"""The port's native (C++) tier: the synthetic-data pipeline and the shard planner.

The JAX package's ``native/``, copied (the port imports nothing of it):
``csrc/dataloader.cpp`` and ``csrc/shardplan.cpp`` are compiled with
``g++`` at first use into one library in ``_build/`` inside this package
(listed in ``.gitignore``), keyed on a hash of the sources, and bound with
ctypes.

- :func:`conv_out_dim`, :func:`pool_out_dim`: the shape calculators;
- :func:`make_shard_plan_native`: the ``parallel.plan.ShardPlan`` of
  ``parallel.plan.make_shard_plan``, field for field, from C++;
- :func:`owned_range_native`: a shard's global output rows;

- :func:`fill_batch`: one synthetic float32 batch (``ones``, or ``uniform``
  from a seeded LCG), bit for bit the JAX package's (``run --input native``
  gives both packages one input);
- :func:`lcg_uniform_numpy`: the uniform stream in numpy, the parity oracle;
- :func:`batch_seed`: the seed of batch k of a loader stream;
- :class:`NativeDataLoader`: a multi-threaded prefetching batch iterator
  whose batch k depends only on (seed, k), never on thread timing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_SRCS = tuple(Path(__file__).resolve().parent / "csrc" / name for name in ("dataloader.cpp", "shardplan.cpp"))
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_CXXFLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> Path:
    """Compile the sources unless the library of these sources and these
    flags exists. Raises ``RuntimeError`` without ``g++`` or on a failed build."""
    digest = hashlib.sha256(" ".join(_CXXFLAGS).encode() + b"".join(p.read_bytes() for p in _SRCS)).hexdigest()[:16]
    lib = _BUILD_DIR / f"libportnative-{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(_BUILD_DIR))
    os.close(fd)
    try:
        subprocess.run(["g++", *_CXXFLAGS, *map(str, _SRCS), "-o", tmp], check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError("g++ not found; the native tier needs a C++ toolchain") from e
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed:\n{e.stderr}") from e
    os.replace(tmp, lib)  # atomic: concurrent builds race harmlessly
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        lib.dl_fill.restype = None
        lib.dl_fill.argtypes = [ctypes.c_int, ctypes.c_uint64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [ctypes.c_int, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.dl_next.restype = ctypes.c_int64
        lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.dl_destroy.restype = None
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        lib.sp_conv_out_dim.restype = ctypes.c_int
        lib.sp_conv_out_dim.argtypes = [ctypes.c_int] * 4
        lib.sp_pool_out_dim.restype = ctypes.c_int
        lib.sp_pool_out_dim.argtypes = [ctypes.c_int] * 3
        lib.sp_plan_chain.restype = ctypes.c_int
        lib.sp_plan_chain.argtypes = [ctypes.c_int, *(ctypes.POINTER(ctypes.c_int32),) * 4, ctypes.c_int,
                                      ctypes.c_int, ctypes.POINTER(_LayerPlanC)]
        lib.sp_owned_range.restype = None
        lib.sp_owned_range.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int32)] * 2
        _lib = lib
        return lib


# ---------------------------------------------------------------- shard plan

_KIND_NAME = {0: "conv", 1: "pool", 2: "pointwise"}
_ERRORS = {-1: "degenerate layer output (filter cannot fit)", -2: "uniform window escapes padded buffer",
           -3: "bad argument"}
# shardplan.cpp's sp_layer_plan: LayerPlan's geometry fields, in its order
_PLAN_FIELDS = ("filter_size", "stride", "padding", "l_in", "l_out", "b_in", "b_out", "h_top", "h_bot",
                "s0_coef", "s0_const", "win_rows", "pad_bot")


class _LayerPlanC(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32)] + [(f, ctypes.c_int32) for f in _PLAN_FIELDS]


def conv_out_dim(d: int, f: int, p: int, s: int) -> int:
    return _load().sp_conv_out_dim(d, f, p, s)


def pool_out_dim(d: int, f: int, s: int) -> int:
    return _load().sp_pool_out_dim(d, f, s)


def _chain_arrays(cfg):
    """The layer chain as (names, kinds, filter sizes, strides, paddings)."""
    from ..models.alexnet import ConvSpec, LrnSpec, PoolSpec

    rows = []
    for name, spec in cfg.layer_chain():
        if isinstance(spec, ConvSpec):
            rows.append((name, 0, spec.filter_size, spec.stride, spec.padding))
        elif isinstance(spec, PoolSpec):
            rows.append((name, 1, spec.window, spec.stride, 0))
        elif isinstance(spec, LrnSpec):
            rows.append((name, 2, 1, 1, 0))
        else:
            raise TypeError(f"unknown layer spec {spec!r}")
    return [list(col) for col in zip(*rows)]


def make_shard_plan_native(cfg, n_shards: int):
    """``parallel.plan.make_shard_plan(cfg, n_shards)`` computed by
    ``shardplan.cpp``: the same ``ShardPlan``, field for field."""
    from ..parallel.plan import LayerPlan, ShardPlan

    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    names, kinds, fs, ss, ps = _chain_arrays(cfg)
    n = len(names)

    def arr(xs):
        return (ctypes.c_int32 * n)(*xs)

    out = (_LayerPlanC * n)()
    rc = _load().sp_plan_chain(n, arr(kinds), arr(fs), arr(ss), arr(ps), cfg.in_height, n_shards, out)
    if rc != 0:
        raise ValueError(f"native plan failed: {_ERRORS.get(rc, rc)}")
    layers = tuple(LayerPlan(name=names[i], kind=_KIND_NAME[out[i].kind],
                             **{f: getattr(out[i], f) for f in _PLAN_FIELDS}) for i in range(n))
    return ShardPlan(n_shards=n_shards, layers=layers)


def owned_range_native(b_out: int, l_out: int, i: int) -> Tuple[int, int]:
    """``parallel.plan.owned_range`` from C++."""
    start, end = ctypes.c_int32(), ctypes.c_int32()
    _load().sp_owned_range(b_out, l_out, i, ctypes.byref(start), ctypes.byref(end))
    return start.value, end.value


MODES = {"ones": 0, "uniform": 1}


def fill_batch(shape: Sequence[int], mode: str = "ones", seed: int = 0) -> np.ndarray:
    """One synthetic batch (float32, C order), generated synchronously."""
    out = np.empty(shape, dtype=np.float32)
    _load().dl_fill(MODES[mode], ctypes.c_uint64(seed), out.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def lcg_uniform_numpy(seed: int, n: int) -> np.ndarray:
    """The native uniform stream in numpy (the parity oracle): splitmix64
    of the seed, then the 64-bit LCG, top 24 bits to [0, 1)."""
    with np.errstate(over="ignore"):
        x = np.uint64(seed) + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        s = x ^ (x >> np.uint64(31))
        out = np.empty(n, dtype=np.float32)
        mul = np.uint64(6364136223846793005)
        inc = np.uint64(1442695040888963407)
        for i in range(n):
            s = s * mul + inc
            out[i] = np.float32(s >> np.uint64(40)) * np.float32(1.0 / 16777216.0)
    return out


def batch_seed(seed: int, k: int) -> int:
    """Seed of batch ``k`` in a loader stream (as ``dataloader.cpp`` mixes it)."""
    return (seed + 0x517CC1B727220A95 * (k + 1)) % (1 << 64)


class NativeDataLoader:
    """Prefetching iterator over synthetic NHWC batches.

    ``depth`` bounds how many finished batches buffer ahead of the consumer;
    ``workers`` fill batches concurrently. Batch ``k`` equals
    ``fill_batch(shape, mode, batch_seed(seed, k))`` whatever the timing."""

    def __init__(self, shape: Sequence[int], mode: str = "ones", seed: int = 0, depth: int = 2, workers: int = 2):
        self._handle = None  # so close() is safe if the constructor raises below
        self._shape = tuple(int(d) for d in shape)
        self._handle = _load().dl_create(MODES[mode], ctypes.c_uint64(seed), int(np.prod(self._shape)), depth, workers)
        if not self._handle:
            raise ValueError("dl_create failed (bad shape, depth, workers or mode)")

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise StopIteration
        out = np.empty(self._shape, dtype=np.float32)
        if _load().dl_next(self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) < 0:
            raise StopIteration
        return out

    def close(self) -> None:
        if self._handle is not None:
            _load().dl_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeDataLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        self.close()
