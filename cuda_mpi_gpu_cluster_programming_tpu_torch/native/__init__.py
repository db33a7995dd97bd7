"""The port's native (C++) tier: the synthetic-data pipeline.

The data-loader half of the JAX package's ``native/``, copied (the port
imports nothing of it): ``csrc/dataloader.cpp`` is compiled with ``g++`` at
first use into ``_build/`` inside this package (listed in ``.gitignore``),
keyed on a hash of the source, and bound with ctypes.

- :func:`fill_batch`: one synthetic float32 batch (``ones``, or ``uniform``
  from a seeded LCG), bit for bit the JAX package's (``run --input native``
  gives both packages one input);
- :func:`lcg_uniform_numpy`: the uniform stream in numpy, the parity oracle;
- :func:`batch_seed`: the seed of batch k of a loader stream;
- :class:`NativeDataLoader`: a multi-threaded prefetching batch iterator
  whose batch k depends only on (seed, k), never on thread timing.

The shard planner (``shardplan.cpp``: ``conv_out_dim``, ``pool_out_dim``,
``make_shard_plan_native``, ``owned_range_native``) waits for the
distribution tiers (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "dataloader.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_CXXFLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> Path:
    """Compile ``dataloader.cpp`` unless the library of this source and these
    flags exists. Raises ``RuntimeError`` without ``g++`` or on a failed build."""
    digest = hashlib.sha256(" ".join(_CXXFLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libportnative-{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(_BUILD_DIR))
    os.close(fd)
    try:
        subprocess.run(["g++", *_CXXFLAGS, str(_SRC), "-o", tmp], check=True, capture_output=True, text=True)
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
        _lib = lib
        return lib


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
