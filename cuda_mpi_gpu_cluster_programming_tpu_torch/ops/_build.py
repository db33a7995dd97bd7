"""Build and load the port's CUDA kernel library.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers: a build takes seconds, not minutes). Each
``.cu`` compiles in its own ``nvcc`` process, all started together, and the
objects are linked once. The library lands in ``_build/<hash>/`` inside the
package (listed in ``.gitignore``), keyed on a hash of the sources and the
flags, so an edited source builds anew and an unchanged one loads as is.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libport_kernels.so"
LOG_NAME = "build.log"  # nvcc's output of the build, beside the library
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, into the build log
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time of this call's compile and link (0 when cached)
    built: bool     # False when the library for these sources already existed
    log: str        # nvcc's output, with ptxas's per-kernel resource lines (that build's, when cached)


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands in parallel; raise with the output of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed (rc={p.returncode}): {' '.join(cmd)}\n{out}")
    return outs


def build() -> BuildInfo:
    """The library for the current sources, compiled now unless it exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        saved = out_dir / LOG_NAME
        return BuildInfo(lib, 0.0, False, saved.read_text() if saved.is_file() else "")
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
            "kernels build only where the CUDA toolkit is installed"
        )
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs = [tmp / (src.stem + ".o") for src in sources()]
        logs = _run_all(
            [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)] for src, obj in zip(sources(), objs)]
        )
        logs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME), *map(str, objs)]])
        (tmp / LOG_NAME).write_text("".join(logs))
        os.replace(tmp / LOG_NAME, out_dir / LOG_NAME)  # before the library: a cached library has its log
        os.replace(tmp / LIB_NAME, lib)  # atomic: a reader never sees a half-written library
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return BuildInfo(lib, time.perf_counter() - t0, True, "".join(logs))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # entry: (argtypes, dtype suffixes)
    # x, w, b, y, N, H, W, C, K, F, stride, pad_h, pad_w, Ho, Wo, relu, k_block, hpool window, hpool stride,
    # Hp, stream
    "conv2d_bias_relu": ([_P, _P, _P, _P] + [_I] * 16 + [_P], ("f32", "bf16")),
    # xs, ws, b, y, N, Hs, Ws, cs, K, fq, Ho, Wo, relu, k_block, hpool window, hpool stride, Hp, stream
    "conv_taps": ([_P, _P, _P, _P] + [_I] * 13 + [_P], ("f32", "bf16")),
    # xpair, xs, wpair, wlast, b, y, N, Hs, Ws, cs, K, fq, Ho, Wo, relu, stream
    "conv_pairs": ([_P] * 6 + [_I] * 9 + [_P], ("f32", "bf16")),
    # xs8, wcols (the four phase frames as 4K columns), b, y, N, Hs8, Ws8, G, K, fq8, Ho, Wo, relu, stream
    "conv_g8": ([_P] * 4 + [_I] * 9 + [_P], ("f32", "bf16")),
    # xcol, w, b, y, N, Ho, Wo, KD, K, relu, stream
    "conv_im2col": ([_P] * 4 + [_I] * 6 + [_P], ("f32", "bf16")),
    # x, y, N, H, W, C, window rows, window cols, stride rows, stride cols, Ho, Wo, vector width, stream
    "maxpool2d": ([_P, _P] + [_I] * 11 + [_P], ("f32", "bf16")),
    # x, xph, N, H, W, C, hp, wp, stride, vector width, stream
    "pool_phases_pack": ([_P, _P] + [_I] * 8 + [_P], ("f32", "bf16")),
    # xph, y, N, hp, wp, C, window, stride, Ho, Wo, vector width, stream
    "maxpool_phases": ([_P, _P] + [_I] * 9 + [_P], ("f32", "bf16")),
    # x, xs, N, H, W, C, hs, ws, stride, cp, vector width, stream
    "s2d_pool_pack": ([_P, _P] + [_I] * 9 + [_P], ("f32", "bf16")),
    # xs, y, N, hs, ws, cp, C, window, stride, Ho, Wo, stream
    "maxpool_s2d": ([_P, _P] + [_I] * 9 + [_P], ("f32", "bf16")),
    # x, y, total, C, size, a, beta, k, vector width, stream
    "lrn": ([_P, _P, ctypes.c_longlong, _I, _I, _F, _F, _F, _I, _P], ("f32", "bf16")),
    # x, w, b, scale, y, N, H, W, C, K, F, stride, pad, Ho, Wo, pool window, pool stride,
    # Hp, Wp, band, lrn, lrn size, lrn a, beta, k, stream
    "conv_block": ([_P] * 5 + [_I] * 17 + [_F, _F, _F, _P], ("f32", "bf16", "int8w")),
    # x, y, total, stream
    "relu": ([_P, _P, ctypes.c_longlong, _P], ("f32", "bf16")),
    # q, k, v, out, lse, B, L, H, D, (b, l, h) strides of q, k and v, causal, scale, stream
    "flash_fwd": ([_P] * 5 + [_I] * 4 + [ctypes.c_longlong] * 9 + [_I, _F, _P], ("f32", "bf16")),
    # q, k, v, g, lse, delta, dq, B, L, H, D, (b, l, h) strides of q, k, v and g, causal, scale, stream
    "flash_dq": ([_P] * 7 + [_I] * 4 + [ctypes.c_longlong] * 12 + [_I, _F, _P], ("f32", "bf16")),
    # q, k, v, g, lse, delta, dk, dv, B, L, H, D, (b, l, h) strides of q, k, v and g, causal, scale, stream
    "flash_dkv": ([_P] * 8 + [_I] * 4 + [ctypes.c_longlong] * 12 + [_I, _F, _P], ("f32", "bf16")),
}

_LIB: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded library, built on first use, with every entry point's
    ``argtypes`` set (pointers and the stream as ``c_void_p``)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for base, (argtypes, suffixes) in _SIGNATURES.items():
            for suffix in suffixes:
                fn = getattr(lib, f"{base}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
