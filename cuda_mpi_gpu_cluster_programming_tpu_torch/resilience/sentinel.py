"""The fp32 oracle's spot check: the tolerance gate's preflight.

The ``oracle_spot_check`` of the JAX package's ``resilience/sentinel.py``:
before the gate trusts the port's fp32 reference forward as its oracle, the
reference conv must agree with a plain numpy loop nest (the course code's
serial conv semantics, hand-checkable) on one tiny fixed case. A device
whose fp32 path is itself off (a silent data corruption, or TF32 left on)
then fails the gate for every candidate instead of blessing a matching
error. The JAX package loads its numpy oracle from ``tests/oracle.py``;
the port keeps its own copy of that conv (:func:`conv2d_np`), so it runs
wherever the package is installed.
"""

from __future__ import annotations

import numpy as np
import torch


def conv2d_np(x: np.ndarray, w: np.ndarray, b: np.ndarray, stride: int, padding: int) -> np.ndarray:
    """x (H, W, C), w (F, F, C, K), b (K,) -> (Ho, Wo, K) in float64."""
    h, wd, c = x.shape
    f, _, _, k = w.shape
    ho = (h - f + 2 * padding) // stride + 1
    wo = (wd - f + 2 * padding) // stride + 1
    xp = np.zeros((h + 2 * padding, wd + 2 * padding, c), dtype=np.float64)
    xp[padding : padding + h, padding : padding + wd] = x
    out = np.zeros((ho, wo, k), dtype=np.float64)
    for i in range(ho):
        for j in range(wo):
            patch = xp[i * stride : i * stride + f, j * stride : j * stride + f]
            out[i, j] = np.einsum("fgc,fgck->k", patch, w) + b
    return out


def oracle_spot_check(tol: float = 1e-3, _corrupt: bool = False, device="cuda") -> float:
    """Max abs deviation of the port's reference conv on ``device`` from
    :func:`conv2d_np` on the JAX package's fixed case (9x9x3 input, 3x3x3x4
    weights, stride 2, padding 1, numpy seed 0). ``tol`` is the caller's
    threshold (the gate trips above 1e-3); ``_corrupt`` perturbs the
    result, so tests reach the trip path without a real fault. Runs on
    CUDA unless the caller asks for the CPU; without a GPU it raises."""
    from ..configs import resolve_device
    from ..ops import reference

    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 9, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    want = conv2d_np(x, w, b, stride=2, padding=1)
    dev = resolve_device(device)
    reference.true_fp32(dev)
    got = reference.conv2d(
        torch.from_numpy(x)[None].to(dev), torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev),
        stride=2, padding=1,
    )[0].cpu().numpy()
    if _corrupt:
        got = got + 1.0
    return float(np.max(np.abs(got - want.astype(np.float32))))
