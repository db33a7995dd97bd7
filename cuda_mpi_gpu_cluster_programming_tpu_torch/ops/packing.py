"""Host-side operand packers of the conv and pool variants.

The JAX package's ``_space_to_depth``, ``_weights_to_depth``,
``_weights_to_phase_depth`` and ``_pool_phases``
(``ops/pallas_kernels.py``) as plain tensor code, bitwise
the same (they only move and zero-fill values). Strided convolution is
lowered by phase decomposition: the input is repacked to (N, Hs, Ws,
s*s*C) and the weights to (fq, fq, s*s*C, K) with fq = ceil(F/s), so output
row i's tap fy reads s2d row ``i + fy//s``, channel block ``fy%s``, and every
window the kernels read is unit-stride. For s = 1 the packing is the
identity. The pool's phase stack does the same for a strided max-pool.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor, s: int, hs: int, ws: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, hs, ws, s*s*C); H, W zero-padded to hs*s, ws*s,
    or cropped where the conv never reads the trailing rows/cols."""
    n, h, w, c = x.shape
    if h < hs * s or w < ws * s:
        x = F.pad(x, (0, 0, 0, max(0, ws * s - w), 0, max(0, hs * s - h)))
    x = x[:, : hs * s, : ws * s, :]
    x = x.reshape(n, hs, s, ws, s, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, hs, ws, s * s * c)


def weights_to_depth(w: torch.Tensor, s: int, fq: int) -> torch.Tensor:
    """(F, F, C, K) -> (fq, fq, s*s*C, K), zero taps past F."""
    f, _, c, k = w.shape
    if f < fq * s:
        w = F.pad(w, (0, 0, 0, 0, 0, fq * s - f, 0, fq * s - f))
    w = w.reshape(fq, s, fq, s, c, k)
    return w.permute(0, 2, 1, 3, 4, 5).reshape(fq, fq, s * s * c, k)


def weights_to_phase_depth(w: torch.Tensor, s: int, g: int, fq8: int) -> torch.Tensor:
    """(F, F, C, K) -> (2, 2, fq8, fq8, g*g*C, K): the g8 body's phase weight
    frames. Phase (ph, pw) holds the filter at offset (ph*s, pw*s) in a zero
    frame of fq8*g rows and cols, depth-packed in :func:`space_to_depth`'s
    channel order, so frame row v lands at tap v//g, channel block v%g."""
    f, _, c, k = w.shape
    frames = []
    for ph in range(2):
        for pw in range(2):
            wp = F.pad(w, (0, 0, 0, 0, pw * s, fq8 * g - f - pw * s, ph * s, fq8 * g - f - ph * s))
            wp = wp.reshape(fq8, g, fq8, g, c, k).permute(0, 2, 1, 3, 4, 5)
            frames.append(wp.reshape(fq8, fq8, g * g * c, k))
    return torch.stack(frames).reshape(2, 2, fq8, fq8, g * g * c, k)


def pool_phases(x: torch.Tensor, s: int, hp: int, wp: int) -> torch.Tensor:
    """(N, H, W, C) -> (s*s, N, hp, wp, C): the stride-phase views
    ``x[:, r::s, p::s, :]``, cropped or zero-padded to hp x wp (the
    padding is never read: the pool's taps stop at the window)."""
    phases = []
    for r in range(s):
        for p in range(s):
            v = x[:, r::s, p::s, :][:, :hp, :wp, :]
            phases.append(F.pad(v, (0, 0, 0, wp - v.shape[2], 0, hp - v.shape[1])))
    return torch.stack(phases)
