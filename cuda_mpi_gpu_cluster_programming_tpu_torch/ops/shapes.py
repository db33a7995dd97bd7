"""Output-shape calculators for conv and pool layers.

Reference parity: ``convOutDim``/``poolOutDim`` inline helpers
(v2_mpi_only/2.2_scatter_halo/include/alexnet.hpp:35-44), including V4's
degenerate-size guards that return 0 when the filter cannot fit
(v4_mpi_cuda/include/alexnet.hpp:28-33).
"""

from __future__ import annotations


def conv_out_dim(d: int, f: int, p: int, s: int) -> int:
    """Output length of a conv along one spatial dim: (d - f + 2p)/s + 1."""
    if d <= 0 or f <= 0 or s <= 0:
        return 0
    if f > d + 2 * p:
        return 0
    return (d - f + 2 * p) // s + 1


def pool_out_dim(d: int, f: int, s: int) -> int:
    """Output length of a VALID pool along one spatial dim: (d - f)/s + 1."""
    if d <= 0 or f <= 0 or s <= 0:
        return 0
    if f > d:
        return 0
    return (d - f) // s + 1
