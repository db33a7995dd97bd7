"""Lowering variants: the knobs that choose how the kernel tier runs a layer.

The JAX package's ``env_variant``, ``KernelVariants`` and ``LayerVariants``
with the same fields, defaults, environment variables and validation, so
that a tuning plan or an environment set for one package means the same
for the other:

- ``TPU_FRAMEWORK_CONV``     conv body: taps | pairs | fused | vcol | g8 (default vcol)
- ``TPU_FRAMEWORK_POOL``     pool body: sep2 | phases (default sep2)
- ``TPU_FRAMEWORK_ROWBLOCK`` output rows per program: 8 | 16 | 32 | 64 (default 64)
- ``TPU_FRAMEWORK_KBLOCK``   output-channel grid block: 0 | 64 | 128 (default 0)
- ``TPU_FRAMEWORK_FUSE``     epilogue fusion: none | hpool | block (default none)

The port builds every value. ``row_block`` sets no tile here (the CUDA
kernels tile on their own); only the hpool and block gates read it (a whole
image per program), and tuning plans carry it.
"""

from __future__ import annotations

import os
from typing import NamedTuple

ROW_BLOCK = 64


def env_variant(env_name: str, default: str, allowed: tuple) -> str:
    """A lowering-variant switch from the environment: unset or empty gives
    ``default``; a value outside ``allowed`` raises ``ValueError``."""
    v = os.environ.get(env_name, "").strip().lower()
    if not v:
        return default
    if v not in allowed:
        raise ValueError(f"{env_name} must be {'|'.join(allowed)}, got {v!r}")
    return v


def effective_k_block(k_block: int, k: int) -> int:
    """The k_block that applies to K output channels: ``k_block`` when K is
    a multiple of it and larger, else 0 (the conv runs unblocked)."""
    return k_block if k_block and k % k_block == 0 and k > k_block else 0


class KernelVariants(NamedTuple):
    """A resolved set of lowering knobs (hashable). ``resolve()`` reads the
    environment once; build-time callers resolve and close over the result."""

    conv: str = "vcol"
    pool: str = "sep2"
    row_block: int = ROW_BLOCK
    k_block: int = 0
    fuse: str = "none"
    # Layer-binding metadata, not a knob: the conv's output-channel count
    # once bound to a layer (0 = unbound), so the label can state the
    # effective k_block beside the requested one.
    k_channels: int = 0

    @classmethod
    def resolve(cls) -> "KernelVariants":
        return cls(
            conv=env_variant("TPU_FRAMEWORK_CONV", "vcol", ("taps", "pairs", "fused", "vcol", "g8")),
            pool=env_variant("TPU_FRAMEWORK_POOL", "sep2", ("sep2", "phases")),
            row_block=int(env_variant("TPU_FRAMEWORK_ROWBLOCK", str(ROW_BLOCK), ("8", "16", "32", "64"))),
            k_block=int(env_variant("TPU_FRAMEWORK_KBLOCK", "0", ("0", "64", "128"))),
            fuse=env_variant("TPU_FRAMEWORK_FUSE", "none", ("none", "hpool", "block")),
        )

    def bind(self, k_channels: int) -> "KernelVariants":
        """The same knobs bound to a conv with K output channels."""
        return self._replace(k_channels=k_channels)

    def knobs(self) -> "KernelVariants":
        """The lowering knobs alone (binding stripped)."""
        return self._replace(k_channels=0)

    @property
    def effective_k_block(self) -> int:
        """The k_block that applies at K=k_channels (see
        :func:`effective_k_block`); unbound variants report the request."""
        if not self.k_block or not self.k_channels:
            return self.k_block
        return effective_k_block(self.k_block, self.k_channels)

    def label(self) -> str:
        kb = str(self.k_block)
        if self.k_channels and self.effective_k_block != self.k_block:
            kb = f"{self.k_block}->{self.effective_k_block}(K={self.k_channels})"
        return f"conv={self.conv} pool={self.pool} rb={self.row_block} kb={kb} fuse={self.fuse}"

    def __repr__(self) -> str:
        return f"KernelVariants({self.label()})"


class LayerVariants(NamedTuple):
    """A per-layer plan: each conv layer (and the pool it feeds) may carry
    its own ``KernelVariants``; unnamed layers take ``default``."""

    layers: tuple = ()  # ((layer_name, KernelVariants), ...)
    default: KernelVariants = KernelVariants()

    def for_layer(self, name: str) -> KernelVariants:
        for n, v in self.layers:
            if n == name:
                return v
        return self.default
