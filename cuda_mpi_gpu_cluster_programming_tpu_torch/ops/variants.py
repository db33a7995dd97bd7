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

The port builds ``conv="vcol"``, ``pool="sep2"``, ``k_block=0`` and
``fuse`` in {none, block}; :func:`require_ported` raises for any other
value, naming its ROADMAP Queue 2 item. ``row_block`` runs no kernel here
(the CUDA kernels tile on their own); it is carried because
``megakernel.block_fusible_reason`` and tuning plans speak of it.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Union

ROW_BLOCK = 64

# Knob value -> the ROADMAP Queue 2 item whose kernel it needs.
_UNPORTED = {
    ("conv", "taps"): "item 2 (_conv_kernel, the taps conv body)",
    ("conv", "fused"): "item 3 (_conv_fused_kernel)",
    ("conv", "pairs"): "items 4-5 (_conv_pairs_kernel, _conv_pairs_even_kernel)",
    ("conv", "g8"): "item 6 (_conv_g8_kernel)",
    ("pool", "phases"): "item 7 (_pool_kernel, the phases pool body)",
    ("fuse", "hpool"): "item 2 (the hpool epilogue of _conv_kernel)",
}


def env_variant(env_name: str, default: str, allowed: tuple) -> str:
    """A lowering-variant switch from the environment: unset or empty gives
    ``default``; a value outside ``allowed`` raises ``ValueError``."""
    v = os.environ.get(env_name, "").strip().lower()
    if not v:
        return default
    if v not in allowed:
        raise ValueError(f"{env_name} must be {'|'.join(allowed)}, got {v!r}")
    return v


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
        """The k_block that applies at K=k_channels (K % k_block == 0 and
        K > k_block, else unblocked); unbound variants report the request."""
        if not self.k_block or not self.k_channels:
            return self.k_block
        if self.k_channels % self.k_block == 0 and self.k_channels > self.k_block:
            return self.k_block
        return 0

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


def require_ported(v: Union[KernelVariants, LayerVariants]) -> None:
    """Raise ``NotImplementedError`` for a knob the port cannot run yet,
    naming the ROADMAP Queue 2 item that would build it."""
    for kv in (*(lv for _n, lv in v.layers), v.default) if isinstance(v, LayerVariants) else (v,):
        for knob in ("conv", "pool", "fuse"):
            item = _UNPORTED.get((knob, getattr(kv, knob)))
            if item:
                raise NotImplementedError(
                    f"{knob}={getattr(kv, knob)} is not ported to CUDA yet: ROADMAP Queue 2, {item}"
                )
        if kv.k_block:
            raise NotImplementedError(
                f"k_block={kv.k_block} is not ported to CUDA yet: ROADMAP Queue 2, item 2 "
                "(the k_block grid of _conv_kernel)"
            )
