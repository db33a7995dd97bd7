"""Dtype policies: precision as a named, per-layer axis.

Per layer a policy names the dtype operands enter the contraction in
(``compute``), the dtype the contraction accumulates in (``accumulate``)
and the dtype parameters are stored in (``params``). The presets:

- ``fp32``: fp32 operands and accumulation, true fp32 on the card (no TF32);
- ``bf16``: bf16 operands and params, fp32 accumulation, fp32 output;
- ``int8w``: weight-only int8 with per-output-channel symmetric scales,
  bf16 activations, fp32 accumulation, the rescale applied once to the
  conv's fp32 output before the bias (``precision/quantize.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

POLICY_NAMES = ("fp32", "bf16", "int8w")

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def tdt(name: str) -> torch.dtype:
    """The torch dtype for a policy dtype name."""
    return _TORCH_DTYPES[name]


@dataclasses.dataclass(frozen=True)
class LayerPrecision:
    """One layer's dtype triple (see the module docstring)."""

    compute: str = "float32"
    accumulate: str = "float32"
    params: str = "float32"


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """A named per-layer precision assignment; ``layers`` overrides the
    ``default`` triple for the named layers."""

    name: str
    default: LayerPrecision = LayerPrecision()
    layers: Tuple[Tuple[str, LayerPrecision], ...] = ()

    def layer(self, layer_name: str) -> LayerPrecision:
        for n, lp in self.layers:
            if n == layer_name:
                return lp
        return self.default

    @property
    def quantized(self) -> bool:
        """True when any layer stores int8 params."""
        return any(lp.params == "int8" for lp in (self.default, *(lp for _n, lp in self.layers)))


PRESETS: Dict[str, DtypePolicy] = {
    "fp32": DtypePolicy("fp32", LayerPrecision("float32", "float32", "float32")),
    "bf16": DtypePolicy("bf16", LayerPrecision("bfloat16", "float32", "bfloat16")),
    "int8w": DtypePolicy("int8w", LayerPrecision("bfloat16", "float32", "int8")),
}


def resolve_policy(spec: Union[str, DtypePolicy, None]) -> DtypePolicy:
    """A DtypePolicy from a preset name, a policy object, or None (fp32).
    Raises ``ValueError`` for an unknown name."""
    if spec is None:
        return PRESETS["fp32"]
    if isinstance(spec, DtypePolicy):
        return spec
    name = str(spec).strip().lower()
    if name not in PRESETS:
        raise ValueError(f"unknown precision policy {spec!r} (known: {'|'.join(POLICY_NAMES)})")
    return PRESETS[name]
