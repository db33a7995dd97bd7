"""Device spec table for the port's bounds: NVIDIA H100 variants.

Peaks are NVIDIA's H100 data-sheet figures, dense (no sparsity), at each
part's full power limit: fp32 outside the tensor cores (FFMA), bf16 on the
tensor cores, HBM bandwidth. A card set below its maximum power runs slower
under load, so a bound computed from these is a floor, stated beside the
card's name and power limit. The part is picked from
``torch.cuda.get_device_name()``: PCIe and NVL say so in their names;
any other H100 is the SXM part.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    marker: str       # substring of the lower-cased device name
    name: str
    fp32_tflops: float  # FFMA, non-tensor
    bf16_tflops: float  # tensor cores, dense
    hbm_gbps: float     # GB/s

    def peak_tflops(self, dtype: str) -> float:
        """``dtype`` is a policy name: fp32 or bf16."""
        return self.fp32_tflops if dtype == "fp32" else self.bf16_tflops

    def bound_ms(self, flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
        """Least time for ``flops`` operations and ``nbytes`` moved, and
        which of the two sets it ("operations" or "bytes")."""
        t_ops = flops / (self.peak_tflops(dtype) * 1e12) * 1e3
        t_bytes = nbytes / (self.hbm_gbps * 1e9) * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# Ordered: the specific markers first, then the SXM part as plain "h100".
SPEC_TABLE: Tuple[DeviceSpec, ...] = (
    DeviceSpec("h100 pcie", "H100 PCIe", 51.2, 756.0, 2000.0),
    DeviceSpec("h100 nvl", "H100 NVL", 60.0, 835.0, 3900.0),
    DeviceSpec("h100", "H100 SXM", 67.0, 989.0, 3350.0),
)


def spec_for(device_name: str) -> Tuple[DeviceSpec, bool]:
    """``(spec, assumed)`` for a device name; ``assumed`` is True when the
    name matched no entry and the H100 SXM stands in."""
    name = (device_name or "").lower()
    for spec in SPEC_TABLE:
        if spec.marker in name:
            return spec, False
    return SPEC_TABLE[-1], True
