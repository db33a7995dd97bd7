"""Device spec table for the port's bounds: NVIDIA H100 variants.

Peaks are NVIDIA's H100 data-sheet figures, dense (no sparsity), at each
part's full power limit: fp32 outside the tensor cores (FFMA), bf16 on the
tensor cores, HBM bandwidth. A card set below its maximum power runs slower
under load, so a bound computed from these is a floor, stated beside the
card's name and power limit. The part is picked from
``torch.cuda.get_device_name()``: PCIe and NVL say so in their names;
any other H100 is the SXM part.

The module-level :func:`peak_tflops` and :func:`hbm_gbps` are what the bench
row and the roofline report read (the JAX package's functions of the same
names): ``BENCH_PEAK_TFLOPS`` overrides the bf16 tensor-core peak and the
fp32 peak scales with it, ``BENCH_PEAK_HBM_GBPS`` the bandwidth.
:func:`device_memory_stats` is the live memory snapshot. Standard library
at module scope; torch is imported where the snapshot is taken.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    marker: str       # substring of the lower-cased device name
    name: str
    fp32_tflops: float  # FFMA, non-tensor
    bf16_tflops: float  # tensor cores, dense
    hbm_gbps: float     # GB/s

    def peak_tflops(self, dtype: str) -> float:
        """``dtype`` is a policy name: fp32, or bf16/int8w (bf16 operands
        on the tensor cores)."""
        return self.fp32_tflops if dtype == "fp32" else self.bf16_tflops

    def bound_ms(self, flops: float, nbytes: float, dtype: str, fp32_flops: float = 0.0) -> Tuple[float, str]:
        """Least time for ``flops`` operations at ``dtype``'s peak plus
        ``fp32_flops`` more outside the tensor cores (pool compares, LRN),
        against ``nbytes`` moved; and which of the two sets it
        ("operations" or "bytes")."""
        t_ops = (flops / (self.peak_tflops(dtype) * 1e12) + fp32_flops / (self.fp32_tflops * 1e12)) * 1e3
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


def peak_tflops(device_name: str, dtype: str = "bf16") -> float:
    """Peak TFLOP/s of ``device_name`` for a ``dtype`` policy: fp32 on FFMA,
    bf16 and int8w on the tensor cores (int8w runs bf16 operands there).
    ``BENCH_PEAK_TFLOPS`` overrides the bf16 peak; fp32 keeps the spec's
    ratio of FFMA to tensor-core peak under it."""
    spec, _assumed = spec_for(device_name)
    env = os.environ.get("BENCH_PEAK_TFLOPS")
    bf16 = float(env) if env else spec.bf16_tflops
    return bf16 * spec.fp32_tflops / spec.bf16_tflops if dtype == "fp32" else bf16


def hbm_gbps(device_name: str) -> float:
    """HBM bandwidth (GB/s) of ``device_name``; ``BENCH_PEAK_HBM_GBPS`` overrides."""
    env = os.environ.get("BENCH_PEAK_HBM_GBPS")
    if env:
        return float(env)
    return spec_for(device_name)[0].hbm_gbps


def device_memory_stats() -> dict:
    """One memory snapshot. On a GPU ``source="device"``: the caching
    allocator's bytes in use and their peak (``torch.cuda.memory_stats``,
    ``allocated_bytes.all``) and the card's memory, summed over the visible
    devices with the per-device list beside. Without one, the process's
    peak RSS (``source="rss"``); ``source="none"`` when neither is read."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            devices = []
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                devices.append({
                    "device": i,
                    "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                    "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
                })

            def _total(field: str) -> Optional[int]:
                return sum(d[field] for d in devices) if devices else None

            return {
                "source": "device",
                "bytes_in_use": _total("bytes_in_use"),
                "peak_bytes_in_use": _total("peak_bytes_in_use"),
                "bytes_limit": _total("bytes_limit"),
                "devices": devices,
            }
    except (ImportError, RuntimeError):
        pass
    try:
        import resource

        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return {"source": "rss", "bytes_in_use": int(rss_kb) * 1024,  # linux reports KB
                "peak_bytes_in_use": None, "bytes_limit": None}
    except (ImportError, OSError):
        return {"source": "none", "bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None}
