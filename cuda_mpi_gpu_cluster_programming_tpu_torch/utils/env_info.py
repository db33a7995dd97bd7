"""Environment capture: a machine-readable record of the toolchain a run used.

The JAX package's ``utils/env_info.py``, for PyTorch and CUDA: the Python,
torch and CUDA versions, the installed packages the port and its tests use,
the ``TPU_FRAMEWORK_*`` knobs set, the driver version, and the card's name
and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them (a card set below its maximum power runs
slower under load, so a time is read beside this). Where ``nvidia-smi`` is
missing or fails, its field holds a note; collecting never raises.

The JAX module's ``cpu_subprocess_env`` and ``force_virtual_cpu`` set XLA's
virtual host devices for sharded runs on one host. The port has no
counterpart and needs none: its mesh (``parallel/mesh.py``) places shard
slots round-robin over the visible devices, several to a device where
there are fewer devices than shards, the CPU included.

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.utils.env_info [--out env.json] [--no-devices]
"""

from __future__ import annotations

import importlib.metadata
import json
import os
import platform
import subprocess
import sys
from typing import Dict, List

PACKAGES = ("torch", "triton", "numpy", "scipy", "einops", "pytest", "hypothesis")

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit,driver_version", "--format=csv,noheader"]


def nvidia_smi(timeout_s: float = 30.0) -> Dict[str, object]:
    """``{"gpus": [{"name", "power_limit", "driver"}...]}`` from ``nvidia-smi``,
    or ``{"note": why not}``. ``name_power`` keeps each card's line as
    ``--query-gpu=name,power.limit`` prints it."""
    try:
        proc = subprocess.run(SMI_QUERY, capture_output=True, text=True, timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"note": f"nvidia-smi not run: {type(e).__name__}: {e}"[:200]}
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout).strip().splitlines()[-1:] or ["no output"]
        return {"note": f"nvidia-smi failed (rc={proc.returncode}): {tail[0][:160]}"}
    gpus: List[Dict[str, str]] = []
    for line in proc.stdout.strip().splitlines():
        fields = [f.strip() for f in line.split(",")]
        if len(fields) == 3:
            gpus.append({"name": fields[0], "power_limit": fields[1], "driver": fields[2],
                         "name_power": f"{fields[0]}, {fields[1]}"})
    return {"gpus": gpus}


def collect(probe_devices: bool = True) -> Dict[str, object]:
    info: Dict[str, object] = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "machine": platform.node() or "unknown",
        "packages": {},
        "env": {k: v for k, v in sorted(os.environ.items())
                if v and (k.startswith("TPU_FRAMEWORK_") or k in ("CUDA_VISIBLE_DEVICES", "CUDA_HOME"))},
    }
    for pkg in PACKAGES:
        try:
            info["packages"][pkg] = importlib.metadata.version(pkg)
        except importlib.metadata.PackageNotFoundError:
            info["packages"][pkg] = None
    if probe_devices:
        try:
            import torch

            info["torch"] = torch.__version__
            info["torch_cuda"] = torch.version.cuda
            info["cuda_available"] = torch.cuda.is_available()
            info["device_count"] = torch.cuda.device_count() if info["cuda_available"] else 0
            info["devices"] = [torch.cuda.get_device_name(i) for i in range(info["device_count"])]
        except Exception as e:  # a device probe must never fail the capture
            info["backend_error"] = f"{type(e).__name__}: {e}"
        info["nvidia_smi"] = nvidia_smi()
    return info


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="cuda_mpi_gpu_cluster_programming_tpu_torch.utils.env_info")
    p.add_argument("--out", help="also write the JSON dump to this path")
    p.add_argument("--no-devices", action="store_true", help="skip the torch device query and nvidia-smi")
    args = p.parse_args(argv)
    info = collect(probe_devices=not args.no_devices)
    text = json.dumps(info, indent=2)
    print(text)
    if args.out:
        from ..resilience.journal import atomic_write_text

        atomic_write_text(args.out, text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
