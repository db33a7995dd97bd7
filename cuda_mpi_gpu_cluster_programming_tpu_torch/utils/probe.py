"""Bounded device-health probe: the one place that asks whether the GPU answers.

The JAX package's ``utils/probe.py``, for CUDA. A faulted or lost card can
hang the first CUDA call of a process, so a caller that must not inherit
that hang (the bench's parent process) runs the probe in a bounded
subprocess instead of touching the device in-process. The probe imports
torch, checks ``torch.cuda.is_available()``, runs one 8x8 matmul on
``cuda:0`` and synchronizes. It builds no kernel: the first-use ``nvcc``
build of the kernel library belongs to the process that measures.
"""

from __future__ import annotations

import os
import subprocess
import sys

PROBE_SRC = (
    "import torch;"
    "assert torch.cuda.is_available(), 'torch.cuda.is_available() is False';"
    "v = float((torch.ones((8, 8), device='cuda:0') @ torch.ones((8, 8), device='cuda:0')).sum());"
    "torch.cuda.synchronize();"
    "print('PROBE_OK', 'gpu', v)"
)


def probe(timeout_s: float = 45.0) -> tuple:
    """Run the bounded probe. Returns ``(True, "gpu")`` or ``(False, reason)``."""
    try:
        proc = subprocess.run(
            [sys.executable, "-u", "-c", PROBE_SRC],
            capture_output=True,
            text=True,
            timeout=timeout_s,
            env=dict(os.environ),
        )
    except subprocess.TimeoutExpired:
        return False, f"probe timed out after {timeout_s:.0f}s (hung device?)"
    ok_line = next((l for l in proc.stdout.splitlines() if l.startswith("PROBE_OK")), None)
    if proc.returncode != 0 or ok_line is None:
        tail = (proc.stderr or proc.stdout).strip().splitlines()[-1:] or ["no output"]
        return False, f"probe failed (rc={proc.returncode}): {tail[0][:160]}"
    return True, ok_line.split()[1]


def device_responsive(timeout_s: float = 45.0) -> bool:
    return probe(timeout_s)[0]
