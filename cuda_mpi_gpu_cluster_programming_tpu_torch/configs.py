"""Execution-config registry for the port: the single-device stages.

The keys are the JAX package's, so the CLI and the analysis names map 1:1:

- ``v1_jit``    ↔ V1 Serial: the reference-op tier (PyTorch library ops;
  cuDNN on the card). The oracle.
- ``v3_pallas`` ↔ V3 CUDA: the hand-written CUDA kernel tier
  (``ops/kernel_model.py``; the JAX package runs Pallas kernels here).

The sharded and full-AlexNet configs wait for later slices (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from .models.alexnet import BLOCKS12, forward_blocks12
from .models.init import params_to
from .precision.policy import resolve_policy


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    key: str
    version_name: str  # canonical name for CSV/analysis compatibility
    tier: str  # "reference" (library ops) | "kernels" (hand-written CUDA)
    description: str


REGISTRY: Dict[str, ExecConfig] = {
    c.key: c
    for c in [
        ExecConfig(
            "v1_jit", "V1 Serial", "reference",
            "single-device PyTorch library ops (cuDNN on the GPU): the oracle",
        ),
        ExecConfig(
            "v3_pallas", "V3 CUDA", "kernels",
            "single-device hand-written CUDA kernels (conv+bias+ReLU, max-pool, LRN)",
        ),
    ]
}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; asking for CUDA on a host without it raises (never a silent
    move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless the "
            "CPU is asked for (device='cpu', or --device cpu on the CLI)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda|cpu)")
    return dev


def build_forward(exec_cfg: ExecConfig, model_cfg=None, policy=None, device="cuda") -> Callable:
    """A ``(params, x) -> out`` callable for ``exec_cfg``.

    ``params`` and ``x`` are fp32 on ``device``, NHWC/HWIO; the output is
    fp32. ``policy`` (a preset name or ``DtypePolicy``; default fp32):

    - ``fp32``: true fp32 everywhere. On the card, cuDNN's and cuBLAS's
      TF32 switches are turned off here, before the reference tier runs
      (the JAX package's ``Precision.HIGHEST``); the kernels never use TF32.
    - ``bf16``: params and input cast to bf16, the forward run in bf16
      (the kernels accumulate in fp32, write each conv in bf16 after the
      fp32 bias and ReLU, pool in bf16, run LRN in fp32 and write bf16),
      and the output cast to fp32 — the cast points of the JAX package's
      ``configs.build_forward``.
    """
    dev = resolve_device(device)
    pol = resolve_policy(policy)
    cfg = model_cfg or BLOCKS12
    if exec_cfg.tier == "kernels":
        from .ops.kernel_model import forward_blocks12_kernels as fwd
    else:
        fwd = forward_blocks12
    if dev.type == "cuda" and pol.name == "fp32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    if pol.name == "fp32":
        @torch.inference_mode()
        def forward(p, x):
            return fwd(p, x, cfg).contiguous()
    else:
        @torch.inference_mode()
        def forward(p, x):
            pb = params_to(p, dtype=torch.bfloat16)
            return fwd(pb, x.to(torch.bfloat16), cfg).float().contiguous()

    return forward
