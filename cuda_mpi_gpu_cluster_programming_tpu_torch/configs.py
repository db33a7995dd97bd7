"""Execution-config registry for the port: the single-device stages.

The keys are the JAX package's, so the CLI and the analysis names map 1:1:

- ``v1_jit``    ↔ V1 Serial: the reference-op tier (PyTorch library ops;
  cuDNN on the card). The oracle.
- ``v3_pallas`` ↔ V3 CUDA: the hand-written CUDA kernel tier
  (``ops/kernel_model.py``; the JAX package runs Pallas kernels here);
  the ``TPU_FRAMEWORK_*`` knobs or a tuned plan pick each layer's conv,
  pool and fusion variants.
- ``v6_full_jit`` ↔ V6 AlexNet Full: full AlexNet (conv1-5, FC6-8) on
  library ops (cuDNN, and cuBLAS for the FC head).
- ``v6_full_pallas`` ↔ V6 AlexNet Full Pallas: full AlexNet with the
  spatial part on the CUDA kernels, then the FC head as ``torch.matmul``.

The sharded configs (``v6_full_sharded`` among them) wait for ROADMAP
Queue 1 item 3.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict

import torch

from .models.alexnet import BLOCKS12, forward_blocks12
from .models.alexnet_full import ALEXNET, forward_alexnet
from .models.init import params_to
from .ops.kernel_model import forward_alexnet_kernels, forward_blocks12_kernels
from .ops.reference import true_fp32
from .ops.variants import KernelVariants
from .precision.policy import resolve_policy
from .precision.quantize import forward_blocks12_int8w


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    key: str
    version_name: str  # canonical name for CSV/analysis compatibility
    tier: str  # "reference" (library ops) | "kernels" (hand-written CUDA)
    description: str
    model: str = "blocks12"  # "blocks12" | "alexnet_full"


REGISTRY: Dict[str, ExecConfig] = {
    c.key: c
    for c in [
        ExecConfig(
            "v1_jit", "V1 Serial", "reference",
            "single-device PyTorch library ops (cuDNN on the GPU): the oracle",
        ),
        ExecConfig(
            "v3_pallas", "V3 CUDA", "kernels",
            "single-device hand-written CUDA kernels (conv+bias+ReLU, max-pool, LRN; one per block when fused)",
        ),
        ExecConfig(
            "v6_full_jit", "V6 AlexNet Full", "reference",
            "full AlexNet (conv1-5 + FC6-8) single device, library ops (cuDNN, cuBLAS)",
            model="alexnet_full",
        ),
        ExecConfig(
            "v6_full_pallas", "V6 AlexNet Full Pallas", "kernels",
            "full AlexNet, hand-written CUDA kernels for the spatial part, torch.matmul FC head",
            model="alexnet_full",
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


def _resolve_variants(plan):
    """Env-resolved variants, overlaid with a TunePlan's per-layer winners
    when one is supplied. Precedence per knob: explicit env var beats the
    tuned plan beats the code default (``tuning.plan.effective_layer_variants``
    is the one implementation)."""
    kv = KernelVariants.resolve()
    if plan is None:
        return kv
    from .tuning.plan import effective_layer_variants

    return effective_layer_variants(plan, base=kv)


def build_forward(
    exec_cfg: ExecConfig, model_cfg=None, policy=None, variants=None, device="cuda", plan=None,
) -> Callable:
    """A ``(params, x) -> out`` callable for ``exec_cfg``.

    ``params`` and ``x`` are fp32 on ``device``, NHWC/HWIO (FC weights
    ``(in, out)``); the output is fp32. ``model_cfg`` defaults to the
    config's family: ``BLOCKS12`` or ``ALEXNET``. ``policy`` (a preset name
    or ``DtypePolicy``; default fp32):

    - ``fp32``: true fp32 everywhere. On the card, cuDNN's and cuBLAS's
      TF32 switches are turned off here, before the reference tier runs
      (the JAX package's ``Precision.HIGHEST``); the kernels never use TF32.
    - ``bf16``: params and input cast to bf16, the forward run in bf16
      (the kernels accumulate in fp32, write each conv in bf16 after the
      fp32 bias and ReLU, pool in bf16, run LRN in fp32 and write bf16;
      the FC head's products come out in bf16, accumulated in fp32 on the
      card: ``ops.reference.linear``),
      and the output cast to fp32 — the cast points of the JAX package's
      ``configs.build_forward``.
    - ``int8w``: ``precision.quantize.forward_blocks12_int8w`` on the
      config's tier: weights quantized per output channel inside the
      forward, bf16 activations, fp32 accumulation (TF32 off), fp32 output.
      Blocks 1-2 only: a full-AlexNet config raises ``ValueError``, as in
      the JAX package.

    ``variants`` (kernel tier only; the reference tier ignores it): a
    ``KernelVariants`` or per-layer ``LayerVariants``; None resolves the
    ``TPU_FRAMEWORK_*`` environment now, once, overlaid with ``plan`` (a
    ``tuning.plan.TunePlan``) when one is given: per knob an explicit
    environment variable beats the plan beats the default. The returned
    function keeps the variants it was built with.
    """
    dev = resolve_device(device)
    pol = resolve_policy(policy)
    full = exec_cfg.model == "alexnet_full"
    if pol.quantized and full:
        raise ValueError(
            f"policy {pol.name!r} supports the Blocks 1-2 configs only (config {exec_cfg.key!r} is "
            f"{exec_cfg.model}); a quantized full-AlexNet forward is an open ROADMAP item"
        )
    cfg = model_cfg or (ALEXNET if full else BLOCKS12)
    kv = None
    if exec_cfg.tier == "kernels":
        kv = variants if variants is not None else _resolve_variants(plan)
    if pol.name != "bf16":
        true_fp32(dev)

    if pol.quantized:
        tier = exec_cfg.tier

        @torch.inference_mode()
        def forward(p, x):
            return forward_blocks12_int8w(p, x, cfg, variants=kv, tier=tier).contiguous()

        return forward

    if exec_cfg.tier == "kernels":
        fwd = functools.partial(forward_alexnet_kernels if full else forward_blocks12_kernels, variants=kv)
    else:
        fwd = forward_alexnet if full else forward_blocks12

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
