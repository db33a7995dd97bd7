"""Execution-config registry for the port: the staged-parallelism stages.

Each stage of the original course code (its V1..V5 source trees) is an
``ExecConfig``: an op tier (``reference``: PyTorch library ops, cuDNN on
the card; ``kernels``: the hand-written CUDA kernels) and a distribution
strategy over one model definition. The keys are the JAX package's, so the
CLI and the analysis names map 1:1:

- ``v1_jit``          ↔ V1 Serial: single device, reference ops. The oracle.
- ``v2.1_replicated`` ↔ V2.1 BroadcastAll: every shard computes the whole
  pass on a full copy (``parallel/replicated.py``), the anti-baseline.
- ``v2.2_sharded``    ↔ V2.2 ScatterHalo: row-sharded with neighbour halo
  copies, reference ops (``parallel/sharded.py``).
- ``v3_pallas``       ↔ V3 CUDA: single device, the CUDA kernels
  (``ops/kernel_model.py``); the ``TPU_FRAMEWORK_*`` knobs or a tuned plan
  pick each layer's conv, pool and fusion variants.
- ``v4_hybrid``       ↔ V4 MPI+CUDA: row-sharded, the conv and pool
  kernels on every shard, halos staged through an all_gather.
- ``v5_collective``   ↔ V5 CUDA-aware MPI: row-sharded, the kernels on
  every shard, device-to-device neighbour halos.
- ``v7_tp``           ↔ V7 TensorParallel: conv filters split on K,
  channel-halo LRN (``parallel/tensor_parallel.py``).
- ``v6_full_jit``, ``v6_full_pallas``, ``v6_full_sharded``: full AlexNet
  (conv1-5, FC6-8) on library ops, on the CUDA kernels (FC head
  ``torch.matmul``), and row-sharded with the FC head on the gathered
  features.

The sharded strategies run on a mesh of shard slots (``parallel/mesh.py``):
on one card every slot shares it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict

import torch

from .models.alexnet import BLOCKS12, forward_blocks12
from .models.alexnet_full import ALEXNET, fc_head, forward_alexnet
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
    strategy: str  # "single" | "replicated" | "halo" | "staged_halo" | "tp"
    description: str
    model: str = "blocks12"  # "blocks12" | "alexnet_full"


REGISTRY: Dict[str, ExecConfig] = {
    c.key: c
    for c in [
        ExecConfig(
            "v1_jit", "V1 Serial", "reference", "single",
            "single-device PyTorch library ops (cuDNN on the GPU): the oracle",
        ),
        ExecConfig(
            "v2.1_replicated", "V2.1 BroadcastAll", "reference", "replicated",
            "every shard computes the whole pass on a full copy (the anti-baseline)",
        ),
        ExecConfig(
            "v2.2_sharded", "V2.2 ScatterHalo", "reference", "halo",
            "1-D row decomposition, device-to-device neighbour halos, library ops",
        ),
        ExecConfig(
            "v3_pallas", "V3 CUDA", "kernels", "single",
            "single-device hand-written CUDA kernels (conv+bias+ReLU, max-pool, LRN; one per block when fused)",
        ),
        ExecConfig(
            "v4_hybrid", "V4 MPI+CUDA", "kernels", "staged_halo",
            "row-sharded, the CUDA kernels on every shard, all_gather-staged halos (V4's host staging)",
        ),
        ExecConfig(
            "v5_collective", "V5 MPI+CUDA-Aware", "kernels", "halo",
            "row-sharded, the CUDA kernels on every shard, device-to-device neighbour halos",
        ),
        ExecConfig(
            "v7_tp", "V7 TensorParallel", "reference", "tp",
            "conv filter-bank (K-axis) decomposition: weights sharded, channel-halo LRN, boundary all_gather",
        ),
        ExecConfig(
            "v6_full_jit", "V6 AlexNet Full", "reference", "single",
            "full AlexNet (conv1-5 + FC6-8) single device, library ops (cuDNN, cuBLAS)",
            model="alexnet_full",
        ),
        ExecConfig(
            "v6_full_pallas", "V6 AlexNet Full Pallas", "kernels", "single",
            "full AlexNet, hand-written CUDA kernels for the spatial part, torch.matmul FC head",
            model="alexnet_full",
        ),
        ExecConfig(
            "v6_full_sharded", "V6 AlexNet Full Sharded", "reference", "halo",
            "full AlexNet, row-sharded spatial part + FC head on the gathered features",
            model="alexnet_full",
        ),
    ]
}

SHARDED = ("replicated", "halo", "staged_halo", "tp")


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


def _build_sharded(exec_cfg: ExecConfig, cfg, n_shards: int, mesh, plan, variants, quantized: bool) -> Callable:
    """The fp32 (or int8w) forward of a sharded strategy over ``mesh``."""
    from .parallel.replicated import build_replicated_forward
    from .parallel.sharded import build_sharded_forward
    from .parallel.tensor_parallel import build_tp_forward

    if exec_cfg.strategy == "replicated":
        return build_replicated_forward(cfg, n_shards, mesh=mesh, quantized=quantized)
    if exec_cfg.strategy == "tp":
        return build_tp_forward(cfg, n_shards, mesh=mesh)
    staged = exec_cfg.strategy == "staged_halo"
    if exec_cfg.model == "alexnet_full":
        spatial = build_sharded_forward(cfg, n_shards, mesh=mesh, tier=exec_cfg.tier, staged=staged, plan=plan,
                                        variants=variants)
        # the FC head on the gathered features (the 6x6x256 activations are small next to conv1's); across
        # ranks on rank 0, which alone holds them
        def full_forward(p, x):
            feats = spatial(p, x)
            return None if feats is None else fc_head(p, feats, cfg)

        return full_forward
    return build_sharded_forward(cfg, n_shards, mesh=mesh, tier=exec_cfg.tier, staged=staged, plan=plan,
                                 variants=variants, quantized=quantized)


def build_forward(
    exec_cfg: ExecConfig, model_cfg=None, policy=None, variants=None, device="cuda", plan=None,
    n_shards: int = 1, mesh=None,
) -> Callable:
    """A ``(params, x) -> out`` callable for ``exec_cfg``.

    ``params`` and ``x`` are fp32 on ``device``, NHWC/HWIO (FC weights
    ``(in, out)``); the output is fp32 on ``device``. ``model_cfg`` defaults
    to the config's family: ``BLOCKS12`` or ``ALEXNET``. ``policy`` (a
    preset name or ``DtypePolicy``; default fp32):

    - ``fp32``: true fp32 everywhere. On the card, cuDNN's and cuBLAS's
      TF32 switches are turned off here, before the reference tier runs
      (the JAX package's ``Precision.HIGHEST``); the kernels never use TF32.
    - ``bf16``: params and input cast to bf16, the forward run in bf16
      (the kernels accumulate in fp32, write each conv in bf16 after the
      fp32 bias and ReLU, pool in bf16, run LRN in fp32 and write bf16;
      the FC head's products come out in bf16, accumulated in fp32 on the
      card: ``ops.reference.linear``),
      and the output cast to fp32 — the cast points of the JAX package's
      ``configs.build_forward``, for every strategy.
    - ``int8w``: weights quantized per output channel inside the forward,
      bf16 activations, fp32 accumulation (TF32 off), fp32 output: on a
      single device ``precision.quantize.forward_blocks12_int8w`` on the
      config's tier, and on the halo, staged and replicated strategies their
      quantized builders. Blocks 1-2 only, and not tensor-parallel: other
      configs raise ``ValueError``, as in the JAX package.

    ``n_shards`` (the original code's ``mpirun -np N``) and ``mesh`` (a
    ``parallel.mesh.Mesh``; default ``make_mesh(n_shards)`` on ``device``'s
    type: every visible GPU, or the CPU; under a process group the mesh
    across its ranks) apply to the sharded strategies; a single-device
    config runs on ``device`` whatever they say, as in the JAX package.
    Across ranks the sharded forward returns the output on rank 0 and None
    on the others.

    ``variants`` (kernel tier only; the reference tier ignores it): a
    ``KernelVariants`` or per-layer ``LayerVariants``; None resolves the
    ``TPU_FRAMEWORK_*`` environment now, once, overlaid with ``plan`` (a
    ``tuning.plan.TunePlan``) when one is given: per knob an explicit
    environment variable beats the plan beats the default. The returned
    function keeps the variants it was built with; the sharded path ignores
    ``fuse``.
    """
    dev = resolve_device(device)
    pol = resolve_policy(policy)
    full = exec_cfg.model == "alexnet_full"
    strategy = exec_cfg.strategy
    if pol.quantized and (full or strategy not in ("single", "halo", "staged_halo", "replicated")):
        raise ValueError(
            f"policy {pol.name!r} supports the Blocks 1-2 single-device, halo-sharded, and replicated tiers only "
            f"(config {exec_cfg.key!r} is {exec_cfg.model}/{strategy}); quantized tensor-parallel and "
            "full-AlexNet forwards are open ROADMAP items"
        )
    cfg = model_cfg or (ALEXNET if full else BLOCKS12)
    kv = None
    if exec_cfg.tier == "kernels":
        kv = variants if variants is not None else _resolve_variants(plan)

    devices = (dev,)
    if strategy in SHARDED:
        from .parallel.mesh import make_mesh

        mesh = mesh or make_mesh(n_shards, device=dev.type)
        devices = mesh.distinct_devices
        fwd = _build_sharded(exec_cfg, cfg, n_shards, mesh, plan, kv, pol.quantized)
    elif pol.quantized:
        def fwd(p, x):
            return forward_blocks12_int8w(p, x, cfg, variants=kv, tier=exec_cfg.tier)
    else:
        if exec_cfg.tier == "kernels":
            model_fwd = functools.partial(forward_alexnet_kernels if full else forward_blocks12_kernels, variants=kv)
        else:
            model_fwd = forward_alexnet if full else forward_blocks12

        def fwd(p, x):
            return model_fwd(p, x, cfg)

    if pol.name != "bf16":
        for d in devices:
            true_fp32(d)

    def fp32_out(out):
        return None if out is None else out.float().contiguous()  # None: another rank holds the output

    if pol.name == "bf16":
        @torch.inference_mode()
        def forward(p, x):
            pb = params_to(p, dtype=torch.bfloat16)
            return fp32_out(fwd(pb, x.to(torch.bfloat16)))
    else:
        @torch.inference_mode()
        def forward(p, x):
            return fp32_out(fwd(p, x))

    return _observed(forward, exec_cfg, pol.name, n_shards)


def _observed(fn: Callable, exec_cfg: ExecConfig, dtype: str, n_shards: int) -> Callable:
    """The compile-observer gate (``observability.health``): with an
    observer installed (``health.set_compile_observer``), the first call per
    input shape is timed with the device fenced and reported as a
    ``compile_event`` at ``site="build"``; with none, ``fn`` itself comes
    back. There is no compiler cost model to ask, so the event's flops
    fields are null."""
    from .observability.health import get_compile_observer, observed_first_calls

    if get_compile_observer() is None:
        return fn
    return observed_first_calls(fn, site="build", entry=exec_cfg.key, dtype=dtype,
                                n_shards=n_shards if exec_cfg.strategy != "single" else 1)
