"""Kernel autotuning: candidate space, sweep, and persistent TunePlans.

The JAX package's ``tuning/`` over the port's CUDA kernels: the
per-(geometry, dtype, batch, device, code-rev) replacement for hand-set
TPU_FRAMEWORK_* variant knobs. Precedence: an explicit env var beats a
tuned plan beats the code default.
"""

from .autotune import DTYPES, AllDtypesPruned, autotune, autotune_model, autotune_precision, tune_layer
from .plan import (
    VARIANT_ENV,
    TunePlan,
    code_rev,
    effective_layer_variants,
    explicit_env_knobs,
    load_plan,
    load_policy,
    plan_key,
    save_plan,
    save_policy,
    shape_key,
)
from .space import ConvGeometry, candidate_space, conv_geometries, prune_reason

__all__ = [
    "AllDtypesPruned",
    "ConvGeometry",
    "DTYPES",
    "TunePlan",
    "VARIANT_ENV",
    "autotune",
    "autotune_model",
    "autotune_precision",
    "candidate_space",
    "code_rev",
    "conv_geometries",
    "effective_layer_variants",
    "explicit_env_knobs",
    "load_plan",
    "load_policy",
    "plan_key",
    "prune_reason",
    "save_plan",
    "save_policy",
    "shape_key",
    "tune_layer",
]
