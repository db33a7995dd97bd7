"""Persistent kernel-tuning plans: on-disk winners of the variant sweep.

The JAX package's ``tuning/plan.py`` for the port, in the same JSON format
and key scheme, so a plan file written by either package reads in the
other. A ``TunePlan`` records, for one (device kind, model geometry, batch,
dtype, code revision) point, the per-layer ``KernelVariants`` the
autotuner measured fastest. Plan files hold many plans keyed by the full
point:

    {
      "version": 1,
      "plans": {
        "<device_kind>|<shape_key>|b<batch>|<dtype>|rev=<code_rev>": {
          "device_kind": ..., "shape_key": ..., "batch": ..., "dtype": ...,
          "code_rev": ..., "degraded": "", "created": "...",
          "layers":  {"conv1": {"conv": "vcol", "pool": "sep2", ...}},
          "stats":   {"conv1": {"best_ms": ..., "default_ms": ..., ...}}
        }
      },
      "policies": {"<device_kind>|<shape_key>|b<batch>|rev=<code_rev>": {...}}
    }

``device_kind`` is ``torch.cuda.get_device_name()`` (``"cpu"`` on the CPU).
Staleness: ``code_rev`` hashes the port's kernel wrappers, lowering and
CUDA sources; a plan tuned against different kernel code is a MISS
(re-sweep), never silently reused.

Precedence (one implementation, here): an EXPLICIT env knob beats the
tuned plan beats the code default, so a hand A/B (TPU_FRAMEWORK_CONV=taps)
still pins every layer even when a plan is loaded.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

from ..ops.variants import KernelVariants, LayerVariants

PLAN_VERSION = 1

# Variant-knob field -> env var: what the precedence merge reads.
VARIANT_ENV = {
    "conv": "TPU_FRAMEWORK_CONV",
    "pool": "TPU_FRAMEWORK_POOL",
    "row_block": "TPU_FRAMEWORK_ROWBLOCK",
    "k_block": "TPU_FRAMEWORK_KBLOCK",
    "fuse": "TPU_FRAMEWORK_FUSE",
}

# Sources whose drift invalidates tuned winners: the kernel wrappers, the
# model chain that decides fusion, the block route, the packers, the
# candidate space and the quantized lowering; and the CUDA sources
# themselves, through the build's own hash (``ops._build.source_hash``).
_REV_FILES = (
    "../ops/cuda_kernels.py",
    "../ops/kernel_model.py",
    "../ops/megakernel.py",
    "../ops/packing.py",
    "space.py",
    "../precision/quantize.py",
)


def code_rev() -> str:
    """12-hex digest of the kernel/lowering sources: the plan-staleness key."""
    from ..ops._build import source_hash

    h = hashlib.sha256()
    here = Path(__file__).resolve().parent
    for rel in _REV_FILES:
        h.update((here / rel).read_bytes())
    h.update(source_hash().encode())
    return h.hexdigest()[:12]


def device_kind(device) -> str:
    """The plan key's device field: ``torch.cuda.get_device_name`` of a CUDA
    device, ``"cpu"`` on the CPU."""
    import torch

    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def explicit_env_knobs() -> frozenset:
    """Variant-knob FIELDS the environment explicitly sets right now
    (non-empty value) — these outrank any tuned plan."""
    return frozenset(
        f for f, env in VARIANT_ENV.items() if os.environ.get(env, "").strip()
    )


def _input_dims(model_cfg) -> Tuple[int, int, int]:
    return model_cfg.in_height, model_cfg.in_width, model_cfg.in_channels


def shape_key(model_cfg) -> str:
    """Geometry identity of a model config: family + input dims (the layer
    chain is derived from these by the shared traversal). The families are
    the JAX package's: "blocks12" and "alexnet_full"."""
    h, w, c = _input_dims(model_cfg)
    return f"{model_cfg.family}_{h}x{w}x{c}"


def plan_key(device_kind: str, shape_k: str, batch: int, dtype: str, rev: str) -> str:
    return f"{device_kind}|{shape_k}|b{batch}|{dtype}|rev={rev}"


@dataclasses.dataclass(frozen=True)
class TunePlan:
    """Winners of one autotune sweep (or the default-plan degradation)."""

    device_kind: str
    shape_key: str
    batch: int
    dtype: str  # a precision policy name: "fp32" | "bf16" | "int8w"
    code_rev: str
    layers: Tuple[Tuple[str, KernelVariants], ...]
    stats: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # Non-empty = the sweep could not finish (deadline/chaos/faults) and fell
    # back to defaults for the listed layers — visible, never silent.
    degraded: str = ""

    @property
    def key(self) -> str:
        return plan_key(
            self.device_kind, self.shape_key, self.batch, self.dtype, self.code_rev
        )

    def variants_for(self, name: str, default: Optional[KernelVariants] = None):
        for n, v in self.layers:
            if n == name:
                return v
        return default if default is not None else KernelVariants()

    def plan_hash(self) -> str:
        """10-hex identity of (key, winners) — the CSV/bench row label that
        makes tuned measurements attributable to one exact plan."""
        payload = json.dumps(
            {"key": self.key, "layers": {n: v._asdict() for n, v in self.layers}},
            sort_keys=True,
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:10]

    def to_obj(self) -> dict:
        return {
            "device_kind": self.device_kind,
            "shape_key": self.shape_key,
            "batch": self.batch,
            "dtype": self.dtype,
            "code_rev": self.code_rev,
            "degraded": self.degraded,
            "layers": {n: v._asdict() for n, v in self.layers},
            "stats": self.stats,
        }

    @classmethod
    def from_obj(cls, obj: dict) -> "TunePlan":
        layers = tuple(
            (n, KernelVariants(**fields)) for n, fields in obj["layers"].items()
        )
        return cls(
            device_kind=obj["device_kind"],
            shape_key=obj["shape_key"],
            batch=int(obj["batch"]),
            dtype=obj["dtype"],
            code_rev=obj["code_rev"],
            layers=layers,
            stats=obj.get("stats", {}),
            degraded=obj.get("degraded", ""),
        )


def _read_file(path) -> dict:
    """The whole plan file as a dict (``plans`` + the sibling ``policies``
    section); a missing/torn file degrades to empty sections."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError):
        obj = {}
    if not isinstance(obj, dict):
        obj = {}
    if not isinstance(obj.get("plans"), dict):
        obj["plans"] = {}
    if not isinstance(obj.get("policies"), dict):
        obj["policies"] = {}
    obj["version"] = PLAN_VERSION
    return obj


def _read_plans(path) -> dict:
    return _read_file(path)["plans"]


def _write_file(path, obj: dict) -> None:
    # Atomic replace: a crash mid-save leaves the previous (complete) file,
    # never a torn one.
    from ..resilience.journal import atomic_write_text

    atomic_write_text(path, json.dumps(obj, indent=2) + "\n")


def save_plan(plan: TunePlan, path) -> str:
    """Merge one plan into the file under its key (read-modify-write; other
    device/dtype/batch points AND the policy records are preserved).
    Returns the key written."""
    path = Path(path)
    obj = _read_file(path)
    entry = plan.to_obj()
    entry["created"] = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%MZ"
    )
    obj["plans"][plan.key] = entry
    _write_file(path, obj)
    return plan.key


def load_plan(
    path,
    *,
    device_kind: str,
    model_cfg,
    dtype: str,
    batch: int,
    rev: Optional[str] = None,
    match_any_batch: bool = True,
) -> Optional[TunePlan]:
    """The plan for this exact point, or None (= tune or run untuned).

    A different ``code_rev`` is a MISS even when everything else matches —
    stale winners must never be applied to changed kernels. With
    ``match_any_batch`` a same-device/geometry/dtype plan tuned at another
    batch is accepted as the nearest usable point (the variants space is
    geometry-dominated; the returned plan keeps its own batch so consumers
    can see the approximation).
    """
    plans = _read_plans(path)
    if not plans:
        return None
    rev = rev or code_rev()
    sk = shape_key(model_cfg)
    exact = plans.get(plan_key(device_kind, sk, batch, dtype, rev))
    if exact is not None:
        return TunePlan.from_obj(exact)
    if not match_any_batch:
        return None
    prefix = f"{device_kind}|{sk}|b"
    suffix = f"|{dtype}|rev={rev}"
    for key in sorted(plans):
        if key.startswith(prefix) and key.endswith(suffix):
            return TunePlan.from_obj(plans[key])
    return None


def plan_batches(
    path,
    *,
    device_kind: str,
    model_cfg,
    dtype: str,
    rev: Optional[str] = None,
) -> list:
    """Batch sizes the plan file holds CURRENT tuned winners for at this
    (device kind, geometry, dtype, code-rev) point, sorted ascending.

    The JAX package's serving layer pads every batch to one of these sizes
    so tuned winners apply. Stale-rev entries are excluded for the same
    reason ``load_plan`` misses on them: their winners no longer describe
    the current kernels. Empty when the file is missing or unmatched."""
    plans = _read_plans(path)
    if not plans:
        return []
    rev = rev or code_rev()
    prefix = f"{device_kind}|{shape_key(model_cfg)}|b"
    suffix = f"|{dtype}|rev={rev}"
    batches = set()
    for key, obj in plans.items():
        if not (key.startswith(prefix) and key.endswith(suffix)):
            continue
        try:
            batches.add(int(obj["batch"]))
        except (KeyError, TypeError, ValueError):
            continue  # malformed entry: not a usable bucket, skip it
    return sorted(batches)


def policy_key(device_kind: str, shape_k: str, batch: int, rev: str) -> str:
    """Key of a dtype-policy record — the plan key WITHOUT the dtype field
    (the record's whole job is to say which dtype won at this point)."""
    return f"{device_kind}|{shape_k}|b{batch}|rev={rev}"


def save_policy(
    path,
    *,
    device_kind: str,
    model_cfg,
    batch: int,
    dtype: str,
    rev: Optional[str] = None,
    swept=(),
    pruned: Optional[Dict[str, str]] = None,
    gates: Optional[Dict[str, dict]] = None,
) -> str:
    """Persist the dtype-sweep winner for one (device, geometry, batch,
    code-rev) point into the plan file's ``policies`` section (sibling of
    ``plans``; the per-dtype kernel winners stay under their own keys).

    ``pruned`` records every gate-failed dtype with its attributable
    reason; ``gates`` the full per-dtype gate verdicts (margin and all).
    The gate's journaled
    ``gate_pass`` record is written by the gate itself at screening time;
    this record points at the same verdict."""
    path = Path(path)
    obj = _read_file(path)
    rev = rev or code_rev()
    key = policy_key(device_kind, shape_key(model_cfg), batch, rev)
    obj["policies"][key] = {
        "device_kind": device_kind,
        "shape_key": shape_key(model_cfg),
        "batch": batch,
        "code_rev": rev,
        "dtype": dtype,
        "swept": list(swept),
        "pruned": dict(pruned or {}),
        "gates": dict(gates or {}),
        "created": datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%MZ"
        ),
    }
    _write_file(path, obj)
    return key


def load_policy(
    path,
    *,
    device_kind: str,
    model_cfg,
    batch: int,
    rev: Optional[str] = None,
    match_any_batch: bool = True,
) -> Optional[dict]:
    """The dtype-policy record for this point, or None. Same staleness and
    nearest-batch semantics as ``load_plan``: a different code_rev is a
    MISS, and with ``match_any_batch`` a same-device/geometry record tuned
    at another batch is the nearest usable point."""
    policies = _read_file(path)["policies"]
    if not policies:
        return None
    rev = rev or code_rev()
    sk = shape_key(model_cfg)
    exact = policies.get(policy_key(device_kind, sk, batch, rev))
    if exact is not None:
        return exact
    if not match_any_batch:
        return None
    prefix = f"{device_kind}|{sk}|b"
    suffix = f"|rev={rev}"
    for key in sorted(policies):
        if key.startswith(prefix) and key.endswith(suffix):
            return policies[key]
    return None


def effective_layer_variants(
    plan: TunePlan, base: Optional[KernelVariants] = None
) -> LayerVariants:
    """Merge a tuned plan with the environment into the per-layer variants a
    forward builder closes over. Precedence per knob: explicit env var >
    tuned plan > code default. ``base`` is the env-resolved variants
    (``KernelVariants.resolve()``), whose values are authoritative exactly
    for the knobs the env explicitly sets; unset knobs take the plan's
    winners. Layers the plan does not cover fall back to ``base`` whole."""
    base = base if base is not None else KernelVariants.resolve()
    explicit = explicit_env_knobs()
    layers = []
    for name, pv in plan.layers:
        merged = {
            f: getattr(base if f in explicit else pv, f) for f in VARIANT_ENV
        }
        layers.append((name, KernelVariants(**merged, k_channels=pv.k_channels)))
    return LayerVariants(layers=tuple(layers), default=base)
