"""ToleranceGate: a lowered-precision policy or a fused route passes only
within budget of the fp32 oracle.

The JAX package's ``precision/gate.py``. A screening runs the fp32 oracle
(reference ops, true fp32) and the candidate through the same staged
forward, with taps at every conv/pool/LRN boundary (``screen``), or holds
the fused blocks' outputs against the oracle's block-boundary stages
(``screen_blocks``), or holds a row-sharded forward's output against the
oracle's lrn2 at a shard count (``screen_sharded``), and compares each
stage with its budget.

Budgets are per-stage max-abs / max-rel pairs; ``rel`` is normalised by the
oracle stage's max |value| (elementwise relative error explodes near the
zeros LRN outputs cross). ``margin`` is the fraction of budget left (1.0 =
exact, 0.0 = at budget, negative = fail).

Each screening journals a ``gate_pass``/``gate_fail`` record (with the
trace ids of an open span) when the gate has a journal
(``resilience.journal.Journal``): the evidence the autotuner's dtype sweep
keys on. Before trusting the fp32 reference forward as the oracle, the gate
preflights ``resilience.sentinel.oracle_spot_check`` on the screened
input's device (default ``preflight=True``, as in the JAX package): a
reference conv that deviates from the numpy loop oracle by more than 1e-3
fails every candidate with an ``oracle_fault``. A kernel that fails to
build or launch raises out of a screening; it is not turned into a verdict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from ..models.alexnet import BLOCKS12
from ..ops import megakernel as mk
from ..ops import reference as ops
from ..ops.shapes import conv_out_dim
from ..ops.variants import KernelVariants
from .policy import DtypePolicy, resolve_policy, tdt

# Per-policy, per-stage budgets; "*" is the any-stage default. bf16 carries
# ~2^-8 operand rounding through two convs; int8w adds <= scale/2 per
# weight (~0.4% of the channel max) on top — budgets leave ~4x headroom
# over the observed CPU/TPU error so a genuine SDC or broken lowering
# (not rounding) is what trips them.
@dataclasses.dataclass(frozen=True)
class StageBudget:
    max_abs: float = math.inf
    max_rel: float = math.inf


DEFAULT_BUDGETS: Dict[str, Dict[str, StageBudget]] = {
    "fp32": {
        "*": StageBudget(max_abs=1e-4, max_rel=1e-5),
        # Block-granularity rows (the fused screen): a different lowering
        # whose fp32 MACs accumulate in another order than the oracle's.
        "block1": StageBudget(max_abs=1e-3, max_rel=1e-4),
        "block2": StageBudget(max_abs=1e-3, max_rel=1e-4),
    },
    "bf16": {"*": StageBudget(max_rel=2e-2)},
    "int8w": {"*": StageBudget(max_rel=6e-2)},
}


@dataclasses.dataclass
class StageCheck:
    stage: str
    max_abs: float
    max_rel: float  # |cand-oracle|max / |oracle|max
    abs_budget: float
    rel_budget: float

    @property
    def passed(self) -> bool:
        return self.max_abs <= self.abs_budget and self.max_rel <= self.rel_budget

    @property
    def margin(self) -> float:
        """Fraction of budget unspent; the binding (smaller) of abs/rel."""
        m = 1.0
        if math.isfinite(self.abs_budget) and self.abs_budget > 0:
            m = min(m, 1.0 - self.max_abs / self.abs_budget)
        if math.isfinite(self.rel_budget) and self.rel_budget > 0:
            m = min(m, 1.0 - self.max_rel / self.rel_budget)
        return m

    def to_obj(self) -> dict:
        return {
            "stage": self.stage,
            "max_abs": float(self.max_abs),
            "max_rel": float(self.max_rel),
            "abs_budget": self.abs_budget if math.isfinite(self.abs_budget) else None,
            "rel_budget": self.rel_budget if math.isfinite(self.rel_budget) else None,
            "passed": self.passed,
            "margin": round(self.margin, 6),
        }


@dataclasses.dataclass
class GateResult:
    policy: str
    stages: List[StageCheck] = dataclasses.field(default_factory=list)
    oracle_fault: str = ""  # non-empty: the fp32 oracle itself failed preflight

    @property
    def passed(self) -> bool:
        return not self.oracle_fault and all(s.passed for s in self.stages)

    @property
    def margin(self) -> float:
        if self.oracle_fault:
            return -math.inf
        return min((s.margin for s in self.stages), default=1.0)

    @property
    def worst_stage(self) -> str:
        if not self.stages:
            return ""
        return min(self.stages, key=lambda s: s.margin).stage

    def reason(self) -> str:
        """The verdict line a refused candidate's record carries."""
        if self.oracle_fault:
            return f"{self.policy}: {self.oracle_fault}"
        if self.passed:
            return ""
        s = min(self.stages, key=lambda s: s.margin)
        parts = []
        if s.max_rel > s.rel_budget:
            parts.append(f"max_rel {s.max_rel:.3e} > budget {s.rel_budget:.1e}")
        if s.max_abs > s.abs_budget:
            parts.append(f"max_abs {s.max_abs:.3e} > budget {s.abs_budget:.1e}")
        return f"{self.policy}: stage {s.stage} " + ", ".join(parts)

    def to_obj(self) -> dict:
        return {
            "policy": self.policy,
            "passed": self.passed,
            "margin": None if self.margin == -math.inf else round(self.margin, 6),
            "worst_stage": self.worst_stage,
            "oracle_fault": self.oracle_fault,
            "reason": self.reason(),
            "stages": [s.to_obj() for s in self.stages],
        }


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


@torch.inference_mode()
def staged_policy_outputs(params, x, cfg=BLOCKS12, policy="fp32") -> Dict[str, np.ndarray]:
    """fp32 copies of every layer-boundary activation under ``policy``, on
    the reference-op tier: the comparison surface both gate sides run
    through. fp32 is the oracle (true fp32: TF32 off on the card); bf16
    casts operands per layer and accumulates in fp32; int8w takes the
    quantized forward's taps."""
    pol = resolve_policy(policy)
    ops.true_fp32(x.device)
    if pol.quantized:
        from .quantize import forward_blocks12_int8w

        _out, stages = forward_blocks12_int8w(params, x, cfg, tier="reference", taps=True)
        return {k: _np(v) for k, v in stages.items()}

    stages: Dict[str, np.ndarray] = {}
    cur = x
    c1, p1, c2, p2, n2 = cfg.conv1, cfg.pool1, cfg.conv2, cfg.pool2, cfg.lrn2
    for cname, cspec, pname, pspec in (("conv1", c1, "pool1", p1), ("conv2", c2, "pool2", p2)):
        lp = pol.layer(cname)
        cdt, adt = tdt(lp.compute), tdt(lp.accumulate)
        cur = ops.conv2d(
            cur.to(cdt), params[cname]["w"].to(tdt(lp.params)), params[cname]["b"].to(adt),
            stride=cspec.stride, padding=cspec.padding, preferred_element_type=adt,
        )
        cur = ops.relu(cur).to(cdt)
        stages[cname] = _np(cur)
        cur = ops.maxpool(cur, window=pspec.window, stride=pspec.stride)
        stages[pname] = _np(cur)
    stages["lrn2"] = _np(ops.lrn(
        cur.float(), size=n2.size, alpha=n2.alpha, beta=n2.beta, k=n2.k,
        alpha_over_size=n2.alpha_over_size,
    ))
    return stages


# The fused blocks' comparison surface: each block's single output, joined
# to the staged oracle at the block BOUNDARY stages.
BLOCK_BOUNDARIES = (("block1", "pool1"), ("block2", "lrn2"))


@torch.inference_mode()
def megakernel_block_outputs(params, x, cfg=BLOCKS12, policy="fp32", variants=None) -> Dict[str, np.ndarray]:
    """fp32 copies of the fused blocks' outputs under ``policy``: both
    blocks through ``ops.megakernel`` (the ``conv_block`` kernel on the
    card, its plain version on the CPU), int8w through the epilogue-rescale
    variant."""
    pol = resolve_policy(policy)
    c1, p1, c2, p2, n2 = cfg.conv1, cfg.pool1, cfg.conv2, cfg.pool2, cfg.lrn2
    v = variants if variants is not None else KernelVariants()
    conv_v = v.conv if v.conv in ("taps", "vcol") else "vcol"
    out: Dict[str, np.ndarray] = {}
    blocks = (("block1", "conv1", c1, p1, None), ("block2", "conv2", c2, p2, n2))
    if pol.quantized:
        from .quantize import quantize_conv_params

        qp = quantize_conv_params(params)
        cur = x.to(torch.bfloat16)
        for bname, cname, cspec, pspec, lrn in blocks:
            ho = conv_out_dim(cur.shape[1], cspec.filter_size, cspec.padding, cspec.stride)
            e = qp[cname]
            cur = mk.int8w_conv_block(
                cur, e["q"], e["scale"], e["b"], stride=cspec.stride, padding=cspec.padding,
                pool_window=pspec.window, pool_stride=pspec.stride,
                lrn=lrn, variant=conv_v, row_block=max(v.row_block, ho),
            )
            out[bname] = _np(cur)
        return out
    cur = x
    for bname, cname, cspec, pspec, lrn in blocks:
        lp = pol.layer(cname)
        cdt = tdt(lp.compute)
        ho = conv_out_dim(cur.shape[1], cspec.filter_size, cspec.padding, cspec.stride)
        cur = mk.conv_block(
            cur.to(cdt), params[cname]["w"].to(tdt(lp.params)), params[cname]["b"].to(cdt),
            stride=cspec.stride, padding=cspec.padding,
            pool_window=pspec.window, pool_stride=pspec.stride,
            lrn=lrn, variant=conv_v, row_block=max(v.row_block, ho),
        )
        out[bname] = _np(cur)
    return out


def _stage_check(stage: str, got: np.ndarray, want: np.ndarray, budget: StageBudget) -> StageCheck:
    diff = float(np.max(np.abs(got - want))) if want.size else 0.0
    denom = float(np.max(np.abs(want))) if want.size else 0.0
    rel = diff / denom if denom > 0 else (0.0 if diff == 0.0 else math.inf)
    return StageCheck(stage, diff, rel, budget.max_abs, budget.max_rel)


class ToleranceGate:
    """Screen a candidate policy against the fp32 oracle, stage by stage.

    ``budgets``: ``{policy_name: {stage_or_"*": StageBudget}}`` overrides
    (missing entries fall back to :data:`DEFAULT_BUDGETS`). ``journal``: a
    ``resilience.journal.Journal`` receiving one fsync'd ``gate_pass`` /
    ``gate_fail`` record per screening. ``preflight``: run the oracle spot
    check before each screening (see the module docstring)."""

    def __init__(self, budgets=None, journal=None, preflight: bool = True):
        self.budgets = dict(DEFAULT_BUDGETS)
        if budgets:
            self.budgets.update(budgets)
        self.journal = journal
        self.preflight = preflight

    def budget_for(self, policy: str, stage: str) -> StageBudget:
        table = self.budgets.get(policy, {})
        return table.get(stage) or table.get("*") or StageBudget()

    def _preflight_fault(self, device) -> str:
        """The oracle fault the preflight finds on ``device`` ('' = none)."""
        if not self.preflight:
            return ""
        from ..resilience.sentinel import oracle_spot_check

        err = oracle_spot_check(device=device)
        if err > 1e-3:
            return (
                f"fp32 oracle failed preflight: device fp32 conv deviates "
                f"from the tests/oracle.py loop oracle by {err:.3e}"
            )
        return ""

    def screen(self, policy, params, x, model_cfg=BLOCKS12, *, key: str = "", candidate_params=None) -> GateResult:
        """Oracle and candidate staged forwards, compared stage by stage;
        the verdict is journaled under ``key``. ``candidate_params``: an
        optional distinct param tree for the candidate side (a corrupted
        replica must fail against the clean oracle)."""
        pol: DtypePolicy = resolve_policy(policy)
        res = GateResult(policy=pol.name, oracle_fault=self._preflight_fault(x.device))
        if res.oracle_fault:
            self._journal(res, key)
            return res
        oracle = staged_policy_outputs(params, x, model_cfg, "fp32")
        if pol.name == "fp32" and candidate_params is None:
            # The oracle matches itself; exact stages keep the schema uniform.
            for stage in oracle:
                b = self.budget_for("fp32", stage)
                res.stages.append(StageCheck(stage, 0.0, 0.0, b.max_abs, b.max_rel))
            self._journal(res, key)
            return res
        cand = staged_policy_outputs(
            candidate_params if candidate_params is not None else params, x, model_cfg, pol
        )
        for stage, want in oracle.items():
            res.stages.append(_stage_check(stage, cand[stage], want, self.budget_for(pol.name, stage)))
        self._journal(res, key)
        return res

    def screen_blocks(self, policy, params, x, model_cfg=BLOCKS12, *, variants=None, key: str = "") -> GateResult:
        """Screen the fused blocks at BLOCK granularity: each block's single
        output against the fp32 staged oracle at its boundary stage
        (``BLOCK_BOUNDARIES``), with the block's budget (falling back to
        the policy's "*" row); journaled like :meth:`screen`."""
        pol: DtypePolicy = resolve_policy(policy)
        res = GateResult(policy=pol.name, oracle_fault=self._preflight_fault(x.device))
        if res.oracle_fault:
            self._journal(res, key)
            return res
        oracle = staged_policy_outputs(params, x, model_cfg, "fp32")
        cand = megakernel_block_outputs(params, x, model_cfg, pol, variants=variants)
        for bname, boundary in BLOCK_BOUNDARIES:
            res.stages.append(_stage_check(bname, cand[bname], oracle[boundary], self.budget_for(pol.name, bname)))
        self._journal(res, key)
        return res

    def screen_sharded(self, policy, params, x, model_cfg=BLOCKS12, *, n_shards: int, tier: str = "reference",
                       staged: bool = False, key: str = "", mesh=None) -> GateResult:
        """Screen one rung of the row-sharded tier: the whole sharded
        forward's output under ``policy`` (int8w runs the quantized sharded
        path, bf16 the cast around the fp32 builder, as ``configs`` ships
        it) against the fp32 staged oracle's lrn2 boundary. The shard count
        is part of the journalled key (``gate-sharded:<policy>|n<N>``): the
        halo and mask machinery must hold the budget at every rung. ``mesh``
        defaults to ``n_shards`` slots on ``x``'s device type."""
        from ..models.init import params_to
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded import build_sharded_forward

        pol: DtypePolicy = resolve_policy(policy)
        key = key or f"gate-sharded:{pol.name}|n{n_shards}"
        res = GateResult(policy=pol.name, oracle_fault=self._preflight_fault(x.device))
        if res.oracle_fault:
            self._journal(res, key)
            return res
        want = staged_policy_outputs(params, x, model_cfg, "fp32")["lrn2"]
        fwd = build_sharded_forward(model_cfg, n_shards, mesh=mesh or make_mesh(n_shards, device=x.device.type),
                                    tier=tier, staged=staged, quantized=pol.quantized)
        if pol.quantized or pol.name == "fp32":
            got = fwd(params, x)
        else:
            got = fwd(params_to(params, dtype=torch.bfloat16), x.to(torch.bfloat16))
        res.stages.append(_stage_check(f"lrn2@n{n_shards}", _np(got), want, self.budget_for(pol.name, "lrn2")))
        self._journal(res, key)
        return res

    def _journal(self, res: GateResult, key: str) -> None:
        if self.journal is not None:
            from ..observability.trace import current_ids

            self.journal.append(
                "gate_pass" if res.passed else "gate_fail",
                key=key or f"gate:{res.policy}",
                **current_ids(),
                **res.to_obj(),
            )
