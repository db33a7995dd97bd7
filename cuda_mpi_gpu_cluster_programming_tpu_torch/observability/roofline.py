"""Roofline attribution: per-stage MFU, an HBM-traffic ledger, and the
predicted fused-block ceiling.

The JAX package's ``observability/roofline.py`` for the port, judged against
the H100 spec table of :mod:`.specs` (the bench row reads the same table):

- **Analytic ledger** (:func:`stage_ledger` / :func:`pass_ledger`):
  per-stage FLOPs from the port's ``models.alexnet.stage_flops`` (the
  generator ``flops_per_image`` sums) and the HBM bytes each stage moves
  when run staged: it reads its input activation and params and writes its
  output activation, at the dtype policy's widths (fp32 4 B, bf16 2 B,
  int8w 1 B weights with fp32 per-channel scales over bf16 activations).
  Conv stages include their ReLU.
- **Fused byte model** (:func:`fused_blocks`): one pass per block that
  keeps its interior activations on chip reads the block input and params
  and writes the block output only; ``staged - fused`` is the
  intermediates' round trips. Over the spec's roofs that gives a fused time
  floor and an MFU ceiling per block.
- **Measured attribution** (:func:`attribute_roofline`): a measured
  per-stage breakdown (``observability.stages``, a bench row's
  ``breakdown``) joined with the ledger: achieved FLOP/s and GB/s, MFU
  against the dtype's peak (fp32 on FFMA, bf16 and int8w on the tensor
  cores), the compute/memory verdict at the ridge point, and the headroom
  to the binding roof. A stage measured faster than its roof did fewer
  operations than the ledger counts (cuDNN's FFT convolution in fp32, for
  one): its row carries a ``note`` saying so, and its share is shown as
  measured, above 1, never clamped. Rows without a breakdown take a
  **model split** (``source="model"``): ``per_pass_ms`` spread over the
  stages in proportion to their floors.
- **Bench-row views** (:func:`roofline_from_bench_row`): a bench row and
  its ``bf16`` sub-object, each attributed from its own fields.

Standard library, :mod:`.specs` and the port's ``models.alexnet``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .specs import hbm_gbps as _spec_hbm, peak_tflops as _spec_peak, spec_for

# Activation / weight byte widths per dtype policy: int8w stores int8
# weights with fp32 per-output-channel scales and runs bf16 activations.
_ACT_BYTES = {"fp32": 4, "bf16": 2, "int8w": 2}
_WEIGHT_BYTES = {"fp32": 4, "bf16": 2, "int8w": 1}

# The blocks ``fuse="block"`` runs as one ``conv_block`` launch each.
BLOCKS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("block1", ("conv1", "pool1")),
    ("block2", ("conv2", "pool2", "lrn2")),
)

ABOVE_ROOF_NOTE = (
    "ran faster than its roof: the algorithm did fewer operations than the ledger counts "
    "(a library's FFT or Winograd convolution), so mfu above 1 is no utilization"
)


@dataclasses.dataclass(frozen=True)
class StageCost:
    """One stage's analytic cost for ONE pass at a given batch: FLOPs and
    the staged-execution HBM traffic (activations scale with batch;
    params are read once per pass)."""

    name: str
    flops: int  # all work, batch-scaled
    matmul_flops: int  # conv MACs x2 only (the MFU numerator), batch-scaled
    act_in_bytes: int
    act_out_bytes: int
    param_bytes: int

    @property
    def staged_bytes(self) -> int:
        """HBM bytes this stage moves when executed staged: read input
        activation + params, write output activation."""
        return self.act_in_bytes + self.param_bytes + self.act_out_bytes

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (FLOP/byte) under staged execution."""
        return self.flops / self.staged_bytes if self.staged_bytes else 0.0


def _dtype_bytes(dtype: str) -> Tuple[int, int]:
    if dtype not in _ACT_BYTES:
        raise ValueError(
            f"roofline ledger supports {sorted(_ACT_BYTES)}, got {dtype!r}"
        )
    return _ACT_BYTES[dtype], _WEIGHT_BYTES[dtype]


def stage_ledger(cfg=None, dtype: str = "fp32") -> List[StageCost]:
    """Per-stage costs for ONE image (batch=1) — see :func:`pass_ledger`
    for the batch-scaled form the attribution joins against."""
    return pass_ledger(cfg, dtype=dtype, batch=1)


def pass_ledger(cfg=None, dtype: str = "fp32", batch: int = 1) -> List[StageCost]:
    """The analytic per-stage ledger for one pass of ``batch`` images.

    FLOPs come from ``models.alexnet.stage_flops`` (the generator the
    whole-pass counters sum); bytes from the layer dims under the dtype
    policy's widths. Params are counted once per pass, activations per
    image.
    """
    from ..models.alexnet import BLOCKS12, ConvSpec, layer_dims, stage_flops

    cfg = cfg if cfg is not None else BLOCKS12
    act_b, w_b = _dtype_bytes(dtype)
    batch = max(1, int(batch))
    flops_by_stage = {n: (f, mm) for n, f, mm in stage_flops(cfg)}
    out: List[StageCost] = []
    for name, spec, (hi, wi, ci), (h, w, c) in layer_dims(cfg):
        flops, matmul = flops_by_stage[name]
        params = 0
        if isinstance(spec, ConvSpec):
            params = spec.filter_size**2 * ci * c * w_b + c * act_b  # w + bias
            if dtype == "int8w":
                params += c * 4  # fp32 per-output-channel scales
        out.append(
            StageCost(
                name=name,
                flops=flops * batch,
                matmul_flops=matmul * batch,
                act_in_bytes=hi * wi * ci * act_b * batch,
                act_out_bytes=h * w * c * act_b * batch,
                param_bytes=params,
            )
        )
    return out


# ------------------------------------------------------ fused byte model ---


@dataclasses.dataclass(frozen=True)
class BlockModel:
    """Staged-vs-fused prediction for one block at a device spec."""

    name: str
    stages: Tuple[str, ...]
    flops: int
    matmul_flops: int
    staged_bytes: int
    fused_bytes: int  # block input + params + block output only
    staged_floor_ms: float  # sum of per-stage max(compute, memory) floors
    fused_floor_ms: float  # max(compute, memory) over the fused pass
    fused_mfu_ceiling: Optional[float]  # matmul/(peak * fused_floor)

    @property
    def intermediate_bytes(self) -> int:
        """The HBM round-trips fusion deletes: every interior boundary's
        activation written once and read once."""
        return self.staged_bytes - self.fused_bytes

    def to_obj(self) -> dict:
        return {
            "stages": list(self.stages),
            "flops": self.flops,
            "matmul_flops": self.matmul_flops,
            "staged_bytes": self.staged_bytes,
            "fused_bytes": self.fused_bytes,
            "intermediate_bytes": self.intermediate_bytes,
            "staged_floor_ms": round(self.staged_floor_ms, 4),
            "fused_floor_ms": round(self.fused_floor_ms, 4),
            "fused_mfu_ceiling": (
                round(self.fused_mfu_ceiling, 4)
                if self.fused_mfu_ceiling is not None
                else None
            ),
        }


def _floor_ms(flops: int, num_bytes: int, peak_tflops: float, bw_gbps: float) -> float:
    """Roofline time floor: the binding of the compute and memory roofs."""
    compute_s = flops / (peak_tflops * 1e12) if peak_tflops else 0.0
    memory_s = num_bytes / (bw_gbps * 1e9) if bw_gbps else 0.0
    return max(compute_s, memory_s) * 1e3


def fused_blocks(
    entries: List[StageCost], peak_tflops: float, bw_gbps: float
) -> List[BlockModel]:
    """The fused-ceiling prediction per block: what a pass that keeps the
    block's interior activations on chip is worth at these roofs."""
    by_name = {e.name: e for e in entries}
    out: List[BlockModel] = []
    for block, names in BLOCKS:
        stages = [by_name[n] for n in names if n in by_name]
        if len(stages) != len(names):
            continue  # non-blocks12 ledger: no block story to tell
        flops = sum(e.flops for e in stages)
        matmul = sum(e.matmul_flops for e in stages)
        staged = sum(e.staged_bytes for e in stages)
        fused = (
            stages[0].act_in_bytes
            + sum(e.param_bytes for e in stages)
            + stages[-1].act_out_bytes
        )
        staged_floor = sum(
            _floor_ms(e.flops, e.staged_bytes, peak_tflops, bw_gbps)
            for e in stages
        )
        fused_floor = _floor_ms(flops, fused, peak_tflops, bw_gbps)
        ceiling = (
            matmul / (peak_tflops * 1e12 * fused_floor / 1e3)
            if peak_tflops and fused_floor > 0
            else None
        )
        out.append(
            BlockModel(
                name=block,
                stages=tuple(names),
                flops=flops,
                matmul_flops=matmul,
                staged_bytes=staged,
                fused_bytes=fused,
                staged_floor_ms=staged_floor,
                fused_floor_ms=fused_floor,
                fused_mfu_ceiling=ceiling,
            )
        )
    return out


# -------------------------------------------------- measured attribution ---


@dataclasses.dataclass(frozen=True)
class StageRoofline:
    """One stage's measured-vs-roof verdict."""

    name: str
    ms: float
    share: float  # of the pass total
    flops: int
    matmul_flops: int
    bytes: int
    intensity: float  # FLOP/byte, staged
    achieved_tflops: float
    achieved_gbps: float
    mfu: Optional[float]
    bound: str  # "compute" | "memory"
    floor_ms: float  # the binding roof's time floor
    headroom_ms: float  # ms - floor_ms: reclaimable time at this roof
    headroom_x: Optional[float]  # ms / floor_ms
    # Block-granularity rows only: the fused_mfu_ceiling this block's
    # measured MFU is judged against. None on per-stage rows.
    mfu_ceiling: Optional[float] = None
    # Set when the stage ran faster than its roof (ms < floor_ms): the work
    # done was less than the ledger counts, and mfu above 1 says so.
    note: str = ""

    def to_obj(self) -> dict:
        obj = {
            "name": self.name,
            "ms": round(self.ms, 4),
            "share": round(self.share, 4),
            "flops": self.flops,
            "matmul_flops": self.matmul_flops,
            "bytes": self.bytes,
            "intensity": round(self.intensity, 2),
            "achieved_tflops": round(self.achieved_tflops, 4),
            "achieved_gbps": round(self.achieved_gbps, 2),
            "mfu": round(self.mfu, 4) if self.mfu is not None else None,
            "bound": self.bound,
            "floor_ms": round(self.floor_ms, 4),
            "headroom_ms": round(self.headroom_ms, 4),
            "headroom_x": (
                round(self.headroom_x, 2) if self.headroom_x is not None else None
            ),
        }
        if self.mfu_ceiling is not None:
            obj["mfu_ceiling"] = round(self.mfu_ceiling, 4)
        if self.note:
            obj["note"] = self.note
        return obj


@dataclasses.dataclass
class RooflineReport:
    """The full attribution: ranked stages, block predictions, pass MFU."""

    dtype: str
    batch: int
    device: str  # spec name the verdicts are judged against
    device_kind: str  # torch.cuda.get_device_name (or what the row carried)
    spec_assumed: bool  # True = no spec matched; the H100 SXM stands in
    peak_tflops: float
    hbm_gbps: float
    ridge_intensity: float  # FLOP/byte where the roofs cross
    source: str  # "breakdown" (measured stage ms) | "model" (split)
    total_ms: float
    pass_mfu: Optional[float]
    stages: List[StageRoofline]  # ranked: biggest headroom_ms first
    blocks: List[BlockModel]
    fused_pass_mfu_ceiling: Optional[float] = None
    label: str = ""  # row context ("bf16@b128")
    granularity: str = "stage"  # "stage" | "block" (megakernel rows)

    def to_obj(self) -> dict:
        return {
            "dtype": self.dtype,
            "granularity": self.granularity,
            "batch": self.batch,
            "device": self.device,
            "device_kind": self.device_kind,
            "spec_assumed": self.spec_assumed,
            "peak_tflops": self.peak_tflops,
            "hbm_gbps": self.hbm_gbps,
            "ridge_intensity": round(self.ridge_intensity, 2),
            "source": self.source,
            "total_ms": round(self.total_ms, 4),
            "pass_mfu": (
                round(self.pass_mfu, 4) if self.pass_mfu is not None else None
            ),
            "fused_pass_mfu_ceiling": (
                round(self.fused_pass_mfu_ceiling, 4)
                if self.fused_pass_mfu_ceiling is not None
                else None
            ),
            "stale": False,  # the JAX report's key: a port row carries no earlier measurement
            "label": self.label or None,
            "stages": [s.to_obj() for s in self.stages],
            "blocks": {b.name: b.to_obj() for b in self.blocks},
        }

    def render(self) -> str:
        """The ranked stage table (the CLI's text face)."""
        hdr = (
            f"roofline [{self.dtype} b={self.batch} {self.device}"
            f"{' (assumed spec)' if self.spec_assumed else ''}"
            f" peak={self.peak_tflops:g}TF/s hbm={self.hbm_gbps:g}GB/s"
            f" ridge_ai={self.ridge_intensity:.0f}]"
        )
        if self.label:
            hdr += f" {self.label}"
        lines = [hdr]
        mfu = f"{self.pass_mfu:.4f}" if self.pass_mfu is not None else "n/a"
        lines.append(
            f"  pass: {self.total_ms:.4f} ms mfu={mfu} source={self.source}"
            f"{' granularity=block' if self.granularity == 'block' else ''}"
        )
        lines.append(
            "  rank stage    ms      share  AI      TF/s    GB/s    mfu"
            "     bound    floor_ms headroom_ms"
        )
        for i, s in enumerate(self.stages, 1):
            smfu = f"{s.mfu:.3f}" if s.mfu is not None else "  n/a"
            line = (
                f"  {i:<4d} {s.name:<8s} {s.ms:<7.4f} {s.share:<6.2f} "
                f"{s.intensity:<7.1f} {s.achieved_tflops:<7.2f} "
                f"{s.achieved_gbps:<7.1f} {smfu:<7s} {s.bound:<8s} "
                f"{s.floor_ms:<8.4f} {s.headroom_ms:.4f}"
            )
            if s.mfu_ceiling is not None:
                line += f" mfu_ceiling<={s.mfu_ceiling:.3f}"
            if s.note:
                line += " ABOVE ROOF (fewer operations than counted)"
            lines.append(line)
        for b in self.blocks:
            ceil = (
                f"{b.fused_mfu_ceiling:.3f}"
                if b.fused_mfu_ceiling is not None
                else "n/a"
            )
            lines.append(
                f"  fused {b.name} ({'+'.join(b.stages)}): floor "
                f"{b.fused_floor_ms:.4f} ms (staged floor "
                f"{b.staged_floor_ms:.4f} ms, deletes "
                f"{b.intermediate_bytes} intermediate bytes) "
                f"mfu_ceiling<={ceil}"
            )
        if self.fused_pass_mfu_ceiling is not None:
            lines.append(
                f"  fused pass mfu ceiling <= {self.fused_pass_mfu_ceiling:.4f}"
            )
        return "\n".join(lines)


def model_stage_split(
    total_ms: float, entries: List[StageCost], peak_tflops: float, bw_gbps: float
) -> Dict[str, float]:
    """Distribute a measured whole-pass time across stages proportionally
    to each stage's roofline floor: the model-backed attribution for a
    row without a measured breakdown. Sums to ``total_ms``."""
    floors = {
        e.name: _floor_ms(e.flops, e.staged_bytes, peak_tflops, bw_gbps)
        for e in entries
    }
    floor_sum = sum(floors.values())
    if floor_sum <= 0:
        even = total_ms / max(1, len(entries))
        return {e.name: even for e in entries}
    return {n: total_ms * f / floor_sum for n, f in floors.items()}


def attribute_roofline(
    stages_ms: Dict[str, float],
    *,
    dtype: str,
    batch: int,
    device_kind: str = "",
    cfg=None,
    source: str = "breakdown",
    total_ms: Optional[float] = None,
    peak_override: Optional[float] = None,
    hbm_override: Optional[float] = None,
    pass_img_s: Optional[float] = None,
    label: str = "",
) -> RooflineReport:
    """Join measured (or model-split) per-stage ms with the analytic
    ledger and the device spec into the ranked verdict table.

    ``peak_override``/``hbm_override`` replace the spec table's roofs
    (and its ``BENCH_PEAK_*`` overrides); otherwise the spec of
    ``device_kind`` for ``dtype`` decides. ``pass_img_s`` computes the
    whole-pass MFU as the bench does (img/s x matmul FLOPs per image /
    peak)."""
    spec, assumed = spec_for(device_kind)
    peak = (
        float(peak_override)
        if peak_override
        else _spec_peak(device_kind, dtype=dtype)
    )
    bw = float(hbm_override) if hbm_override else _spec_hbm(device_kind)
    entries = pass_ledger(cfg, dtype=dtype, batch=batch)
    by_name = {e.name: e for e in entries}
    ridge = (peak * 1e12) / (bw * 1e9) if bw else 0.0
    blocks = fused_blocks(entries, peak, bw)
    by_block = {b.name: b for b in blocks}
    known = {n: float(ms) for n, ms in stages_ms.items() if n in by_name}
    granularity = "stage"
    if not known:
        # A fuse="block" breakdown speaks block vocabulary (block1/block2):
        # join it against the fused BlockModels (their bytes and floors),
        # never fake per-stage rows the fused pass did not measure.
        known = {n: float(ms) for n, ms in stages_ms.items() if n in by_block}
        if not known:
            raise ValueError(
                f"no ledger stage or fused block matches the breakdown "
                f"stages {sorted(stages_ms)!r} (ledger: {sorted(by_name)!r},"
                f" blocks: {sorted(by_block)!r})"
            )
        granularity = "block"
    total = float(total_ms) if total_ms else sum(known.values())
    rows: List[StageRoofline] = []
    for name, ms in known.items():
        if granularity == "block":
            b = by_block[name]
            flops, matmul = b.flops, b.matmul_flops
            nbytes, floor = b.fused_bytes, b.fused_floor_ms
            intensity = flops / nbytes if nbytes else 0.0
            ceiling = b.fused_mfu_ceiling
        else:
            e = by_name[name]
            flops, matmul = e.flops, e.matmul_flops
            nbytes, intensity = e.staged_bytes, e.intensity
            floor = _floor_ms(e.flops, e.staged_bytes, peak, bw)
            ceiling = None
        note = ABOVE_ROOF_NOTE if 0 < ms < floor else ""
        secs = ms / 1e3
        achieved_f = flops / secs / 1e12 if ms > 0 else 0.0
        achieved_b = nbytes / secs / 1e9 if ms > 0 else 0.0
        # A clamped-to-zero stage (noise-negative prefix diff) still gets
        # a 0.0 MFU when the peak is known: "measured nothing" and
        # "utilized nothing" render the same, and None stays reserved for
        # "no peak to judge against".
        if peak:
            mfu: Optional[float] = (
                matmul / (secs * peak * 1e12) if ms > 0 else 0.0
            )
        else:
            mfu = None
        rows.append(
            StageRoofline(
                name=name,
                ms=ms,
                share=ms / total if total > 0 else 0.0,
                flops=flops,
                matmul_flops=matmul,
                bytes=nbytes,
                intensity=intensity,
                achieved_tflops=achieved_f,
                achieved_gbps=achieved_b,
                mfu=mfu,
                bound="compute" if intensity >= ridge else "memory",
                floor_ms=floor,
                headroom_ms=ms - floor,
                headroom_x=ms / floor if floor > 0 else None,
                mfu_ceiling=ceiling,
                note=note,
            )
        )
    # Ranked by headroom: the ms the binding roof says are reclaimable —
    # the optimization target list, biggest opportunity first.
    rows.sort(key=lambda s: s.headroom_ms, reverse=True)
    matmul_total = sum(e.matmul_flops for e in entries)
    if pass_img_s and peak:
        per_image_matmul = matmul_total / max(1, batch)
        pass_mfu: Optional[float] = pass_img_s * per_image_matmul / (peak * 1e12)
    elif total > 0 and peak:
        pass_mfu = matmul_total / (total / 1e3 * peak * 1e12)
    else:
        pass_mfu = None
    fused_total_floor = sum(b.fused_floor_ms for b in blocks)
    fused_pass_ceiling = (
        matmul_total / (fused_total_floor / 1e3 * peak * 1e12)
        if blocks and fused_total_floor > 0 and peak
        else None
    )
    return RooflineReport(
        dtype=dtype,
        batch=batch,
        device=spec.name,
        device_kind=device_kind or "",
        spec_assumed=assumed,
        peak_tflops=peak,
        hbm_gbps=bw,
        ridge_intensity=ridge,
        source=source,
        total_ms=total,
        pass_mfu=pass_mfu,
        stages=rows,
        blocks=blocks,
        fused_pass_mfu_ceiling=fused_pass_ceiling,
        label=label,
        granularity=granularity,
    )


# ---------------------------------------------------------- bench rows ---


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) and v > 0 else None


def _view(src: dict, obj: dict) -> Optional[dict]:
    """One dtype view of a bench row: the fields roofline needs, from the
    sub-object first and the row second (the ``bf16`` sub-object inherits
    batch, peak and device from its row)."""
    img_s = _num(src.get("value"))
    if img_s is None:
        return None

    def pick(key):
        for d in (src, obj):
            v = d.get(key)
            if v is not None:
                return v
        return None

    dtype = src.get("dtype") or src.get("compute") or pick("compute") or "fp32"
    batch = pick("batch") or 1
    per_pass = _num(src.get("per_pass_ms")) or (batch / img_s * 1e3)
    bd = src.get("breakdown") if isinstance(src.get("breakdown"), dict) else None
    return {
        "label": f"{dtype}@b{int(batch)}",
        "dtype": str(dtype),
        "img_s": img_s,
        "batch": int(batch),
        "per_pass_ms": per_pass,
        "peak": _num(pick("assumed_peak_tflops")),
        "device_kind": str(pick("device_kind") or ""),
        "breakdown": bd,
    }


def row_views(obj: dict) -> List[dict]:
    """The measured dtype views of a bench row: the row and its ``bf16``
    sub-object. A row that measured nothing (an error row) has none: the
    port's rows carry no earlier measurement (the JAX package's
    ``last_good``), so there is nothing stale to attribute."""
    if not _num(obj.get("value")):
        return []
    views = [_view(src, obj) for src in (obj, obj.get("bf16")) if isinstance(src, dict)]
    return [v for v in views if v is not None]


def roofline_from_bench_row(obj: dict, cfg=None) -> List[RooflineReport]:
    """Every dtype view of one bench row, attributed. Views with a
    measured ``breakdown`` join it (``source="breakdown"``); views
    without one model-split their ``per_pass_ms`` (``source="model"``).
    The view's ``assumed_peak_tflops`` (the bf16 tensor-core peak the
    row's ``mfu`` is taken against) governs, so a row reproduces its own
    ``mfu`` from its own fields."""
    reports: List[RooflineReport] = []
    for v in row_views(obj):
        bd = v["breakdown"]
        stages = bd.get("stages") if isinstance(bd, dict) else None
        if isinstance(stages, dict) and stages:
            stages_ms = {n: float(ms) for n, ms in stages.items()}
            source = "breakdown"
            total = _num(bd.get("total_ms")) or sum(stages_ms.values())
        else:
            entries = pass_ledger(cfg, dtype=v["dtype"], batch=v["batch"])
            peak = v["peak"] or _spec_peak(v["device_kind"], dtype=v["dtype"])
            stages_ms = model_stage_split(
                v["per_pass_ms"], entries, peak, _spec_hbm(v["device_kind"])
            )
            source = "model"
            total = v["per_pass_ms"]
        reports.append(
            attribute_roofline(
                stages_ms,
                dtype=v["dtype"],
                batch=v["batch"],
                device_kind=v["device_kind"],
                cfg=cfg,
                source=source,
                total_ms=total,
                peak_override=v["peak"],
                pass_img_s=v["img_s"],
                label=v["label"],
            )
        )
    return reports
