"""Perf-regression gate over a trajectory of bench rounds.

The JAX package's ``observability/gate.py``: :func:`evaluate` classifies
a list of bench row files (one round each, in path-name order) and returns
a :class:`GateVerdict` (machine-readable ``to_obj``, human ``render``);
``BENCH_MODE=gate`` exits 3 on any regression, so a performance claim
fails a check instead of being eyeballed. Two disciplines beside the plain
diff:

- **Echo exclusion.** A round whose only value is a ``last_good`` carry
  identical to a value an earlier round already reported, with the
  provenance marker (``value_last_good`` / ``last_good.stale``), is
  classified ``stale (echo of rNN)`` and left out of every comparison. A
  ``last_good`` number seen for the first time is kept as measured once.
- **Per-stage verdicts.** Rounds with a ``breakdown`` sub-object are diffed
  stage by stage, between rounds of one granularity (staged rows against
  staged rows, fused ``block`` rows against fused ones).

The gate reads only the paths it is given. The ``BENCH_r*.json`` files at
the repository root are the JAX package's TPU rounds: no TPU number enters
a verdict on the port, so with no paths the verdict is over zero rounds.
Standard library only.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# The regression bar: a headline drop or per-stage rise past this
# fraction between compared rounds fails the gate.
THRESHOLD = 0.10


# ------------------------------------------------------------ row parsing ---


def _bench_obj(path: Path) -> Optional[dict]:
    """One round file's measured row: a wrapped row ({"parsed": {...},
    "tail": ...}), a bare row object, or raw JSONL (its first parseable
    line)."""
    try:
        text = path.read_text()
    except OSError:
        return None
    try:
        obj = json.loads(text)
    except ValueError:
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    obj = json.loads(line)
                    break
                except ValueError:
                    continue
        else:
            return None
    if isinstance(obj, dict) and isinstance(obj.get("parsed"), dict):
        obj = obj["parsed"]
    return obj if isinstance(obj, dict) else None


def _stale_value(row: dict) -> Tuple[Optional[float], bool]:
    """(the row's last_good carry value, whether it wears the staleness
    provenance marker). The marker is what separates 'a wedged round
    echoing old evidence' from 'two rounds that legitimately measured
    the same number' — only marked rows can ever be echoes."""
    lg = row.get("last_good")
    lg = lg if isinstance(lg, dict) else {}
    marker = bool(lg.get("stale")) or "value_last_good" in row
    for v in (row.get("value_last_good"), lg.get("value"), lg.get("stale_value")):
        if isinstance(v, (int, float)) and v > 0:
            return float(v), marker
    return None, marker


@dataclasses.dataclass
class RoundRow:
    """One round's classified evidence."""

    name: str
    row: dict
    value: Optional[float]  # measurable throughput (img/s) or None
    provenance: str  # fresh | last_good(stale) | stale (echo of rNN) | error | none
    echo_of: str = ""  # origin round name when provenance is an echo
    per_pass_ms: Optional[float] = None
    stages: Optional[Dict[str, float]] = None
    # "stage" (sentinel-boundary rows) vs "block" (fuse="block" megakernel
    # rows, block1/block2 vocabulary). Stage diffs only ever compare rows
    # of the SAME granularity: a fused block1 time against a staged conv1
    # time is not a regression signal, it's a vocabulary collision.
    granularity: str = "stage"
    error: str = ""

    @property
    def is_echo(self) -> bool:
        return bool(self.echo_of)

    @property
    def measured(self) -> bool:
        """Participates in comparisons: carries a value that was measured
        (fresh, or a first-appearance last_good carry) — echoes and
        error-only rounds do not."""
        return self.value is not None and not self.is_echo

    def to_obj(self) -> dict:
        return {
            "name": self.name,
            "value": self.value,
            "provenance": self.provenance,
            "echo_of": self.echo_of or None,
            "per_pass_ms": self.per_pass_ms,
            "stages": self.stages,
            "granularity": self.granularity,
            "error": self.error or None,
        }


def load_rounds(paths) -> List[RoundRow]:
    """Parse + classify a trajectory (sorted by path name, the round
    order). Echo detection is cross-round by construction: a marked
    ``last_good`` value equal to ANY value an earlier round reported
    (measured or itself a first-appearance carry) is the echo of that
    round."""
    rows: List[RoundRow] = []
    seen_values: Dict[float, str] = {}  # value -> first round reporting it
    for p in sorted(Path(str(p)) for p in paths):
        obj = _bench_obj(p)
        if obj is None:
            continue
        v = obj.get("value")
        per_pass = obj.get("per_pass_ms")
        bd = obj.get("breakdown")
        stages = bd.get("stages") if isinstance(bd, dict) else None
        stages = (
            {
                s: float(ms)
                for s, ms in stages.items()
                if isinstance(ms, (int, float))
            }
            if isinstance(stages, dict) and stages
            else None
        )
        rr = RoundRow(
            name=p.name,
            row=obj,
            value=None,
            provenance="none",
            per_pass_ms=float(per_pass) if isinstance(per_pass, (int, float)) else None,
            stages=stages,
            granularity=(
                str(bd.get("granularity") or "stage")
                if isinstance(bd, dict)
                else "stage"
            ),
            error=str(obj.get("error") or ""),
        )
        if isinstance(v, (int, float)) and v > 0:
            rr.value, rr.provenance = float(v), "fresh"
            seen_values.setdefault(rr.value, rr.name)
        else:
            carry, marked = _stale_value(obj)
            if carry is not None:
                rr.value = carry
                if marked and carry in seen_values:
                    rr.echo_of = seen_values[carry]
                    rr.provenance = f"stale (echo of {rr.echo_of})"
                else:
                    rr.provenance = "last_good(stale)"
                    seen_values.setdefault(carry, rr.name)
            else:
                rr.provenance = "error" if rr.error else "none"
        rows.append(rr)
    return rows


# ---------------------------------------------------------------- verdict ---


@dataclasses.dataclass
class Regression:
    """One >threshold finding between two compared rounds."""

    kind: str  # "headline" | "stage"
    frm: str  # earlier round name
    to: str  # later round name
    prev: float
    cur: float
    pct: float  # signed change percent (negative = slower/worse headline)
    stage: str = ""
    provenance: str = ""  # the later round's value provenance

    def to_obj(self) -> dict:
        return dataclasses.asdict(self)

    def line(self) -> str:
        if self.kind == "stage":
            return (
                f"  REGRESSION {self.to} stage {self.stage}: "
                f"{self.prev:.3f} -> {self.cur:.3f} ms "
                f"(+{self.pct:.0f}% vs {self.frm})"
            )
        return (
            f"  REGRESSION {self.to}: {self.prev:.1f} -> {self.cur:.1f} img/s "
            f"(-{self.pct:.0f}% vs {self.frm})"
        )


@dataclasses.dataclass
class GateVerdict:
    """The gate's full structured output (``ok`` is the exit-code bit)."""

    rows: List[RoundRow]
    regressions: List[Regression]
    threshold: float = THRESHOLD
    compared: int = 0  # headline round-pairs actually diffed

    @property
    def ok(self) -> bool:
        return not self.regressions

    @property
    def echoes(self) -> List[RoundRow]:
        return [r for r in self.rows if r.is_echo]

    def to_obj(self) -> dict:
        return {
            "ok": self.ok,
            "threshold": self.threshold,
            "compared": self.compared,
            "rounds": [r.to_obj() for r in self.rows],
            "regressions": [r.to_obj() for r in self.regressions],
            "echoes": [r.name for r in self.echoes],
        }

    def render(self) -> str:
        """The human report (header, per-round lines, ``flags:`` section),
        with echo rounds labeled instead of diffed."""
        if not self.rows:
            return "bench report: no parseable BENCH rows"
        lines = ["bench trajectory:"]
        for r in self.rows:
            bits = [
                f"  {r.name}:",
                f"value={r.value:.1f} img/s" if r.value is not None else "value=unmeasured",
                f"({r.provenance})",
            ]
            if r.per_pass_ms is not None:
                bits.append(f"per_pass={r.per_pass_ms:.3f} ms")
            if r.error:
                bits.append(f"error={r.error[:60]!r}")
            if r.stages:
                worst = max(r.stages, key=lambda s: r.stages[s])
                gran = "" if r.granularity == "stage" else f" {r.granularity}-granularity"
                bits.append(
                    f"breakdown[{len(r.stages)} stages, top {worst}="
                    f"{r.stages[worst]:.3f} ms{gran}]"
                )
            lines.append(" ".join(bits))
        if self.regressions:
            lines.append("flags:")
            lines.extend(r.line() for r in self.regressions)
        else:
            lines.append(
                "flags: none (no >10% regression between measured rounds)"
            )
        return "\n".join(lines)


def evaluate(paths, threshold: float = THRESHOLD) -> GateVerdict:
    """Classify a trajectory and diff consecutive MEASURED rounds.

    Headline: a later measured value below ``(1 - threshold)`` × the
    previous measured value is a regression. Stages: between consecutive
    breakdown-carrying measured rounds OF THE SAME GRANULARITY, any stage
    above ``(1 + threshold)`` × its predecessor is a regression (a staged
    round and a ``fuse="block"`` round are distinct variants whose
    per-stage chains diff independently: a fused block1 row never diffs
    against a staged conv1 row). Echo rounds are excluded from every
    chain and reported in the verdict."""
    rows = load_rounds(paths)
    regressions: List[Regression] = []
    compared = 0
    prev: Optional[RoundRow] = None
    prev_stages_by_gran: Dict[str, Tuple[str, Dict[str, float]]] = {}
    for r in rows:
        if r.is_echo:
            continue
        if r.stages and not r.is_echo:
            prev_stages = prev_stages_by_gran.get(r.granularity)
            if prev_stages is not None:
                frm_name, p_stages = prev_stages
                for s, ms in r.stages.items():
                    p_ms = p_stages.get(s)
                    if (
                        isinstance(p_ms, (int, float))
                        and p_ms > 0
                        and ms > p_ms * (1.0 + threshold)
                    ):
                        regressions.append(
                            Regression(
                                kind="stage", frm=frm_name, to=r.name,
                                prev=p_ms, cur=ms,
                                pct=(ms / p_ms - 1) * 100, stage=s,
                                provenance=r.provenance,
                            )
                        )
            prev_stages_by_gran[r.granularity] = (r.name, r.stages)
        if not r.measured:
            continue
        if prev is not None:
            compared += 1
            if r.value < prev.value * (1.0 - threshold):
                regressions.append(
                    Regression(
                        kind="headline", frm=prev.name, to=r.name,
                        prev=prev.value, cur=r.value,
                        pct=(1 - r.value / prev.value) * 100,
                        provenance=r.provenance,
                    )
                )
        prev = r
    return GateVerdict(
        rows=rows, regressions=regressions, threshold=threshold,
        compared=compared,
    )
