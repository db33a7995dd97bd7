"""Static per-layer comm/compute breakdown of the sharded configs.

The JAX package's ``parallel/breakdown.py``. The original course code
planned a per-phase comm/compute breakdown and never built it; here it
follows from the static shard plan (``plan.py``): halo widths are Python
ints, so per-layer bytes, collective counts, FLOPs and arithmetic intensity
are exact, with no profiler. The collectives a forward runs are counted
at run time (``halo.COLLECTIVES``), and the tests hold that count to
:func:`expected_collectives` and :func:`expected_tp_collectives`, so the
table cannot drift from what runs.

FLOP conventions:
- conv: 2 * F^2 * C_in * K per output element (multiply and add);
- pool: window^2 compares per output element (one "flop" each);
- lrn: (2*size + 4) per element: size squares and adds for the window sum,
  plus the square, scale, pow and divide.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from ..models.alexnet import ConvSpec, LrnSpec, PoolSpec
from ..ops.shapes import conv_out_dim, pool_out_dim
from .plan import make_shard_plan


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Static per-shard cost of one layer on an n-shard row mesh."""

    name: str
    kind: str           # conv | pool | pointwise
    h_top: int          # halo rows pulled from above
    h_bot: int          # halo rows pulled from below
    collectives: int    # ppermutes (or all_gathers when staged) this layer emits
    halo_bytes: int     # bytes this shard RECEIVES for the exchange (per pass)
    flops: int          # per-shard compute (convention in module docstring)
    out_shape: Tuple[int, int, int]  # per-shard (b_out, W_out, C_out)

    @property
    def intensity(self) -> float:
        """Arithmetic intensity against communicated bytes: FLOPs per halo
        byte (inf for layers that communicate nothing)."""
        return self.flops / self.halo_bytes if self.halo_bytes else float("inf")


def comm_compute_breakdown(
    cfg,
    n_shards: int,
    batch: int = 1,
    dtype_bytes: int = 4,
    staged: bool = False,
) -> List[LayerCost]:
    """Per-layer static costs for the halo/staged_halo strategies.

    ``staged`` mirrors ``halo_exchange_gathered`` (the V4 host-staging
    analogue): one all_gather moving every shard's full block instead of
    multi-hop ppermutes moving only the halo rows — the per-layer byte
    ratio IS the V4-vs-V5 pedagogy, now stated statically.
    """
    plan = make_shard_plan(cfg, n_shards)
    rows: List[LayerCost] = []
    w_cur, c_cur = cfg.in_width, cfg.in_channels
    for (name, spec), lp in zip(cfg.layer_chain(), plan.layers):
        if isinstance(spec, ConvSpec):
            w_out = conv_out_dim(w_cur, spec.filter_size, spec.padding, spec.stride)
            c_out = spec.out_channels
            flops = 2 * spec.filter_size**2 * c_cur * c_out * lp.b_out * w_out
        elif isinstance(spec, PoolSpec):
            w_out = pool_out_dim(w_cur, spec.window, spec.stride)
            c_out = c_cur
            flops = spec.window**2 * lp.b_out * w_out * c_out
        elif isinstance(spec, LrnSpec):
            w_out, c_out = w_cur, c_cur
            flops = (2 * spec.size + 4) * lp.b_out * w_out * c_out
        else:  # pragma: no cover - layer_chain only yields the three kinds
            raise TypeError(f"unknown layer spec {spec!r}")
        needs_halo = (lp.h_top + lp.h_bot) > 0
        if staged:
            collectives = 1 if needs_halo else 0
            # Rows RECEIVED from remote shards: the all_gather delivers the
            # other (n-1) blocks; the shard's own block is local. Counting
            # n*b_in would inflate the V4-vs-V5 ratio by n/(n-1) against
            # the ppermute side's received-rows accounting.
            moved_rows = (n_shards - 1) * lp.b_in if needs_halo else 0
        else:
            collectives = math.ceil(lp.h_top / lp.b_in) + math.ceil(lp.h_bot / lp.b_in)
            moved_rows = lp.h_top + lp.h_bot
        rows.append(
            LayerCost(
                name=name,
                kind=lp.kind,
                h_top=lp.h_top,
                h_bot=lp.h_bot,
                collectives=collectives,
                halo_bytes=batch * moved_rows * w_cur * c_cur * dtype_bytes,
                flops=batch * flops,
                out_shape=(lp.b_out, w_out, c_out),
            )
        )
        w_cur, c_cur = w_out, c_out
    return rows


def tp_comm_compute_breakdown(
    cfg,
    n_shards: int,
    batch: int = 1,
    dtype_bytes: int = 4,
) -> List[LayerCost]:
    """Per-layer static costs for the ``tp`` (conv filter-decomposition)
    strategy — the dual of the row plan above, with the "halo" rotated onto
    the channel axis (parallel/tensor_parallel.py). Exact for the same
    reason: every width below is a Python int.

    Comm events per pass (n > 1):
    - conv2's row carries the ONE boundary ``all_gather`` (conv2 consumes
      every conv1 channel; each shard receives the other n-1 channel
      blocks of pool1's output).
    - lrn2's row carries the channel-halo ``ppermute`` pair (``size//2``
      neighbor channels from each side).
    ``h_top``/``h_bot`` hold neighbor CHANNELS here, not rows.
    """
    if cfg.conv1.out_channels % n_shards or cfg.conv2.out_channels % n_shards:
        raise ValueError(
            f"conv K axes ({cfg.conv1.out_channels}, {cfg.conv2.out_channels}) "
            f"not divisible by {n_shards} tp shards"
        )
    half = cfg.lrn2.size // 2
    k1l = cfg.conv1.out_channels // n_shards  # local conv1 filters
    k2l = cfg.conv2.out_channels // n_shards  # local conv2 filters
    h1 = conv_out_dim(cfg.in_height, cfg.conv1.filter_size, cfg.conv1.padding, cfg.conv1.stride)
    w1 = conv_out_dim(cfg.in_width, cfg.conv1.filter_size, cfg.conv1.padding, cfg.conv1.stride)
    hp1 = pool_out_dim(h1, cfg.pool1.window, cfg.pool1.stride)
    wp1 = pool_out_dim(w1, cfg.pool1.window, cfg.pool1.stride)
    h2 = conv_out_dim(hp1, cfg.conv2.filter_size, cfg.conv2.padding, cfg.conv2.stride)
    w2 = conv_out_dim(wp1, cfg.conv2.filter_size, cfg.conv2.padding, cfg.conv2.stride)
    hp2 = pool_out_dim(h2, cfg.pool2.window, cfg.pool2.stride)
    wp2 = pool_out_dim(w2, cfg.pool2.window, cfg.pool2.stride)
    # The lrn normalizes over the halo-extended slice, then crops.
    lrn_c = k2l + 2 * half if n_shards > 1 else k2l
    rows = [
        LayerCost(
            name="conv1", kind="conv", h_top=0, h_bot=0, collectives=0, halo_bytes=0,
            flops=batch * 2 * cfg.conv1.filter_size**2 * cfg.in_channels * k1l * h1 * w1,
            out_shape=(h1, w1, k1l),
        ),
        LayerCost(
            name="pool1", kind="pool", h_top=0, h_bot=0, collectives=0, halo_bytes=0,
            flops=batch * cfg.pool1.window**2 * hp1 * wp1 * k1l,
            out_shape=(hp1, wp1, k1l),
        ),
        LayerCost(
            # The boundary gather is attributed to conv2 — it exists because
            # conv2 contracts over ALL conv1 channels. The gather runs at
            # every n (at n=1 it moves 0 remote bytes), as tensor_parallel.py
            # counts it.
            name="conv2", kind="conv", h_top=0, h_bot=0, collectives=1,
            halo_bytes=batch * hp1 * wp1 * (cfg.conv1.out_channels - k1l) * dtype_bytes,
            flops=batch * 2 * cfg.conv2.filter_size**2 * cfg.conv1.out_channels * k2l * h2 * w2,
            out_shape=(h2, w2, k2l),
        ),
        LayerCost(
            name="pool2", kind="pool", h_top=0, h_bot=0, collectives=0, halo_bytes=0,
            flops=batch * cfg.pool2.window**2 * hp2 * wp2 * k2l,
            out_shape=(hp2, wp2, k2l),
        ),
        LayerCost(
            name="lrn2", kind="pointwise", h_top=half if n_shards > 1 else 0,
            h_bot=half if n_shards > 1 else 0,
            collectives=2 if n_shards > 1 else 0,
            halo_bytes=(
                batch * hp2 * wp2 * 2 * half * dtype_bytes if n_shards > 1 else 0
            ),
            flops=batch * (2 * cfg.lrn2.size + 4) * hp2 * wp2 * lrn_c,
            out_shape=(hp2, wp2, k2l),
        ),
    ]
    return rows


def expected_tp_collectives(cfg, n_shards: int) -> dict:
    """Collective counts one tp forward runs, by the JAX primitive each
    stands for (``halo.COLLECTIVES`` after one forward)."""
    rows = tp_comm_compute_breakdown(cfg, n_shards)
    return {
        "all_gather": sum(r.collectives for r in rows if r.kind == "conv"),
        "ppermute": sum(r.collectives for r in rows if r.kind == "pointwise"),
    }


def expected_collectives(cfg, n_shards: int, staged: bool = False) -> int:
    """Total halo collectives one sharded forward runs (the sum of
    ``halo.COLLECTIVES`` after one forward)."""
    return sum(r.collectives for r in comm_compute_breakdown(cfg, n_shards, staged=staged))


def format_table(
    rows: List[LayerCost], staged: bool = False, transport: str | None = None
) -> str:
    """Human table for run.py --breakdown (stdout contract: one line per
    layer prefixed 'Comm ' so the harness can regex it like timing lines).
    ``transport`` overrides the header label (the tp strategy's mixed
    all_gather + channel-halo ppermute plan)."""
    kind = transport or ("all_gather" if staged else "ppermute")
    out = [
        f"Per-layer comm/compute plan ({kind} transport):",
        f"{'layer':8s} {'halo(t/b)':>9s} {'coll':>4s} {'KiB/pass':>9s} "
        f"{'MFLOP':>8s} {'flop/byte':>9s}",
    ]
    for r in rows:
        inten = f"{r.intensity:9.1f}" if r.halo_bytes else "      inf"
        out.append(
            f"Comm {r.name:8s} {r.h_top:4d}/{r.h_bot:<4d} {r.collectives:4d} "
            f"{r.halo_bytes / 1024:9.1f} {r.flops / 1e6:8.1f} {inten}"
        )
    total_b = sum(r.halo_bytes for r in rows)
    total_f = sum(r.flops for r in rows)
    total_c = sum(r.collectives for r in rows)
    out.append(
        f"Comm TOTAL    {'':9s} {total_c:4d} {total_b / 1024:9.1f} "
        f"{total_f / 1e6:8.1f} {total_f / total_b if total_b else float('inf'):9.1f}"
    )
    return "\n".join(out)
