"""Static shard planner: exact per-shard output-row ownership.

The JAX package's ``parallel/plan.py``, over the port's own model specs.
The original course code shards image rows across ranks, computes each
layer on a halo-padded tile and trims rows with heuristics that over-remove
at four ranks. This planner gives every shard exactly the output rows it
owns, layer by layer, so nothing is trimmed:

- every layer's rows are split into blocks of ``ceil(L/n)`` rows a shard
  (equal block shapes); shard ``i`` owns global output rows
  ``[i*B_out, min((i+1)*B_out, L_out))``, and rows past the end are dead
  and kept zero (the mask invariant);
- for a conv or pool with (F, S, P), shard ``i``'s owned output rows need
  global input rows ``[i*B_out*S - P, (end_own-1)*S - P + F)``; the planner
  turns that into static top and bottom halo widths (the max over shards)
  and a window start affine in the shard index,
  ``s0(i) = i*(B_out*S - B_in) + (h_top - P)``;
- halos come from neighbours (several hops where a halo is wider than one
  block); the edge shards receive zeros, which is the conv's zero padding
  (shard 0's ``h_top`` includes ``P`` by construction).

Every quantity is a Python int.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from ..models.alexnet import ConvSpec, LrnSpec, PoolSpec
from ..ops.shapes import conv_out_dim, pool_out_dim


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Static halo and window geometry of one spatial layer on an n-shard mesh."""

    name: str
    kind: str  # "conv" | "pool" | "pointwise"
    filter_size: int
    stride: int
    padding: int  # H padding, supplied by the halos; W padding stays inside the op
    l_in: int  # global input rows
    l_out: int  # global output rows
    b_in: int  # input block rows a shard
    b_out: int  # output block rows a shard
    h_top: int  # static top halo rows
    h_bot: int  # static bottom halo rows
    s0_coef: int  # window start = i*s0_coef + s0_const (local, in the padded buffer)
    s0_const: int
    win_rows: int  # rows of the padded buffer a window reads: (b_out-1)*stride + filter_size
    pad_bot: int  # zero rows appended so the uniform window always fits

    @property
    def padded_rows(self) -> int:
        return self.h_top + self.b_in + self.h_bot + self.pad_bot


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    n_shards: int
    layers: Tuple[LayerPlan, ...]

    @property
    def b_final(self) -> int:
        return self.layers[-1].b_out

    @property
    def l_final(self) -> int:
        return self.layers[-1].l_out


def _plan_spatial_layer(name: str, kind: str, l_in: int, n: int, f: int, s: int, p: int) -> LayerPlan:
    l_out = conv_out_dim(l_in, f, p, s) if kind == "conv" else pool_out_dim(l_in, f, s)
    if l_out <= 0:
        raise ValueError(f"layer {name}: degenerate output length {l_out} (l_in={l_in}, f={f}, s={s}, p={p})")
    b_in = math.ceil(l_in / n)
    b_out = math.ceil(l_out / n)

    h_top = h_bot = 0
    for i in range(n):
        own_start, own_end = i * b_out, min((i + 1) * b_out, l_out)
        if own_start >= own_end:
            continue  # owns nothing at this layer; stays masked zero
        need_start = own_start * s - p
        need_end = (own_end - 1) * s - p + f  # exclusive
        h_top = max(h_top, i * b_in - need_start)
        h_bot = max(h_bot, need_end - (i + 1) * b_in)
    h_top, h_bot = max(h_top, 0), max(h_bot, 0)

    # Window start inside [h_top rows | block | h_bot rows | pad_bot zeros]:
    # s0(i) = need_start(i) - (i*b_in - h_top) = i*(b_out*s - b_in) + h_top - p
    s0_coef = b_out * s - b_in
    s0_const = h_top - p
    # Every shard reads a full b_out window, also one that owns fewer (or no)
    # output rows; rows past the halo only feed masked outputs, so zero rows
    # at the bottom suffice (and move nothing between shards).
    win_rows = (b_out - 1) * s + f
    pad_bot = 0
    for i in range(n):
        s0 = max(0, i * s0_coef + s0_const)
        pad_bot = max(pad_bot, s0 + win_rows - (h_top + b_in + h_bot))
    for i in range(n):
        s0 = i * s0_coef + s0_const
        if min((i + 1) * b_out, l_out) <= i * b_out:
            continue  # owns nothing: its window start is clamped, its outputs masked
        if s0 < 0 or s0 + win_rows > h_top + b_in + h_bot + pad_bot:
            raise ValueError(
                f"layer {name}: window [{s0}, {s0 + win_rows}) escapes padded buffer "
                f"rows {h_top + b_in + h_bot + pad_bot} for shard {i}"
            )
    return LayerPlan(name, kind, f, s, p, l_in, l_out, b_in, b_out, h_top, h_bot, s0_coef, s0_const, win_rows,
                     pad_bot)


def make_shard_plan(cfg, n_shards: int) -> ShardPlan:
    """Plan every spatial layer of ``cfg``'s chain (Blocks 1-2, or full
    AlexNet's conv1..pool5) for an ``n_shards`` row mesh."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    layers: List[LayerPlan] = []
    l_cur = cfg.in_height
    for name, spec in cfg.layer_chain():
        if isinstance(spec, ConvSpec):
            lp = _plan_spatial_layer(name, "conv", l_cur, n_shards, spec.filter_size, spec.stride, spec.padding)
        elif isinstance(spec, PoolSpec):
            lp = _plan_spatial_layer(name, "pool", l_cur, n_shards, spec.window, spec.stride, 0)
        elif isinstance(spec, LrnSpec):
            prev_out = layers[-1].l_out if layers else l_cur
            b = math.ceil(prev_out / n_shards)
            lp = LayerPlan(name, "pointwise", 1, 1, 0, prev_out, prev_out, b, b, 0, 0, 0, 0, b, 0)
        else:
            raise TypeError(f"unknown layer spec {spec!r}")
        layers.append(lp)
        l_cur = lp.l_out
    return ShardPlan(n_shards=n_shards, layers=tuple(layers))


def owned_range(b_out: int, l_out: int, i: int) -> Tuple[int, int]:
    """Global output rows shard ``i`` owns (the course code's mapRangeStart/End)."""
    return i * b_out, min((i + 1) * b_out, l_out)
