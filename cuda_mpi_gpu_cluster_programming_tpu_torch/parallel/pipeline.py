"""Pipeline parallelism: GPipe fill-and-drain over a ``pp`` mesh axis.

The JAX package's ``parallel/pipeline.py`` splits the decoder stack into S
stages, stage ``s``'s params on mesh slot ``s`` (``shard_map`` over "pp"),
and rotates microbatches stage to stage with ``lax.ppermute`` inside one
``lax.scan`` of M + S - 1 steps. Here one controller drives the schedule
over the mesh's "pp" slots: at step ``t`` stage ``s`` runs microbatch
``t - s`` on slot ``s`` over its L/S layers, and every stage's output is
handed to the next slot (one ``ppermute`` a step, counted in
``halo.COLLECTIVES``). The bubble steps (``t - s`` before the first or
past the last microbatch) compute nothing: the JAX schedule computes them
and never collects their outputs, and on slots that share one stream they
would be pure waste. Autograd runs through the whole schedule (the hand-offs
are ``.to()`` copies), so the same code trains.

``dp_axis`` composes the pipeline with data parallelism on a ``(dp, pp)``
mesh: each dp row runs the full pipeline over its slice of every
microbatch (stage params on the row's slots), the hand-offs confined to
the row. Pipelining reorders scheduling, not arithmetic: each microbatch's
rows go through the same layers as in the sequential forward, so the
output is that forward's up to the matrix products' summation order at
fewer rows.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional

import torch

from ..utils.tree import tree_leaves, tree_map
from .halo import COLLECTIVES
from .mesh import Mesh, make_mesh

Params = Any


def stack_layers(layers: List[Params]) -> Params:
    """A list of per-layer trees -> one tree, each leaf stacked on a new
    leading axis (the axis ``pipeline_apply`` splits into stages)."""
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def _reshape_stages(stacked: Params, n_stages: int) -> Params:
    def r(x):
        n_layers = x.shape[0]
        if n_layers % n_stages:
            raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
        return x.reshape(n_stages, n_layers // n_stages, *x.shape[1:])

    return tree_map(r, stacked)


def pipeline_apply(
    layer_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    stacked_layers: Params,
    x: torch.Tensor,
    *,
    n_stages: int,
    n_microbatches: int,
    mesh: Optional[Mesh] = None,
    axis_name: str = "pp",
    dp_axis: Optional[str] = None,
) -> torch.Tensor:
    """``layer_fn(layer_params, x) -> x`` over every layer of
    ``stacked_layers`` (leaves ``(n_layers, ...)``) on ``x`` (B, ...), the
    layers split into ``n_stages`` stages over the mesh's ``axis_name``
    slots (default: a mesh of ``n_stages`` slots on x's device type) and B
    into ``n_microbatches``. Returns the (B, ...) output on x's device.

    ``dp_axis``: the name of the mesh's data-parallel axis (an explicit
    ``(dp, pp)`` mesh); each dp row pipelines its share of every
    microbatch's rows."""
    b = x.shape[0]
    m = n_microbatches
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    if mesh is None:
        if dp_axis is not None:
            raise ValueError(
                "dp_axis requires an explicit 2-D mesh containing that axis "
                "(the auto-built default mesh is pp-only)"
            )
        mesh = make_mesh(n_stages, axis_name=axis_name, device=x.device.type)
    dp = 1
    if dp_axis is not None:
        if dp_axis not in mesh.axis_names:
            raise ValueError(f"dp_axis {dp_axis!r} not in mesh axes {tuple(mesh.axis_names)}")
        dp = mesh.axis_size(dp_axis)
        if (b // m) % dp:
            raise ValueError(f"microbatch size {b // m} not divisible by dp axis {dp}")
    staged = _reshape_stages(stacked_layers, n_stages)
    rows = mesh.axis_groups(axis_name)[:dp]
    if any(len(row) != n_stages for row in rows):
        raise ValueError(f"mesh axis {axis_name!r} has {len(rows[0])} slots but n_stages={n_stages}")
    per_stage = tree_leaves(staged)[0].shape[1]
    # stage s's layers on slot s of each dp row, moved once a call
    stage_params = [[[tree_map(lambda a, s=s, i=i, dev=dev: a[s, i].to(dev, non_blocking=True), staged)
                      for i in range(per_stage)] for s, dev in enumerate(row)] for row in rows]
    mb = b // m
    # row r's share of microbatch j: rows [j*mb + r*mb/dp, j*mb + (r+1)*mb/dp) of x
    share = mb // dp
    feeds = [[x[j * mb + r * share:j * mb + (r + 1) * share] for j in range(m)] for r in range(dp)]
    outs: List[List[Optional[torch.Tensor]]] = [[None] * m for _ in range(dp)]
    held: List[List[Optional[torch.Tensor]]] = [[None] * n_stages for _ in range(dp)]  # each stage's input
    for t in range(m + n_stages - 1):
        produced: List[List[Optional[torch.Tensor]]] = [[None] * n_stages for _ in range(dp)]
        for r, row in enumerate(rows):
            for s, dev in enumerate(row):
                j = t - s
                if not 0 <= j < m:
                    continue  # a bubble: nothing to run
                h = feeds[r][j].to(dev, non_blocking=True) if s == 0 else held[r][s]
                for layer in stage_params[r][s]:
                    h = layer_fn(layer, h)
                produced[r][s] = h
                if s == n_stages - 1:
                    outs[r][j] = h
        if any(produced[r][s] is not None for r in range(dp) for s in range(n_stages - 1)):
            COLLECTIVES["ppermute"] += 1  # every stage's output one slot down the pipeline
            for r, row in enumerate(rows):
                held[r] = [None] + [None if produced[r][s] is None else produced[r][s].to(row[s + 1], non_blocking=True)
                                    for s in range(n_stages - 1)]
    return torch.cat([outs[r][j].to(x.device, non_blocking=True) for j in range(m) for r in range(dp)], dim=0)


def pipeline_lm_forward(
    params: Params,
    tokens: torch.Tensor,
    cfg,
    *,
    n_stages: int,
    n_microbatches: int,
    mesh: Optional[Mesh] = None,
    dp_axis: Optional[str] = None,
) -> torch.Tensor:
    """The transformer LM's forward with the decoder stack pipelined over
    "pp". The embedding, the final norm and the weight-tied head run on the
    tokens' device (a small share of the work, as in the JAX package); the
    decoder blocks are staged. A MoE block routes each microbatch alone (its
    capacity from the microbatch's tokens) and its aux loss is not
    collected, as in the JAX package's pipeline."""
    from ..models.transformer import decoder_block, rmsnorm
    from ..ops.reference import true_fp32

    b, l = tokens.shape
    if l > cfg.max_len:
        raise ValueError(f"sequence length {l} exceeds max_len {cfg.max_len}")
    true_fp32(params["embed"].device)
    x = params["embed"][tokens.long()] + params["pos"][:l][None]
    stacked = stack_layers(params["layers"])
    x = pipeline_apply(functools.partial(decoder_block, cfg=cfg), stacked, x, n_stages=n_stages,
                       n_microbatches=n_microbatches, mesh=mesh, dp_axis=dp_axis)
    x = rmsnorm(x, params["final_norm"]["g"])
    return x @ params["embed"].T


def pipeline_lm_loss(
    params: Params,
    tokens: torch.Tensor,
    cfg,
    *,
    n_stages: int,
    n_microbatches: int,
    mesh: Optional[Mesh] = None,
    dp_axis: Optional[str] = None,
) -> torch.Tensor:
    """Next-token cross-entropy (fp32) through the pipelined forward."""
    logits = pipeline_lm_forward(params, tokens[:, :-1], cfg, n_stages=n_stages, n_microbatches=n_microbatches,
                                 mesh=mesh, dp_axis=dp_axis).float()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, tokens[:, 1:].long()[..., None])[..., 0]
    return -torch.mean(ll)
