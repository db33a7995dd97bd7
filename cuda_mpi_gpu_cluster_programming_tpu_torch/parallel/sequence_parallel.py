"""Long-context sequence parallelism: ring attention and Ulysses all-to-all.

The JAX package's ``parallel/sequence_parallel.py`` as one controller over
the mesh's shard slots. There a ``shard_map`` body runs on every device;
here each slot's ``(B, L/n, H, D)`` block is a tensor on its slot's device
and the controller drives the slots in turn, so a slot's index ``me`` and
a hop ``t`` are Python ints:

- :func:`ring_attention`: blockwise attention with online-softmax
  accumulation. The K/V blocks circulate the ring, one hop forward a step
  (two ``ppermute`` operations a hop, n hops, the last one restoring ownership),
  while every slot keeps only ``L/n`` of the sequence resident. The
  ``einsum`` engine materialises each hop's (Lb, Lb) scores in fp32; the
  ``flash`` engine runs the flash kernel on the resident block and merges
  the normalised partials through their per-row LSEs. Causal hops split
  three ways on the block's global position: ``src < me`` full attention,
  ``src == me`` in-block causal, ``src > me`` skipped (it launches
  nothing: its weight in the merge is exactly 0).
- :func:`ulysses_attention`: reshard from sequence-sharded to head-sharded
  (``all_to_all``: q, k and v), exact attention over the full sequence for
  the slot's H/n heads, reshard back (a fourth ``all_to_all``).

``head_axis`` composes either with a second mesh axis that splits the
heads (sp x tp): heads are independent in attention, so each head group
runs its own ring (or all-to-all) over its column of slots.

Gradients go through plain autograd: the slot copies, the merge
arithmetic and the flash kernels' joint ``(out, lse)`` VJP
(``ops.flash_attention``). On one card every slot shares the device, a
"move" is a no-op ``.to()`` (counted all the same in
``halo.COLLECTIVES``), and the slots run in order on one stream.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from ..ops.attention import NEG_INF
from .halo import COLLECTIVES
from .mesh import Mesh, make_mesh

Blocks = List[List[torch.Tensor]]  # [head group][slot] -> that slot's block


def _block_scores(q, k, scale):
    """(B, Lq, H, D) x (B, Lk, H, D) -> fp32 scores (B, H, Lq, Lk)."""
    return torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale


def _einsum_hop(q, k_blk, v_blk, carry, me: int, src: int, causal: bool):
    """One hop of the einsum engine's online softmax on slot ``me`` with the
    block first owned by slot ``src``: (m, num, den) updated in fp32."""
    m, num, den = carry
    lb, d = q.shape[1], q.shape[3]
    s = _block_scores(q, k_blk, 1.0 / math.sqrt(d))  # (B, H, Lb, Lb)
    if causal and src == me:
        pos = torch.arange(lb, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    num = num * corr[..., None] + torch.einsum("bhlm,bmhd->bhld", p, v_blk.float())
    den = den * corr + p.sum(-1)
    return m_new, num, den


def _flash_hop(q, k_blk, v_blk, carry, me: int, src: int, causal: bool):
    """One hop of the flash engine: the kernel on the resident block, its
    normalised partial merged into (out, lse) by the LSE rule

        lse = logaddexp(lse1, lse2)
        out = exp(lse1 - lse) * out1 + exp(lse2 - lse) * out2

    in fp32 (the partial cast up first, as the JAX package's bf16 path)."""
    from ..ops.flash_attention import flash_attention_with_lse

    out, lse = carry
    o_t, lse_t = flash_attention_with_lse(q, k_blk, v_blk, causal=causal and src == me)
    lse_new = torch.logaddexp(lse, lse_t)  # (B, H, Lb)
    w_old = torch.exp(lse - lse_new).permute(0, 2, 1)[..., None]
    w_t = torch.exp(lse_t - lse_new).permute(0, 2, 1)[..., None]
    return out * w_old + o_t.float() * w_t, lse_new


def _ring(qs: Blocks, ks: Blocks, vs: Blocks, groups, *, causal: bool, engine: str) -> Blocks:
    """Every head group's ring at once: n hops, each slot's step on the
    block resident there, then the K/V rotation one slot forward (slot i
    receives slot i-1's block), two ``ppermute`` operations a hop for the whole
    mesh. After n rotations every block is back with its owner."""
    n = len(groups[0])
    carries = []
    for qg in qs:
        row = []
        for q in qg:
            b, lb, h, d = q.shape
            lse0 = torch.full((b, h, lb), NEG_INF, dtype=torch.float32, device=q.device)
            if engine == "flash":
                row.append((torch.zeros((b, lb, h, d), dtype=torch.float32, device=q.device), lse0))
            else:
                row.append((lse0, torch.zeros((b, h, lb, d), dtype=torch.float32, device=q.device),
                            torch.zeros((b, h, lb), dtype=torch.float32, device=q.device)))
        carries.append(row)
    hop = _flash_hop if engine == "flash" else _einsum_hop
    kb, vb = ks, vs
    for t in range(n):
        for g, qg in enumerate(qs):
            for me, q in enumerate(qg):
                src = (me - t) % n  # the resident block's owner
                if causal and src > me:
                    continue  # every key after every query: the partial's merge weight is exactly 0
                carries[g][me] = hop(q, kb[g][me], vb[g][me], carries[g][me], me, src, causal)
        COLLECTIVES["ppermute"] += 2
        kb = [[blk[(i - 1) % n].to(devs[i], non_blocking=True) for i in range(n)] for blk, devs in zip(kb, groups)]
        vb = [[blk[(i - 1) % n].to(devs[i], non_blocking=True) for i in range(n)] for blk, devs in zip(vb, groups)]
    outs = []
    for qg, row in zip(qs, carries):
        if engine == "flash":
            outs.append([out.to(q.dtype) for q, (out, _) in zip(qg, row)])
        else:
            outs.append([(num / torch.clamp_min(den, 1e-30)[..., None]).permute(0, 2, 1, 3).to(q.dtype)
                         for q, (_, num, den) in zip(qg, row)])
    return outs


def _to_heads(blocks: Blocks, groups) -> Blocks:
    """One tiled ``all_to_all`` (split heads, concat sequence): slot i of a
    group receives head slice i of every slot's (B, Lb, Hg, D) block, in
    source order: (B, L, Hg/n, D)."""
    COLLECTIVES["all_to_all"] += 1
    out = []
    for blk, devs in zip(blocks, groups):
        hh = blk[0].shape[2] // len(devs)
        out.append([torch.cat([x[:, :, i * hh:(i + 1) * hh].to(dev, non_blocking=True) for x in blk], dim=1)
                    for i, dev in enumerate(devs)])
    return out


def _to_seq(blocks: Blocks, groups) -> Blocks:
    """The inverse ``all_to_all`` (split sequence, concat heads): slot s of a
    group receives sequence block s of every slot's (B, L, Hg/n, D) output,
    in source order: (B, Lb, Hg, D)."""
    COLLECTIVES["all_to_all"] += 1
    out = []
    for blk, devs in zip(blocks, groups):
        lb = blk[0].shape[1] // len(devs)
        out.append([torch.cat([x[:, s * lb:(s + 1) * lb].to(dev, non_blocking=True) for x in blk], dim=2)
                    for s, dev in enumerate(devs)])
    return out


def _ulysses(qs: Blocks, ks: Blocks, vs: Blocks, groups, *, causal: bool, engine: str) -> Blocks:
    if engine == "flash":
        from ..ops.flash_attention import flash_attention as attend
    else:
        from ..ops.attention import attention as attend
    qh, kh, vh = _to_heads(qs, groups), _to_heads(ks, groups), _to_heads(vs, groups)
    outs = [[attend(q, k, v, causal=causal) for q, k, v in zip(qg, kg, vg)] for qg, kg, vg in zip(qh, kh, vh)]
    return _to_seq(outs, groups)


def _validate_engine(engine: str) -> None:
    if engine not in ("einsum", "flash"):
        raise ValueError(f"engine must be einsum|flash, got {engine!r}")


def _validate_mesh_axis_size(mesh: Optional[Mesh], axis_name: str, n_shards: int) -> None:
    """n_shards must equal the mesh's axis size. Ring: the loop runs
    n_shards hops over the axis' slots, so a mismatch would compute
    attention over a subset of the K/V blocks (the JAX package measured a
    max abs error of ~0.8 against the oracle before it had this guard).
    Ulysses: the L/H split assumes the all_to_all group is n_shards long."""
    if mesh is not None and mesh.axis_size(axis_name) != n_shards:
        raise ValueError(
            f"n_shards ({n_shards}) != mesh axis {axis_name!r} size "
            f"({mesh.axis_size(axis_name)}); the ring/reshard hop count is n_shards"
        )


def _validate_head_axis_mesh(mesh: Optional[Mesh], head_axis: str) -> int:
    """The sp x tp pre-validation: an explicit mesh with the axis. Returns
    the head axis' size, so each caller applies its own divisibility rule
    (ring: tp; ulysses: sp*tp), all with global numbers."""
    if mesh is None:
        raise ValueError("head_axis needs an explicit mesh containing both axes")
    if head_axis not in mesh.axis_names:
        raise ValueError(f"head_axis {head_axis!r} not in mesh axes {tuple(mesh.axis_names)}")
    return mesh.axis_size(head_axis)


def _slot_groups(mesh: Mesh, axis_name: str, head_axis: Optional[str]) -> Tuple[Tuple[torch.device, ...], ...]:
    """The slot groups the attention runs over: with ``head_axis`` one
    group a head shard (that column's slots along ``axis_name``); without,
    the first group alone (the other axis replicates the work, as the JAX
    package's ``shard_map`` does)."""
    groups = mesh.axis_groups(axis_name)
    return groups if head_axis is not None else groups[:1]


def _split(x: torch.Tensor, groups) -> Blocks:
    """Slot (j, i)'s block of x: sequence block i of head group j, on its slot's device."""
    n, g = len(groups[0]), len(groups)
    lb, hg = x.shape[1] // n, x.shape[2] // g
    return [[x[:, i * lb:(i + 1) * lb, j * hg:(j + 1) * hg].to(dev, non_blocking=True)
             for i, dev in enumerate(devs)] for j, devs in enumerate(groups)]


def _join(blocks: Blocks, device) -> torch.Tensor:
    """The (B, L, H, D) result on ``device``: the blocks in slot order on the
    sequence axis, the head groups in group order on the head axis."""
    return torch.cat([torch.cat([b.to(device, non_blocking=True) for b in row], dim=1) for row in blocks], dim=2)


def _digests(qs: Blocks, ks: Blocks, vs: Blocks, outs: Blocks, device) -> dict:
    """The sentinel taps: one ``tree_digest`` of each slot's (q, k, v) block
    and of its output block, (n,) float32 each, over the first head group's
    slots (the JAX package's ``P(axis_name)`` out_spec)."""
    from ..resilience.sentinel import tree_digest

    def stack(vals):
        return torch.stack([v.to(device) for v in vals])

    return {"qkv": stack([tree_digest((q, k, v)) for q, k, v in zip(qs[0], ks[0], vs[0])]),
            "out": stack([tree_digest(o) for o in outs[0]])}


def _run(body, q, k, v, *, n_shards, causal, mesh, axis_name, engine, head_axis, with_digests):
    if mesh is None:
        mesh = make_mesh(n_shards, axis_name=axis_name, device=q.device.type)
    groups = _slot_groups(mesh, axis_name, head_axis)
    qs, ks, vs = _split(q, groups), _split(k, groups), _split(v, groups)
    outs = body(qs, ks, vs, groups, causal=causal, engine=engine)
    out = _join(outs, q.device)
    return (out, _digests(qs, ks, vs, outs, q.device)) if with_digests else out


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    n_shards: int,
    causal: bool = False,
    mesh: Optional[Mesh] = None,
    axis_name: str = "sp",
    engine: str = "einsum",
    head_axis: Optional[str] = None,
    with_digests: bool = False,
):
    """Sequence-sharded blockwise ring attention. q, k, v: (B, L, H, D) ->
    (B, L, H, D) on q's device. Requires ``L % n_shards == 0``.

    ``mesh``: the port's mesh (default: ``n_shards`` slots over the visible
    devices of q's type); its ``axis_name`` axis must be ``n_shards`` long.
    ``head_axis``: a second mesh axis splitting H (sp x tp); ``mesh`` must
    hold both axes and H divide by its size. ``engine``: ``"einsum"``
    (fp32 score blocks) or ``"flash"`` (the flash kernels a hop, merged by
    LSE; the per-shard block L/n must divide by its flash block). Both are
    differentiable. ``with_digests``: return ``(out, {"qkv": (n,), "out":
    (n,)})``, one sentinel digest a slot of its inputs and of its output."""
    b, l, h, d = q.shape
    if l % n_shards != 0:
        raise ValueError(f"sequence length {l} not divisible by {n_shards} shards")
    _validate_engine(engine)
    if engine == "flash":
        from ..ops.flash_attention import flash_block

        lb = l // n_shards
        blk = flash_block(lb)
        if lb % blk:
            raise ValueError(
                f"engine='flash' needs the per-shard block (L/n = {lb}) to be "
                f"a multiple of the flash block size ({blk}); L={l}, "
                f"n_shards={n_shards}. Use the einsum engine or pad L."
            )
    _validate_mesh_axis_size(mesh, axis_name, n_shards)
    if head_axis is not None:
        tp = _validate_head_axis_mesh(mesh, head_axis)
        if h % tp:
            raise ValueError(f"head count {h} not divisible by {head_axis}={tp} shards")
    return _run(_ring, q, k, v, n_shards=n_shards, causal=causal, mesh=mesh, axis_name=axis_name, engine=engine,
                head_axis=head_axis, with_digests=with_digests)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    n_shards: int,
    causal: bool = False,
    mesh: Optional[Mesh] = None,
    axis_name: str = "sp",
    engine: str = "einsum",
    head_axis: Optional[str] = None,
    with_digests: bool = False,
):
    """All-to-all (Ulysses) sequence parallelism. q, k, v: (B, L, H, D) ->
    (B, L, H, D) on q's device. Requires ``L % n == 0`` and ``H % n == 0``
    (with ``head_axis``, ``H % (n * tp) == 0``).

    Each slot runs exact attention over the full sequence for its H/n heads
    (``ops.attention`` or, with ``engine="flash"``, the flash kernels, whose
    rule is then ``L % flash_block(L) == 0``); four ``all_to_all`` operations move
    the blocks. ``mesh``, ``head_axis`` and ``with_digests`` as in
    :func:`ring_attention`."""
    b, l, h, d = q.shape
    if l % n_shards != 0:
        raise ValueError(f"sequence length {l} not divisible by {n_shards} shards")
    if h % n_shards != 0:
        raise ValueError(f"head count {h} not divisible by {n_shards} shards")
    _validate_mesh_axis_size(mesh, axis_name, n_shards)
    if head_axis is not None:
        tp = _validate_head_axis_mesh(mesh, head_axis)
        if h % (n_shards * tp):
            raise ValueError(
                f"head count {h} not divisible by sp x {head_axis} = "
                f"{n_shards} x {tp} shards"
            )
    _validate_engine(engine)
    if engine == "flash":
        from ..ops.flash_attention import flash_block

        blk = flash_block(l)
        if l % blk:
            raise ValueError(
                f"engine='flash' needs L ({l}) to be a multiple of the flash "
                f"block size ({blk}). Use the einsum engine or pad L."
            )
    return _run(_ulysses, q, k, v, n_shards=n_shards, causal=causal, mesh=mesh, axis_name=axis_name,
                engine=engine, head_axis=head_axis, with_digests=with_digests)
