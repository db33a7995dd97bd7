"""Step-level silent-data-corruption (SDC) sentinel: the JAX package's
``resilience/sentinel.py``.

The loud faults (a non-zero exit, a timeout) are ``policy``'s; this module
detects the silent ones, a flipped bit, a NaN loss, replicas that disagree,
and raises a structured :class:`SDC` so the supervisor can re-plan and
replay instead of committing a corrupt result:

- **Non-finite and norm-spike screens** (:class:`Sentinel`): a loss, grad
  norm or param tree is screened for NaN/Inf, and each watched scalar
  keeps a rolling window whose median a value ``spike_factor`` times
  larger trips (a high exponent bit flipped moves an fp32 by ~2^64).
- **Stage digests** (:class:`StageDigests`): the sharded builders'
  ``with_digests=True`` forwards return, beside the output, one digest a
  stage boundary and a shard: a device tensor, so the hot loop makes no
  host round trip. Screening pulls them once, between timed regions
  (:func:`off_timed_path`), and trips on a non-finite digest, on replicas
  that differ, or on a digest off its recorded reference.
- **Replica checksums**: :func:`replica_spread` and
  :func:`cross_replica_digests` take a digest of each shard slot's block;
  :func:`replicated_shard_spread` compares the copies of a replicated
  value (a :class:`Replicas` leaf: what each slot computed).
- **The oracle spot check** (:func:`oracle_spot_check`): the reference
  conv against a plain numpy loop nest (:func:`conv2d_np`, the port's copy
  of the JAX package's ``tests/oracle.py`` conv) on one tiny fixed case;
  a mismatch indicts the compute stack itself. The tolerance gate runs it
  as its preflight.

:func:`inject_bit_flip` is the seeded corruption of the chaos layer's
``sdc`` site: the same element as the JAX package's for the same seed and
tree. A digest here is the JAX package's ``tree_digest`` (a weighted sum
and an abs-sum a leaf, in float32).
"""

from __future__ import annotations

import dataclasses
import math
import random
import statistics
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability.trace import off_timed_path
from ..utils.tree import tree_leaves, tree_unflatten


class SDC(RuntimeError):
    """A detected silent-data-corruption event, structured (kind, step,
    detail) so policy and logs triage it without string matching. Kinds:
    ``nan_loss``, ``nonfinite``, ``norm_spike``, ``replica_divergence``,
    ``oracle_mismatch``, and the supervisor's: ``stage_digest`` (a stage
    digest is non-finite or off its reference), ``shard_divergence``
    (copies that should agree digest differently), ``device_loss`` and
    ``mesh_shrink`` (a shard slot vanished), ``step_nonfinite``."""

    def __init__(self, kind: str, step: int, detail: str = ""):
        super().__init__(f"SDC({kind}) at step {step}" + (f": {detail}" if detail else ""))
        self.kind = kind
        self.step = step
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """``window``: the rolling history of a watched scalar; ``warmup``: the
    observations that arm spike detection; ``spike_factor``: the trip ratio
    against the window median; ``divergence_tol``: the largest digest
    spread of copies; ``oracle_every``: the oracle spot check every N-th
    ``check_tree`` (0 = off), within ``oracle_tol``."""

    window: int = 8
    warmup: int = 2
    spike_factor: float = 1e3
    divergence_tol: float = 0.0
    oracle_every: int = 0
    oracle_tol: float = 1e-3


def _trip(owner, kind: str, step: int, detail: str) -> None:
    e = SDC(kind, step, detail)
    owner.trips.append(e)
    raise e


def _as_f32(leaf) -> torch.Tensor:
    t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
    return t.detach().float()


class Sentinel:
    """A per-run watcher: every ``check_*`` raises :class:`SDC` on a trip
    (kept on ``trips``) and otherwise records the observation."""

    def __init__(self, cfg: SentinelConfig = SentinelConfig(), site: str = "train"):
        self.cfg = cfg
        self.site = site
        self.trips: List[SDC] = []
        self._hist: Dict[str, Deque[float]] = {}
        self._tree_checks = 0

    def check_scalar(self, step: int, value, name: str = "loss") -> float:
        """Screen one scalar for NaN/Inf and window-median spikes; returns
        it as a float. A tripped value is not added to the history, so a
        replay re-enters with the window as it was before the fault."""
        v = float(value)
        if not math.isfinite(v):
            _trip(self, "nan_loss" if name == "loss" else "nonfinite", step, f"{name}={v}")
        hist = self._hist.setdefault(name, deque(maxlen=self.cfg.window))
        if len(hist) >= self.cfg.warmup:
            ref = statistics.median(hist)
            if abs(v) > self.cfg.spike_factor * max(abs(ref), 1e-12):
                _trip(self, "norm_spike", step,
                      f"{name}={v:.6e} vs window median {ref:.6e} (factor {self.cfg.spike_factor:g})")
        hist.append(v)
        return v

    @off_timed_path
    def check_tree(self, step: int, tree, name: str = "params") -> float:
        """Screen a tree: a NaN/Inf leaf value trips ``nonfinite``; the
        global L2 norm (float32, as the JAX package's) rides the spike
        detector under ``{name}_norm``. Drives the oracle spot check every
        ``oracle_every`` calls. Returns the norm."""
        leaves = [_as_f32(leaf) for leaf in tree_leaves(tree)]
        if leaves:
            bad = sum(int((~torch.isfinite(leaf)).sum()) for leaf in leaves)
            if bad:
                _trip(self, "nonfinite", step, f"{name}: {bad} non-finite value(s)")
            norm = float(torch.sqrt(sum(torch.sum(leaf.square()).cpu() for leaf in leaves)))
        else:
            norm = 0.0
        self.check_scalar(step, norm, name=f"{name}_norm")
        self._tree_checks += 1
        if self.cfg.oracle_every and self._tree_checks % self.cfg.oracle_every == 0:
            self.oracle_check(step)
        return norm

    @off_timed_path
    def check_divergence(self, step: int, tree, name: str = "params") -> float:
        """The copies of a replicated tree must agree: a spread above
        ``divergence_tol`` trips ``replica_divergence``. Returns it."""
        spread = replicated_shard_spread(tree)
        if spread > self.cfg.divergence_tol:
            _trip(self, "replica_divergence", step,
                  f"{name}: replica digest spread {spread:.6e} > tol {self.cfg.divergence_tol:g}")
        return spread

    @off_timed_path
    def oracle_check(self, step: int, device="cpu") -> None:
        """The oracle spot check (:func:`oracle_spot_check`) on ``device``:
        a deviation past ``oracle_tol`` trips ``oracle_mismatch``."""
        err = oracle_spot_check(tol=self.cfg.oracle_tol, device=device)
        if err > self.cfg.oracle_tol:
            _trip(self, "oracle_mismatch", step,
                  f"framework conv deviates from numpy oracle by {err:.3e} (tol {self.cfg.oracle_tol:g})")


class StageDigests:
    """Screen the digest tree a ``with_digests=True`` forward returns,
    ``{stage: (n_shards,) float32}``, once, between timed regions. Trips
    ``stage_digest`` on a non-finite digest or one off ``expect`` past
    ``rtol`` of its max, and ``shard_divergence`` when ``replicated`` and
    a stage's digests spread past ``divergence_tol``. Returns the host
    copies as float64 arrays (also on ``last``)."""

    def __init__(self, cfg: SentinelConfig = SentinelConfig(), site: str = "forward"):
        self.cfg = cfg
        self.site = site
        self.trips: List[SDC] = []
        self.last: Dict[str, np.ndarray] = {}

    @off_timed_path
    def check(self, step: int, digests, replicated: bool = False,
              expect: Optional[Dict[str, np.ndarray]] = None, rtol: float = 0.0) -> Dict[str, np.ndarray]:
        host: Dict[str, np.ndarray] = {}
        stages = sorted(digests)
        # the device digests go to the host in one copy (one sync a screen), then split by stage
        tens = [s for s in stages if isinstance(digests[s], torch.Tensor)]
        if tens:
            home = digests[tens[0]].device
            flat = torch.cat([digests[s].detach().reshape(-1).to(home, torch.float64) for s in tens]).cpu().numpy()
            sizes = np.cumsum([digests[s].numel() for s in tens])[:-1]
            host.update(zip(tens, np.split(flat, sizes)))
        for stage in stages:
            if stage not in host:
                host[stage] = np.asarray(digests[stage], np.float64).reshape(-1)
            vec = host[stage]
            if not np.all(np.isfinite(vec)):
                _trip(self, "stage_digest", step, f"{self.site}/{stage}: non-finite stage digest {vec.tolist()}")
            if replicated and vec.size > 1:
                spread = float(vec.max() - vec.min())
                if spread > self.cfg.divergence_tol:
                    _trip(self, "shard_divergence", step,
                          f"{self.site}/{stage}: per-shard digest spread {spread:.6e} > tol "
                          f"{self.cfg.divergence_tol:g}")
            if expect is not None and stage in expect:
                want = np.asarray(expect[stage], np.float64).reshape(-1)
                scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-12)
                err = float(np.max(np.abs(vec - want))) if vec.shape == want.shape else float("inf")
                if err > rtol * scale:
                    _trip(self, "stage_digest", step,
                          f"{self.site}/{stage}: digest deviates from reference by {err:.6e} "
                          f"(rtol {rtol:g}, scale {scale:.3e})")
        self.last = host
        return host


# ------------------------------------------------------------- digests ---


def tree_digest(tree) -> torch.Tensor:
    """The JAX package's order-sensitive digest of a tree: the sum over
    leaves i of ``(i + 1) * sum(x) + sum(|x|)`` in float32, so a sign flip,
    a swap or one flipped bit moves it. A 0-d float32 tensor on the first
    leaf's device, computed there (no host sync): two float32-accumulated
    reductions a leaf, each one read of it (no cast or abs copy of the
    activations). Not a cryptographic hash: it only has to disagree when
    copies disagree."""
    leaves = [leaf for leaf in tree_leaves(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    acc = None
    for i, leaf in enumerate(leaves):
        x = (leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))).detach()
        term = (i + 1) * torch.sum(x, dtype=torch.float32) + torch.linalg.vector_norm(x, 1, dtype=torch.float32)
        acc = term if acc is None else acc + term.to(acc.device)
    return acc


def shard_digests(blocks: Sequence) -> torch.Tensor:
    """One :func:`tree_digest` per shard slot's block, as one ``(n,)``
    float32 tensor on the first block's device: the per-shard tap a
    sharded builder returns for a stage."""
    home = blocks[0].device
    return torch.stack([tree_digest(b).to(home, non_blocking=True) for b in blocks])


def replica_spread(blocks: Sequence) -> torch.Tensor:
    """max - min of the per-slot digests of ``blocks`` (what each slot
    holds of a value that should be replicated): 0 exactly when every copy
    is the same. A device scalar; compare it against a tolerance off the
    timed path."""
    d = shard_digests(blocks)
    return d.max() - d.min()


def cross_replica_digests(x, n_shards: int, dim: int = 0) -> np.ndarray:
    """One digest per ``n_shards``-way slice of ``x`` (a tensor, split
    along ``dim`` as a leading-axis-sharded array is; or a sequence of
    per-slot blocks): copies that should agree digest alike, and
    ``max - min`` of the result is the divergence checksum."""
    blocks = list(x) if isinstance(x, (list, tuple)) else list(torch.chunk(x, n_shards, dim=dim))
    return shard_digests(blocks).double().cpu().numpy()


class Replicas(tuple):
    """The copies of one replicated value, one a shard slot (what each slot
    computed or holds): a leaf that :func:`replicated_shard_spread`
    compares. A tensor leaf on one device is one copy and contributes
    nothing, as a single-device leaf does in the JAX package."""


def replicated_shard_spread(tree) -> float:
    """The host-side replica checksum: for each :class:`Replicas` leaf of
    ``tree``, the spread of its copies' sums (float64 of the float32
    values). Replicated copies are bit-identical on healthy hardware, so
    any spread is corruption, not rounding."""
    worst = 0.0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, Replicas):
            if len(node) > 1:
                sums = [float(_as_f32(c).double().sum()) for c in node]
                worst = max(worst, max(sums) - min(sums))
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return worst


# ------------------------------------------------------- chaos injection ---


def inject_bit_flip(tree, seed: int = 0, bit: int = 30) -> Tuple[object, Optional[Tuple[int, int]]]:
    """The seeded single-bit corruption of one float32 element (the chaos
    ``sdc`` site's payload): bit ``bit`` (30, a high exponent bit: ~2^64)
    of a seeded non-zero element of a seeded float32 leaf, the JAX
    package's draw for the same seed, leaf order and shapes. Returns
    ``(corrupted_tree, (leaf_idx, elem_idx))`` with the other leaves the
    same objects, or ``(tree, None)`` when no leaf can be flipped."""
    leaves = tree_leaves(tree)
    rng = random.Random(f"sdc:{seed}")
    order = list(range(len(leaves)))
    rng.shuffle(order)
    for li in order:
        leaf = leaves[li]
        arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)).copy()
        if arr.dtype != np.float32 or arr.size == 0:
            continue
        flat = arr.reshape(-1)
        idx = rng.randrange(flat.size)
        for k in range(flat.size):  # walk to a non-zero element: a flipped zero stays small
            j = (idx + k) % flat.size
            if flat[j] != 0.0:
                idx = j
                break
        else:
            continue
        flat.view(np.uint32)[idx] ^= np.uint32(1 << bit)
        out = list(leaves)
        out[li] = torch.from_numpy(arr).to(leaf.device) if isinstance(leaf, torch.Tensor) else arr
        return tree_unflatten(tree, out), (li, idx)
    return tree, None


# ------------------------------------------------------ oracle spot check ---


def conv2d_np(x: np.ndarray, w: np.ndarray, b: np.ndarray, stride: int, padding: int) -> np.ndarray:
    """x (H, W, C), w (F, F, C, K), b (K,) -> (Ho, Wo, K) in float64."""
    h, wd, c = x.shape
    f, _, _, k = w.shape
    ho = (h - f + 2 * padding) // stride + 1
    wo = (wd - f + 2 * padding) // stride + 1
    xp = np.zeros((h + 2 * padding, wd + 2 * padding, c), dtype=np.float64)
    xp[padding : padding + h, padding : padding + wd] = x
    out = np.zeros((ho, wo, k), dtype=np.float64)
    for i in range(ho):
        for j in range(wo):
            patch = xp[i * stride : i * stride + f, j * stride : j * stride + f]
            out[i, j] = np.einsum("fgc,fgck->k", patch, w) + b
    return out


def oracle_spot_check(tol: float = 1e-3, _corrupt: bool = False, device="cuda") -> float:
    """Max abs deviation of the port's reference conv on ``device`` from
    :func:`conv2d_np` on the JAX package's fixed case (9x9x3 input, 3x3x3x4
    weights, stride 2, padding 1, numpy seed 0). ``tol`` is the caller's
    threshold (the gate trips above 1e-3); ``_corrupt`` perturbs the
    result, so tests reach the trip path without a real fault. Runs on
    CUDA unless the caller asks for the CPU; without a GPU it raises."""
    from ..configs import resolve_device
    from ..ops import reference

    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 9, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    want = conv2d_np(x, w, b, stride=2, padding=1)
    dev = resolve_device(device)
    reference.true_fp32(dev)
    got = reference.conv2d(
        torch.from_numpy(x)[None].to(dev), torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev),
        stride=2, padding=1,
    )[0].cpu().numpy()
    if _corrupt:
        got = got + 1.0
    return float(np.max(np.abs(got - want.astype(np.float32))))
