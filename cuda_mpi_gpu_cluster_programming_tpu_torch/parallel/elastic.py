"""Elastic pools over the mesh's shard slots, and live resharding: the JAX
package's ``parallel/elastic.py``.

The supervisor answers a lost shard by re-planning down its ladder, and
every rung it lands on builds its mesh over the slots that survive, never
over the full set that just lost one:

- :class:`ElasticPool` keeps the *exclusions* (lost, probationary,
  quarantined slots) and re-queries the *roster* at every build: slot ``i``
  of ``n_slots`` on the device :func:`slot_roster` reads from the runtime
  now (``parallel/mesh.py``'s placement: slot i on visible GPU i mod their
  count). Nothing caches a slot or device list, so a rebuild never names a
  slot the pool has lost (the JAX package's stale-device-set rule).
- :meth:`ElasticPool.mesh_for` builds a :class:`~.mesh.Mesh` over the
  first N surviving slots, or raises the ``mesh needs N slots, have M``
  ``ValueError`` that the supervisor's degrade loop reads as "rung
  unsatisfiable".
- :func:`reshard_tree` and :func:`reshard_train_state` re-home live params
  and optimizer state onto a mesh: the port's builders take the params on
  the mesh's home device and copy them to each slot's device inside the
  call (the replicated layout), so a reshard moves every leaf to the
  mesh's first slot's device and leaves the values untouched.
- Grow-back with anti-flap hysteresis: :meth:`~ElasticPool.heal` and
  :meth:`~ElasticPool.rejoin_check` move a lost slot back only once a fresh
  roster shows it, into probation (``probation_steps`` clean batches,
  ticked by :meth:`~ElasticPool.note_clean_batch`), and a slot that
  completes ``quarantine_flaps`` lose/heal cycles inside ``flap_window``
  ticks is quarantined for good. Every transition is journaled
  (``mesh_shrink``, ``mesh_probation``, ``mesh_quarantine``).

On one H100 every slot shares the card, so a "lost device" is a lost slot:
the drills (``CHAOS_SPEC`` ``mesh_shrink``, ``device_rejoin``, ``flap``)
exercise every path on the card as on the CPU. A real fault of the one
card kills the process; the serving fleet (``serving/fleet.py``: backend
processes behind the router) is what survives that. A pool over physical
cards (a rank a card over ``parallel/distributed.py``'s process group) is
ROADMAP Queue 1 item 17.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, Iterable, List, Set, Tuple

import torch

from .mesh import Mesh, device_count, make_mesh

# The slots a pool has when the caller names none: the JAX tests' virtual
# mesh of 8 CPU devices, and the widest shard count a tier runs (N = 8).
DEFAULT_SLOTS = 8


@dataclasses.dataclass(frozen=True)
class Slot:
    """One shard slot: its id in the pool and the device it sits on now."""

    id: int
    device: torch.device


def slot_roster(n_slots: int, device: str = "cuda") -> List[Slot]:
    """The pool's ``n_slots`` slots, re-queried from the runtime now: slot
    ``i`` on visible device ``i`` mod their count (``mesh.make_mesh``'s
    placement), or on the CPU. Empty on a host without the device asked
    for."""
    kind = torch.device(device)
    if kind.type == "cpu":
        devs = [torch.device("cpu")]
    elif kind.index is not None:
        devs = [kind] if device_count("cuda") > kind.index else []
    else:
        devs = [torch.device("cuda", i) for i in range(device_count("cuda"))]
    if not devs:
        return []
    return [Slot(i, devs[i % len(devs)]) for i in range(n_slots)]


def _id(slot) -> int:
    return slot if isinstance(slot, int) else slot.id


class ElasticPool:
    """The surviving slots, queried fresh at every mesh build: the roster
    (:func:`slot_roster`) minus the lost, probationary and quarantined
    ids. ``device`` is the kind the slots sit on (``cuda`` unless the
    caller asks for ``cpu``)."""

    def __init__(
        self,
        journal=None,
        site: str = "elastic",
        probation_steps: int = 2,
        quarantine_flaps: int = 3,
        flap_window: int = 64,
        n_slots: int = DEFAULT_SLOTS,
        device: str = "cuda",
    ):
        self.journal = journal
        self.site = site
        self.n_slots = max(1, int(n_slots))
        self.device = str(device)
        self.probation_steps = max(0, int(probation_steps))
        self.quarantine_flaps = max(1, int(quarantine_flaps))
        self.flap_window = max(1, int(flap_window))
        self._lost_ids: Set[int] = set()
        self._lost_order: List[int] = []  # loss recency, most recent last
        self._probation: Dict[int, int] = {}  # id -> clean batches left
        self._probation_t0: Dict[int, float] = {}
        self._quarantined: Set[int] = set()
        self._heal_pending: Set[int] = set()  # healed ids the roster does not show yet
        self._flaps: Dict[int, List[int]] = {}  # id -> the clock at each heal
        self._clock = 0  # clean-batch ticks: the flap window's time base
        self.shrinks: List[dict] = []

    # ------------------------------------------------------------ queries

    def roster(self) -> List[Slot]:
        return slot_roster(self.n_slots, self.device)

    def alive(self) -> List[Slot]:
        """The eligible slots, re-queried now: the roster minus lost,
        quarantined and probationary ids."""
        excluded = self._lost_ids | self._quarantined | set(self._probation)
        return [s for s in self.roster() if s.id not in excluded]

    @property
    def n_total(self) -> int:
        return len(self.roster())

    @property
    def n_alive(self) -> int:
        return len(self.alive())

    @property
    def n_lost(self) -> int:
        return len(self._lost_ids)

    @property
    def n_probation(self) -> int:
        return len(self._probation)

    @property
    def n_quarantined(self) -> int:
        return len(self._quarantined)

    def is_lost(self, slot) -> bool:
        return _id(slot) in self._lost_ids

    def is_probationary(self, slot) -> bool:
        return _id(slot) in self._probation

    def is_quarantined(self, slot) -> bool:
        return _id(slot) in self._quarantined

    def recently_lost(self, k: int) -> List[int]:
        """The k most recently lost ids, most recent first."""
        return list(reversed(self._lost_order))[: max(0, int(k))]

    def summary(self) -> str:
        return f"{self.n_alive}/{self.n_total}"

    def _journal(self, kind: str, key: str, **payload) -> None:
        if self.journal is not None:
            from ..observability.trace import current_ids

            self.journal.append(kind, key=key, site=self.site, **current_ids(), **payload)

    # ------------------------------------------------------------- shrink

    def lose(self, slots: Iterable, cause: str = "device_loss") -> dict:
        """Mark slots (``Slot`` or int ids) lost, journaling a
        ``mesh_shrink`` record (before, after, lost, cause). Refuses to lose
        the last survivor: the single-slot floor needs somewhere to land."""
        ids = {_id(s) for s in slots}
        survivors = [s for s in self.alive() if s.id not in ids]
        if not survivors:
            raise ValueError(
                f"refusing to lose all {self.n_alive} surviving devices (ids {sorted(ids)}): "
                "the single-device floor needs one"
            )
        before = self.n_alive
        # losing a probationary slot is a flap half-cycle: its flap history stays
        for i in ids:
            self._probation.pop(i, None)
            self._probation_t0.pop(i, None)
            if i in self._lost_order:
                self._lost_order.remove(i)
            self._lost_order.append(i)
        self._lost_ids |= ids
        record = {"before": before, "after": self.n_alive, "lost": sorted(ids), "cause": cause}
        self.shrinks.append(record)
        self._journal("mesh_shrink", key=f"shrink:{before}->{self.n_alive}", **record)
        return record

    # ------------------------------------------------------------ grow-back

    def heal(self, slots: Iterable, cause: str = "device_rejoin") -> dict:
        """Report slots healed. A healed id leaves the lost set only once a
        fresh roster shows it (else it waits for :meth:`rejoin_check`), into
        probation (``mesh_probation``) or, completing its K-th flap inside
        the window, quarantine (``mesh_quarantine``). Returns the
        ``probation``/``absent``/``quarantined`` id lists."""
        return self._rejoin(sorted({_id(s) for s in slots}), cause)

    def rejoin_check(self, cause: str = "rejoin_check") -> dict:
        """Re-run the roster check over every heal still pending."""
        if not self._heal_pending:
            return {"probation": [], "absent": [], "quarantined": []}
        return self._rejoin(sorted(self._heal_pending), cause)

    def _rejoin(self, ids: List[int], cause: str) -> dict:
        roster = {s.id for s in self.roster()}  # fresh re-query, never cached
        probation: List[int] = []
        absent: List[int] = []
        quarantined: List[int] = []
        for i in ids:
            if i in self._quarantined:  # sticky: a flapper does not get to ask again
                self._heal_pending.discard(i)
                quarantined.append(i)
                continue
            if i not in self._lost_ids:
                self._heal_pending.discard(i)
                continue
            if i not in roster:
                self._heal_pending.add(i)
                absent.append(i)
                continue
            flaps = [t for t in self._flaps.get(i, []) if self._clock - t <= self.flap_window]
            flaps.append(self._clock)
            self._flaps[i] = flaps
            self._lost_ids.discard(i)
            self._lost_order.remove(i)
            self._heal_pending.discard(i)
            if len(flaps) >= self.quarantine_flaps:
                self._quarantined.add(i)
                quarantined.append(i)
                self._journal("mesh_quarantine", key=f"quarantine:{i}", device=i, flaps=len(flaps),
                              window=self.flap_window, cause=cause)
            else:
                self._probation[i] = self.probation_steps
                self._probation_t0[i] = time.monotonic()
                probation.append(i)
        record = {"probation": probation, "absent": absent, "quarantined": quarantined}
        if probation:
            self._journal("mesh_probation", key=f"probation:{','.join(map(str, probation))}", event="enter",
                          devices=probation, probation_steps=self.probation_steps, cause=cause)
            if self.probation_steps == 0:
                self.note_clean_batch(0)
        return record

    def note_clean_batch(self, n: int = 1) -> List[int]:
        """One clean supervised batch or step: the flap clock advances and
        each probation counter ticks; a slot reaching 0 graduates back into
        :meth:`alive` (``mesh_probation`` event ``pass``). Returns the ids
        that graduated."""
        self._clock += max(0, int(n))
        passed: List[int] = []
        for i in list(self._probation):
            self._probation[i] -= n
            if self._probation[i] <= 0:
                del self._probation[i]
                passed.append(i)
        if passed:
            now = time.monotonic()
            ms = max((now - self._probation_t0.pop(i, now)) * 1e3 for i in passed)
            self._journal("mesh_probation", key=f"probation-pass:{','.join(map(str, passed))}", event="pass",
                          devices=sorted(passed), ms=round(ms, 3))
        return passed

    # -------------------------------------------------------------- build

    def mesh_for(self, n_shards: int, axis_name: str = "sp", dp: int = 1) -> Mesh:
        """A mesh over the first ``dp * n_shards`` surviving slots, slot
        ``j`` of the mesh on its slot's device. Raises ``ValueError`` when
        fewer survive."""
        need = max(1, int(n_shards)) * max(1, int(dp))
        alive = self.alive()
        if len(alive) < need:
            raise ValueError(f"mesh needs {need} devices, have {len(alive)}")
        return make_mesh(max(1, int(n_shards)), axis_name=axis_name, dp=dp,
                         devices=[s.device for s in alive[:need]])


def seeded_victims(pool: ElasticPool, k: int, seed, site: str = "mesh_shrink") -> List[Slot]:
    """k seeded victims among the pool's survivors, at least one spared;
    the JAX package's draw (``random.Random(f"{seed}:{site}").sample``)
    over the surviving slots in id order, so the same seed loses the same
    ids as the JAX package's over as many devices."""
    alive = pool.alive()
    k = max(0, min(int(k), len(alive) - 1))
    if k == 0:
        return []
    return random.Random(f"{seed}:{site}").sample(alive, k)


def reshard_tree(tree, mesh: Mesh):
    """The tree's tensors on ``mesh``'s home device (its first slot's), the
    replicated layout every builder of the port takes; values untouched, a
    leaf already there the same tensor."""
    from ..utils.tree import tree_map

    home = mesh.devices[0]
    return tree_map(lambda t: t.to(home) if isinstance(t, torch.Tensor) else t, tree)


def reshard_train_state(params, opt_state, mesh: Mesh) -> Tuple[object, object]:
    """Reshard live ``(params, opt_state)`` onto ``mesh`` in one call, so
    an update never mixes placements."""
    placed = reshard_tree((params, opt_state), mesh)
    return placed[0], placed[1]


def tree_device_ids(tree) -> Set[str]:
    """The devices the tree's tensors live on, as strings ("cuda:0")."""
    from ..utils.tree import tree_leaves

    return {str(t.device) for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}
