"""The mesh: N shard slots, each on a device.

The JAX package's ``parallel/mesh.py`` builds a ``jax.sharding.Mesh`` over
N devices and runs one program on all of them (``shard_map``). In one
process the port keeps that single-controller model: the process drives N
shard slots, and slot ``i`` lives on
``devices[i % len(devices)]``. By default the devices are every visible
GPU, so 4 shards on one H100 share ``cuda:0`` (as the JAX tests' virtual
CPU devices share one CPU), and on a 4-GPU host each shard has a card of
its own. :meth:`Mesh.describe` says which layout a mesh has
("4 shards on 1 device: cuda:0"), so sharing a card is never silent.

A mesh can span ranks (``parallel/distributed.py``: one process a rank,
``torch.distributed``): when a process group is up, :func:`make_mesh`
gives each rank a contiguous run of N/R slots (the course's ``mpirun``
row decomposition), on its own device; :attr:`Mesh.owners` names each
slot's rank, and this rank holds only its :attr:`Mesh.local_slots`'
tensors (another rank's slots sit on the ``meta`` device here, so a
tensor moved to one carries no data). The describe line says so: "4
shards over 2 ranks x 2 slots on cuda:0 (gloo, 2 ranks to a card)".

Both axes are named, as in the JAX package: ``make_mesh(2, axis_name="tp",
dp=4, dp_axis_name="sp")`` is the ``(sp, tp)`` mesh of the LM's sp x tp
composition, and :meth:`Mesh.axis_groups` gives the slots along one axis
(the ring's and the tensor-parallel reduction's groups).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


def device_count(device: str = "cuda") -> int:
    """The devices a mesh of ``device``'s type may spread over: the visible
    GPUs (0 without one), or 1 for the CPU."""
    if torch.device(device).type == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` = (dp, n_shards) slots, row-major in ``devices`` (one
    ``torch.device`` a slot); the shard axis is the last, named
    ``axis_names[-1]``, the leading one ``axis_names[0]`` ("dp" unless the
    caller named it)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    # across ranks: each slot's rank, this process's rank and the group's backend; None: one process, every slot
    owners: Optional[Tuple[int, ...]] = None
    rank: int = 0
    backend: Optional[str] = None

    @property
    def world(self) -> int:
        """The ranks the mesh spans (1 in one process)."""
        return 1 if self.owners is None else max(self.owners) + 1

    @property
    def local_slots(self) -> Tuple[int, ...]:
        """The slots (row-major indices) whose tensors this process holds."""
        if self.owners is None:
            return tuple(range(len(self.devices)))
        return tuple(i for i, r in enumerate(self.owners) if r == self.rank)

    def is_local(self, slot: int) -> bool:
        return self.owners is None or self.owners[slot] == self.rank

    @property
    def n_shards(self) -> int:
        return self.shape[-1]

    @property
    def dp(self) -> int:
        return self.shape[0] if len(self.shape) > 1 else 1

    @property
    def shard_devices(self) -> Tuple[torch.device, ...]:
        """The devices of the shard axis (the first data-parallel row)."""
        return self.devices[: self.n_shards]

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """This process's devices (another rank's slots are not among them)."""
        return tuple(dict.fromkeys(self.devices[i] for i in self.local_slots))

    def axis_size(self, name: str) -> Optional[int]:
        """The length of axis ``name``, None if the mesh has no such axis."""
        return dict(zip(self.axis_names, self.shape)).get(name)

    def axis_groups(self, name: str) -> Tuple[Tuple[torch.device, ...], ...]:
        """The slots along axis ``name``, one group for each index of the
        other axis, in that index's order: on a ``(sp, tp)`` mesh,
        ``axis_groups("sp")[j]`` is the ring of head group ``j`` and
        ``axis_groups("tp")[i]`` the tensor-parallel slots of row ``i``."""
        if name not in self.axis_names:
            raise ValueError(f"axis {name!r} not in mesh axes {self.axis_names}")
        if len(self.shape) == 1:
            return (self.devices,)
        rows, cols = self.shape
        if name == self.axis_names[-1]:
            return tuple(self.devices[r * cols:(r + 1) * cols] for r in range(rows))
        return tuple(self.devices[c::cols] for c in range(cols))

    def describe(self) -> str:
        distinct = self.distinct_devices
        if self.owners is not None:
            n, per = len(self.devices), len(self.local_slots)
            share = _ranks_to_a_card(distinct[0])
            return (f"{n} shard{'s' if n != 1 else ''} over {self.world} rank{'s' if self.world != 1 else ''} x "
                    f"{per} slot{'s' if per != 1 else ''} on {', '.join(str(d) for d in distinct)} ({self.backend}"
                    + (f", {share} ranks to a card" if share > 1 else "") + ")")
        lead = f"{self.n_shards} shard{'s' if self.n_shards != 1 else ''}"
        if self.dp > 1 and self.axis_names[0] == "dp":
            lead += f" x {self.dp} data-parallel replicas"
        elif self.dp > 1:
            lead = f"{self.dp} x {self.n_shards} slots ({self.axis_names[0]} x {self.axis_names[-1]})"
        return (f"{lead} on {len(distinct)} device{'s' if len(distinct) != 1 else ''}: "
                f"{', '.join(str(d) for d in distinct)}")


def make_mesh(
    n_shards: int,
    axis_name: str = "sp",
    dp: int = 1,
    dp_axis_name: str = "dp",
    devices: Optional[Sequence] = None,
    device: str = "cuda",
) -> Mesh:
    """A ``(dp, n_shards)`` mesh (one axis when ``dp == 1``), its axes named
    ``(dp_axis_name, axis_name)``: slot ``i`` on ``devices[i % len(devices)]``. ``devices`` defaults to every visible GPU
    (``device="cuda"``) or the CPU (``device="cpu"``); without a GPU and
    without ``device="cpu"`` it raises, so nothing moves to the CPU unless
    asked.

    Under a process group of R ranks the mesh spans them: the dp * n_shards
    slots (a multiple of R) go to the ranks in contiguous runs, rank r's
    on its own device (``devices``, default the CPU or this rank's card),
    the others' on ``meta``."""
    if n_shards < 1 or dp < 1:
        raise ValueError(f"a mesh needs n_shards >= 1 and dp >= 1, got {n_shards} and {dp}")
    names = (axis_name,) if dp == 1 else (dp_axis_name, axis_name)
    shape = (n_shards,) if dp == 1 else (dp, n_shards)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return _rank_mesh(names, shape, devices, device)
    if devices is None:
        kind = torch.device(device)
        if kind.type == "cpu":
            devices = [torch.device("cpu")]
        elif kind.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available for the mesh; pass device='cpu' for a CPU mesh")
            devices = ([torch.device("cuda", kind.index)] if kind.index is not None
                       else [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
        else:
            raise ValueError(f"unsupported mesh device {device!r} (cuda|cpu)")
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d} asked for, but no CUDA device is available")
    need = dp * n_shards
    return Mesh(names, shape, tuple(devs[i % len(devs)] for i in range(need)))


def _rank_mesh(names, shape, devices, device) -> Mesh:
    """The mesh over the process group's ranks (:func:`make_mesh`)."""
    import math

    dist = torch.distributed
    world, rank = dist.get_world_size(), dist.get_rank()
    need = math.prod(shape)
    if need % world:
        raise ValueError(f"{need} slots do not split evenly over {world} ranks: a rank owns a contiguous run of "
                         f"N/R slots, so the slot count must be a multiple of the ranks")
    if devices is None:
        kind = torch.device(device)
        if kind.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the mesh; pass device='cpu' for a CPU mesh")
        devices = [torch.device("cpu")] if kind.type == "cpu" else [
            torch.device("cuda", kind.index if kind.index is not None else torch.cuda.current_device())]
    devs = [torch.device(d) for d in devices]
    per = need // world
    owners = tuple(i // per for i in range(need))
    meta = torch.device("meta")
    slots = tuple(devs[(i - rank * per) % len(devs)] if owners[i] == rank else meta for i in range(need))
    return Mesh(names, shape, slots, owners=owners, rank=rank, backend=dist.get_backend())


def _ranks_to_a_card(dev: torch.device) -> int:
    """How many of this host's ranks share ``dev``'s card (1 on the CPU)."""
    import os

    if dev.type != "cuda":
        return 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return -(-local // max(1, torch.cuda.device_count()))
