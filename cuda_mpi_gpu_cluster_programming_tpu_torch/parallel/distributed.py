"""One rank per process over ``torch.distributed``: the host inventory, the
process group, the (dcn, ici) mesh, the launchers and the self-test.

The JAX package's ``parallel/distributed.py``, after the reference's
``scripts/2_final_multi_machine.sh`` (a ``HOSTS_INFO`` inventory of
``user@host arch`` entries, a hostfile and ``mpirun`` launches):

- **Inventory**: :class:`HostSpec` and :class:`ClusterConfig`; host 0 is
  the coordinator (the reference's master). ``arch`` is the card's kind.
- **Process group**: :func:`initialize` and :func:`maybe_initialize_from_env`
  wrap ``torch.distributed.init_process_group`` over a TCP store at the
  coordinator. They read torch's own variables (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``), so a ``torchrun`` launch joins too. Each rank
  takes ``cuda:{LOCAL_RANK % device_count}``. The backend is the caller's
  choice (``nccl`` or ``gloo``; :data:`BACKEND_ENV` carries it to a
  launched process), by default ``nccl`` for CUDA and ``gloo`` for the CPU,
  and is never switched quietly. NCCL refuses two ranks on one card, so
  asking for it with more local ranks than cards raises before the group
  is made: several ranks on one card run under ``gloo``, which stages their
  tensors through host memory.
- **Mesh**: :func:`make_multihost_mesh`, ranks x local slots; the inner
  axis never crosses a process.
- **Launchers**: :func:`launch_plan` renders one command per host (host 0
  local, the rest ``ssh`` strings; nothing runs them here);
  :func:`launch_local` runs an N-process cluster on this host, the
  ``mpirun --oversubscribe -np N`` of the reference's localhost tests.
- **Self-test** (:func:`_selftest_main`): every global slot's value, its id
  + 1, summed in slot order inside the rank, all-reduced across the ranks
  and checked against n(n+1)/2.

``python -m cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.distributed
--local-cluster 2 --device cpu --backend gloo`` runs the self-test on this
host; ``--plan HOST ...`` prints a launch plan.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shlex
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import torch

DEFAULT_COORDINATOR_PORT = 9911
# how long a rank waits in a collective (and at the rendezvous) before it raises
DEFAULT_TIMEOUT_S = 300.0
# the backend a launched process joins with (launch_plan, launch_local); run --dist-backend overrides it
BACKEND_ENV = "TPU_FRAMEWORK_DIST_BACKEND"
BACKENDS = ("nccl", "gloo")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """One inventory entry (``user@host arch``, 2_final_multi_machine.sh:26-29)."""

    host: str
    user: Optional[str] = None
    arch: str = "h100"  # the card's kind

    @classmethod
    def parse(cls, entry: str) -> "HostSpec":
        parts = entry.split()
        if not parts or len(parts) > 2:
            raise ValueError(f"malformed host entry {entry!r}: expected 'user@host arch' or 'host arch'")
        user, _, host = parts[0].rpartition("@")
        return cls(host=host, user=user or None, arch=parts[1] if len(parts) == 2 else "h100")

    @property
    def ssh_target(self) -> str:
        return f"{self.user}@{self.host}" if self.user else self.host


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """The HOSTS_INFO analogue: one process a host, host 0's coordinating."""

    hosts: Tuple[HostSpec, ...]
    coordinator_port: int = DEFAULT_COORDINATOR_PORT
    local_devices_per_host: Optional[int] = None  # None = every visible card

    @classmethod
    def parse(cls, entries: Sequence[str], port: int = DEFAULT_COORDINATOR_PORT) -> "ClusterConfig":
        return cls(hosts=tuple(HostSpec.parse(e) for e in entries), coordinator_port=port)

    @property
    def coordinator_address(self) -> str:
        return f"{self.hosts[0].host}:{self.coordinator_port}"

    @property
    def num_processes(self) -> int:
        return len(self.hosts)


def default_backend(device: str = "cuda") -> str:
    """``nccl`` for CUDA, ``gloo`` for the CPU."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def rank_device(device: str = "cuda", local_rank: int = 0) -> torch.device:
    """This rank's device: the CPU, or ``cuda:{local_rank % device_count}``
    (raises without a card: nothing moves to the CPU unless asked)."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for this rank; pass device='cpu' (--device cpu) for the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _check_backend(backend: str, device: str, local_world_size: int) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} ({'|'.join(BACKENDS)})")
    if backend != "nccl":
        return
    if torch.device(device).type == "cpu":
        raise ValueError("nccl moves CUDA tensors only; a CPU cluster runs under gloo")
    if not torch.cuda.is_available():
        raise RuntimeError("nccl asked for, but no CUDA device is available")
    cards = torch.cuda.device_count()
    if local_world_size > cards:
        raise ValueError(
            f"nccl refuses two ranks on one card ('Duplicate GPU detected'): {local_world_size} local ranks over "
            f"{cards} card(s); run several ranks on one card under gloo (backend='gloo', --dist-backend gloo), which "
            "stages their tensors through host memory")


def initialize(
    cluster: Optional[ClusterConfig] = None, rank: Optional[int] = None, *, backend: Optional[str] = None,
    device: str = "cuda", local_rank: Optional[int] = None, local_world_size: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join the process group (MPI_Init) and return this rank's device.

    With a ``cluster``: the coordinator's address, one process a host, and
    ``rank`` (default ``$RANK``, else 0); the rank is its host's only one
    unless ``local_rank`` and ``local_world_size`` say otherwise. Without
    one, torch's variables (``MASTER_ADDR`` ... ``LOCAL_WORLD_SIZE``).
    ``backend`` defaults to :func:`default_backend` of ``device``. Every
    collective waits at most ``timeout_s`` before it raises."""
    env = os.environ
    if cluster is not None:
        addr, port = cluster.hosts[0].host, cluster.coordinator_port
        world = cluster.num_processes
        rank = int(env.get("RANK", "0")) if rank is None else rank
    else:
        addr, port = env.get("MASTER_ADDR", "localhost"), int(env.get("MASTER_PORT", DEFAULT_COORDINATOR_PORT))
        world = int(env.get("WORLD_SIZE", "1"))
        rank = int(env.get("RANK", "0")) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", "0")) if local_rank is None else local_rank
    local_world_size = int(env.get("LOCAL_WORLD_SIZE", "1")) if local_world_size is None else local_world_size
    backend = backend or default_backend(device)
    _check_backend(backend, device, local_world_size)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        backend=backend, init_method=f"tcp://{addr}:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    if backend == "nccl":
        # every rank in the group's first collective, as nccl asks of a later batch_isend_irecv
        torch.distributed.barrier(device_ids=[dev.index])
    return dev


def maybe_initialize_from_env(backend: Optional[str] = None, device: str = "cuda") -> bool:
    """Join the cluster that torch's variables describe (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; what ``launch_plan``,
    ``launch_local`` and ``torchrun`` export), under ``backend``, else
    ``$TPU_FRAMEWORK_DIST_BACKEND``, else :func:`default_backend`. A no-op
    returning False when they are absent; True if this process is in a
    group (already, or now). Call it at an entry point's start, before any
    CUDA use."""
    if not os.environ.get("MASTER_ADDR") or not os.environ.get("WORLD_SIZE"):
        return False
    if torch.distributed.is_initialized():
        return True
    initialize(backend=backend or os.environ.get(BACKEND_ENV) or None, device=device)
    return True


def is_distributed() -> bool:
    """Whether this process is a rank of a process group."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def make_multihost_mesh(ici_shards: Optional[int] = None, dcn_axis_name: str = "dp", ici_axis_name: str = "sp",
                        device: str = "cuda"):
    """The (ranks, ici_shards) mesh: the outer (dcn) axis over the ranks, the
    inner (ici) axis over each rank's own ``ici_shards`` slots (default 1),
    so only the outer axis crosses a process. One process: a (1, ici) mesh."""
    from .mesh import make_mesh

    world = torch.distributed.get_world_size() if is_distributed() else 1
    mesh = make_mesh(ici_shards or 1, axis_name=ici_axis_name, dp=world, dp_axis_name=dcn_axis_name, device=device)
    # one rank: make_mesh drops the unit axis; the (dcn, ici) grid keeps it
    return mesh if world > 1 else dataclasses.replace(mesh, axis_names=(dcn_axis_name, ici_axis_name),
                                                      shape=(1, mesh.n_shards))


def launch_plan(
    cluster: ClusterConfig, module: str, args: Sequence[str] = (), workdir: str = ".",
    extra_env: Optional[dict] = None, backend: Optional[str] = None,
) -> List[str]:
    """One command a host (the hostfile + mpirun analogue,
    2_final_multi_machine.sh:289-303, 393-410): host 0's runs locally, the
    others' are ``ssh`` strings. Each sets torch's variables and, with
    ``backend``, :data:`BACKEND_ENV`; ``extra_env`` adds assignments."""
    env = dict(extra_env or {})
    if backend:
        env[BACKEND_ENV] = backend
    extras = "".join(f"{k}={shlex.quote(str(v))} " for k, v in env.items())
    host0 = cluster.hosts[0].host
    cmds = []
    for rank, host in enumerate(cluster.hosts):
        inner = (
            f"cd {shlex.quote(workdir)} && {extras}"
            f"MASTER_ADDR={host0} MASTER_PORT={cluster.coordinator_port} "
            f"WORLD_SIZE={cluster.num_processes} RANK={rank} LOCAL_RANK=0 LOCAL_WORLD_SIZE=1 "
            f"{shlex.quote(sys.executable)} -m {module} {' '.join(map(shlex.quote, args))}"
        ).rstrip()
        cmds.append(inner if rank == 0 else f"ssh {host.ssh_target} {shlex.quote(inner)}")
    return cmds


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local(
    n_processes: int,
    slots_per_process: int = 1,
    module: str = f"{__package__}.distributed",
    module_args: Sequence[str] = (),
    timeout_s: float = 300.0,
    port: Optional[int] = None,
    device: str = "cuda",
    backend: Optional[str] = None,
) -> List[subprocess.CompletedProcess]:
    """Run an ``n_processes``-rank cluster on this host: ``python -m module
    *module_args`` a rank, from the repo's root, each with torch's variables,
    :data:`BACKEND_ENV` (``backend``, default :func:`default_backend` of
    ``device``), ``TPU_FRAMEWORK_DIST_SLOTS`` = ``slots_per_process`` (the
    self-test's slots) and one intra-op thread. The coordinator takes a
    free port unless ``port`` is given. The first rank to exit non-zero
    ends the cluster (the others are killed: none is left waiting in a
    collective); past ``timeout_s`` every rank is killed and
    ``subprocess.TimeoutExpired`` raised. Returns each rank's
    ``CompletedProcess``, stdout and stderr merged, in rank order."""
    backend = backend or default_backend(device)
    _check_backend(backend, device, n_processes)
    port = port or _free_port()
    procs, logs = [], []
    try:
        for rank in range(n_processes):
            env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                   "WORLD_SIZE": str(n_processes), "RANK": str(rank), "LOCAL_RANK": str(rank),
                   "LOCAL_WORLD_SIZE": str(n_processes), BACKEND_ENV: backend,
                   "TPU_FRAMEWORK_DIST_SLOTS": str(slots_per_process), "OMP_NUM_THREADS": "1",
                   "MKL_NUM_THREADS": "1"}
            env["PYTHONPATH"] = os.pathsep.join(p for p in (_REPO_ROOT, os.environ.get("PYTHONPATH")) if p)
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            # the cluster's own ranks, each waited on below under one deadline and killed at its end
            procs.append(subprocess.Popen(  # noqa: raw-subprocess
                [sys.executable, "-m", module, *module_args], env=env, stdout=log, stderr=subprocess.STDOUT,
                text=True, cwd=_REPO_ROOT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break  # a rank failed: the rest would wait for it in their next collective
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired([sys.executable, "-m", module, *module_args], timeout_s)
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    done = []
    for p, log in zip(procs, logs):
        log.seek(0)
        done.append(subprocess.CompletedProcess(p.args, p.returncode, stdout=log.read(), stderr=""))
        log.close()
    return done


def _selftest_main(device: str = "cuda", backend: Optional[str] = None) -> int:
    """A rank of the self-test: join the group, build the (ranks, slots)
    mesh, put each of this rank's slots' values (global slot id + 1) on its
    device, sum them in slot order, all-reduce the sum across the ranks
    and check n(n+1)/2 (the reference's parallel-against-serial check
    applied to the runtime itself)."""
    if not maybe_initialize_from_env(backend=backend, device=device):
        raise SystemExit("the self-test runs as a rank: MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK unset")
    try:
        slots = int(os.environ.get("TPU_FRAMEWORK_DIST_SLOTS", "1"))
        rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
        grid = make_multihost_mesh(slots, device=device)
        # the inner axis stays inside a process: each (dcn) row's slots have one owner
        for row in range(world):
            owners = set(grid.owners[row * slots:(row + 1) * slots]) if grid.owners else {0}
            if len(owners) != 1:
                raise SystemExit(f"the ici axis crosses processes: {owners}")
        dev = grid.devices[grid.local_slots[0]]
        local = torch.zeros((), dtype=torch.float64, device=dev)
        for i in grid.local_slots:  # slot order
            local = local + torch.tensor(float(i + 1), dtype=torch.float64, device=dev)
        wire = local.cpu() if grid.backend == "gloo" else local
        torch.distributed.all_reduce(wire)
        n = len(grid.devices)
        total, expect = float(wire), n * (n + 1) / 2
        ok = abs(total - expect) < 1e-9
        print(f"rank={rank}: processes={world} global_slots={n} slots_per_process={slots} backend={grid.backend} "
              f"device={dev} mesh={dict(zip(grid.axis_names, grid.shape))} psum={total:.1f} expect={expect:.1f} "
              f"-> {'PASSED' if ok else 'FAILED'}", flush=True)
        return 0 if ok else 1
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog=f"{__package__}.distributed", description=__doc__.splitlines()[0])
    p.add_argument("--plan", nargs="+", metavar="HOST",
                   help="print the per-host launch plan of this inventory ('user@host arch' entries) and exit")
    p.add_argument("--module", default=f"{__package__.rsplit('.', 1)[0]}.run", help="the module --plan launches")
    p.add_argument("--local-cluster", type=int, metavar="N", help="run an N-rank self-test cluster on this host")
    p.add_argument("--slots-per-process", type=int, default=2, help="each rank's shard slots in the self-test")
    p.add_argument("--backend", choices=BACKENDS, default=None,
                   help="the process group's backend (default nccl on CUDA, gloo on the CPU)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--timeout-s", type=float, default=300.0, help="with --local-cluster: the cluster's deadline")
    args = p.parse_args(argv)

    if args.plan:
        for cmd in launch_plan(ClusterConfig.parse(args.plan), args.module, backend=args.backend):
            print(cmd)
        return 0
    if args.local_cluster:
        results = launch_local(args.local_cluster, args.slots_per_process, module_args=["--device", args.device],
                               timeout_s=args.timeout_s, device=args.device, backend=args.backend)
        for r in results:
            sys.stdout.write(r.stdout)
        return max(abs(r.returncode) for r in results)
    # no orchestration flag: a rank of a cluster (what launch_local and launch_plan start)
    return _selftest_main(args.device, args.backend)


if __name__ == "__main__":
    raise SystemExit(main())
