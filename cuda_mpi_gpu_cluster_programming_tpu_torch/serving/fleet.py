"""Backend fleet: N serving processes behind one FleetRouter.

The JAX package's ``serving/fleet.py``. Each backend is a real OS process
(``python -m cuda_mpi_gpu_cluster_programming_tpu_torch.serving.fleet
--child ...``, a fresh interpreter, never a fork of a parent that already
holds a CUDA context) that builds its own
:class:`~.server.InferenceServer` and :class:`~.frontend.ServingFrontend`
on an ephemeral port, captures every bucket's CUDA graph (the server's
warmup), and only then announces itself with one machine-parsed line::

    FLEET_READY name=b0 port=41231

so the router never proxies to a backend that is still capturing, and host
loss is a process fault: the ``host_loss`` chaos site SIGKILLs a backend
mid-load, across a process boundary.

On the card backend ``i`` sees one card, visible card ``i % count`` of the
parent's (``CUDA_VISIBLE_DEVICES``), and runs on ``device`` there: on a
host with several cards each backend has one of its own; on one card the N
CUDA contexts share it, and the CUDA driver time-slices their kernels. Before spawning a fleet
on the card, :meth:`BackendFleet.start` loads the kernel library in the
parent (``ops._build``), so the children find it built and none runs
``nvcc``. The children start together and are awaited together, so the
fleet's bring-up costs one backend's start, not N.

Each backend writes its own journal (``<journal_dir>/backend_<i>.jsonl``)
beside the router's (``<journal_dir>/router.jsonl``);
``observability.export.load_records`` on the directory reads them all.

The parent-side :class:`BackendFleet` spawns, kills and restarts children:
``kill(i)`` is SIGKILL then ``wait()`` (host loss: no goodbye; the victim
is reaped, so the CUDA driver has reclaimed its context before a replacement
starts), ``restart(i)`` spawns the slot again on a NEW ephemeral port (a
replacement host) and returns the url for
:meth:`~.router.FleetRouter.replace_backend`: the slot's hash-ring position
never moves, and the restarted backend still re-admits through the
router's probation.

:func:`maybe_host_loss` is the chaos consumer: the seeded ``host_loss``
site picks its victim as ``seed % n``, deterministic per spec.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from ..resilience import chaos

READY_PREFIX = "FLEET_READY"
_PKG_ROOT = Path(__file__).resolve().parents[2]  # the repository root (the package's parent)


class FleetError(RuntimeError):
    pass


class BackendProc:
    """One spawned backend: process handle, announced endpoint, and the
    wall seconds from spawn to its ready line."""

    def __init__(self, index: int, proc: subprocess.Popen, port: int, journal_path: str, spawn_s: float):
        self.index = index
        self.name = f"b{index}"
        self.proc = proc
        self.port = port
        self.journal_path = journal_path
        self.spawn_s = spawn_s

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None


def _read_ready(proc: subprocess.Popen, timeout_s: float) -> int:
    """Scan the child's stdout for the READY line (bounded: a backend that
    never comes up is a spawn failure, not a hang). The scan runs in a
    helper thread so a wedged child cannot block the launcher past its
    deadline; after the READY line the thread keeps draining the child's
    output, so a chatty child never blocks on a full pipe."""
    found: List[int] = []
    err: List[str] = []
    ready = threading.Event()

    def _scan() -> None:
        tail: List[str] = []
        for line in proc.stdout:  # type: ignore[union-attr]
            if ready.is_set():
                continue  # drain
            tail.append(line.rstrip()[-200:])
            if line.startswith(READY_PREFIX):
                for tok in line.split():
                    if tok.startswith("port="):
                        found.append(int(tok[5:]))
                        ready.set()
        err.append("; ".join(tail[-5:]))
        ready.set()

    threading.Thread(target=_scan, daemon=True).start()
    ready.wait(timeout_s)
    if not found:
        proc.kill()
        proc.wait(10.0)
        tail = err[0] if err else "no output"
        raise FleetError(
            f"backend never announced {READY_PREFIX} within {timeout_s}s (rc={proc.poll()}, tail: {tail})"
        )
    return found[0]


class BackendFleet:
    """Spawn and manage N backend serving processes on ``device``.

    ``journal_dir`` receives one ``backend_<i>.jsonl`` per backend (callers
    point the router's journal there too). Children inherit the environment
    with the repository root on ``PYTHONPATH``, so the fleet spawns from any
    working directory, and without ``CHAOS_SPEC``: the parent owns the
    ``host_loss`` budget, and a child drawing it again would fire twice.
    """

    def __init__(
        self,
        n: int,
        journal_dir,
        *,
        height: int = 63,
        width: int = 63,
        max_batch: int = 4,
        config: str = "v1_jit",
        slo: bool = True,
        slo_scale: float = 1.0,
        spawn_timeout_s: float = 240.0,
        env: Optional[Dict[str, str]] = None,
        controller=None,
        device: str = "cuda",
    ):
        if n < 1:
            raise ValueError("fleet needs n >= 1 backends")
        self.n = n
        self.journal_dir = Path(journal_dir)
        self.height, self.width = height, width
        self.max_batch, self.config, self.slo = max_batch, config, slo
        # Scales every class latency budget and deadline in the children
        # (SLOPolicy.scaled): the fleet pressure drill tightens SLOs so a
        # short swell burns measurably.
        self.slo_scale = slo_scale
        self.spawn_timeout_s = spawn_timeout_s
        self._extra_env = dict(env or {})
        # Optional ControllerConfig (or its to_obj dict): every child runs a
        # serving controller, for the fleet controller to arbitrate across.
        self.controller = controller
        self.device = device
        self.backends: List[Optional[BackendProc]] = [None] * n

    def _command(self, index: int, jpath: str) -> List[str]:
        cmd = [
            sys.executable, "-m", f"{__package__}.fleet",
            "--child", "--name", f"b{index}",
            "--config", self.config,
            "--height", str(self.height), "--width", str(self.width),
            "--max-batch", str(self.max_batch),
            "--journal", jpath, "--port", "0",
            "--device", self.device,
        ]
        if self.slo:
            cmd.append("--slo")
            if self.slo_scale != 1.0:
                cmd.extend(["--slo-scale", repr(self.slo_scale)])
        if self.controller is not None:
            obj = self.controller if isinstance(self.controller, dict) else self.controller.to_obj()
            cmd.extend(["--controller", json.dumps(obj)])
        return cmd

    def visible_card(self, index: int) -> Optional[str]:
        """Backend ``index``'s ``CUDA_VISIBLE_DEVICES``: the parent's visible
        card ``index % count`` (None on the CPU or without a card)."""
        import torch

        if self.device == "cpu" or not torch.cuda.is_available():
            return None
        visible = [c.strip() for c in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",") if c.strip()]
        count = torch.cuda.device_count()
        return visible[index % len(visible)] if visible else str(index % count)

    def _launch(self, index: int):
        jpath = str(self.journal_dir / f"backend_{index}.jsonl")
        env = {**os.environ, **self._extra_env}
        card = self.visible_card(index)
        if card is not None:
            env["CUDA_VISIBLE_DEVICES"] = card
        env["PYTHONPATH"] = (str(_PKG_ROOT) + os.pathsep + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
        env.pop(chaos.CHAOS_ENV, None)
        t0 = time.monotonic()
        proc = subprocess.Popen(
            self._command(index, jpath), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        return proc, jpath, t0

    def _await(self, index: int, proc: subprocess.Popen, jpath: str, t0: float) -> BackendProc:
        port = _read_ready(proc, self.spawn_timeout_s)
        b = BackendProc(index, proc, port, jpath, time.monotonic() - t0)
        print(f"fleet: {b.name} pid={b.pid} port={port} ready in {b.spawn_s:.2f} s", file=sys.stderr, flush=True)
        return b

    def _spawn(self, index: int) -> BackendProc:
        return self._await(index, *self._launch(index))

    def _load_kernels(self) -> None:
        """The kernel library, loaded here before any child starts: a child
        then finds it built (``ops._build``'s cache) and runs no ``nvcc``."""
        from ..configs import REGISTRY, resolve_device

        if resolve_device(self.device).type == "cuda" and REGISTRY[self.config].tier == "kernels":
            from ..ops import _build

            _build.library()

    def start(self) -> "BackendFleet":
        self.journal_dir.mkdir(parents=True, exist_ok=True)
        self._load_kernels()
        launched = [self._launch(i) for i in range(self.n)]  # they build and capture concurrently
        try:
            for i, (proc, jpath, t0) in enumerate(launched):
                self.backends[i] = self._await(i, proc, jpath, t0)
        except BaseException:
            for proc, _, _ in launched:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(10.0)
            raise
        return self

    def urls(self) -> List[str]:
        out = []
        for b in self.backends:
            if b is None:
                raise FleetError("fleet not started")
            out.append(b.url)
        return out

    def kill(self, index: int) -> None:
        """SIGKILL, then reap: host loss, no drain, no goodbye. The router
        finds out as production does: requests die and probes miss."""
        b = self.backends[index]
        if b is not None:
            b.proc.kill()
            b.proc.wait(10.0)

    def restart(self, index: int) -> str:
        """Spawn a dead slot again on a new ephemeral port (a replacement
        host keeps the slot's ring position, not its address). Returns the
        new url for ``FleetRouter.replace_backend``."""
        old = self.backends[index]
        if old is not None and old.alive:
            raise FleetError(f"backend {index} still alive; kill it first")
        self.backends[index] = self._spawn(index)
        return self.backends[index].url

    def stop(self) -> None:
        for b in self.backends:
            if b is not None and b.alive:
                b.proc.terminate()
        for b in self.backends:
            if b is None:
                continue
            try:
                b.proc.wait(10.0)
            except subprocess.TimeoutExpired:
                b.proc.kill()
                b.proc.wait(10.0)


def maybe_host_loss(fleet: BackendFleet) -> Optional[int]:
    """Fire the seeded ``host_loss`` chaos site if armed: SIGKILL one
    backend chosen as ``seed % n`` (deterministic per ``CHAOS_SPEC``, as
    every other site). Returns the killed index, or None when the site did
    not fire."""
    ch = chaos.active()
    if ch is None or not ch.draw("host_loss"):
        return None
    idx = ch.spec.seed % fleet.n
    fleet.kill(idx)
    return idx


# ------------------------------------------------------------ child entry


def _child_main(argv: List[str]) -> int:
    """One backend process: InferenceServer (every bucket captured) and
    ServingFrontend on an ephemeral port, the READY line on stdout, then
    park until killed."""
    import argparse
    import dataclasses

    ap = argparse.ArgumentParser(prog="serving.fleet --child")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--name", default="b0")
    ap.add_argument("--config", default="v1_jit")
    ap.add_argument("--height", type=int, default=63)
    ap.add_argument("--width", type=int, default=63)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--journal", default="")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--slo", action="store_true")
    ap.add_argument("--slo-scale", type=float, default=1.0)
    ap.add_argument("--controller", default="")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    from ..models.alexnet import BLOCKS12
    from .frontend import ServingFrontend
    from .server import InferenceServer, ServeConfig

    model_cfg = dataclasses.replace(BLOCKS12, in_height=args.height, in_width=args.width)
    slo = None
    if args.slo:
        from .batcher import power_of_two_buckets
        from .traffic import default_class_mix, slo_policy

        slo = slo_policy(default_class_mix(power_of_two_buckets(args.max_batch)))
        if args.slo_scale != 1.0:
            slo = slo.scaled(args.slo_scale)
    srv = InferenceServer(ServeConfig(
        config=args.config,
        max_batch=args.max_batch,
        model_cfg=model_cfg,
        journal_path=args.journal,
        slo=slo,
        controller=json.loads(args.controller) if args.controller else None,
        device=args.device,
    ))
    srv.start()  # builds the forward and captures every bucket before the READY line
    fe = ServingFrontend(srv, port=args.port).start()
    print(f"{READY_PREFIX} name={args.name} port={fe.port}", flush=True)
    try:
        while True:  # host loss is SIGKILL; an orderly stop is SIGTERM
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        fe.stop()
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(_child_main(sys.argv[1:]))
