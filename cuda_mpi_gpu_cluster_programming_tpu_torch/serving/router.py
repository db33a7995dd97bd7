"""Fleet router: the tier above N serving front ends.

The JAX package's ``serving/router.py``, copied: the same routing, health
machine, accounting and ``router_*`` journal records, so one journal routes
identically in both packages. One :class:`~.frontend.ServingFrontend`
serves one :class:`~.server.InferenceServer`; a :class:`FleetRouter`
(a standard-library ``ThreadingHTTPServer``, as the front end) speaks the
front end's wire contract northbound and proxies southbound to N backends,
each a separate OS process (``serving.fleet`` spawns them). Three rules:

- **Routing is a hash, not a choice.** A request's home backend is
  ``crc32(rid) % N``, the crc32-of-rid rule of the replay scheduler
  (``observability/replay.py``); no RNG anywhere on the routing path.
  Spillover (when the home backend is not routable, or refuses) walks the
  other backends in a class+rid-salted crc32 order, so two runs over one
  journal route byte-identically. Classes in ``no_spill_classes``
  (default: ``bulk``, whose requests are the largest and have no deadline)
  never spill: with their home backend unroutable they are counted
  ``unroutable``, a verdict of its own, never a silent drop.
- **Health is hysteretic, not a boolean.** A probe loop polls each
  backend's ``GET /healthz`` (and scrapes ``GET /metrics``, so the
  Prometheus surface stays exercised and journaled per probe) and drives a
  per-backend state machine with anti-flap rules: ``fail_k`` consecutive
  probe failures take a backend **up -> down** (journaled, with the
  detection latency); a down backend that answers again enters
  **probation** and re-admits only after ``readmit_m`` clean probes;
  ``quarantine_flaps`` heals inside ``flap_window_s`` quarantine it
  **sticky**, so a flapping host cannot oscillate the fleet. A connection
  failure on the request path is fed to the same machine as a probe
  failure, so detection never waits out the probe interval.
- **A redirect is journaled, never silent.** On 429 (backpressure), 504
  (shed) or a connection failure the router retries the request on the
  next candidate under the ``RetryPolicy`` backoff and jitter, with the
  request's own deadline as the retry budget (``Deadline.remaining`` clamps
  every pause and every hop timeout). Every hop writes a
  ``router_redirect`` record (from, to, attempt, reason); the final
  verdict writes ``router_route``. Per-class accounting closes AT THE
  ROUTER: ``ok + shed + failed + rejected + unroutable == offered``
  (:class:`RouterClassStats`).

When ``RouterConfig.fleet`` is set, the probe sweep also feeds a
:class:`~.fleet_controller.FleetController`: each probe parses the
backend's ``/healthz`` controller sub-object (ladder rung, protected burn,
intent, queue depth) into its ``BackendSlot`` and journals a
``router_probe`` record; the controller arbitrates across backends
(staggered downshift tokens, drain-vs-shed, forecast pre-actuation) and
actuates through :meth:`FleetRouter.set_drained` (drained backends keep
probing but receive no routed traffic; their home load spills) and
:meth:`FleetRouter.set_preshed` (listed classes are pre-shed at the router
with 429, counted ``rejected`` on both ledgers so accounting stays closed).

Journals: the router writes its own (``router_config``, ``router_route``,
``router_redirect``, ``router_backend_state``, ``router_probe`` and, under
fleet control, ``fleet_action`` and ``fleet_refusal``); each backend keeps
writing its own. ``observability.export.load_records`` on the shared
directory reads all of them as one record list.

Standard library only: the router is transport and policy, never compute.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlparse

from ..observability.metrics import registry as metrics_registry
from ..observability.trace import off_timed_path
from ..resilience.journal import Journal
from ..resilience.policy import Deadline, RetryPolicy
from .fleet_controller import FleetController, FleetControllerConfig
from .traffic import ClassStats, _fmt_ms

# Backend states (the elastic pool's discipline, per process instead of per
# device): routable traffic goes to UP only — a probation backend earns
# readmission through clean PROBES, not through live requests.
UP = "up"
PROBATION = "probation"
DOWN = "down"
QUARANTINED = "quarantined"
ROUTABLE = (UP,)

# Wire verdicts the router retries elsewhere (the front end's contract): queue
# backpressure, shed, and transport failure. Everything else is a
# definitive per-request verdict and forwards to the client as-is.
_RETRY_CODES = (429, 504)
_CONN_FAIL = -1  # connection refused/reset/timeout pseudo-code


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Fleet routing + hysteresis knobs. ``fail_k``/``readmit_m``/
    ``quarantine_flaps``/``flap_window_s`` mirror the elastic pool's
    ``quarantine_flaps``/``probation_steps``/``flap_window`` semantics;
    ``retry`` is the retry policy whose backoff paces redirects (its
    ``max_retries`` bounds attempts per request, the request deadline
    bounds them in time)."""

    probe_interval_s: float = 0.5
    probe_timeout_s: float = 2.0
    fail_k: int = 3
    readmit_m: int = 3
    quarantine_flaps: int = 3
    flap_window_s: float = 60.0
    retry: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(
            max_retries=4, base_delay_s=0.05, max_delay_s=0.5, jitter=0.1
        )
    )
    default_deadline_s: Optional[float] = None
    no_spill_classes: Tuple[str, ...] = ("bulk",)
    max_wait_s: float = 120.0  # per-hop response-wait cap
    journal_path: Optional[str] = None
    # Fleet control plane: when set, the probe sweep feeds a
    # FleetController that arbitrates degradation across backends.
    fleet: Optional[FleetControllerConfig] = None


def drill_config(journal_path: Optional[str], deadline_s: Optional[float] = 30.0,
                 fleet: Optional[FleetControllerConfig] = None) -> RouterConfig:
    """The drills' router (``run --serve --route``, ``BENCH_MODE=route`` and
    ``fleetcontrol``): 0.1 s probes, two misses down, two clean probes back
    up, three hops under a ``deadline_s`` request deadline (the JAX run's
    and bench's)."""
    return RouterConfig(
        probe_interval_s=0.1, probe_timeout_s=2.0, fail_k=2, readmit_m=2,
        retry=RetryPolicy(max_retries=3, base_delay_s=0.02, max_delay_s=0.25, jitter=0.1),
        default_deadline_s=deadline_s, journal_path=journal_path, fleet=fleet,
    )


@dataclasses.dataclass
class BackendSlot:
    """One backend's routing identity + health-machine state."""

    index: int
    name: str
    url: str
    state: str = UP
    consec_fail: int = 0
    clean_probes: int = 0
    flaps: List[float] = dataclasses.field(default_factory=list)
    first_fail: Optional[float] = None  # clock of the streak's first miss
    down_since: Optional[float] = None
    probation_since: Optional[float] = None
    # Fleet-drain flag: a drained backend keeps its health
    # state and keeps probing, but _pick skips it — home traffic spills
    # exactly like probation.
    drained: bool = False
    # Scraped controller state from the last successful probe (None on
    # backends without a controller).
    ctl_level: Optional[int] = None
    ctl_mode: Optional[str] = None
    ctl_burn: Optional[float] = None
    ctl_overloaded: Optional[bool] = None
    queue_depth: Optional[int] = None

    @property
    def host_port(self) -> Tuple[str, int]:
        p = urlparse(self.url)
        return p.hostname or "127.0.0.1", int(p.port or 80)


class RouterClassStats(ClassStats):
    """Per-class accounting with the router's fifth bucket: a request
    whose candidate set is empty is ``unroutable`` — refused with HTTP
    503 and counted, so the closed identity survives fleet-wide outage
    instead of leaking requests."""

    def __init__(self) -> None:
        super().__init__()
        self.unroutable = 0

    @property
    def closed(self) -> bool:
        return (
            self.ok + self.shed + self.failed + self.rejected + self.unroutable
            == self.offered
        )

    def to_obj(self) -> dict:
        obj = super().to_obj()
        obj["unroutable"] = self.unroutable
        return obj


@dataclasses.dataclass
class RouterReport:
    """Router-side closed accounting snapshot (client-side reports from
    ``http_fleet_load`` see an ``unroutable`` 503 as ``failed`` — both
    ledgers close, the router's is the attributed one)."""

    per_class: Dict[str, RouterClassStats]
    redirects: int
    backends: Dict[str, str]  # name -> state
    duration_s: float = 0.0

    def _total(self, field: str) -> int:
        return sum(getattr(c, field) for c in self.per_class.values())

    @property
    def n_offered(self) -> int:
        return self._total("offered")

    @property
    def n_unroutable(self) -> int:
        return self._total("unroutable")

    @property
    def closed(self) -> bool:
        return all(c.closed for c in self.per_class.values())

    def all_latencies(self) -> List[float]:
        out: List[float] = []
        for c in self.per_class.values():
            out.extend(c.latencies_ms)
        return out

    def summary(self) -> str:
        """Machine-parseable 'Route:' payload (run CLI contract)."""
        from .loadgen import percentile

        lat = self.all_latencies()
        states = " ".join(
            f"{n}={s}" for n, s in sorted(self.backends.items())
        )
        return (
            f"reqs={self.n_offered} ok={self._total('ok')} "
            f"shed={self._total('shed')} failed={self._total('failed')} "
            f"rejected={self._total('rejected')} "
            f"unroutable={self.n_unroutable} redirects={self.redirects} "
            f"p50_ms={_fmt_ms(percentile(lat, 50))} "
            f"p99_ms={_fmt_ms(percentile(lat, 99))} "
            f"closed={self.closed} {states}"
        )

    def class_lines(self) -> List[str]:
        out = []
        for name in sorted(self.per_class):
            c = self.per_class[name]
            out.append(
                f"Route class: name={name or 'default'} offered={c.offered} "
                f"ok={c.ok} shed={c.shed} failed={c.failed} "
                f"rejected={c.rejected} unroutable={c.unroutable}"
            )
        return out

    def to_obj(self) -> dict:
        return {
            "classes": {
                (n or "default"): c.to_obj() for n, c in self.per_class.items()
            },
            "redirects": self.redirects,
            "backends": dict(self.backends),
            "accounting_closed": self.closed,
        }


@dataclasses.dataclass
class RouteResult:
    code: int
    body: bytes
    verdict: str  # ok|shed|failed|rejected|unroutable
    backend: str  # final backend name ("" when unroutable)
    attempts: int
    redirects: int


class _RouterHandler(BaseHTTPRequestHandler):
    """One northbound HTTP exchange. ``router`` is bound per-FleetRouter
    via a subclass (the front end's extension idiom)."""

    router: "FleetRouter"  # bound in FleetRouter.__init__
    server_version = "tpu-serve-router/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:
        pass  # the journal is the access log

    def _send_json(self, code: int, payload: dict) -> None:
        self._send_raw(code, json.dumps(payload).encode())

    def _send_raw(self, code: int, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if code == 429:
            self.send_header("Retry-After", "1")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        ro = self.router
        if self.path == "/healthz":
            with ro._lock:
                states = {s.name: s.state for s in ro.slots}
            up = sum(1 for v in states.values() if v in ROUTABLE)
            self._send_json(
                200 if up else 503,
                {
                    "status": "ok" if up else "unroutable",
                    "routable": up,
                    "backends": states,
                },
            )
        elif self.path == "/stats":
            payload = ro.report().to_obj()
            if ro.fleet_controller is not None:
                payload["fleet"] = ro.fleet_controller.state_obj()
            self._send_json(200, payload)
        else:
            self._send_json(404, {"error": f"no route {self.path!r}"})

    def do_POST(self) -> None:
        if self.path != "/v1/infer":
            self._send_json(404, {"error": f"no route {self.path!r}"})
            return
        ro = self.router
        t0 = time.monotonic()
        try:
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length)
            req = json.loads(raw or b"{}")
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, KeyError) as e:
            self._send_json(
                400, {"status": "REJECTED", "error": f"bad request: {e}"}
            )
            ro._finish("", "", t0, "rejected", 400, "", 0, 0, 0)
            return
        rid = str(req.get("rid") or "")
        if not rid:
            # Routing needs a rid (it IS the hash key); assign a
            # sequential one and re-encode so backend journals carry it.
            rid = ro._next_rid()
            req["rid"] = rid
            raw = json.dumps(req).encode()
        cls = str(req.get("class", ""))
        try:
            deadline_s = float(req["deadline_s"]) if req.get("deadline_s") else None
        except (TypeError, ValueError):
            deadline_s = None  # backend 400s the malformed body
        shape = req.get("shape")
        n_images = (
            int(shape[0]) if isinstance(shape, list) and len(shape) == 4 else 1
        )
        res = ro.route(rid, cls, deadline_s, raw)
        self._send_raw(res.code, res.body)
        ro._finish(
            rid, cls, t0, res.verdict, res.code, res.backend,
            res.attempts, res.redirects, n_images if res.verdict == "ok" else 0,
        )


class FleetRouter:
    """Deterministic consistent-hash router over N backend front ends.

    ``backends`` is the stable-order url list (position = routing
    index — restarts swap a slot's url via :meth:`replace_backend`,
    never its position, so the hash ring is stable across host loss).
    ``clock`` is injectable so the flap-window hysteresis is testable
    without real waiting; tests drive :meth:`probe_once` directly with
    ``probe_interval_s=0`` (no probe thread).
    """

    def __init__(
        self,
        backends: Sequence[str],
        cfg: RouterConfig = RouterConfig(),
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        clock=time.monotonic,
    ):
        if not backends:
            raise ValueError("FleetRouter needs at least one backend url")
        self.cfg = cfg
        self._clock = clock
        self._t0 = clock()
        self.journal = (
            Journal(cfg.journal_path) if cfg.journal_path else None
        )
        self.slots = [
            BackendSlot(i, f"b{i}", url) for i, url in enumerate(backends)
        ]
        self._lock = threading.Lock()
        self.stats: Dict[str, RouterClassStats] = {}
        self.redirects = 0
        self.http_codes: Dict[int, int] = {}
        self._seq = 0
        self._started_at = clock()
        handler = type("BoundRouterHandler", (_RouterHandler,), {"router": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # Fleet control plane: evaluated from probe_once, owns
        # no thread. Classes in _preshed are refused 429 at the router
        # (tuple assignment is atomic — read lock-free on the hot path).
        self._preshed: Tuple[str, ...] = ()
        self.fleet_controller: Optional[FleetController] = None
        if cfg.fleet is not None:
            fc = (
                cfg.fleet
                if isinstance(cfg.fleet, FleetControllerConfig)
                else FleetControllerConfig.from_obj(dict(cfg.fleet))
            )
            self.fleet_controller = FleetController(self, fc)
        self._journal_append(
            "router_config",
            key="router",
            n_backends=len(self.slots),
            backends=[{"name": s.name, "url": s.url} for s in self.slots],
            fail_k=cfg.fail_k,
            readmit_m=cfg.readmit_m,
            quarantine_flaps=cfg.quarantine_flaps,
            flap_window_s=cfg.flap_window_s,
            probe_interval_s=cfg.probe_interval_s,
            retry=dataclasses.asdict(cfg.retry),
            no_spill_classes=list(cfg.no_spill_classes),
            t_ms=self._t_ms(),
            **(
                {"fleet": self.fleet_controller.cfg.to_obj()}
                if self.fleet_controller is not None
                else {}
            ),
        )

    # ------------------------------------------------------------ lifecycle

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "FleetRouter":
        if self._thread is not None:
            raise RuntimeError("router already started")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-router", daemon=True
        )
        self._thread.start()
        if self.cfg.probe_interval_s > 0:
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="router-probe", daemon=True
            )
            self._probe_thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(10.0)
        if self._probe_thread is not None:
            self._probe_thread.join(10.0)
            self._probe_thread = None
        self._thread = None

    def _t_ms(self) -> float:
        return round((self._clock() - self._t0) * 1e3, 3)

    def _next_rid(self) -> str:
        with self._lock:
            self._seq += 1
            return f"rt{self._seq:06d}"

    def _journal_append(self, kind: str, **payload) -> None:
        if self.journal is not None:
            self.journal.append(kind, **payload)

    # -------------------------------------------------------------- probing

    def _probe_loop(self) -> None:
        while not self._stop_evt.wait(self.cfg.probe_interval_s):
            self.probe_once()

    def probe_once(self) -> None:
        """One synchronous sweep over all backends (the probe thread's
        body; tests call it directly to step the machine without a
        clock)."""
        for slot in self.slots:
            if slot.state == QUARANTINED:
                continue  # sticky: a quarantined host needs an operator
            ok, ms, why, scrape = self._probe(slot)
            self._note_probe(slot, ok, ms, why)
            self._note_scrape(slot, ok, ms, scrape)
        if self.fleet_controller is not None:
            self.fleet_controller.evaluate(self._clock())

    def _probe(
        self, slot: BackendSlot
    ) -> Tuple[bool, float, str, Optional[dict]]:
        host, port = slot.host_port
        t0 = time.monotonic()
        try:
            conn = http.client.HTTPConnection(
                host, port, timeout=self.cfg.probe_timeout_s
            )
            try:
                conn.request("GET", "/healthz")
                # The probe MEASURES backend responsiveness around its own
                # socket wait — blocking here is the health signal.
                resp = conn.getresponse()  # noqa: blocking-socket-call-in-timed-region
                body = json.loads(resp.read() or b"{}")
                if resp.status != 200 or body.get("status") != "ok":
                    return False, (time.monotonic() - t0) * 1e3, (
                        f"healthz:{resp.status}"
                    ), None
                # The metrics scrape rides every probe: the Prometheus
                # surface stays exercised (and journaled backend-side as a
                # serve_transport record) and a wedged exporter is a
                # health failure, not a monitoring gap.
                conn.request("GET", "/metrics")
                m = conn.getresponse()  # noqa: blocking-socket-call-in-timed-region
                m.read()
                if m.status != 200:
                    return False, (time.monotonic() - t0) * 1e3, (
                        f"metrics:{m.status}"
                    ), None
            finally:
                conn.close()
        except (OSError, http.client.HTTPException, ValueError) as e:
            return False, (time.monotonic() - t0) * 1e3, (
                f"conn:{type(e).__name__}"
            ), None
        return True, (time.monotonic() - t0) * 1e3, "", body

    def _note_probe(
        self, slot: BackendSlot, ok: bool, ms: float, why: str
    ) -> None:
        """Advance one backend's state machine on a probe verdict (also
        fed by request-path connection failures — detection must not
        wait out the probe interval). Transitions journal
        ``router_backend_state``; the rules mirror the elastic pool:
        ``fail_k`` misses down a backend, a heal enters probation (and
        counts a flap — ``quarantine_flaps`` inside ``flap_window_s``
        quarantine it sticky), ``readmit_m`` clean probes re-admit."""
        now = self._clock()
        event = None  # (frm, to, reason, extra) journaled outside the lock
        with self._lock:
            if slot.state == QUARANTINED:
                return
            if ok:
                slot.consec_fail, slot.first_fail = 0, None
                if slot.state == DOWN:
                    slot.flaps = [
                        t
                        for t in slot.flaps
                        if now - t <= self.cfg.flap_window_s
                    ]
                    slot.flaps.append(now)
                    if len(slot.flaps) >= self.cfg.quarantine_flaps:
                        slot.state = QUARANTINED
                        event = (
                            DOWN, QUARANTINED, "flap",
                            {
                                "flaps": len(slot.flaps),
                                "window_s": self.cfg.flap_window_s,
                            },
                        )
                    else:
                        slot.state = PROBATION
                        slot.clean_probes = 0
                        slot.probation_since = now
                        event = (
                            DOWN, PROBATION, "heal",
                            {"probes_needed": self.cfg.readmit_m},
                        )
                elif slot.state == PROBATION:
                    slot.clean_probes += 1
                    if slot.clean_probes >= self.cfg.readmit_m:
                        slot.state = UP
                        prob_ms = (now - (slot.probation_since or now)) * 1e3
                        down_ms = (now - (slot.down_since or now)) * 1e3
                        slot.down_since = slot.probation_since = None
                        event = (
                            PROBATION, UP, "readmit",
                            {
                                "clean_probes": slot.clean_probes,
                                "probation_ms": round(prob_ms, 3),
                                "down_ms": round(down_ms, 3),
                            },
                        )
            else:
                slot.consec_fail += 1
                if slot.first_fail is None:
                    slot.first_fail = now
                if slot.state == PROBATION:
                    # A miss during probation resets the clean streak and
                    # sends the backend back down — the original
                    # down_since survives, so the incident wall covers
                    # the whole outage, not the last bounce.
                    slot.state = DOWN
                    slot.clean_probes = 0
                    event = (PROBATION, DOWN, why or "probe_failed", {})
                elif (
                    slot.state == UP
                    and slot.consec_fail >= self.cfg.fail_k
                ):
                    slot.state = DOWN
                    slot.down_since = slot.first_fail
                    detect_ms = (now - slot.first_fail) * 1e3
                    event = (
                        UP, DOWN, why or "probe_failed",
                        {
                            "consec_fail": slot.consec_fail,
                            "detect_ms": round(detect_ms, 3),
                        },
                    )
        if event is not None:
            frm, to, reason, extra = event
            self._journal_state(slot, frm, to, reason, probe_ms=round(ms, 3), **extra)

    @off_timed_path
    def _journal_state(
        self, slot: BackendSlot, frm: str, to: str, reason: str, **extra
    ) -> None:
        metrics_registry().counter(f"router.backend_{to}").inc()
        self._journal_append(
            "router_backend_state",
            key=f"{slot.name}:{to}",
            backend=slot.name,
            url=slot.url,
            frm=frm,
            to=to,
            reason=reason,
            t_ms=self._t_ms(),
            **extra,
        )

    def _note_scrape(
        self, slot: BackendSlot, ok: bool, ms: float, scrape: Optional[dict]
    ) -> None:
        """Fold one successful probe's scraped ``/healthz`` payload into
        the slot: the controller sub-object (ladder rung,
        protected burn, intent) and queue depth become the fleet
        controller's evidence, and every scrape journals a
        ``router_probe`` record. Backends without a controller scrape to
        None fields; the record still carries the queue depth."""
        if not ok:
            return  # the failed probe already journaled its transition
        scrape = scrape or {}
        q = scrape.get("queue")
        ctl = scrape.get("controller")
        with self._lock:
            depth = (q or {}).get("depth")
            slot.queue_depth = depth if isinstance(depth, int) else None
            if isinstance(ctl, dict):
                slot.ctl_level = int(ctl.get("level") or 0)
                slot.ctl_mode = str(ctl.get("mode") or "") or None
                intent = ctl.get("intent")
                if isinstance(intent, dict):
                    burn = intent.get("burn")
                    slot.ctl_burn = (
                        float(burn) if isinstance(burn, (int, float)) else None
                    )
                    slot.ctl_overloaded = bool(intent.get("overloaded"))
                else:
                    slot.ctl_burn = None
                    slot.ctl_overloaded = None
            else:
                slot.ctl_level = None
                slot.ctl_mode = None
                slot.ctl_burn = None
                slot.ctl_overloaded = None
        self._journal_probe(slot, ms)

    @off_timed_path
    def _journal_probe(self, slot: BackendSlot, ms: float) -> None:
        self._journal_append(
            "router_probe",
            key=f"probe:{slot.name}",
            backend=slot.name,
            state=slot.state,
            drained=slot.drained,
            level=slot.ctl_level,
            mode=slot.ctl_mode,
            burn=slot.ctl_burn,
            overloaded=slot.ctl_overloaded,
            depth=slot.queue_depth,
            probe_ms=round(ms, 3),
            t_ms=self._t_ms(),
        )

    def set_drained(self, index: int, drained: bool) -> None:
        """Fleet-drain hook: a drained backend keeps its
        health state and keeps probing but receives no routed traffic —
        home load spills exactly like probation. The FleetController's
        ``fleet_action`` record IS the journal entry; this just flips
        the flag."""
        with self._lock:
            self.slots[index].drained = bool(drained)
        metrics_registry().counter(
            "router.drain" if drained else "router.drain_release"
        ).inc()

    def set_preshed(self, classes: Sequence[str]) -> None:
        """Fleet pre-shed hook: listed classes are refused
        429 at the router before any forwarding — counted ``rejected``
        on both the router and client ledgers, so accounting stays
        closed while the fleet keeps its capacity for protected
        traffic."""
        self._preshed = tuple(classes)

    def replace_backend(self, index: int, url: str) -> None:
        """Point a slot at a restarted backend's new endpoint. The slot
        keeps its position (the hash ring is stable) and its state — a
        restarted host still re-admits through probation, never
        straight to UP."""
        with self._lock:
            slot = self.slots[index]
            old, slot.url = slot.url, url
        self._journal_append(
            "router_backend_state",
            key=f"{slot.name}:replace",
            backend=slot.name,
            url=url,
            frm=slot.state,
            to=slot.state,
            reason="endpoint_replaced",
            old_url=old,
            t_ms=self._t_ms(),
        )

    def backend_states(self) -> Dict[str, str]:
        with self._lock:
            return {s.name: s.state for s in self.slots}

    # -------------------------------------------------------------- routing

    def home(self, rid: str) -> int:
        return zlib.crc32(rid.encode()) % len(self.slots)

    def candidates(self, rid: str, cls: str) -> List[int]:
        """Deterministic candidate order: the crc32 home first, then —
        for classes allowed to spill — the rest in a class+rid-salted
        crc32 order. Pure function of (rid, cls, N): replayable."""
        home = self.home(rid)
        order = [home]
        if cls not in self.cfg.no_spill_classes:
            order.extend(
                sorted(
                    (i for i in range(len(self.slots)) if i != home),
                    key=lambda i: zlib.crc32(f"{cls}:{rid}:{i}".encode()),
                )
            )
        return order

    def _pick(self, order: List[int], avoid: Optional[int]) -> Optional[int]:
        with self._lock:
            for i in order:
                if (
                    i != avoid
                    and self.slots[i].state in ROUTABLE
                    and not self.slots[i].drained
                ):
                    return i
            # The backend that just refused may be the only routable one
            # left — backpressure clears, so retrying it beats giving up.
            if (
                avoid is not None
                and avoid in order
                and self.slots[avoid].state in ROUTABLE
                and not self.slots[avoid].drained
            ):
                return avoid
        return None

    def _forward(
        self, slot: BackendSlot, body: bytes, dl: Deadline
    ) -> Tuple[int, bytes, str]:
        host, port = slot.host_port
        timeout = max(0.05, dl.remaining(self.cfg.max_wait_s))
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            conn.request(
                "POST", "/v1/infer", body, {"Content-Type": "application/json"}
            )
            # The hop wait IS the redirect budget being spent — blocking
            # here is the mechanism, clamped by the request deadline.
            resp = conn.getresponse()  # noqa: blocking-socket-call-in-timed-region
            data = resp.read()
            return resp.status, data, f"http_{resp.status}"
        except (OSError, http.client.HTTPException) as e:
            return _CONN_FAIL, b"", f"conn:{type(e).__name__}"
        finally:
            conn.close()

    def route(
        self, rid: str, cls: str, deadline_s: Optional[float], body: bytes
    ) -> RouteResult:
        """Forward one request: home backend first, then redirect on
        429/504/connection-failure through the candidate walk under the
        RetryPolicy's backoff, the request's resolved deadline bounding
        both pauses and hop timeouts. Every hop is journaled."""
        if cls in self._preshed:
            # Fleet pre-shed: refused before any forwarding,
            # counted rejected on both ledgers (http_fleet_load maps 429
            # to rejected) — the closed identity survives pre-actuation.
            body_out = json.dumps(
                {
                    "rid": rid,
                    "status": "REJECTED",
                    "class": cls,
                    "reason": "fleet_preshed",
                    "error": "class pre-shed by fleet controller",
                }
            ).encode()
            return RouteResult(429, body_out, "rejected", "", 0, 0)
        dl = Deadline.after(
            deadline_s if deadline_s is not None else self.cfg.default_deadline_s
        )
        order = self.candidates(rid, cls)
        max_attempts = self.cfg.retry.max_retries + 1
        attempt = 0
        redirects = 0
        last_code: Optional[int] = None
        last_body = b""
        last_reason = ""
        last_idx: Optional[int] = None
        while attempt < max_attempts and not dl.expired:
            idx = self._pick(order, avoid=last_idx)
            if idx is None:
                break  # nothing routable right now
            slot = self.slots[idx]
            if last_idx is not None:
                redirects += 1
                self._journal_redirect(
                    rid, self.slots[last_idx].name, slot.name,
                    attempt, last_reason,
                )
                pause = min(
                    self.cfg.retry.delay_s(attempt),
                    dl.remaining(self.cfg.retry.max_delay_s),
                )
                if pause > 0:
                    time.sleep(pause)
            attempt += 1
            code, rbody, reason = self._forward(slot, body, dl)
            last_idx = idx
            if code == _CONN_FAIL:
                # Feed the request-path failure to the health machine —
                # a dead host is detected by the traffic it kills, not
                # just by the next probe tick.
                self._note_probe(slot, False, 0.0, reason)
            if code == 200:
                return RouteResult(200, rbody, "ok", slot.name, attempt, redirects)
            if code not in _RETRY_CODES and code != _CONN_FAIL:
                verdict = "rejected" if code in (400, 413) else "failed"
                return RouteResult(
                    code, rbody, verdict, slot.name, attempt, redirects
                )
            last_code, last_body, last_reason = code, rbody, reason
        if last_code is None:
            # Never forwarded anywhere: the candidate set held no
            # routable backend — the router's own attributable verdict.
            body_out = json.dumps(
                {
                    "rid": rid,
                    "status": "UNROUTABLE",
                    "class": cls,
                    "error": "no routable backend",
                }
            ).encode()
            return RouteResult(503, body_out, "unroutable", "", attempt, redirects)
        # Budget exhausted on a retryable verdict: the client sees the
        # last real backend answer (429/504), or 502 for a connection
        # failure — attributed, never silent.
        if last_code == _CONN_FAIL:
            body_out = json.dumps(
                {
                    "rid": rid,
                    "status": "FAILED",
                    "class": cls,
                    "reason": "backend_down",
                    "error": f"backend unreachable after {attempt} attempts",
                }
            ).encode()
            return RouteResult(
                502, body_out, "failed",
                self.slots[last_idx].name if last_idx is not None else "",
                attempt, redirects,
            )
        verdict = "rejected" if last_code == 429 else "shed"
        return RouteResult(
            last_code, last_body, verdict,
            self.slots[last_idx].name if last_idx is not None else "",
            attempt, redirects,
        )

    @off_timed_path
    def _journal_redirect(
        self, rid: str, frm: str, to: str, attempt: int, reason: str
    ) -> None:
        metrics_registry().counter("router.redirects").inc()
        self._journal_append(
            "router_redirect",
            key=f"redirect:{rid}",
            rid=rid,
            frm=frm,
            to=to,
            attempt=attempt,
            reason=reason,
            t_ms=self._t_ms(),
        )

    # ----------------------------------------------------------- accounting

    @off_timed_path
    def _finish(
        self,
        rid: str,
        cls: str,
        t0: float,
        verdict: str,
        code: int,
        backend: str,
        attempts: int,
        redirects: int,
        n_images: int,
    ) -> None:
        """Close one request's ledger AFTER the response hit the socket:
        per-class closed accounting, metrics, and the ``router_route``
        verdict record."""
        t1 = time.monotonic()
        ms = (t1 - t0) * 1e3
        with self._lock:
            self.http_codes[code] = self.http_codes.get(code, 0) + 1
            st = self.stats.setdefault(cls, RouterClassStats())
            st.offered += 1
            if verdict == "ok":
                st.ok += 1
                st.images_ok += n_images
                st.latencies_ms.append(ms)
            elif verdict == "shed":
                st.shed += 1
            elif verdict == "rejected":
                st.rejected += 1
            elif verdict == "unroutable":
                st.unroutable += 1
            else:
                st.failed += 1
            self.redirects += redirects
        reg = metrics_registry()
        reg.counter(f"router.http_{code}").inc()
        reg.histogram("router.transport_ms").observe(ms)
        if verdict == "unroutable":
            reg.counter("router.unroutable").inc()
        self._journal_append(
            "router_route",
            key=f"route:{rid or code}",
            rid=rid,
            cls=cls,
            verdict=verdict,
            backend=backend,
            attempts=attempts,
            redirects=redirects,
            http=code,
            ms=round(ms, 3),
            t_ms=self._t_ms(),
        )

    def report(self) -> RouterReport:
        with self._lock:
            per_class: Dict[str, RouterClassStats] = {}
            for name, st in self.stats.items():
                c = RouterClassStats()
                c.offered, c.ok, c.shed = st.offered, st.ok, st.shed
                c.failed, c.rejected = st.failed, st.rejected
                c.unroutable, c.images_ok = st.unroutable, st.images_ok
                c.latencies_ms = list(st.latencies_ms)
                per_class[name] = c
            return RouterReport(
                per_class=per_class,
                redirects=self.redirects,
                backends={s.name: s.state for s in self.slots},
                duration_s=self._clock() - self._started_at,
            )
