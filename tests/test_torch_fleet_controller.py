"""The port's fleet control plane against the JAX package's, on the CPU.

The injected-clock tests of the JAX ``tests/test_fleet_controller.py``
against the port's ``serving/fleet_controller.py`` over stub backends whose
``/healthz`` carries a programmable serving-controller sub-object: the
diurnal fit, the pressure shape and its chaos site, the probe scrape into
the router's slots, the staggered downshift tokens, the drain and LIFO
readmit machine, the forecast pre-shed and its release, the calm trace with
zero actions, the ``fleet_summary`` fold and the config round trip. Then
the two packages side by side: ``fit_diurnal`` on the same seeded samples
within 1e-12, the same scripted probe trail through both controllers
journaling the same actions and refusals (``t_ms`` aside), and
``fleet_summary`` of one record list equal. The A/B drill over real
backend processes (``BENCH_MODE=fleetcontrol``) is marked ``slow``, as the
JAX package marks its own: it runs two fleets through an 8 s swell each.
"""

import json
import math
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from cuda_mpi_gpu_cluster_programming_tpu.observability import health as jhealth
from cuda_mpi_gpu_cluster_programming_tpu.resilience.policy import RetryPolicy as JRetryPolicy
from cuda_mpi_gpu_cluster_programming_tpu.serving import fleet_controller as jfc
from cuda_mpi_gpu_cluster_programming_tpu.serving import router as jrouter
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.export import load_records
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.health import FLEET_DRAIN_PHASES, fleet_summary
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.metrics import registry as metrics_registry
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import chaos
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.policy import RetryPolicy
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving import fleet_controller as tfc
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving import router as trouter
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.fleet_controller import (
    FleetController,
    FleetControllerConfig,
    fit_diurnal,
    predict_rate,
)
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.loadgen import correlated_pressure, maybe_fleet_pressure
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.router import UP
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.traffic import shaped_arrivals

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_process_state(monkeypatch):
    monkeypatch.delenv(chaos.CHAOS_ENV, raising=False)
    chaos.reset()
    metrics_registry().reset()
    yield
    chaos.reset()


# ------------------------------------------------------------- stubs ---


class _CtlStubHandler(BaseHTTPRequestHandler):
    backend: "CtlStub"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _send(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        b = self.backend
        if self.path == "/healthz":
            payload = {"status": "ok", "queue": {"depth": b.depth}}
            if b.ctl is not None:
                payload["controller"] = b.ctl
            self._send(200, payload)
        elif self.path == "/metrics":
            body = b"# TYPE serve_ok counter\nserve_ok 0\n"
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send(404, {"error": "no route"})

    def do_POST(self):
        b = self.backend
        length = int(self.headers.get("Content-Length") or 0)
        req = json.loads(self.rfile.read(length) or b"{}")
        b.hits.append(str(req.get("rid", "")))
        self._send(200, {"rid": req.get("rid"), "status": "OK", "latency_ms": 1.0})


class CtlStub:
    """A stub backend whose ``/healthz`` carries a programmable serving
    controller sub-object: tests set ``ctl`` and ``depth`` and the next
    probe sweep sees exactly that fleet view."""

    def __init__(self):
        self.ctl = None  # None = a backend without a controller
        self.depth = 0
        self.hits = []
        handler = type("BoundCtlStub", (_CtlStubHandler,), {"backend": self})
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"

    def set_ctl(self, level=0, mode="steady", burn=0.0, overloaded=False):
        self.ctl = {"level": level, "mode": mode, "intent": {"burn": burn, "overloaded": overloaded}}

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(5.0)


@pytest.fixture
def ctl_trio():
    backends = [CtlStub() for _ in range(3)]
    yield backends
    for b in backends:
        b.stop()


def _router(urls, tmp_path=None, pkg=trouter, **kw):
    retry = RetryPolicy if pkg is trouter else JRetryPolicy
    kw.setdefault("probe_interval_s", 0)
    kw.setdefault("retry", retry(max_retries=3, base_delay_s=0.01, max_delay_s=0.05, jitter=0.0))
    if tmp_path is not None:
        kw.setdefault("journal_path", str(tmp_path / "router.jsonl"))
    return pkg.FleetRouter(urls, pkg.RouterConfig(**kw))


def _close(router):
    router.stop()
    router._httpd.server_close()


def _records(tmp_path, *kinds):
    recs = Journal.load(tmp_path / "router.jsonl")
    if not kinds:
        return recs
    return [r for r in recs if r["kind"] in kinds]


def _fleet_cfg(**kw):
    """A short-cadence fleet config: evaluate every sweep, no forecast
    unless the test arms it."""
    kw.setdefault("eval_s", 0.0)
    kw.setdefault("forecast", False)
    return FleetControllerConfig(**kw)


# ---------------------------------------------------------- forecast ---


def test_fit_diurnal_recovers_seeded_shape():
    """The free-phase LS fit recovers base/amp/crest of the exact
    ``traffic.shaped_arrivals`` diurnal form r(t) = base*(1 + amp*sin(
    2*pi*t/T - pi/2)) from samples on an arbitrary clock offset — the
    fleet's clock does not know when the load started."""
    period, base, amp, offset = 60.0, 50.0, 0.9, 17.3
    samples = []
    for i in range(24):
        t = offset + i * 1.25  # 30 s of samples: half a period
        r = base * (1.0 + amp * math.sin(2 * math.pi * (t - offset) / period
                                         - math.pi / 2))
        samples.append((t, r))
    fit = fit_diurnal(samples, period)
    assert fit is not None
    assert fit["base"] == pytest.approx(base, rel=0.05)
    assert fit["amp"] == pytest.approx(base * amp, rel=0.05)
    assert fit["rmse"] < 1.0
    # Crest prediction: the maximum over one period matches base*(1+amp).
    crest = max(
        predict_rate(fit, offset + period * k / 200.0) for k in range(200)
    )
    assert crest == pytest.approx(base * (1 + amp), rel=0.05)


def test_fit_diurnal_degenerate_inputs():
    assert fit_diurnal([], 60.0) is None
    assert fit_diurnal([(0, 1), (1, 2)], 60.0) is None  # under-determined
    assert fit_diurnal([(0, 1), (1, 2), (2, 3)], 0.0) is None
    # Samples all at one instant: singular normal equations, not a crash.
    assert fit_diurnal([(5.0, 1.0), (5.0, 1.0), (5.0, 1.0)], 60.0) is None


def test_correlated_pressure_shape_is_loadgen_legal():
    shape = correlated_pressure(6.0)
    assert shape == "diurnal:amp=0.9,period=6.0"
    arrivals = shaped_arrivals(shape, 200.0, 6.0, seed=0)
    assert len(arrivals) > 0
    # Crest (middle third) carries more arrivals than the trough thirds.
    thirds = [0, 0, 0]
    for t in arrivals:
        thirds[min(2, int(t / 2.0))] += 1
    assert thirds[1] > thirds[0] and thirds[1] > thirds[2]


def test_fleet_pressure_chaos_site(monkeypatch):
    assert "fleet_pressure" in chaos.KNOWN_SITES
    assert maybe_fleet_pressure(100.0, 4.0) is None  # unarmed: calm shape
    monkeypatch.setenv(chaos.CHAOS_ENV, "seed=3,fleet_pressure=1")
    chaos.reset()
    shape = maybe_fleet_pressure(100.0, 4.0)
    assert shape == "diurnal:amp=0.9,period=4.0"
    assert maybe_fleet_pressure(100.0, 4.0) is None  # budget burned


# ------------------------------------------------------ probe scrape ---


def test_probe_scrapes_controller_state_into_slots(ctl_trio, tmp_path):
    """Satellite 1: the probe loop parses the scraped ``/healthz``
    controller sub-object into the BackendSlot and journals a
    ``router_probe`` record per sweep — backends without an Autopilot
    scrape to None fields on the same trail."""
    ctl_trio[0].set_ctl(level=2, mode="degrade", burn=1.4, overloaded=True)
    ctl_trio[0].depth = 7
    router = _router([b.url for b in ctl_trio], tmp_path)
    try:
        router.probe_once()
        s0, s1 = router.slots[0], router.slots[1]
        assert (s0.ctl_level, s0.ctl_mode) == (2, "degrade")
        assert s0.ctl_burn == pytest.approx(1.4)
        assert s0.ctl_overloaded is True
        assert s0.queue_depth == 7
        # Pre-20 backend: depth still scraped, controller fields None.
        assert s1.ctl_level is None and s1.ctl_burn is None
        assert s1.queue_depth == 0
        probes = _records(tmp_path, "router_probe")
        assert len(probes) == 3
        by_backend = {r["backend"]: r for r in probes}
        assert by_backend["b0"]["level"] == 2
        assert by_backend["b0"]["burn"] == pytest.approx(1.4)
        assert by_backend["b0"]["depth"] == 7
        assert by_backend["b0"]["drained"] is False
        assert by_backend["b1"]["level"] is None
    finally:
        _close(router)


# ---------------------------------------------------------- (a) tokens ---


def test_token_budget_refusal_journaled_and_drained(ctl_trio, tmp_path):
    """Two backends degrade at once under max_concurrent_degraded=1: the
    first gets the token, the second gets ONE journaled fleet_refusal
    (cooldown-throttled) and is drained — and the router stops routing
    its home traffic to it."""
    urls = [b.url for b in ctl_trio]
    router = _router(
        urls, tmp_path,
        fleet=_fleet_cfg(max_concurrent_degraded=1, token_cooldown_s=30.0),
    )
    try:
        ctl_trio[0].set_ctl(level=1, mode="degrade", burn=0.2)
        ctl_trio[1].set_ctl(level=2, mode="degrade", burn=0.3)
        ctl_trio[2].set_ctl(level=0)
        router.probe_once()
        fc = router.fleet_controller
        assert fc is not None
        assert fc.action_counts.get("token_grant") == 1
        assert fc.action_counts.get("token_refused") == 1
        assert fc.action_counts.get("drain") == 1
        refusals = _records(tmp_path, "fleet_refusal")
        assert [r["action"] for r in refusals] == ["token_refused"]
        assert refusals[0]["target"] == "b1"
        assert refusals[0]["cause"] == "max_concurrent_degraded"
        assert refusals[0]["actuated"] is False
        assert refusals[0]["evidence"]["holders"] == ["b0"]
        assert refusals[0]["evidence"]["fleet"]["b1"]["level"] == 2
        # The refused backend is drained: flag set, no longer routable.
        assert router.slots[1].drained is True
        rid = next(
            f"rid{i}" for i in range(10_000) if router.home(f"rid{i}") == 1
        )
        res = router.route(rid, "", None, json.dumps({"rid": rid}).encode())
        assert res.verdict == "ok"
        assert res.backend != "b1"
        assert not ctl_trio[1].hits
        # Cooldown: the next sweep does NOT re-journal the refusal.
        router.probe_once()
        assert fc.action_counts.get("token_refused") == 1
        # Holder back at the top rung -> token released (a reversal).
        ctl_trio[0].set_ctl(level=0)
        router.probe_once()
        releases = [
            r for r in _records(tmp_path, "fleet_action")
            if r["action"] == "token_release"
        ]
        assert len(releases) == 1 and releases[0]["reversal"] is True
        assert fc.state_obj()["tokens"] == []
    finally:
        _close(router)


# ----------------------------------------------------- (b) drain/readmit ---


def test_drain_readmit_state_machine_injectable_clock(ctl_trio, tmp_path):
    """Sustained protected burn drains after ``drain_after_s``; grow-back
    (dwell + empty queue + not-overloaded intent, burn deliberately
    ignored — it is frozen while drained) readmits. All on an injected
    ``now=``: no sleeps, no clock flake."""
    urls = [b.url for b in ctl_trio]
    router = _router(
        urls, tmp_path,
        fleet=_fleet_cfg(
            drain_burn_high=1.0, drain_after_s=2.0, drain_min_s=1.0,
            max_drained=1,
        ),
    )
    try:
        fc = router.fleet_controller
        slot = router.slots[0]
        with router._lock:
            slot.ctl_level = 0
            slot.ctl_burn = 1.5
            slot.queue_depth = 3
        assert fc.evaluate(now=100.0) == []  # arms the burn timer
        assert fc.evaluate(now=101.0) == []  # dwell not served yet
        recs = fc.evaluate(now=102.5)
        assert [r["action"] for r in recs] == ["drain"]
        assert recs[0]["cause"] == "sustained_burn"
        assert recs[0]["evidence"]["detect_ms"] == pytest.approx(2500.0)
        assert router.slots[0].drained is True
        # Queue still draining: no readmit even after the dwell.
        with router._lock:
            slot.queue_depth = 1
        assert fc.evaluate(now=104.0) == []
        # Queue empty + not overloaded + dwell served -> readmit, even
        # though the scraped burn is still frozen HIGH.
        with router._lock:
            slot.queue_depth = 0
            slot.ctl_overloaded = False
        recs = fc.evaluate(now=104.5)
        assert [r["action"] for r in recs] == ["readmit"]
        assert recs[0]["cause"] == "grow_back"
        assert recs[0]["reversal"] is True
        assert router.slots[0].drained is False
        assert fc.state_obj()["drained"] == []
    finally:
        _close(router)


def test_drain_refusals_min_active_and_lifo_readmit(ctl_trio, tmp_path):
    """The drain guards refuse attributably (max_drained, min_active) and
    re-admission is strict LIFO: the bottom of the stack waits for the
    top even when it grew back first."""
    urls = [b.url for b in ctl_trio]
    router = _router(
        urls, tmp_path,
        fleet=_fleet_cfg(
            drain_burn_high=1.0, drain_after_s=0.5, drain_min_s=0.5,
            max_drained=2, min_active=1, token_cooldown_s=30.0,
        ),
    )
    try:
        fc = router.fleet_controller
        for i in (0, 1, 2):
            with router._lock:
                router.slots[i].ctl_burn = 2.0
                router.slots[i].queue_depth = 2
        fc.evaluate(now=10.0)
        recs = fc.evaluate(now=10.6)
        acts = [(r["kind"], r["action"], r["target"]) for r in recs]
        # b0 and b1 drain; b2 is refused on min_active (2 drained already,
        # max_drained=2 hits first for... max_drained=2 allows both, the
        # third refusal names whichever guard tripped).
        assert ("fleet_action", "drain", "b0") in acts
        assert ("fleet_action", "drain", "b1") in acts
        refusal = [r for r in recs if r["kind"] == "fleet_refusal"]
        assert len(refusal) == 1 and refusal[0]["target"] == "b2"
        assert refusal[0]["cause"] in ("max_drained", "min_active")
        assert fc.state_obj()["drained"] == ["b0", "b1"]
        # Bottom of the stack (b0) grows back first — but strict LIFO
        # holds it until the top (b1) is ready.
        with router._lock:
            router.slots[0].queue_depth = 0
            router.slots[0].ctl_overloaded = False
            router.slots[1].queue_depth = 4  # b1 still draining
        assert fc.evaluate(now=11.5) == []
        with router._lock:
            router.slots[1].queue_depth = 0
            router.slots[1].ctl_overloaded = False
        recs = fc.evaluate(now=12.0)
        assert [r["action"] for r in recs] == ["readmit", "readmit"]
        assert [r["target"] for r in recs] == ["b1", "b0"]  # LIFO
    finally:
        _close(router)


# ------------------------------------------------- (c) pre-actuation ---


def _seed_diurnal_samples(fc, period, base, amp, upto_t, n=20):
    """Seed the controller's rate-sample window with the exact diurnal
    trace (load clock == fleet clock for readability; the fit is
    phase-free either way)."""
    fc._samples.clear()
    for i in range(n):
        t = upto_t * (i + 1) / n
        r = base * (1.0 + amp * math.sin(2 * math.pi * t / period
                                         - math.pi / 2))
        fc._samples.append((t, r))


def test_forecast_presheds_before_realized_crest(ctl_trio, tmp_path):
    """Pre-actuation: with realized burn still BELOW the trip line, the
    fitted forecast crosses it at t+horizon and presheds the deferrable
    classes at the router (429/rejected), releasing any drain — with
    predicted-vs-realized evidence journaled."""
    urls = [b.url for b in ctl_trio]
    period, capacity = 60.0, 90.0
    router = _router(
        urls, tmp_path,
        fleet=FleetControllerConfig(
            eval_s=0.0, forecast=True, forecast_period_s=period,
            forecast_capacity_rps=capacity, forecast_horizon_s=5.0,
            forecast_min_samples=6, forecast_burn_high=0.95,
            forecast_burn_low=0.55, preshed_min_s=1.0,
        ),
    )
    try:
        fc = router.fleet_controller
        # Pre-drain b2 so the entry also proves forecast_release.
        router.set_drained(2, True)
        fc._drained.append(2)
        fc._drain_t[2] = 0.0
        with router._lock:
            router.slots[2].drained = True
            router.slots[2].queue_depth = 0
        _seed_diurnal_samples(fc, period, base=50.0, amp=0.9, upto_t=20.0)
        recs = fc._forecast_step(20.0)
        acts = [r["action"] for r in recs]
        assert acts == ["preshed", "readmit"]
        pre = recs[0]
        assert pre["cause"] == "forecast"  # predicted, NOT yet realized
        ev = pre["evidence"]
        assert ev["realized_burn"] < 0.95 <= ev["predicted_burn"]
        assert ev["capacity_rps"] == pytest.approx(capacity)
        assert ev["fit"]["period_s"] == period
        assert recs[1]["cause"] == "forecast_release"
        assert router.slots[2].drained is False
        # The deferrable classes bounce 429 at the router; the protected
        # class still routes.
        body = json.dumps({"rid": "r1"}).encode()
        res = router.route("r1", "bulk", None, body)
        assert (res.code, res.verdict) == (429, "rejected")
        assert json.loads(res.body)["reason"] == "fleet_preshed"
        assert router.route("r2", "interactive", None, body).verdict == "ok"
        # The swell subsides (settled low trace — trough samples alone
        # would NOT release: the fit correctly extrapolates the next
        # crest into the horizon) + grown-back fleet -> release, with
        # entry evidence.
        _seed_diurnal_samples(fc, period, base=10.0, amp=0.1, upto_t=20.0)
        recs = fc._forecast_step(25.0)
        assert [r["action"] for r in recs] == ["preshed_release"]
        rel = recs[0]["evidence"]
        assert rel["entry_predicted_rps"] is not None
        assert rel["realized_peak_rps"] >= 0.0
        assert rel["preshed_s"] == pytest.approx(5.0)
        assert router.route("r3", "bulk", None, body).verdict == "ok"
    finally:
        _close(router)


def test_preshed_release_waits_for_grow_back(ctl_trio, tmp_path):
    """The closed-loop trap: a collapsing fleet stops being OFFERED
    traffic, which reads as calm. Release must therefore ALSO require
    every routable backend back at the top rung — a quiet rate alone
    cannot release the shed into the crest."""
    urls = [b.url for b in ctl_trio]
    router = _router(
        urls, tmp_path,
        fleet=FleetControllerConfig(
            eval_s=0.0, forecast=True, forecast_period_s=60.0,
            forecast_capacity_rps=90.0, forecast_horizon_s=5.0,
            forecast_min_samples=6, preshed_min_s=0.0,
        ),
    )
    try:
        fc = router.fleet_controller
        _seed_diurnal_samples(fc, 60.0, base=50.0, amp=0.9, upto_t=20.0)
        assert [r["action"] for r in fc._forecast_step(20.0)] == ["preshed"]
        # Rate fully settled, but one backend still degraded.
        with router._lock:
            router.slots[1].ctl_level = 2
        _seed_diurnal_samples(fc, 60.0, base=10.0, amp=0.1, upto_t=20.0)
        assert fc._forecast_step(26.0) == []
        assert router._preshed  # still shedding
        with router._lock:
            router.slots[1].ctl_level = 0
        recs = fc._forecast_step(27.0)
        assert [r["action"] for r in recs] == ["preshed_release"]
    finally:
        _close(router)


def test_preshed_suppresses_drain(ctl_trio, tmp_path):
    """Drain-vs-shed arbitration, resolved: while the fleet is preshed
    for a crest, sustained-burn drains are REFUSED (cause
    ``preshed_active``) — pulling a backend mid-crest spills its
    protected-class share onto the survivors and cascades the fleet."""
    urls = [b.url for b in ctl_trio]
    router = _router(
        urls, tmp_path,
        fleet=FleetControllerConfig(
            eval_s=0.0, forecast=True, forecast_period_s=60.0,
            forecast_capacity_rps=90.0, forecast_horizon_s=5.0,
            forecast_min_samples=6, drain_burn_high=1.0,
            drain_after_s=1.0, drain_min_s=0.5, preshed_min_s=0.0,
        ),
    )
    try:
        fc = router.fleet_controller
        _seed_diurnal_samples(fc, 60.0, base=50.0, amp=0.9, upto_t=20.0)
        assert [r["action"] for r in fc.evaluate(now=20.0)] == ["preshed"]
        with router._lock:
            router.slots[0].ctl_burn = 2.0
            router.slots[0].ctl_level = 1
        fc.evaluate(now=21.0)  # arms the sustained-burn timer
        recs = fc.evaluate(now=22.5)
        refusals = [r for r in recs if r["kind"] == "fleet_refusal"]
        assert [r["action"] for r in refusals] == ["drain_refused"]
        assert refusals[0]["cause"] == "preshed_active"
        assert router.slots[0].drained is False
        assert fc.state_obj()["drained"] == []
    finally:
        _close(router)


# -------------------------------------------------------- calm trace ---


def test_calm_trace_journals_zero_fleet_actions(ctl_trio, tmp_path):
    """A healthy fleet under a forecast-armed controller journals NOTHING
    — no-op on calm traffic is an acceptance criterion (twitchy fleet
    control is worse than none)."""
    urls = [b.url for b in ctl_trio]
    router = _router(
        urls, tmp_path,
        fleet=FleetControllerConfig(
            eval_s=0.0, forecast=True, forecast_period_s=60.0,
            forecast_capacity_rps=1000.0, forecast_min_samples=6,
        ),
    )
    try:
        for b in ctl_trio:
            b.set_ctl(level=0, burn=0.05)
        body = json.dumps({"rid": "r"}).encode()
        for i in range(8):
            router.probe_once()
            assert router.route(f"r{i}", "", None, body).verdict == "ok"
        fc = router.fleet_controller
        assert fc.action_counts == {}
        assert _records(tmp_path, "fleet_action", "fleet_refusal") == []
        assert fc.state_obj()["n_samples"] > 0  # it WAS sampling
        rrep = router.report()
        assert rrep.closed
    finally:
        _close(router)



# ------------------------------------------------------- health fold ---


def _probe_rec(backend, level, t_ms):
    return {
        "kind": "router_probe", "backend": backend, "state": UP,
        "drained": False, "level": level, "mode": None, "burn": None,
        "overloaded": None, "depth": 0, "probe_ms": 1.0, "t_ms": t_ms,
    }


def test_health_fleet_fold_max_degraded_and_drain_phases():
    """Satellite 3: the health fold reports max-simultaneously-degraded
    from the probe trail and decomposes each drain into detect -> drain
    -> readmit phases summing to the incident wall."""
    records = [
        {"kind": "serve_config", "slo": None},
        _probe_rec("b0", 0, 10.0), _probe_rec("b1", 0, 10.0),
        _probe_rec("b0", 1, 20.0), _probe_rec("b1", 2, 20.0),  # both down
        _probe_rec("b0", 0, 30.0), _probe_rec("b1", 1, 30.0),
        {
            "kind": "fleet_action", "action": "drain", "target": "b1",
            "actuated": True, "reversal": False, "cause": "sustained_burn",
            "ms": 2.0, "evidence": {"detect_ms": 500.0}, "t_ms": 1000.0,
        },
        {
            "kind": "fleet_refusal", "action": "token_refused",
            "target": "b0", "actuated": False, "reversal": False,
            "cause": "max_concurrent_degraded", "ms": 0.0, "evidence": {},
            "t_ms": 1100.0,
        },
        {
            "kind": "fleet_action", "action": "readmit", "target": "b1",
            "actuated": True, "reversal": True, "cause": "grow_back",
            "ms": 1.0, "evidence": {"drain_ms": 2500.0}, "t_ms": 3500.0,
        },
    ]
    fs = fleet_summary(records)
    assert fs["max_simultaneous_degraded"] == 2
    assert fs["actions"] == {
        "drain": 1, "token_refused": 1, "readmit": 1
    }
    assert fs["refusals"] == 1
    [drain] = fs["drains"]
    assert drain["kind"] == "fleet_drain"
    assert drain["entry"] == "b1"
    assert drain["cause"] == "sustained_burn"
    # wall = readmit.t_ms - (drain.t_ms - detect) = 3500 - 500 = 3000
    assert drain["wall_ms"] == pytest.approx(3000.0)
    assert set(drain["phases"]) == set(FLEET_DRAIN_PHASES)
    assert sum(drain["phases"].values()) == pytest.approx(
        drain["wall_ms"], rel=1e-6
    )
    assert drain["phases"]["detect"] == pytest.approx(500.0)
    assert fleet_summary([{"kind": "serve_config"}]) == {}
    # the JAX fold of the same records, equal key for key
    assert fs == jhealth.fleet_summary(records)



# ------------------------------------------------------------ config ---


def test_config_roundtrip_and_router_header():
    cfg = FleetControllerConfig(
        max_concurrent_degraded=2, forecast_period_s=30.0,
        preshed_classes=("bulk",),
    )
    back = FleetControllerConfig.from_obj(cfg.to_obj())
    assert back == cfg
    # Unknown keys are dropped, not fatal (forward-compatible payloads).
    assert FleetControllerConfig.from_obj(
        {"max_drained": 3, "not_a_knob": 1}
    ).max_drained == 3


def test_router_config_journals_fleet_header(ctl_trio, tmp_path):
    router = _router(
        [b.url for b in ctl_trio], tmp_path,
        fleet=_fleet_cfg(max_concurrent_degraded=2),
    )
    try:
        [hdr] = _records(tmp_path, "router_config")
        assert hdr["fleet"]["max_concurrent_degraded"] == 2
        assert isinstance(router.fleet_controller, FleetController)
    finally:
        _close(router)


# ------------------------------------------------- against the JAX package ---


def test_fit_diurnal_equals_the_jax_fit_within_1e_12():
    rng = np.random.default_rng(7)
    for period in (6.0, 8.0, 60.0):
        samples = [(float(t), float(50.0 * (1.0 + 0.9 * math.sin(2 * math.pi * t / period - 1.3))
                                      + rng.normal(0.0, 3.0)))
                   for t in np.sort(rng.uniform(0.0, 2 * period, 40))]
        got, want = fit_diurnal(samples, period), jfc.fit_diurnal(samples, period)
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), (period, k)
        for t in (0.0, 1.7, period):
            assert abs(predict_rate(got, t) - jfc.predict_rate(want, t)) <= 1e-12 * 100


# one scripted fleet view a step: each backend's (level, burn, overloaded, depth), and the injected clock
_TRAIL = [
    (0.0, [(0, 0.1, False, 0), (0, 0.1, False, 0), (0, 0.1, False, 0)]),
    (0.2, [(1, 0.4, True, 3), (2, 1.5, True, 5), (0, 0.2, False, 0)]),
    (0.5, [(1, 1.4, True, 4), (2, 1.6, True, 5), (1, 1.2, True, 2)]),
    (0.9, [(1, 1.4, True, 4), (2, 1.6, True, 5), (1, 1.2, True, 2)]),
    (1.4, [(0, 0.3, False, 0), (1, 1.6, False, 0), (1, 1.3, True, 1)]),
    (2.1, [(0, 0.2, False, 0), (0, 1.6, False, 0), (0, 0.4, False, 0)]),
    (2.8, [(0, 0.1, False, 0), (0, 0.2, False, 0), (0, 0.1, False, 0)]),
    (3.6, [(0, 0.1, False, 0), (0, 0.1, False, 0), (0, 0.1, False, 0)]),
]


def _play(pkg, ctl_pkg, tmp_path):
    """Play ``_TRAIL`` through one package's router and fleet controller
    (the slots set as a probe scrape sets them, the controller evaluated at
    the injected clock), then a forecast crest and its release."""
    urls = [f"http://127.0.0.1:{9 + i}" for i in range(3)]  # never contacted: no probe runs
    cfg = ctl_pkg.FleetControllerConfig(
        eval_s=0.0, max_concurrent_degraded=1, token_cooldown_s=0.5, drain_burn_high=1.0, drain_after_s=0.3,
        drain_min_s=0.5, max_drained=1, min_active=1, forecast=True, forecast_period_s=60.0,
        forecast_capacity_rps=90.0, forecast_horizon_s=5.0, forecast_min_samples=6, preshed_min_s=0.5)
    r = _router(urls, tmp_path, pkg=pkg, fleet=cfg)
    try:
        fc = r.fleet_controller
        for now, view in _TRAIL:
            with r._lock:
                for slot, (level, burn, over, depth) in zip(r.slots, view):
                    slot.ctl_level, slot.ctl_mode, slot.ctl_burn = level, "steady", burn
                    slot.ctl_overloaded, slot.queue_depth = over, depth
            fc.evaluate(now=now)
        for i in range(20):  # a diurnal crest in the rate samples, then a settled trace
            t = 20.0 * (i + 1) / 20
            fc._samples.append((t, 50.0 * (1.0 + 0.9 * math.sin(2 * math.pi * t / 60.0 - math.pi / 2))))
        fc._forecast_step(20.0)
        fc._samples.clear()
        for i in range(20):
            fc._samples.append((20.0 * (i + 1) / 20, 10.0))
        fc._forecast_step(26.0)
        return fc.state_obj()
    finally:
        _close(r)


def test_a_scripted_trail_journals_the_jax_controllers_actions(tmp_path):
    out = {}
    for name, pkg, ctl_pkg in (("port", trouter, tfc),
                               ("jax", jrouter, jfc)):
        d = tmp_path / name
        d.mkdir()
        state = _play(pkg, ctl_pkg, d)
        recs = [{k: v for k, v in r.items() if k not in ("t_ms", "ms", "ts", "wall", "seq")}
                for r in Journal.load(d / "router.jsonl") if r["kind"] in ("fleet_action", "fleet_refusal")]
        out[name] = (recs, state)
    assert out["port"] == out["jax"]
    actions = {r["action"] for r in out["port"][0]}
    assert {"token_grant", "token_refused", "drain", "readmit", "preshed", "preshed_release"} <= actions


def test_fleet_summary_of_a_played_trail_equals_the_jax_fold(tmp_path):
    _play(trouter, tfc, tmp_path)
    records = load_records(tmp_path)
    fs = fleet_summary(records)
    assert fs and fs == jhealth.fleet_summary(records)
    assert all(set(d["phases"]) == set(FLEET_DRAIN_PHASES) for d in fs["drains"])


# --------------------------------------------- acceptance drill (A/B) ---


@pytest.mark.slow
def test_bench_fleetcontrol_ab_acceptance_drill(tmp_path):
    """The fleet control plane's A/B over real backend processes on the CPU:
    the same correlated diurnal swell (chaos ``fleet_pressure``) through 3
    controlled backends with fleet control ON, then OFF. From the journals:
    ON never all-degrades while OFF does, the protected class's burn is
    strictly lower ON, the calm window journals no fleet action, and the
    router closes its accounting both ways. Two fleets through an 8 s swell
    each over live subprocesses, so marked slow, as in the JAX package."""
    proc = subprocess.run(
        [sys.executable, "-m", "cuda_mpi_gpu_cluster_programming_tpu_torch.bench"],
        cwd=ROOT, capture_output=True, text=True, timeout=560,
        env={**os.environ, "BENCH_MODE": "fleetcontrol", "BENCH_DEVICE": "cpu",
             "BENCH_FLEETCTL_JOURNAL": str(tmp_path / "fleetctl")},
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    row = json.loads([line for line in proc.stdout.splitlines() if line.strip()][-1])
    assert row["metric"] == "alexnet_blocks12_fleet_control" and "error" not in row, row
    assert row["ok"] is True and row["failures"] == []
    n = row["n_backends"]
    assert row["calm_actions"] == 0
    assert row["max_degraded"]["on"] < n and row["max_degraded"]["off"] == n
    assert row["burn_protected"]["on"] < row["burn_protected"]["off"]
    assert row["accounting_closed"] == {"on": True, "off": True}
    assert row["fleet_actions"].get("preshed", 0) >= 1
    fs_on = fleet_summary(load_records(str(tmp_path / "fleetctl" / "on")))
    assert fs_on["max_simultaneous_degraded"] == row["max_degraded"]["on"]
