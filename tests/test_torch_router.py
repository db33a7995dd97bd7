"""The port's fleet router against the JAX package's, on the CPU.

The in-process tests of the JAX ``tests/test_router.py`` against the port's
``serving/router.py``, over stub backends that speak just enough of the
front end's wire contract (scripted ``/v1/infer`` verdicts, toggleable
``/healthz`` and ``/metrics``): crc32 routing with class-aware spillover,
the probe-driven up / down / probation / quarantined machine, redirects
under the request's deadline, accounting closed at the router, the
router's own endpoints and the ``host_loss`` chaos site. Then the two
packages side by side: the same rids route to the same backends in the
same spill order, and the same scripted stub trail journals the same
backend transitions and redirects. The real-process drills are in
``tests/test_torch_fleet.py``.
"""

import http.client
import json
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from cuda_mpi_gpu_cluster_programming_tpu.resilience.policy import RetryPolicy as JRetryPolicy
from cuda_mpi_gpu_cluster_programming_tpu.serving import router as jrouter
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.metrics import registry as metrics_registry
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import chaos
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.policy import RetryPolicy
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving import router as trouter
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.fleet import maybe_host_loss
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.router import DOWN, PROBATION, QUARANTINED, UP


@pytest.fixture(autouse=True)
def _clean_process_state(monkeypatch):
    monkeypatch.delenv(chaos.CHAOS_ENV, raising=False)
    chaos.reset()
    metrics_registry().reset()
    yield
    chaos.reset()


# ------------------------------------------------------------- stubs ---


class _StubHandler(BaseHTTPRequestHandler):
    backend: "StubBackend"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _send(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if code == 429:
            self.send_header("Retry-After", "1")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        b = self.backend
        if self.path == "/healthz":
            if b.healthz_ok:
                self._send(200, {"status": "ok", "queue": {"depth": 0}})
            else:
                self._send(503, {"status": "down"})
        elif self.path == "/metrics":
            body = b"# TYPE serve_ok counter\nserve_ok 0\n"
            self.send_response(200 if b.metrics_ok else 500)
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
        code = b.next_code()
        if code == 200:
            self._send(200, {"rid": req.get("rid"), "status": "OK", "latency_ms": 1.0})
        elif code == 429:
            self._send(429, {"status": "REJECTED", "error": "queue full"})
        elif code == 504:
            self._send(504, {"rid": req.get("rid"), "status": "SHED"})
        else:
            self._send(code, {"status": "FAILED"})


class StubBackend:
    """Scripted ``/v1/infer`` verdicts (then 200 forever), toggleable
    ``/healthz`` and ``/metrics``."""

    def __init__(self, codes=()):
        self.codes = list(codes)
        self.healthz_ok = True
        self.metrics_ok = True
        self.hits = []
        self._lock = threading.Lock()
        handler = type("BoundStub", (_StubHandler,), {"backend": self})
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"

    def next_code(self):
        with self._lock:
            return self.codes.pop(0) if self.codes else 200

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(5.0)


@pytest.fixture
def stub_trio():
    backends = [StubBackend() for _ in range(3)]
    yield backends
    for b in backends:
        b.stop()


def _router(urls, tmp_path=None, pkg=trouter, **kw):
    """A router of ``pkg`` with the probe thread OFF (tests step
    ``probe_once``/``route`` directly) and a journal when tmp_path is
    given."""
    retry = RetryPolicy if pkg is trouter else JRetryPolicy
    kw.setdefault("probe_interval_s", 0)
    kw.setdefault("retry", retry(max_retries=3, base_delay_s=0.01, max_delay_s=0.05, jitter=0.0))
    if tmp_path is not None:
        kw.setdefault("journal_path", str(tmp_path / "router.jsonl"))
    return pkg.FleetRouter(urls, pkg.RouterConfig(**kw))


def _close(router):
    router.stop()
    router._httpd.server_close()


def _rid_homed(router, idx, cls=""):
    """A rid whose crc32 home is backend ``idx``."""
    for i in range(10_000):
        rid = f"{cls}rid{i}"
        if router.home(rid) == idx:
            return rid
    raise AssertionError(f"no rid homes on {idx}")


def _post(host, port, payload, timeout=60.0):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/v1/infer", json.dumps(payload), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _report_once(router, offered, timeout_s=10.0):
    """The router's report once ``offered`` requests are on its books: a
    handler closes a request's ledger after its response hit the socket, so
    a client can read the response before the router has counted it."""
    deadline = time.monotonic() + timeout_s
    rep = router.report()
    while rep.n_offered < offered and time.monotonic() < deadline:
        time.sleep(0.01)
        rep = router.report()
    return rep


def _wait_records(jpath, kind, n, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        recs = [r for r in Journal.load(jpath) if r["kind"] == kind]
        if len(recs) >= n:
            return recs
        time.sleep(0.01)
    return [r for r in Journal.load(jpath) if r["kind"] == kind]


# ------------------------------------------------------ deterministic ---


def test_home_and_candidates_are_deterministic(stub_trio):
    urls = [b.url for b in stub_trio]
    r1, r2 = _router(urls), _router(urls)
    try:
        for i in range(40):
            rid = f"req{i}"
            assert r1.home(rid) == zlib.crc32(rid.encode()) % 3
            order = r1.candidates(rid, "interactive")
            assert order == r2.candidates(rid, "interactive") == r1.candidates(rid, "interactive")
            assert sorted(order) == [0, 1, 2] and order[0] == r1.home(rid)
    finally:
        _close(r1)
        _close(r2)


def test_no_spill_classes_get_home_only(stub_trio):
    r = _router([b.url for b in stub_trio])
    try:
        for i in range(10):
            rid = f"bulk{i}"
            assert r.candidates(rid, "bulk") == [r.home(rid)]
            assert len(r.candidates(rid, "batch")) == 3
    finally:
        _close(r)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_home_and_candidates_equal_the_jax_routers(n):
    """1000 seeded rids, every class: the port routes each to the JAX
    router's home and walks the JAX router's spill order, byte for byte."""
    urls = [f"http://127.0.0.1:{9 + i}" for i in range(n)]  # never contacted
    tr, jr = _router(urls), _router(urls, pkg=jrouter)
    rng = np.random.default_rng(n)
    try:
        for _ in range(1000):
            rid = f"r{int(rng.integers(0, 2**40)):x}"
            assert tr.home(rid) == jr.home(rid)
            for cls in ("", "interactive", "batch", "bulk"):
                assert tr.candidates(rid, cls) == jr.candidates(rid, cls)
    finally:
        _close(tr)
        _close(jr)


# ------------------------------------------------------ health machine ---


def test_probe_machine_k_down_m_readmit(stub_trio, tmp_path):
    """fail_k consecutive misses take a backend down (detection latency
    journaled); a heal enters probation; readmit_m clean probes, and only
    probes (probation gets no traffic), re-admit."""
    r = _router([b.url for b in stub_trio], tmp_path, fail_k=2, readmit_m=2)
    try:
        stub_trio[1].healthz_ok = False
        r.probe_once()
        assert r.backend_states()["b1"] == UP  # 1 miss < K
        r.probe_once()
        assert r.backend_states()["b1"] == DOWN
        stub_trio[1].healthz_ok = True
        r.probe_once()
        assert r.backend_states()["b1"] == PROBATION
        assert r._pick([1], avoid=None) is None  # probation is not routable
        r.probe_once()
        assert r.backend_states()["b1"] == PROBATION  # 1 clean < M
        r.probe_once()
        assert r.backend_states()["b1"] == UP
        recs = _wait_records(tmp_path / "router.jsonl", "router_backend_state", 3)
        downs = [x for x in recs if x["to"] == DOWN]
        assert downs and downs[0]["frm"] == UP
        assert downs[0]["consec_fail"] == 2 and downs[0]["detect_ms"] >= 0
        readmits = [x for x in recs if x["reason"] == "readmit"]
        assert readmits and readmits[0]["clean_probes"] == 2
        assert readmits[0]["down_ms"] >= readmits[0]["probation_ms"]
    finally:
        _close(r)


def test_probation_miss_goes_back_down(stub_trio):
    r = _router([b.url for b in stub_trio], fail_k=1, readmit_m=3)
    try:
        stub_trio[0].healthz_ok = False
        r.probe_once()
        assert r.backend_states()["b0"] == DOWN
        down_since = r.slots[0].down_since
        stub_trio[0].healthz_ok = True
        r.probe_once()
        assert r.backend_states()["b0"] == PROBATION
        stub_trio[0].healthz_ok = False
        r.probe_once()
        # back down, and the first down_since survives: the outage is one incident
        assert r.backend_states()["b0"] == DOWN and r.slots[0].down_since == down_since
    finally:
        _close(r)


def test_flapping_backend_quarantined_sticky(stub_trio):
    r = _router([b.url for b in stub_trio], fail_k=1, readmit_m=5, quarantine_flaps=2, flap_window_s=60.0)
    try:
        for _ in range(2):  # two lose -> heal half-cycles inside the window
            stub_trio[2].healthz_ok = False
            r.probe_once()
            assert r.backend_states()["b2"] == DOWN
            stub_trio[2].healthz_ok = True
            r.probe_once()
        assert r.backend_states()["b2"] == QUARANTINED
        r.probe_once()  # sticky: probing does not resurrect it
        assert r.backend_states()["b2"] == QUARANTINED
    finally:
        _close(r)


def test_metrics_scrape_failure_is_a_health_miss(stub_trio):
    r = _router([b.url for b in stub_trio], fail_k=1)
    try:
        stub_trio[0].metrics_ok = False
        r.probe_once()
        assert r.backend_states()["b0"] == DOWN
    finally:
        _close(r)


def _transitions(path):
    return [(x["backend"], x["frm"], x["to"], x["reason"]) for x in Journal.load(path)
            if x["kind"] == "router_backend_state"]


def test_a_scripted_trail_journals_the_jax_routers_transitions(tmp_path):
    """One scripted trail of probe verdicts and request verdicts, played to
    the port's router and to the JAX router over stubs scripted the same:
    the same router_backend_state transitions, the same redirects and the
    same route verdicts, in the same order."""
    trails = {}
    for name, pkg in (("port", trouter), ("jax", jrouter)):
        stubs = [StubBackend() for _ in range(3)]
        d = tmp_path / name
        d.mkdir()
        r = _router([b.url for b in stubs], d, pkg=pkg, fail_k=2, readmit_m=2, quarantine_flaps=2)
        try:
            verdicts = []
            for step, (down, codes) in enumerate([
                ((), {}), ((1,), {}), ((1,), {}), ((), {0: [429, 429]}), ((), {}), ((2,), {}), ((2,), {}),
                ((), {2: [504]}), ((), {}), ((), {}), ((0,), {}), ((0,), {}), ((), {}), ((0,), {}), ((0,), {}),
                ((), {}),
            ]):
                for i, b in enumerate(stubs):
                    b.healthz_ok = i not in down
                    b.codes = list(codes.get(i, []))
                r.probe_once()
                for k in range(6):
                    rid = f"s{step}k{k}"
                    cls = ("interactive", "batch", "bulk")[k % 3]
                    res = r.route(rid, cls, 5.0, json.dumps({"rid": rid}).encode())
                    verdicts.append((rid, res.code, res.verdict, res.backend, res.redirects))
            trails[name] = dict(
                states=_transitions(d / "router.jsonl"), verdicts=verdicts,
                redirects=[(x["rid"], x["frm"], x["to"], x["attempt"], x["reason"])
                           for x in Journal.load(d / "router.jsonl") if x["kind"] == "router_redirect"],
                final=r.backend_states(),
            )
        finally:
            _close(r)
            for b in stubs:
                b.stop()
    assert trails["port"] == trails["jax"]
    reasons = {t[3] for t in trails["port"]["states"]}
    assert {"heal", "readmit", "flap"} <= reasons and trails["port"]["final"]["b0"] == QUARANTINED
    assert trails["port"]["redirects"]


# ----------------------------------------------- redirect + accounting ---


def test_redirect_on_429_lands_elsewhere_and_is_journaled(stub_trio, tmp_path):
    r = _router([b.url for b in stub_trio], tmp_path)
    try:
        rid = _rid_homed(r, 1)
        stub_trio[1].codes = [429, 429, 429, 429]  # home refuses all day
        res = r.route(rid, "interactive", 5.0, json.dumps({"rid": rid, "shape": [1, 63, 63, 3]}).encode())
        assert res.code == 200 and res.verdict == "ok"
        assert res.redirects >= 1 and res.backend != "b1"
        assert rid in stub_trio[1].hits  # home tried first
        recs = _wait_records(tmp_path / "router.jsonl", "router_redirect", 1)
        assert recs[0]["rid"] == rid and recs[0]["frm"] == "b1" and recs[0]["reason"] == "http_429"
    finally:
        _close(r)


def test_retry_budget_is_the_request_deadline(stub_trio):
    """Every backend refusing: the router redirects only while the
    request's own deadline has budget, then surfaces the last backend
    verdict (429 -> rejected, 504 -> shed)."""
    r = _router([b.url for b in stub_trio],
                retry=RetryPolicy(max_retries=50, base_delay_s=0.05, max_delay_s=0.1, jitter=0.0))
    try:
        for b in stub_trio:
            b.codes = [429] * 200
        t0 = time.monotonic()
        res = r.route("rbudget", "interactive", 0.4, b"{}")
        assert res.code == 429 and res.verdict == "rejected"
        assert time.monotonic() - t0 < 5.0  # deadline-bounded, not max_retries-bounded
        for b in stub_trio:
            b.codes = [504] * 200
        res = r.route("rshed", "interactive", 0.3, b"{}")
        assert res.code == 504 and res.verdict == "shed"
    finally:
        _close(r)


def test_unroutable_and_closed_accounting_northbound(stub_trio, tmp_path):
    """A no-spill request whose home is down gets an attributed 503
    UNROUTABLE; spillable traffic rides over; the router's per-class
    ledger closes with the fifth bucket."""
    r = _router([b.url for b in stub_trio], tmp_path).start()
    try:
        bulk_rid = _rid_homed(r, 2, cls="b")
        r.slots[2].state = DOWN
        code, body = _post(r.host, r.port, {"rid": bulk_rid, "class": "bulk", "shape": [1, 63, 63, 3]})
        assert code == 503 and body["status"] == "UNROUTABLE"
        inter_rid = _rid_homed(r, 2, cls="i")
        code, _ = _post(r.host, r.port, {"rid": inter_rid, "class": "interactive", "shape": [1, 63, 63, 3]})
        assert code == 200
        rep = _report_once(r, 2)
        assert rep.closed and rep.n_unroutable == 1
        assert rep.per_class["bulk"].unroutable == 1 and rep.per_class["interactive"].ok == 1
        assert "unroutable=1" in rep.summary()
        conn = http.client.HTTPConnection(r.host, r.port, timeout=10)
        try:
            conn.request("POST", "/v1/infer", b"not json", {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 400
            resp.read()
        finally:
            conn.close()
        assert r.report().closed
        recs = _wait_records(tmp_path / "router.jsonl", "router_route", 3)
        verdicts = {x["rid"]: x["verdict"] for x in recs if x["rid"]}
        assert verdicts[bulk_rid] == "unroutable" and verdicts[inter_rid] == "ok"
    finally:
        _close(r)


def test_request_path_conn_failure_feeds_health_machine(stub_trio):
    r = _router([b.url for b in stub_trio], fail_k=1)
    try:
        rid = _rid_homed(r, 0)
        stub_trio[0].stop()  # a killed host: connection refused
        res = r.route(rid, "interactive", 5.0, json.dumps({"rid": rid}).encode())
        assert res.code == 200 and res.redirects >= 1
        assert r.backend_states()["b0"] == DOWN
    finally:
        _close(r)


def test_router_healthz_and_stats_endpoints(stub_trio):
    r = _router([b.url for b in stub_trio]).start()
    try:
        conn = http.client.HTTPConnection(r.host, r.port, timeout=10)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 200 and body["routable"] == 3
            conn.request("GET", "/stats")
            resp = conn.getresponse()
            stats = json.loads(resp.read())
            assert resp.status == 200 and stats["accounting_closed"]
        finally:
            conn.close()
    finally:
        _close(r)


# ------------------------------------------------------------- chaos ---


def test_host_loss_is_a_known_chaos_site(monkeypatch):
    assert "host_loss" in chaos.KNOWN_SITES

    class _FakeFleet:
        n = 3

        def __init__(self):
            self.killed = []

        def kill(self, idx):
            self.killed.append(idx)

    fleet = _FakeFleet()
    monkeypatch.setenv(chaos.CHAOS_ENV, "seed=4,host_loss=1")
    chaos.reset()
    assert maybe_host_loss(fleet) == 4 % 3  # victim = seed % n
    assert fleet.killed == [1]
    assert maybe_host_loss(fleet) is None  # budget burned: fires once
    monkeypatch.delenv(chaos.CHAOS_ENV)
    chaos.reset()
    assert maybe_host_loss(fleet) is None and fleet.killed == [1]


def test_the_router_config_record_is_the_jax_routers(tmp_path):
    """The ``router_config`` header keys, and the report's keys, as the JAX
    router journals them."""
    urls = ["http://127.0.0.1:9", "http://127.0.0.1:10"]
    heads = {}
    for name, pkg in (("port", trouter), ("jax", jrouter)):
        d = tmp_path / name
        d.mkdir()
        r = _router(urls, d, pkg=pkg)
        heads[name] = (Journal.load(d / "router.jsonl")[0], r.report().to_obj())
        _close(r)
    (tr, trep), (jr, jrep) = heads["port"], heads["jax"]
    drop = ("t_ms", "ts", "wall", "seq")
    assert {k: v for k, v in tr.items() if k not in drop} == {k: v for k, v in jr.items() if k not in drop}
    assert trep == jrep
