"""HTTP front end: the admission queue's network transport.

The JAX package's ``serving/frontend.py``, copied: a standard-library
``http.server`` front end that accepts inference requests over a socket
and keeps the queue's contract on the wire:

- **Backpressure is a status code, not a buffer.** ``QueueFull`` answers
  429 (with ``Retry-After``), a request wider than the largest bucket 413:
  the refusals an in-process submitter gets. A malformed body is 400
  before anything touches the queue.
- **Sheds stay explicit.** A request shed in the queue (hard deadline:
  ``reason="deadline"``; class SLO blown: ``reason="slo"``) answers 504
  with the reason in the body. A failed dispatch answers 500.
- **Every exchange is journaled and traced.** Each one emits a
  ``serve.transport`` span (receive -> response written) around the
  request's ``serve.queue_wait`` and ``serve.dispatch`` spans, and a
  ``serve_transport`` journal record with the span id, class, status and
  HTTP code; refusals journal ``serve_reject``.

Wire format (``POST /v1/infer``, JSON):

    {"shape": [n, H, W, C] | [H, W, C],    # required
     "data": [flat floats],               # payload, XOR "fill"
     "fill": 1.0,                         # constant image (load tests)
     "class": "interactive",              # traffic class (SLO policy)
     "deadline_s": 0.5,                   # hard deadline override
     "rid": "...",                        # optional request id
     "return_output": true}               # echo the output tensor

    -> 200 {"rid", "status": "OK", "class", "latency_ms",
            "output_shape", "output"?}
    -> 429/413/400/504/500 {"rid"?, "status", "reason"?, "error"}

``GET /healthz`` answers liveness and the queue's saturation gauges,
``GET /stats`` the serve and queue counters, ``GET /metrics`` the metrics
registry in Prometheus text exposition (0.0.4), each scrape journaled as a
``serve_transport`` record.

Handler threads block on sockets and handle waits by design: they are
transport, never the dispatch loop, and they touch only numpy. The journal
and span writes happen in ``@off_timed_path`` helpers after the measured
transport window closes.

Also here: :func:`http_fleet_load`, the threaded HTTP client fleet that
drives a traffic shape through the front end and returns the same
per-class accounting as the in-process shaped loader.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlparse

import numpy as np

from ..observability.metrics import registry as metrics_registry
from ..observability.trace import get_tracer, off_timed_path
from .queue import FAILED, OK, SHED, QueueFull
from .server import InferenceServer
from .traffic import (
    ClassStats,
    RequestClass,
    ShapedReport,
    assign_classes,
    shaped_arrivals,
)


class _Handler(BaseHTTPRequestHandler):
    """One HTTP exchange. ``frontend`` is bound per-ServingFrontend via a
    subclass (http.server's intended extension point)."""

    frontend: "ServingFrontend"  # bound in ServingFrontend.__init__
    server_version = "tpu-serve-frontend/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:
        pass  # the journal is the access log; stderr chatter helps nobody

    # ----------------------------------------------------------- plumbing

    def _send_json(self, code: int, payload: dict, retry_after: bool = False) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after:
            self.send_header("Retry-After", "1")
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # ------------------------------------------------------------- routes

    def do_GET(self) -> None:
        fe = self.frontend
        if self.path == "/healthz":
            qs = fe.server.queue.stats()
            payload = {
                "status": "ok",
                "queue": qs.to_obj(),
                "buckets": list(fe.server.buckets),
            }
            # the controller's state (mode, level, rung, overrides, last action, intent): a probe sees
            # degraded-but-healthy instead of inferring it from latency; absent on an uncontrolled server
            if fe.server.controller is not None:
                payload["controller"] = fe.server.controller.state_obj()
            self._send_json(200, payload)
        elif self.path == "/stats":
            srv = fe.server
            payload = {
                "serve": srv.stats.summary(),
                "queue": srv.queue.stats().to_obj(),
                "http": dict(fe.http_codes),
                "entry": srv.cfg.config,
            }
            if srv.controller is not None:
                payload["controller"] = srv.controller.state_obj()
            self._send_json(200, payload)
        elif self.path == "/metrics":
            # Prometheus text exposition of the process-wide registry:
            # counters/gauges map directly, histograms
            # expose as summaries with the same nearest-rank p50/p99 every
            # other surface reports. Journaled like the POST exchanges —
            # one serve_transport record per scrape — so the access trail
            # the journal IS covers the scraper too.
            t0 = time.monotonic()
            self._send_text(
                200,
                metrics_registry().prometheus(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
            fe._finish("", "", t0, "METRICS", 200)
        else:
            self._send_json(404, {"error": f"no route {self.path!r}"})

    def do_POST(self) -> None:
        if self.path != "/v1/infer":
            self._send_json(404, {"error": f"no route {self.path!r}"})
            return
        fe = self.frontend
        t0 = time.monotonic()
        rid = cls = ""
        try:
            length = int(self.headers.get("Content-Length") or 0)
            req = json.loads(self.rfile.read(length) or b"{}")
            x, cls, deadline_s, rid, want_out = _parse_infer(req)
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(
                400, {"status": "REJECTED", "error": f"bad request: {e}"}
            )
            fe._finish(rid, cls, t0, "REJECTED", 400)
            return
        try:
            handle = fe.server.submit(x, deadline_s=deadline_s, rid=rid, cls=cls)
        except QueueFull as e:
            # Backpressure IS the contract: the queue refused, the wire
            # says 429, the client backs off. Never buffered to OOM.
            self._send_json(
                429, {"status": "REJECTED", "error": str(e)}, retry_after=True
            )
            fe._finish(rid, cls, t0, "REJECTED", 429)
            return
        except ValueError as e:  # wider than the largest bucket
            self._send_json(413, {"status": "REJECTED", "error": str(e)})
            fe._finish(rid, cls, t0, "REJECTED", 413)
            return
        handle.wait(fe.max_wait_s)
        if handle.status == OK:
            payload = {
                "rid": handle.rid,
                "status": OK,
                "class": cls,
                "latency_ms": round(handle.latency_ms, 3),
                "output_shape": list(handle.result.shape),
            }
            if want_out:
                payload["output"] = np.asarray(handle.result).reshape(-1).tolist()
            code = 200
        elif handle.status == SHED:
            # Explicit shed -> explicit 504: the deadline/SLO verdict the
            # queue journaled, surfaced to the caller with its reason.
            payload = {
                "rid": handle.rid, "status": SHED, "class": cls,
                "reason": "slo" if "SLO" in handle.error else "deadline",
                "error": handle.error,
            }
            code = 504
        elif handle.status == FAILED:
            payload = {
                "rid": handle.rid, "status": FAILED, "class": cls,
                "error": handle.error,
            }
            code = 500
        else:  # still PENDING past max_wait_s — transport gives up, the
            # request itself stays queued and will still complete/shed.
            payload = {
                "rid": handle.rid, "status": "TIMEOUT", "class": cls,
                "error": f"no verdict within {fe.max_wait_s}s",
            }
            code = 503
        self._send_json(code, payload)
        fe._finish(handle.rid, cls, t0, str(payload["status"]), code)


def _parse_infer(req: dict) -> Tuple[np.ndarray, str, Optional[float], str, bool]:
    """Decode one /v1/infer body into (x, cls, deadline_s, rid, want_out).
    Raises ValueError on anything malformed — mapped to 400 upstream."""
    shape = req.get("shape")
    if not isinstance(shape, list) or len(shape) not in (3, 4) or not all(
        isinstance(d, int) and d > 0 for d in shape
    ):
        raise ValueError(f"shape must be [n,H,W,C] or [H,W,C], got {shape!r}")
    n_elem = int(np.prod(shape))
    if "data" in req:
        data = req["data"]
        if not isinstance(data, list) or len(data) != n_elem:
            raise ValueError(
                f"data must be a flat list of {n_elem} numbers for shape {shape}"
            )
        x = np.asarray(data, np.float32).reshape(shape)
    else:
        x = np.full(shape, float(req.get("fill", 1.0)), np.float32)
    cls = str(req.get("class", ""))
    deadline_s = req.get("deadline_s")
    if deadline_s is not None:
        deadline_s = float(deadline_s)
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
    rid = str(req.get("rid", "")) or None
    return x, cls, deadline_s, rid or "", bool(req.get("return_output", False))


class ServingFrontend:
    """The network face of one :class:`InferenceServer`.

    Owns a ``ThreadingHTTPServer`` (one handler thread per in-flight
    exchange — transport threads block on handle waits; the dispatch
    loop never does) on ``host:port`` (port 0 = ephemeral, the test
    default). The wrapped server must be ``start()``ed by the caller —
    the front end is a transport, not a lifecycle manager.
    """

    def __init__(
        self,
        server: InferenceServer,
        port: int = 0,
        host: str = "127.0.0.1",
        max_wait_s: float = 120.0,
    ):
        self.server = server
        self.max_wait_s = max_wait_s
        self.http_codes: Dict[int, int] = {}
        self._codes_lock = threading.Lock()
        handler = type("BoundHandler", (_Handler,), {"frontend": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingFrontend":
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="serve-frontend",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(10.0)
        self._thread = None

    @off_timed_path
    def _finish(
        self, rid: str, cls: str, t0: float, status: str, http_code: int
    ) -> None:
        """Transport accounting AFTER the response hit the socket: the
        ``serve.transport`` span (emitted from its measured bounds — it
        temporally wraps the request's queue-wait + dispatch spans), the
        ``serve_transport``/``serve_reject`` journal record, and the
        metrics. Off the handler's measured window by construction."""
        t1 = time.monotonic()
        ms = (t1 - t0) * 1e3
        with self._codes_lock:
            self.http_codes[http_code] = self.http_codes.get(http_code, 0) + 1
        reg = metrics_registry()
        reg.counter(f"serve.http_{http_code}").inc()
        reg.histogram("serve.transport_ms").observe(ms)
        sid = ""
        tr = get_tracer()
        if tr is not None:
            sid = tr.emit(
                "serve.transport", t0, t1, parent_id="", track="transport",
                rid=rid, cls=cls, status=status, http=http_code,
            )
        kind = "serve_reject" if status == "REJECTED" else "serve_transport"
        payload = {
            "rid": rid, "cls": cls, "status": status, "http": http_code,
            "ms": round(ms, 3),
        }
        if sid:
            payload["trace_id"] = tr.trace_id
            payload["span_id"] = sid
        self.server._journal(kind, key=f"http:{rid or http_code}", **payload)


# --------------------------------------------------------- client fleet ---


def http_fleet_load(
    url: str,
    image_shape: Tuple[int, int, int],
    *,
    shape: str = "steady",
    rate_rps: float,
    duration_s: float,
    classes: Optional[List[RequestClass]] = None,
    seed: int = 0,
    n_workers: int = 8,
    timeout_s: float = 120.0,
    fill: float = 1.0,
) -> ShapedReport:
    """Threaded HTTP client fleet: drive a traffic shape through the front
    end over real sockets and account every request by its HTTP verdict
    (200 ok / 504 shed / 429 or 413 rejected / anything else failed).

    The arrival schedule and class mix are the SAME seeded draws the
    in-process shaped loader uses, so an HTTP drill and an in-process
    drill at one seed offer identical work — what differs is the
    transport. Latencies are client-measured wall (POST sent -> response
    read): the number a user actually sees, transport included. Per-class
    accounting closes: ok + shed + failed + rejected == offered.
    """
    if classes is None:
        raise ValueError("http_fleet_load needs an explicit class mix")
    parsed = urlparse(url)
    host, port = parsed.hostname, parsed.port
    arrivals = shaped_arrivals(shape, rate_rps, duration_s, seed)
    plan = assign_classes(classes, len(arrivals), seed)
    work: List[Tuple[float, RequestClass, int]] = [
        (at, c, n) for at, (c, n) in zip(arrivals, plan)
    ]
    stats: Dict[str, ClassStats] = {c.name: ClassStats() for c in classes}
    lock = threading.Lock()
    next_idx = [0]
    t0 = time.monotonic()
    images_ok = [0]
    last_done = [t0]

    def _worker() -> None:
        conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
        try:
            while True:
                with lock:
                    i = next_idx[0]
                    if i >= len(work):
                        return
                    next_idx[0] = i + 1
                at, c, n = work[i]
                now = time.monotonic() - t0
                if at > now:
                    time.sleep(at - now)
                body = json.dumps(
                    {
                        "shape": [n, *image_shape],
                        "fill": fill,
                        "class": c.name,
                        "deadline_s": c.deadline_s,
                        "rid": f"h{i:06d}",
                    }
                )
                sent = time.monotonic()
                try:
                    conn.request(
                        "POST", "/v1/infer", body,
                        {"Content-Type": "application/json"},
                    )
                    # The fleet MEASURES user-visible latency around its
                    # own socket wait — blocking here is the experiment.
                    resp = conn.getresponse()  # noqa: blocking-socket-call-in-timed-region
                    resp.read()
                    code = resp.status
                except (OSError, http.client.HTTPException):
                    conn.close()
                    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
                    code = -1
                wall_ms = (time.monotonic() - sent) * 1e3
                with lock:
                    st = stats[c.name]
                    st.offered += 1
                    if code == 200:
                        st.ok += 1
                        st.images_ok += n
                        st.latencies_ms.append(wall_ms)
                        images_ok[0] += n
                    elif code == 504:
                        st.shed += 1
                    elif code in (429, 413):
                        st.rejected += 1
                    else:
                        st.failed += 1
                    last_done[0] = max(last_done[0], time.monotonic())
        finally:
            conn.close()

    threads = [
        threading.Thread(target=_worker, name=f"http-load-{i}", daemon=True)
        for i in range(max(1, n_workers))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s + duration_s)
    wall = max(1e-9, last_done[0] - t0)
    return ShapedReport(
        shape=shape,
        per_class=stats,
        duration_s=wall,
        sustained_img_s=images_ok[0] / wall,
    )
