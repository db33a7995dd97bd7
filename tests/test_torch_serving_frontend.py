"""The port's HTTP front end (``<port>/serving/frontend.py``) against the JAX package's, on the CPU.

The same requests go over real sockets to a JAX front end (over the JAX
``v1_jit`` server) and to the port's (over its ``v3_pallas`` server, whose
kernels run their plain versions on the CPU), both at the 63x63 geometry
of ``tests/test_serving_frontend.py`` with the JAX package's
``init_params_deterministic``: the answers' status codes (200, 400, 404,
413, 429 with ``Retry-After``, 504 with its reason) and bodies' verdicts
are the same, a 200's ``output`` is within the fp32 budget of
``precision/gate.py`` of the JAX server's, the refusals are journaled
(``serve_reject``) and the exchanges too (``serve_transport``), and the
threaded client fleet closes its per-class accounting. Each front end is
built once per module.
"""

import dataclasses
import http.client
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cuda_mpi_gpu_cluster_programming_tpu.models.alexnet import BLOCKS12 as JBLOCKS12  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.models.init import init_params_deterministic as jinit  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.precision.gate import DEFAULT_BUDGETS  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import frontend as jfrontend  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu.serving import server as jserver  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import BLOCKS12  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.models.init import params_from_jax  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal  # noqa: E402
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving import frontend, server, traffic  # noqa: E402

CFG = dataclasses.replace(BLOCKS12, in_height=63, in_width=63)
JCFG = dataclasses.replace(JBLOCKS12, in_height=63, in_width=63)
IMG = [CFG.in_height, CFG.in_width, CFG.in_channels]


def _post(fe, payload, timeout=60.0):
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=timeout)
    try:
        conn.request("POST", "/v1/infer", json.dumps(payload), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), resp.getheader("Retry-After")
    finally:
        conn.close()


def _get(fe, path, timeout=30.0):
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode(), resp.getheader("Content-Type")
    finally:
        conn.close()


def _records(path, kind, n, timeout_s=10.0):
    """The journal's records of ``kind`` once there are ``n`` (they are
    written after the response, off the handler's measured window)."""
    deadline = time.monotonic() + timeout_s
    while True:
        recs = [r for r in Journal.load(path) if r["kind"] == kind]
        if len(recs) >= n or time.monotonic() > deadline:
            return recs
        time.sleep(0.01)


@pytest.fixture(scope="module")
def fronts(tmp_path_factory):
    """A started JAX server and a started port server, each behind its front end."""
    jpath = tmp_path_factory.mktemp("jfe") / "serve.jsonl"
    tpath = tmp_path_factory.mktemp("tfe") / "serve.jsonl"
    jparams = jinit(JCFG)
    jsrv = jserver.InferenceServer(jserver.ServeConfig(config="v1_jit", max_batch=4, model_cfg=JCFG,
                                                       journal_path=str(jpath)), params=jparams).start()
    tsrv = server.InferenceServer(server.ServeConfig(config="v3_pallas", max_batch=4, model_cfg=CFG, device="cpu",
                                                     journal_path=str(tpath)),
                                  params=params_from_jax(jparams, device="cpu")).start()
    jfe, tfe = jfrontend.ServingFrontend(jsrv).start(), frontend.ServingFrontend(tsrv).start()
    yield dict(jax=jfe, port=tfe, jpath=jpath, tpath=tpath)
    for fe in (jfe, tfe):
        fe.stop()
    jsrv.stop()
    tsrv.close()


def test_a_200_carries_the_jax_servers_output(fronts):
    x = np.random.default_rng(3).random((2, *IMG), dtype=np.float32)
    body = {"shape": list(x.shape), "data": x.reshape(-1).tolist(), "return_output": True, "class": "interactive"}
    (jcode, jbody, _), (code, got, _) = _post(fronts["jax"], body), _post(fronts["port"], body)
    assert code == jcode == 200 and set(got) == set(jbody)
    assert got["status"] == "OK" and got["class"] == "interactive" and got["output_shape"] == jbody["output_shape"]
    out = np.asarray(got["output"], np.float32).reshape(got["output_shape"])
    want = np.asarray(jbody["output"], np.float32).reshape(jbody["output_shape"])
    budget = DEFAULT_BUDGETS["fp32"]["*"]
    diff = float(np.abs(out - want).max())
    assert diff <= budget.max_abs and diff / float(np.abs(want).max()) <= budget.max_rel
    assert got["latency_ms"] > 0


@pytest.mark.parametrize("body,code", [
    ({"shape": "nope"}, 400),
    ({"shape": [1, *IMG], "data": [1.0, 2.0]}, 400),
    ({"shape": [1, *IMG], "fill": 1.0, "deadline_s": -1}, 400),
    ({"shape": [2, 2]}, 400),
    ({"shape": [5, *IMG], "fill": 1.0}, 413),
    ({"shape": [1, *IMG], "fill": 1.0, "deadline_s": 1e-6}, 504),
    ({"shape": IMG, "fill": 0.5, "rid": "single"}, 200),
])
def test_each_answer_is_the_jax_front_ends(body, code, fronts):
    (jcode, jbody, _), (got_code, got, _) = _post(fronts["jax"], body), _post(fronts["port"], body)
    assert got_code == jcode == code
    assert set(got) == set(jbody) and got["status"] == jbody["status"]
    assert got.get("reason") == jbody.get("reason")
    if code == 504:
        assert got["reason"] == "deadline" and "deadline" in got["error"]
    if code == 200:
        assert got["rid"] == "single" and got["output_shape"] == jbody["output_shape"] == [1, 2, 2, 256]


def test_refusals_and_exchanges_are_journaled(fronts):
    for fe in (fronts["jax"], fronts["port"]):
        assert _post(fe, {"shape": "nope"})[0] == 400
        assert _post(fe, {"shape": [1, *IMG], "fill": 1.0})[0] == 200
    for path in (fronts["jpath"], fronts["tpath"]):
        rejects = _records(path, "serve_reject", 1)
        exchanges = _records(path, "serve_transport", 1)
        assert rejects and all(r["status"] == "REJECTED" and r["http"] in (400, 413) for r in rejects)
        assert exchanges and all({"rid", "cls", "status", "http", "ms"} <= set(r) for r in exchanges)


def test_backpressure_answers_429_with_retry_after(tmp_path):
    """Both servers parked (no dispatch loop) with one pending slot filled."""
    jsrv = jserver.InferenceServer(jserver.ServeConfig(config="v1_jit", max_batch=2, max_pending=1, model_cfg=JCFG))
    tsrv = server.InferenceServer(server.ServeConfig(config="v1_jit", max_batch=2, max_pending=1, model_cfg=CFG,
                                                     device="cpu", journal_path=str(tmp_path / "s.jsonl")))
    answers = []
    for srv, mod in ((jsrv, jfrontend), (tsrv, frontend)):
        fe = mod.ServingFrontend(srv).start()
        try:
            srv.submit(np.ones((1, *IMG), np.float32))
            answers.append(_post(fe, {"shape": [1, *IMG], "fill": 1.0}))
            answers.append(_get(fe, "/healthz"))
            answers.append(_get(fe, "/stats"))
        finally:
            fe.stop()
    (jcode, jbody, jretry), jhealth, jstats, (code, body, retry), health, stats = answers
    assert code == jcode == 429 and retry == jretry == "1" and body == jbody and "max_pending" in body["error"]
    h, jh = json.loads(health[1]), json.loads(jhealth[1])
    assert health[0] == jhealth[0] == 200 and set(h) == set(jh) and set(h["queue"]) == set(jh["queue"])
    assert h["queue"]["depth"] == jh["queue"]["depth"] == 1 and h["buckets"] == jh["buckets"] == [1, 2]
    st, jst = json.loads(stats[1]), json.loads(jstats[1])
    assert set(st) == set(jst) and st["http"] == {"429": 1}
    (rec,) = _records(tmp_path / "s.jsonl", "serve_reject", 1)
    assert rec["http"] == 429


def test_metrics_scrape_is_prometheus_text_and_journaled(fronts):
    code, text, ctype = _get(fronts["port"], "/metrics")
    jcode, jtext, jctype = _get(fronts["jax"], "/metrics")
    assert code == jcode == 200 and ctype == jctype and ctype.startswith("text/plain; version=0.0.4")
    assert "# TYPE serve_ok counter" in text.splitlines()
    assert any(line.startswith("serve_request_ms_count") for line in text.splitlines())
    assert _get(fronts["port"], "/nope")[0] == _get(fronts["jax"], "/nope")[0] == 404
    assert any(r["status"] == "METRICS" for r in _records(fronts["tpath"], "serve_transport", 1))


def test_the_client_fleet_closes_its_accounting(fronts):
    srv = fronts["port"].server
    mix = list(traffic.default_class_mix(srv.buckets))
    rep = frontend.http_fleet_load(fronts["port"].url, tuple(IMG), shape="diurnal+burst", rate_rps=30.0,
                                   duration_s=0.3, classes=mix, seed=2, n_workers=4)
    offered = sum(s.offered for s in rep.per_class.values())
    assert rep.closed and offered == len(traffic.shaped_arrivals("diurnal+burst", 30.0, 0.3, 2))
    assert srv.stats.cache_misses == 0


@pytest.mark.parametrize("body", [
    {"shape": [1, 2, 2, 1], "data": [1, 2, 3, 4], "class": "bulk", "deadline_s": 0.5, "rid": "r1"},
    {"shape": [2, 2, 1], "fill": 2.5, "return_output": True},
    {"shape": [1, 2, 2, 1], "data": [1, 2]},
    {"shape": [0, 2, 2, 1]},
    {"shape": [1, 2, 2, 1], "deadline_s": 0},
])
def test_parse_infer_is_the_jax_packages(body):
    try:
        want = jfrontend._parse_infer(body)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            frontend._parse_infer(body)
        assert str(got.value) == str(e)
        return
    got = frontend._parse_infer(body)
    assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype and got[1:] == want[1:]
