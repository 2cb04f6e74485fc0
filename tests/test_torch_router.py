"""The port's front-door router (deeplearning4j_tpu_torch/serving/router.py)
over two in-process port hosts on threads, held against the JAX package's
router over JAX hosts on the CPU.

One scenario runs once per package (module-scoped fixtures) on the same
weights: an MLP and a narrow F32 gpt_mini built by the JAX package and
carried into the port through the zip.

- ``/predict`` through the router equals the same rows through a host
  called directly, bit for bit, and spreads over both hosts.
- A dead host is evicted, its request retried on the survivor, and the
  router degrades; with no routable host it answers 503 and reads
  ``unhealthy``; when every host 503s, the router's 503 carries the
  minimum Retry-After; ``/api/fleet`` carries the routing table.
- ``/decode`` failover: the pinned host dies mid-stream and the survivor
  re-prefills from the router's history; the stream equals the
  uninterrupted one.
- Canary: start (token bucket), evaluate (wait, then fail on a NaN row),
  rollback (quarantine, dropped pins, a flight-recorder artifact).
- The JAX package's run gives the same status codes, health states and
  counters, with predictions and decode logits within 1e-5 (f32 sums in
  other orders) and the same tokens.

Every server and router is stopped in ``finally``; every HTTP call has a
timeout.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.observability import distributed as jdist
from deeplearning4j_tpu.observability import flightrec as jflight
from deeplearning4j_tpu.serving import router as jrouter
from deeplearning4j_tpu.serving.decode import DecodeEngine as JEngine
from deeplearning4j_tpu.serving.server import ModelServer as JServer
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.observability import distributed as tdist
from deeplearning4j_tpu_torch.observability import flightrec as tflight
from deeplearning4j_tpu_torch.serving import router as trouter
from deeplearning4j_tpu_torch.serving.decode import DecodeEngine as TEngine
from deeplearning4j_tpu_torch.serving.server import ModelServer as TServer
from deeplearning4j_tpu_torch.utils import serialization as tser

TOL = 1e-5       # f32 forwards of the same weights in two libraries
V = 13
GPT = dict(vocab_size=V, width=16, n_layers=1, n_heads=2, max_len=32,
           seed=5)


def _post(url, path, obj, headers=None, timeout=30.0):
    """(status, json body, headers); error replies come back the same way."""
    req = urllib.request.Request(
        url.rstrip("/") + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url, timeout=30.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _dead_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


class _Overloaded503(BaseHTTPRequestHandler):
    retry_after = "2.5"

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        body = b'{"error": "queue full"}'
        self.send_response(503)
        self.send_header("Retry-After", self.retry_after)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _Fast503(_Overloaded503):
    retry_after = "0.7"


class Pkg:
    def __init__(self, name, server, router, engine, dist, flight, mlp,
                 gpt, out):
        self.name, self.Server, self.router = name, server, router
        self.Engine, self.dist, self.flight = engine, dist, flight
        self.mlp, self.gpt, self._out = mlp, gpt, out

    def output(self, net, x):
        return np.asarray(self._out(net.output(x)), np.float32)


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    root = tmp_path_factory.mktemp("router")
    conf = (JConf.builder().seed(1).list()
            .layer(JDense(n_in=6, n_out=8, activation="relu"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    jmlp = JMLN(conf).init()
    jser.write_model(jmlp, str(root / "mlp.zip"))
    jser.write_model(jzoo.gpt_mini(dtype=jzoo.F32, **GPT),
                     str(root / "gpt.zip"))
    return {
        "jax": Pkg("jax", JServer, jrouter, JEngine, jdist, jflight, jmlp,
                   lambda: jzoo.gpt_mini(dtype=jzoo.F32, **GPT),
                   lambda y: y),
        "torch": Pkg("torch", TServer, trouter, TEngine, tdist, tflight,
                     tser.restore_multi_layer_network(str(root / "mlp.zip"),
                                                      device="cpu"),
                     lambda: tser.restore_multi_layer_network(
                         str(root / "gpt.zip"), device="cpu"),
                     lambda y: y.float().numpy()),
    }


X = np.random.default_rng(0).normal(size=(2, 6)).astype(np.float32)


def _predict_phase(P, rec):
    srvs = [P.Server(P.mlp, port=0, replicas=1, max_batch=8, max_queue=64,
                     warmup=False).start() for _ in range(2)]
    router = P.router.FrontDoorRouter([s.url for s in srvs]).start()
    try:
        preds, backends, statuses = [], set(), []
        for _ in range(8):
            st, out, h = _post(router.url, "/predict",
                               {"features": X.tolist()})
            statuses.append(st)
            preds.append(np.asarray(out["predictions"], np.float32))
            backends.add(h[P.router.BACKEND_HEADER])
        direct = np.asarray(srvs[0].predict(X), np.float32)
        rec["predict"] = {"statuses": statuses, "n_backends": len(backends),
                          "spread": backends == {s.url for s in srvs},
                          "healthz": router.healthz()[1]["status"],
                          "routes": len(router.route_table())}
        rec["preds"], rec["direct"] = preds, direct
        # a dead host joins: the request that picks it is retried
        dead = router.add_host(_dead_url())
        st_dead = []
        for _ in range(4):
            st, out, h = _post(router.url, "/predict",
                               {"features": X.tolist()})
            st_dead.append((st, h[P.router.BACKEND_HEADER] != dead.base_url))
        d = router.describe()
        code, hz = router.healthz()
        code_f, fleet = _get(router.url + "/api/fleet")
        rec["evict"] = {"statuses": st_dead, "evicted": d["evicted_total"],
                        "retried": d["retried_total"] >= 1,
                        "dead": dead.status, "healthz": (code,
                                                         hz["status"])}
        rec["fleet"] = {"code": code_f, "keys": sorted(fleet),
                        "routing": sorted(r["status"]
                                          for r in fleet["routing"]),
                        "requests": fleet["router"]["requests_total"]}
    finally:
        router.stop()
        for s in srvs:
            s.stop()


def _failure_phase(P, rec):
    router = P.router.FrontDoorRouter([_dead_url()]).start()
    try:
        st, out, _ = _post(router.url, "/predict", {"features": [[0.0] * 6]})
        code, hz = router.healthz()
        with pytest.raises(P.router.NoHostsError):
            P.router.FrontDoorRouter().handle_predict(b"{}", "t")
        rec["no_hosts"] = {"status": st, "healthz": (code, hz["status"])}
    finally:
        router.stop()
    servers = []
    for handler in (_Overloaded503, _Fast503):
        hs = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=hs.serve_forever, daemon=True).start()
        servers.append(hs)
    router = P.router.FrontDoorRouter(
        [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]).start()
    try:
        st, out, h = _post(router.url, "/predict", {"features": [[0.0] * 6]},
                           headers={"X-DL4J-Priority": "batch"})
        rec["global_503"] = {
            "status": st, "retry_after": float(h["Retry-After"]),
            "shed_class": h.get("X-DL4J-Shed-Class"),
            "shed_total": router.describe()["shed_total"],
            "hosts": [x.status for x in router.hosts]}
    finally:
        router.stop()
        for s in servers:
            s.shutdown()
            s.server_close()


def _decode_phase(P, rec):
    servers = [P.Server(P.gpt(), port=0, replicas=1, warmup=False,
                        decode_engine=P.Engine(P.gpt(), n_pages=16,
                                               page_tokens=8)).start()
               for _ in range(2)]
    router = P.router.FrontDoorRouter([s.url for s in servers]).start()
    prompt, n_tokens = [1, 4, 7], 6
    try:
        st, out, _ = _post(router.url, "/decode",
                           {"op": "prefill", "sid": "s1", "ids": prompt})
        statuses = [st]
        logits = [np.asarray(out["logits"], np.float32)]
        toks, recovered = [], 0
        for i in range(n_tokens):
            nxt = int(np.argmax(logits[-1]))
            toks.append(nxt)
            st, out, _ = _post(router.url, "/decode",
                               {"op": "step", "sid": "s1", "token": nxt})
            statuses.append(st)
            recovered += bool(out.get("recovered"))
            logits.append(np.asarray(out["logits"], np.float32))
            if i == 1:
                # the pinned host dies: stop it and drop the router's
                # pooled connections, so the next proxy is refused
                pinned = router._affinity["s1"]
                next(s for s in servers if s.url == pinned.base_url).stop()
                pinned.close()
        d = router.describe()
        code, hz = router.healthz()
        st, out, _ = _post(router.url, "/decode", {"op": "close",
                                                   "sid": "s1"})
        # the uninterrupted stream: the survivor's own generate
        st_g, gen, _ = _post(router.url, "/decode",
                             {"op": "generate", "sid": "s2", "ids": prompt,
                              "n_tokens": n_tokens})
        rec["decode"] = {"statuses": statuses, "recovered": recovered,
                         "failovers": d["failovers_total"],
                         "evicted": d["evicted_total"],
                         "hits": d["affinity_hits"] >= n_tokens - 1,
                         "healthz": (code, hz["status"]),
                         "closed": (st, out["closed"]),
                         "generate_status": st_g}
        rec["tokens"], rec["logits"] = toks, logits
        rec["uninterrupted"] = gen["tokens"]
    finally:
        router.stop()
        for s in servers:
            s.stop()


def _fake_push(fed, tag, url, serving):
    fed.ingest({"schema": 1, "identity": {"tag": tag}, "time": time.time(),
                "families": [], "health": {"server_url": url,
                                           "serving": serving}})


def _canary_phase(P, rec, flight_dir):
    P.flight.install_flight_recorder(str(flight_dir))
    try:
        fed = P.dist.MetricsFederation(stale_after_s=30.0)
        router = P.router.FrontDoorRouter(federation=fed)
        stable = router.add_host("http://127.0.0.1:59994")
        canary = router.add_host("http://127.0.0.1:59995")
        _fake_push(fed, "s", stable.base_url,
                   {"requests_total": 50, "errors_total": 0,
                    "nan_rows_total": 0, "latency_p99_ms": 4.0})
        _fake_push(fed, "c", canary.base_url,
                   {"requests_total": 0, "errors_total": 0,
                    "nan_rows_total": 0, "latency_p99_ms": None})
        errors = []
        try:
            router.start_canary(canary.base_url, fraction=0.6)
        except ValueError as e:
            errors.append(str(e))
        started = router.start_canary(canary.base_url, version=9,
                                      fraction=0.25, min_requests=50)
        picks = [router._pick_canary_admitted(()) for _ in range(40)]
        first = router.evaluate_canary()
        router._affinity["sid-1"] = canary
        _fake_push(fed, "c", canary.base_url,
                   {"requests_total": 3, "errors_total": 0,
                    "nan_rows_total": 2, "latency_p99_ms": 5.0})
        verdict = router.evaluate_canary()
        rb = router.rollback_canary(verdict, reason="nan sentinel")
        try:
            router.start_canary(canary.base_url)
        except RuntimeError as e:
            errors.append(str(e).replace(canary.base_url, "<c>"))
        with open(rb["artifact"]) as f:
            doc = json.load(f)
        event = next(e for e in doc["events"]
                     if e["kind"] == "canary_rollback")
        routable = [h.base_url for h, _ in router._routable()]
        rec["canary"] = {
            "started": started, "canary_picks": picks.count(canary),
            "first": first["decision"],
            "verdict": {k: verdict[k] for k in ("decision", "killed_by",
                                                "deltas", "version")},
            "rollback": {k: v for k, v in rb.items() if k != "artifact"},
            "artifact_reason": doc["reason"],
            "event": json.loads(event["detail"]),
            "quarantined": router.describe()["quarantined"],
            "pins": sorted(router._affinity), "routable": routable,
            "reinstated": router.reinstate(canary.base_url),
            "errors": errors}
    finally:
        P.flight.uninstall_flight_recorder()


def _run(P, flight_dir):
    rec = {}
    _predict_phase(P, rec)
    _failure_phase(P, rec)
    _decode_phase(P, rec)
    _canary_phase(P, rec, flight_dir)
    return rec


@pytest.fixture(scope="module")
def port_run(pkgs, tmp_path_factory):
    return _run(pkgs["torch"], tmp_path_factory.mktemp("tflight"))


@pytest.fixture(scope="module")
def jax_run(pkgs, tmp_path_factory):
    return _run(pkgs["jax"], tmp_path_factory.mktemp("jflight"))


def test_predict_is_bit_equal_to_a_host_called_directly_and_spreads(
        pkgs, port_run):
    p = port_run["predict"]
    assert p["statuses"] == [200] * 8 and p["spread"]
    assert p["healthz"] == "ok" and p["routes"] == 2
    for pred in port_run["preds"]:
        assert np.array_equal(pred, port_run["direct"])
    net = pkgs["torch"].mlp
    assert np.array_equal(port_run["direct"],
                          pkgs["torch"].output(net, X))


def test_dead_host_is_evicted_its_request_retried_and_router_degrades(
        port_run):
    e = port_run["evict"]
    assert e["statuses"] == [(200, True)] * 4
    assert e["evicted"] == 1 and e["retried"] and e["dead"] == "dead"
    assert e["healthz"] == (200, "degraded")


def test_no_hosts_is_503_and_unhealthy(port_run):
    assert port_run["no_hosts"] == {"status": 503,
                                    "healthz": (503, "unhealthy")}


def test_global_503_carries_the_minimum_retry_after(port_run):
    g = port_run["global_503"]
    assert g["status"] == 503 and g["retry_after"] == 0.7
    assert g["shed_class"] == "batch" and g["shed_total"] == 1
    assert g["hosts"] == ["live", "live"]


def test_api_fleet_carries_the_routing_table(port_run):
    f = port_run["fleet"]
    assert f["code"] == 200 and f["routing"] == ["dead", "live", "live"]
    assert {"routing", "router", "slo", "trace_store", "instances"} <= \
        set(f["keys"])
    assert f["requests"] == 12


def test_decode_failover_reprefill_equals_the_uninterrupted_stream(
        port_run):
    d = port_run["decode"]
    assert d["statuses"] == [200] * 7 and d["recovered"] == 1
    assert d["failovers"] == 1 and d["evicted"] == 1 and d["hits"]
    assert d["healthz"] == (200, "degraded")
    assert d["closed"] == (200, True) and d["generate_status"] == 200
    assert port_run["tokens"] == port_run["uninterrupted"]


def test_canary_start_evaluate_and_rollback(port_run):
    c = port_run["canary"]
    assert c["canary_picks"] == 10 and c["first"] == "wait"
    assert c["verdict"]["decision"] == "fail"
    assert c["verdict"]["killed_by"]["gate"] == "max_nan_rows"
    assert c["rollback"]["quarantined"] is True
    assert c["rollback"]["sessions_dropped"] == 1 and c["pins"] == []
    assert c["artifact_reason"] == "rollback"
    assert c["event"]["rejected_version"] == 9
    assert c["quarantined"] == ["http://127.0.0.1:59995"]
    assert c["routable"] == ["http://127.0.0.1:59994"]
    assert c["reinstated"] is True and len(c["errors"]) == 2


def test_same_statuses_and_health_as_the_jax_router(port_run, jax_run):
    for key in ("predict", "evict", "fleet", "no_hosts", "global_503",
                "decode", "canary"):
        assert port_run[key] == jax_run[key], key
    for p, j in zip(port_run["preds"], jax_run["preds"]):
        np.testing.assert_allclose(p, j, rtol=0, atol=TOL)
    for p, j in zip(port_run["logits"], jax_run["logits"]):
        np.testing.assert_allclose(p, j, rtol=0, atol=TOL)
    assert port_run["tokens"] == jax_run["tokens"]
    assert port_run["uninterrupted"] == jax_run["uninterrupted"]
