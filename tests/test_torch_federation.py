"""The port's federation (the HTTP half of
deeplearning4j_tpu_torch/observability/distributed.py) held against the
JAX package's on the CPU.

- ``export_snapshot``: the same registry operations in each package give
  snapshots with the same keys, identity keys and families.
- ``push_snapshot``'s retry schedule (seeded jitter, equal sleeps) and a
  ``HeartbeatPusher`` that never raises, with the JAX defaults.
- ``MetricsFederation``: the same pushed snapshots (counters, gauges,
  histograms, kind conflicts, a spoofed instance label, heartbeats of
  several ages) give the same merged exposition, ``health()`` rows,
  auto-evictions and ``fleet_payload()`` on one fixed clock.
- ``SpanPushBuffer`` -> ``TraceStore.waterfall``: the same spans give the
  same push payloads and the same stitched waterfall (clock offsets and
  network gaps), and each package's store ingests the other's batch.
- Across the wire: a port host's heartbeat is ingested by the JAX
  package's router, and a JAX heartbeat by the port's.

Host-only logic: results are held exactly. Every server, router and
pusher is stopped in ``finally``; every HTTP call has a timeout.
"""

import json
import random
import time
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.observability import distributed as jdist
from deeplearning4j_tpu.observability import metrics as jmetrics
from deeplearning4j_tpu.observability import trace as jtrace
from deeplearning4j_tpu_torch.observability import distributed as tdist
from deeplearning4j_tpu_torch.observability import metrics as tmetrics
from deeplearning4j_tpu_torch.observability import trace as ttrace

PKGS = {"jax": (jdist, jmetrics, jtrace), "torch": (tdist, tmetrics, ttrace)}
DEAD = "http://127.0.0.1:1/api/metrics_push"   # refused at once


def _fill(metrics_mod):
    reg = metrics_mod.MetricsRegistry()
    reg.counter("dl4j_a_total", "a counter", ("kind",)).labels(
        kind="x").inc(3)
    reg.gauge("dl4j_depth", "a gauge").set(7.5)
    h = reg.histogram("dl4j_lat_seconds", "a histogram",
                      buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 3.0):
        h.observe(v)
    return reg


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return type(obj).__name__


@pytest.fixture()
def same_identity():
    for d in (jdist, tdist):
        d.reset_identity()
        d.set_identity(run_id="rr", instance="w1", pid=1, incarnation=2,
                       start_time=5.0)
    try:
        yield
    finally:
        for d in (jdist, tdist):
            d.reset_identity()


def test_export_snapshot_keys_equal_the_jax_package(same_identity):
    snaps = {name: d.export_snapshot(_fill(m), health={"batcher_healthy":
                                                       True},
                                     spans={"schema": 1, "spans": []})
             for name, (d, m, _) in PKGS.items()}
    assert _keys(snaps["torch"]) == _keys(snaps["jax"])
    for key in ("schema", "identity", "families", "health", "spans"):
        assert snaps["torch"][key] == snaps["jax"][key], key
    assert json.loads(json.dumps(snaps["torch"])) == snaps["torch"]
    assert tdist.SNAPSHOT_SCHEMA_VERSION == jdist.SNAPSHOT_SCHEMA_VERSION
    assert tdist.TRACE_PUSH_SCHEMA_VERSION == \
        jdist.TRACE_PUSH_SCHEMA_VERSION
    assert tdist.__all__ == jdist.__all__


def test_push_snapshot_retry_schedule_equals_the_jax_package():
    """attempts=3 against a dead target: the same two jittered sleeps
    (initial 0.2, factor 2, jitter 0.5) under one seed, then OSError."""
    sleeps = {}
    for name, (d, m, _) in PKGS.items():
        random.seed(7)
        got = []
        with pytest.raises(OSError):
            d.push_snapshot(DEAD, m.MetricsRegistry(), {}, timeout=2.0,
                            attempts=3, sleep_fn=got.append)
        sleeps[name] = got
    assert sleeps["torch"] == sleeps["jax"]
    assert len(sleeps["torch"]) == 2
    assert 0.2 <= sleeps["torch"][0] <= 0.3
    assert 0.4 <= sleeps["torch"][1] <= 0.6


def test_heartbeat_pusher_never_raises_with_the_jax_defaults():
    p = tdist.HeartbeatPusher(DEAD, interval_s=0.05, timeout=2.0,
                              backoff_initial_s=0.0,
                              health_fn=lambda: 1 / 0)
    j = jdist.HeartbeatPusher(DEAD)
    for attr in ("interval_s", "attempts", "backoff_initial_s",
                 "backoff_factor", "backoff_max_s", "jitter", "timeout"):
        assert getattr(tdist.HeartbeatPusher(DEAD), attr) == \
            getattr(j, attr), attr
    try:
        assert p.push_once() is False          # health_fn raised
        assert "ZeroDivisionError" in p.last_error
        p.health_fn = None
        p.start()                              # first push synchronous
        deadline = time.time() + 10.0
        while p.pushes_failed < 3 and time.time() < deadline:
            time.sleep(0.02)
        assert p.pushes_failed >= 3 and p.pushes_ok == 0
        assert "URLError" in p.last_error or "Error" in p.last_error
    finally:
        p.stop()
    assert p._thread is None


def _wire(tag, fams, health=None, t=1000.0):
    return {"schema": 1, "identity": {"tag": tag, "instance": tag},
            "time": t, "families": fams, "health": health or {}}


def _fam(name, kind, samples):
    return {"name": name, "kind": kind, "help": f"{name} help",
            "samples": [{"labels": dict(lb), "suffix": sfx, "value": v}
                        for lb, sfx, v in samples]}


def _federation_script(d, now):
    fed = d.MetricsFederation(stale_after_s=10.0, evict_after_factor=3.0)
    out = []
    snaps = [
        _wire("w0", [
            _fam("dl4j_steps_total", "counter", [({}, "", 10)]),
            _fam("dl4j_fit_steps_total", "counter", [({}, "", 4)]),
            _fam("dl4j_serving_queue_depth", "gauge",
                 [({"server": "a"}, "", 3), ({"server": "b"}, "", 2)]),
            _fam("dl4j_serving_retry_after_seconds", "gauge",
                 [({}, "", 0.2)]),
            _fam("dl4j_heartbeat_timestamp_seconds", "gauge",
                 [({}, "", 998.0)]),
            _fam("dl4j_lat", "histogram",
                 [({"le": "1"}, "_bucket", 2), ({"le": "+Inf"}, "_bucket",
                                                 5),
                  ({}, "_sum", 7.5), ({}, "_count", 5)]),
            _fam("dl4j_x", "counter", [({"instance": "evil"}, "", 5)]),
        ], health={"batcher_healthy": True, "server_url": "http://h0",
                   "replicas": [{"replica": 0}]}, t=1000.0),
        _wire("w1", [
            _fam("dl4j_steps_total", "counter", [({}, "", 32)]),
            _fam("dl4j_serving_queue_depth", "gauge", [({}, "", 9)]),
            _fam("dl4j_lat", "histogram",
                 [({"le": "1"}, "_bucket", 1), ({"le": "+Inf"}, "_bucket",
                                                 2),
                  ({}, "_sum", 3.5), ({}, "_count", 2)]),
            _fam("dl4j_x", "gauge", [({}, "", 7)]),
            _fam("dl4j_bad", "summary", [({}, "", 1)]),
            _fam("dl4j_heartbeat_timestamp_seconds", "gauge",
                 [({}, "", 990.0)]),
        ], health={"batcher_healthy": False, "ready": True}, t=1000.0),
        _wire("w2", [_fam("dl4j_heartbeat_timestamp_seconds", "gauge",
                          [({}, "", 960.0)])], t=1000.0),
    ]
    for s in snaps:
        out.append(fed.ingest(s))
    out.append(fed.render_prometheus())
    lf = d.MetricFamily("dl4j_local", "gauge", "local")
    lf.add(1.5, {"k": "v"})
    out.append(fed.render_prometheus(local=("router", [lf])))
    now[0] += 5.0
    out.append(fed.health())
    out.append(fed.instance_tags())            # w2 auto-evicted
    now[0] += 30.0
    fed.ingest(_wire("w0", [_fam("dl4j_fit_steps_total", "counter",
                                 [({}, "", 4)])], t=1035.0))
    payload = fed.fleet_payload()
    payload.pop("time")
    out.append(payload)
    out.append(fed.auto_evicted_total)
    with pytest.raises(ValueError) as ei:
        fed.ingest({"no": "families"})
    out.append(str(ei.value))
    return out


def test_federation_merge_and_health_equal_the_jax_package(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    got = {}
    for name, (d, _, _) in PKGS.items():
        now[0] = 1000.0
        got[name] = _federation_script(d, now)
    assert got["torch"] == got["jax"]
    text = got["torch"][3]
    assert 'dl4j_steps_total{instance="fleet"} 42' in text
    assert 'dl4j_lat_bucket{instance="fleet",le="+Inf"} 7' in text
    assert "evil" not in text
    assert got["torch"][6] == ["w0", "w1"]


def _span_dicts():
    return [
        {"name": "predict_handler", "ts_us": 100.0, "dur_us": 4000.0,
         "thread": "h", "attrs": {"trace_id": "t1",
                                  "server_url": "http://h0"}},
        {"name": "queue_wait", "ts_us": 500.0, "dur_us": 1000.0,
         "thread": "d", "attrs": {"trace_ids": ["t1", "t2"]}},
        {"name": "device_compute", "ts_us": 1600.0, "dur_us": 2000.0,
         "thread": "d", "attrs": {"trace_ids": ["t1"]}},
        {"name": "untraced", "ts_us": 0.0, "dur_us": 1.0, "attrs": {}},
    ]


def _stitch(d, payload):
    store = d.TraceStore(max_traces=8, max_spans_per_trace=16)
    n = store.ingest_snapshot({"identity": {"tag": "host0"},
                               "spans": payload})
    store.observe_network("t1", host="http://h0", path="/predict",
                          send_unix=50.0 + 0.0001, recv_unix=50.0 + 0.0061,
                          status=200)
    store.observe_network("t1", host="http://h1", path="/predict",
                          send_unix=49.0, recv_unix=49.5)
    return (n, store.waterfall("t1"), store.waterfall("t2"),
            store.waterfall("nope"), store.describe(), store.trace_ids())


def test_span_push_to_waterfall_equals_the_jax_package():
    payloads = {}
    for name, (d, _, tr) in PKGS.items():
        tracer = tr.Tracer(enabled=True)
        buf = d.SpanPushBuffer(tracer=tracer, capacity=2)
        for i in range(3):
            with tracer.span("step", trace_id=f"t{i}"):
                pass
        with tracer.span("untraced"):
            pass
        p = buf.payload()
        buf.remove()
        payloads[name] = ({k: v for k, v in p.items()
                           if k not in ("epoch_unix", "spans")},
                          [s["attrs"] for s in p["spans"]],
                          buf.payload())
    assert payloads["torch"] == payloads["jax"]
    wire = {"schema": 1, "epoch_unix": 50.0, "count": 4, "dropped_total": 0,
            "spans": _span_dicts()}
    got = {name: _stitch(d, wire) for name, (d, _, _) in PKGS.items()}
    assert got["torch"] == got["jax"]
    wf = got["torch"][1]
    assert wf["found"] and "host0" in wf["clock_offsets_ms"]
    assert {"network", "queue_wait", "device_compute"} <= \
        set(wf["summary_ms"])
    # each package's store files the other's span batch
    for src, dst in (("torch", "jax"), ("jax", "torch")):
        d_src, _, tr = PKGS[src]
        tracer = tr.Tracer(enabled=True)
        buf = d_src.SpanPushBuffer(tracer=tracer)
        with tracer.span("predict_handler", trace_id="x",
                         server_url="http://h"):
            pass
        snap = {"identity": {"tag": src}, "spans": buf.payload()}
        buf.remove()
        store = PKGS[dst][0].TraceStore()
        assert store.ingest_snapshot(snap) == 1
        assert store.waterfall("x")["instances"] == [src]


def _post(url, path, obj, timeout=30.0):
    req = urllib.request.Request(
        url.rstrip("/") + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _port_mlp():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(Dense(n_in=6, n_out=8, activation="relu"))
            .layer(Output(n_in=8, n_out=3, activation="softmax",
                          loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_each_package_ingests_the_others_push_across_the_wire():
    """A port ModelServer's heartbeat (push_url) lands in the JAX
    router's federation with its server_url and serving families, and a
    JAX HeartbeatPusher's lands in the port router's."""
    from deeplearning4j_tpu.serving.router import \
        FrontDoorRouter as JRouter
    from deeplearning4j_tpu_torch.serving import ModelServer
    from deeplearning4j_tpu_torch.serving.router import \
        FrontDoorRouter as TRouter
    jr = JRouter().start()
    tr = TRouter().start()
    srv = jpush = None
    try:
        srv = ModelServer(_port_mlp(), port=0, warmup=False, max_batch=4,
                          push_url=jr.url + "/api/metrics_push",
                          push_interval_s=30.0).start()
        srv.predict(np.zeros((2, 6), np.float32))
        assert srv._pusher.push_once() is True
        rows = jr._fed_rows()
        row = rows[srv.url]
        assert row["ready"] and row["health"]["serving"][
            "requests_total"] == 1
        text = jr.federation.render_prometheus()
        for fam in ("dl4j_serving_requests_total", "dl4j_sched_admitted_total",
                    "dl4j_slo_attainment"):
            assert f"# TYPE {fam} " in text, fam
        jreg = jmetrics.MetricsRegistry()
        jreg.gauge("dl4j_serving_queue_depth", "d").set(4)
        jpush = jdist.HeartbeatPusher(
            tr.url + "/api/metrics_push", interval_s=30.0, registry=jreg,
            health_fn=lambda: {"batcher_healthy": True,
                               "server_url": "http://jax-host:1"}).start()
        assert jpush.pushes_ok == 1
        trow = tr._fed_rows()["http://jax-host:1"]
        assert trow["queue_depth"] == 4.0 and trow["ready"]
        st, _ = _post(tr.url, "/api/metrics_push",
                      jdist.export_snapshot(jreg))
        assert st == 200
    finally:
        if jpush is not None:
            jpush.stop()
        if srv is not None:
            srv.stop()
        jr.stop()
        tr.stop()
