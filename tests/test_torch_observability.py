"""The port's observability core (deeplearning4j_tpu_torch/observability)
against the JAX package's, on the CPU.

- The tracer: the same spans recorded into both give the same ring,
  sampling drops, per-name drop table and Chrome-trace event keys; the
  port's span names appear in a ``torch.profiler`` profile.
- The metrics registry: the same operations on a fresh registry in each
  package render byte-equal Prometheus text and equal JSON snapshots;
  ``ResilienceStats`` renders the same families.
- The flight recorder: a flush writes schema 1 with the JAX file's keys.
- The process identity comes from the JAX package's environment
  variables.
The fit loops' spans, with the threads they run on, close the file.
"""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.observability import distributed as jdist
from deeplearning4j_tpu.observability import flightrec as jflight
from deeplearning4j_tpu.observability import metrics as jmetrics
from deeplearning4j_tpu.observability import trace as jtrace
from deeplearning4j_tpu.resilience.supervisor import (
    ResilienceStats as JResilienceStats)
from deeplearning4j_tpu_torch import datapipe as tpipe
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.observability import distributed as tdist
from deeplearning4j_tpu_torch.observability import flightrec as tflight
from deeplearning4j_tpu_torch.observability import metrics as tmetrics
from deeplearning4j_tpu_torch.observability import trace as ttrace
from deeplearning4j_tpu_torch.resilience.supervisor import (
    ResilienceStats as TResilienceStats)

NAMES = ["data_wait", "host_dispatch", "device_step", "data_wait",
         "score_sync", "device_step", "data_wait", "host_dispatch",
         "device_step", "data_wait", "score_sync", "device_step"]


def _fill(tracer):
    t0 = tracer._epoch
    for i, name in enumerate(NAMES):
        tracer.record(name, t0 + i * 1e-3, t0 + i * 1e-3 + 5e-4,
                      {"i": i} if i % 3 == 0 else None)
    return tracer


@pytest.mark.parametrize("capacity,sample", [(64, 1), (5, 1), (64, 2),
                                             (4, 3)])
def test_tracer_ring_and_sampling_match_jax(capacity, sample):
    j = _fill(jtrace.Tracer(capacity=capacity, sample_every=sample))
    t = _fill(ttrace.Tracer(capacity=capacity, sample_every=sample))
    key = lambda s: (s.name, round(s.ts_us, 3), round(s.dur_us, 3),  # noqa
                     s.attrs)
    assert [key(s) for s in t.spans()] == [key(s) for s in j.spans()]
    assert t.dropped == j.dropped
    assert t.dropped_spans() == j.dropped_spans()
    assert t.totals_ms().keys() == j.totals_ms().keys()


def test_chrome_trace_keys_match_jax(tmp_path):
    j = _fill(jtrace.Tracer(capacity=6))
    t = _fill(ttrace.Tracer(capacity=6))
    jt, tt = j.to_chrome_trace(), t.to_chrome_trace()
    assert tt.keys() == jt.keys()
    assert tt["otherData"].keys() == jt["otherData"].keys()
    assert tt["otherData"]["identity"].keys() == \
        jt["otherData"]["identity"].keys()
    for je, te in zip(jt["traceEvents"], tt["traceEvents"]):
        assert te.keys() == je.keys()
        assert {k: te.get(k) for k in ("ph", "name", "cat")} == \
            {k: je.get(k) for k in ("ph", "name", "cat")}
    path = t.export_chrome_trace(str(tmp_path / "trace.json"))
    assert json.load(open(path))["displayTimeUnit"] == "ms"
    lines = open(t.export_jsonl(str(tmp_path / "t.jsonl"))).readlines()
    assert [json.loads(x)["name"] for x in lines] == \
        [s.name for s in t.spans()]


def test_disabled_tracer_and_env_switch(monkeypatch):
    off = ttrace.Tracer(enabled=False)
    with off.span("x"):
        pass
    assert off.spans() == []
    monkeypatch.setenv("DL4J_TPU_TRACE", "0")
    monkeypatch.setenv("DL4J_TPU_TRACE_SAMPLE", "3")
    tr = ttrace._env_default()
    assert tr.enabled is False and tr.sample_every == 3


def test_span_names_appear_in_a_torch_profile():
    tr = ttrace.Tracer()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("device_step"):
            torch.ones(4) + 1
    names = {e.key for e in prof.key_averages()}
    assert "device_step" in names
    # outside a profile no annotation is made: the span alone
    with tr.span("host_dispatch") as ctx:
        assert ctx._ann is None
    assert [s.name for s in tr.spans()] == ["device_step", "host_dispatch"]


def test_ui_timeline_waits_by_name(tmp_path):
    """The timeline is ported (ui/ landed): for the same recorded spans it
    renders the JAX package's HTML, lane for lane."""
    tr, jtr = ttrace.Tracer(), jtrace.Tracer()
    for t in (tr, jtr):
        t.record("data_wait", 0.001, 0.002)
        t.record("device_step", 0.002, 0.005)
    spans = [s._replace(ts_us=round(s.ts_us), dur_us=round(s.dur_us))
             for s in tr.spans()]
    jspans = [jtrace.Span(*s) for s in spans]
    assert ttrace.trace_timeline_component(spans).render() == \
        jtrace.trace_timeline_component(jspans).render()
    ttrace.export_trace_html(spans, str(tmp_path / "p.html"))
    jtrace.export_trace_html(jspans, str(tmp_path / "j.html"))
    assert (tmp_path / "p.html").read_text() == \
        (tmp_path / "j.html").read_text()
    assert ttrace.span_color("data_wait") in ttrace._PALETTE


# ---------------------------------------------------------------------------
# the metrics registry
# ---------------------------------------------------------------------------

def _operate(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("dl4j_requests_total", "Requests\nserved",
                    labelnames=("route", "code"))
    c.labels(route="/predict", code="200").inc()
    c.labels(route="/predict", code="200").inc(2.5)
    c.labels(route='/a"b\\c\nd', code="500").inc()
    g = reg.gauge("dl4j_queue_depth", "Depth")
    g.set(7)
    g.inc(0.25)
    lazy = reg.gauge("dl4j_lazy", "Lazy", labelnames=("k",))
    lazy.labels(k="x").set_function(lambda: 3.0)
    lazy.labels(k="y").set_function(lambda: 1 / 0)
    h = reg.histogram("dl4j_latency_seconds", "Latency",
                      labelnames=("op",), buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5, 5.0):
        h.labels(op="fwd").observe(v)
    reg.histogram("dl4j_empty_seconds", "Empty")
    reg.register_collector(lambda: [mod.MetricFamily(
        "dl4j_collected", "gauge", "From a collector").add(
            float("inf"), {"a": "1"}).add(float("nan")).add(-2.0, {"b": "x"})])

    def broken():
        raise RuntimeError("a broken collector must not break the scrape")

    reg.register_collector(broken)
    return reg


def _nan_safe(snapshot):
    return json.loads(json.dumps(snapshot).replace("NaN", '"nan"'))


def test_prometheus_text_byte_equal_to_jax():
    j, t = _operate(jmetrics), _operate(tmetrics)
    assert t.render_prometheus() == j.render_prometheus()
    assert _nan_safe(t.snapshot()) == _nan_safe(j.snapshot())
    assert tmetrics.sample_key("m", {"b": "2", "a": '"'}) == \
        jmetrics.sample_key("m", {"b": "2", "a": '"'})
    with pytest.raises(ValueError):
        t.counter("dl4j_queue_depth")
    assert tmetrics.wants_prometheus("text/plain") and \
        not tmetrics.wants_prometheus("*/*")


def test_resilience_stats_render_as_the_jax_packages():
    regs = {}
    for name, stats_cls, mod in (("jax", JResilienceStats, jmetrics),
                                 ("port", TResilienceStats, tmetrics)):
        stats = stats_cls()
        stats.bump("checkpoints", 3)
        stats.bump("rollbacks")
        stats.note_nan_check_lag(4)
        reg = mod.MetricsRegistry()
        stats.attach_to_registry(reg, labels={"job": "ckpt"})
        regs[name] = reg.render_prometheus()
        stats.detach_from_registry()
        assert reg.render_prometheus() == "\n"
    assert regs["port"] == regs["jax"]


def test_runtime_metrics_count_the_ports_compiles():
    before = tmetrics.compile_snapshot()
    tmetrics.note_compile(0.5)
    tmetrics.note_cache(hit=False)
    tmetrics.note_cache(hit=True)
    delta = tmetrics.compile_delta(before)
    assert delta == {"count": 1, "seconds": 0.5, "cache_hits": 1,
                     "cache_misses": 1}
    reg = tmetrics.MetricsRegistry()
    tmetrics.install_runtime_metrics(reg)
    snap = reg.snapshot()
    for name in ("dl4j_xla_compile_total", "dl4j_xla_cache_hits_total",
                 "dl4j_fit_steps_total", "dl4j_instance_info",
                 "dl4j_heartbeat_timestamp_seconds"):
        assert name in snap
    # no card initialised here: memory is the host's
    assert snap["dl4j_device_memory_bytes"][0]["labels"] == {
        "device": "process", "kind": "host_rss_bytes"}
    tmetrics.set_registry(tmetrics.get_registry())


def test_kernel_library_loads_count_as_build_cache_traffic(tmp_path,
                                                           monkeypatch):
    """A kernel library found built on disk loads as a build-cache hit
    (the JAX package's persistent-cache family); one nvcc built in this
    process does not count again when it loads."""
    from deeplearning4j_tpu_torch.ops import _build
    lib = tmp_path / "libfake.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "library_path", lambda name: lib)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_BUILT", {"built_here"})
    before = tmetrics.compile_snapshot()
    _build.load("found_on_disk")
    _build.load("found_on_disk")       # cached in the process: no count
    _build.load("built_here")
    assert tmetrics.compile_delta(before) == {
        "count": 0, "seconds": 0.0, "cache_hits": 1, "cache_misses": 0}


def test_pipeline_stats_attach_while_consumed():
    """A pipeline attaches its counters to the global registry while it
    is consumed, labelled by its name, and detaches on close."""
    reg = tmetrics.MetricsRegistry()
    prev = tmetrics.set_registry(reg)
    try:
        pipe = tpipe.from_arrays(np.zeros((10, 2), np.float32),
                                 name="p").batch(4)
        list(pipe)
        snap = reg.snapshot()
    finally:
        tmetrics.set_registry(prev)
    assert snap["dl4j_datapipe_batches_total"] == [
        {"labels": {"pipeline": "p"}, "value": 3}]
    assert snap["dl4j_datapipe_records_total"][0]["value"] == 10
    pipe.close()
    assert "dl4j_datapipe_batches_total" not in reg.snapshot()


# ---------------------------------------------------------------------------
# the flight recorder and the identity
# ---------------------------------------------------------------------------

def _flush(mod, tracer_mod, d):
    rec = mod.FlightRecorder(dir=str(d), capacity=8)
    for s in _fill(tracer_mod.Tracer()).spans():
        rec._sink(s)
    rec._sink(tracer_mod.Span("queue_wait", 1.0, 2.0, 1, "t",
                              {"trace_id": "abc"}))
    rec.record_event("checkpoint", 4, "periodic")
    rec.record_event("preempt", 6, "clean exit")
    try:
        raise RuntimeError("boom")
    except RuntimeError as e:
        path = rec.flush("exception", exc=e)
    return json.load(open(path)), os.path.basename(path)


def test_flight_file_has_the_jax_files_keys(tmp_path):
    jdoc, jname = _flush(jflight, jtrace, tmp_path / "jax")
    tdoc, tname = _flush(tflight, ttrace, tmp_path / "port")
    assert tdoc["schema"] == jdoc["schema"] == 1
    assert tdoc.keys() == jdoc.keys()
    assert tdoc["exception"].keys() == jdoc["exception"].keys()
    assert tdoc["identity"].keys() == jdoc["identity"].keys()
    assert [e.keys() for e in tdoc["events"]] == \
        [e.keys() for e in jdoc["events"]]
    assert [(e["kind"], e["step"]) for e in tdoc["events"]] == \
        [("checkpoint", 4), ("preempt", 6)]
    assert [s.keys() for s in tdoc["spans"]] == \
        [s.keys() for s in jdoc["spans"]]
    assert tdoc["trace_ids"] == jdoc["trace_ids"] == ["abc"]
    assert len(tdoc["spans"]) == 8
    assert tname.startswith("flight_") and tname.endswith(".json")


def test_flight_recorder_install_chains_the_excepthook(tmp_path):
    import sys
    # a supervised run earlier in this process may have installed one
    tflight.uninstall_flight_recorder()
    prev = sys.excepthook
    rec = tflight.install_flight_recorder(dir=str(tmp_path))
    try:
        assert sys.excepthook == rec._excepthook
        seen = []
        chained = rec._prev_excepthook
        rec._prev_excepthook = lambda *a: seen.append(a[0])
        try:
            raise KeyError("x")
        except KeyError as e:
            sys.excepthook(KeyError, e, e.__traceback__)
        rec._prev_excepthook = chained
        assert seen == [KeyError]
        doc = json.load(open(rec.last_path))
        assert doc["reason"] == "unhandled_exception"
    finally:
        tflight.uninstall_flight_recorder()
    assert sys.excepthook is prev and tflight.get_flight_recorder() is None


@pytest.fixture
def fresh_identity(monkeypatch):
    for mod in (jdist, tdist):
        mod.reset_identity()
    yield monkeypatch
    for mod in (jdist, tdist):
        mod.reset_identity()


def test_identity_comes_from_the_env(fresh_identity):
    fresh_identity.setenv("DL4J_TPU_RUN_ID", "run-7")
    fresh_identity.setenv("DL4J_TPU_INSTANCE", "worker-3")
    fresh_identity.setenv("DL4J_TPU_INCARNATION", "2")
    t, j = tdist.get_identity(), jdist.get_identity()
    assert (t.run_id, t.instance, t.incarnation) == ("run-7", "worker-3", 2)
    assert t.tag == j.tag == "worker-3-i2"
    assert t.labels() == j.labels()
    assert tdist.bump_incarnation().tag == "worker-3-i3"
    assert tdist.rank_suffix() == "" and len(tdist.new_trace_id()) == 16
    tr = ttrace.Tracer()
    ttrace.set_tracer(tr)
    try:
        tdist.stamp_run_marker("fit")
    finally:
        ttrace.set_tracer(ttrace._env_default())
    (marker,) = tr.spans()
    assert marker.name == "run_start" and marker.attrs["instance"] == \
        "worker-3" and marker.attrs["incarnation"] == 3


def _federation_use(name):
    """One call of each federation name, as a caller makes it; None on
    success (tests/test_torch_federation.py holds them to the JAX
    package)."""
    dead = "http://127.0.0.1:1/api/metrics_push"   # refused at once
    if name == "export_snapshot":
        snap = tdist.export_snapshot(health={"batcher_healthy": True})
        assert snap["schema"] == tdist.SNAPSHOT_SCHEMA_VERSION
    elif name == "push_snapshot":
        with pytest.raises(OSError):
            tdist.push_snapshot(dead, timeout=2.0)
    elif name == "MetricsFederation":
        fed = tdist.MetricsFederation()
        assert fed.ingest(tdist.export_snapshot()) in fed.instance_tags()
    elif name == "HeartbeatPusher":
        hb = tdist.HeartbeatPusher(dead, timeout=2.0, attempts=1)
        assert hb.push_once() is False and hb.pushes_failed == 1
    elif name == "SpanPushBuffer":
        assert tdist.SpanPushBuffer().payload() is None
    else:
        assert tdist.TraceStore().waterfall("x")["found"] is False


@pytest.mark.parametrize("name", ["export_snapshot", "push_snapshot",
                                  "MetricsFederation", "HeartbeatPusher",
                                  "SpanPushBuffer", "TraceStore"])
def test_federation_waits_by_name(name):
    """The federation names no longer wait (they were refused naming
    ROADMAP.md A.5): each one is ported and works when called."""
    _federation_use(name)


def test_exports_match_the_jax_packages():
    from deeplearning4j_tpu import observability as jobs
    assert sorted(tobs.__all__) == sorted(jobs.__all__)


# ---------------------------------------------------------------------------
# the fit loops' spans, on their threads
# ---------------------------------------------------------------------------

def test_fit_spans_and_lanes(tmp_path):
    from deeplearning4j_tpu_torch import zoo
    tr = ttrace.Tracer()
    prev = ttrace.set_tracer(tr)
    try:
        net = zoo.char_rnn(vocab_size=12, hidden=8, n_layers=1,
                           dtype=zoo.F32, device="cpu")
        text = "".join(np.random.default_rng(0).choice(
            list("abcdefghijkl"), 600))
        tok = tpipe.CharTokenizer.fit("abcdefghijkl")
        pipe = (tpipe.from_text(text).tokenize(tok)
                .window(8, vocab_size=12)
                .filter(lambda r: r[0].shape[0] == 8)
                .shuffle(window=16, seed=1)
                .batch(4, drop_last=True).prefetch(2))
        net.fit(pipe, epochs=1)
        net.fit(pipe, epochs=1, multi_step=4)
    finally:
        ttrace.set_tracer(prev)
    names = {s.name for s in tr.spans()}
    assert {"run_start", "data_wait", "host_dispatch", "device_step",
            "flops_derive", "pipe_prefetch_pull", "pipe_collate",
            "pipe_shuffle_fill"} <= names
    chunked = [s for s in tr.spans()
               if s.name == "device_step" and s.attrs]
    assert chunked and {s.attrs["steps"] for s in chunked} <= {1, 2, 3, 4}
    threads = {s.thread for s in tr.spans()}
    assert threading.current_thread().name in threads
    assert "dl4j-pipe-prefetch" in threads
    lanes = {e["args"]["name"] for e in tr.to_chrome_trace()["traceEvents"]
             if e["ph"] == "M"}
    assert {"dl4j-pipe-prefetch", threading.current_thread().name} <= lanes


def test_sigterm_flushes_the_flight_file_and_preempts(tmp_path):
    """The supervisor's SIGTERM handler both flushes flight_<tag>.json
    (at once, before the step boundary) and preempts cleanly."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.resilience import (FaultInjector,
                                                     resilient_fit)
    from deeplearning4j_tpu_torch import zoo
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers install on the main thread only")
    net = zoo.char_rnn(vocab_size=6, hidden=4, n_layers=1, dtype=zoo.F32,
                       device="cpu")
    x = np.eye(6, dtype=np.float32)[np.arange(24).reshape(4, 6) % 6]
    inj = FaultInjector()
    inj.sigterm_at_step(3)
    reasons = []
    orig = tflight.FlightRecorder.flush

    def spy(self, reason, exc=None):
        reasons.append(reason)
        return orig(self, reason, exc=exc)

    tflight.FlightRecorder.flush = spy
    old = signal.getsignal(signal.SIGTERM)
    try:
        with inj.installed():
            res = resilient_fit(net, DataSet(x, x), checkpoint_dir=str(
                tmp_path), epochs=8, injector=inj, handle_sigterm=True)
    finally:
        tflight.FlightRecorder.flush = orig
    assert signal.getsignal(signal.SIGTERM) is old
    assert res.status == "preempted" and res.final_step < 8
    assert reasons == ["sigterm", "preemption"]
    flights = [n for n in os.listdir(str(tmp_path))
               if n.startswith("flight_")]
    doc = json.load(open(str(tmp_path / flights[0])))
    last = doc["events"][-1]
    assert doc["schema"] == 1 and doc["reason"] == "preemption"
    assert (last["kind"], last["step"]) == ("preempt", res.final_step)
