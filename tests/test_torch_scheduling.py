"""The port's traffic engine (deeplearning4j_tpu_torch/scheduling/core.py and
its seams in the batcher, the replica set and the server) held against the
JAX package's on the CPU.

- ``SchedulingCore`` on one fake clock: one scripted sequence of ``admit``
  calls (tenants, classes, depths, capacities, deadlines, wait estimates)
  runs through both packages; the same classes come back, the same
  ``ShedError`` (klass, reason) is raised, and ``snapshot()`` and
  ``metric_families()`` are equal at every step.
- ``TokenBucket`` and the header parse/build round trip, against the JAX
  functions.
- Interactive jumps a batch backlog in the port's batcher; the fleet's
  admission counts only live depth; a 503 carries the shed class and the
  counters; a default ``ModelServer`` has a scheduler with the JAX
  package's ``dl4j_sched_*`` names, and ``scheduler=False`` has none.

Host-only logic: results are held exactly. Every server and batcher is
stopped in ``finally``; every wait and HTTP call has a timeout.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.scheduling import core as jcore
from deeplearning4j_tpu_torch.scheduling import core as tcore
from deeplearning4j_tpu_torch.serving.batcher import (MicroBatcher,
                                                      QueueFullError)
from deeplearning4j_tpu_torch.serving.fleet import DEAD, ReplicaSet
from deeplearning4j_tpu_torch.serving.server import ModelServer

CORES = {"jax": jcore, "torch": tcore}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _mlp(seed=1):
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(Dense(n_in=6, n_out=8, activation="relu"))
            .layer(Output(n_in=8, n_out=3, activation="softmax",
                          loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


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


def _get_text(url, timeout=30.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def _families(fams):
    return [(f.name, f.kind, f.help,
             [(s.suffix, dict(s.labels), s.value) for s in f.samples])
            for f in fams]


# one scripted admission sequence: (clock advance, admit kwargs)
SCRIPT = [
    (0.0, dict(tenant="a")),
    (0.0, dict(tenant="a", rows=2)),
    (0.0, dict(tenant="a")),                              # quota
    (0.0, dict(tenant="b", klass="batch", depth=10, capacity=100)),
    (0.0, dict(tenant="b", klass="best_effort", depth=30, capacity=100)),
    (0.0, dict(klass="batch", depth=60, capacity=100)),   # backpressure
    (0.0, dict(klass="Interactive", depth=60, capacity=100)),
    (0.0, dict(klass="nonsense", depth=100, capacity=100)),
    (0.5, dict(tenant="a", rows=1)),                      # refilled 0.5
    (1.5, dict(tenant="a", rows=1)),
    (0.0, dict(deadline_ms=500.0, wait_estimate_s=2.0)),  # deadline
    (0.0, dict(deadline_ms=5000.0, wait_estimate_s=2.0)),
    (0.0, dict(tenant="t2", klass="best-effort", rows=4)),
    (0.0, dict(tenant="t2", klass="batch", rows=4)),      # t2 quota
    (2.0, dict(tenant="t2", klass="batch", rows=8, depth=40,
               capacity=100)),
    (0.0, dict(tenant="a", klass="batch", deadline_ms=10.0,
               wait_estimate_s=0.001, depth=49, capacity=100)),
    (0.0, dict(tenant="c", klass="best_effort", depth=0, capacity=0)),
]


def _run_script(core_mod):
    clock = FakeClock()
    core = core_mod.SchedulingCore(quotas={"a": (1.0, 3.0),
                                           "t2": (2.0, 6.0)},
                                   watermarks={"batch": 0.5},
                                   clock=clock)
    trail = []
    for dt, kw in SCRIPT:
        clock.t += dt
        try:
            got = ("admit", core.admit(**kw))
        except core_mod.ShedError as e:
            assert isinstance(e, Exception)
            got = ("shed", e.klass, e.reason, str(e))
        trail.append((got, core.snapshot(),
                      _families(core.metric_families({"server": "s"}))))
    core.record_shed("batch", "backpressure")
    core.set_quota("a", 0.0, 1.0)
    try:
        core.admit(tenant="a")
        core.admit(tenant="a")
    except core_mod.ShedError as e:
        trail.append(("final", e.klass, e.reason))
    trail.append((core.snapshot(), _families(core.metric_families())))
    return trail


@pytest.fixture(scope="module")
def jax_script():
    return _run_script(jcore)


def test_scripted_admissions_equal_the_jax_core(jax_script):
    port = _run_script(tcore)
    assert len(port) == len(jax_script)
    for step, (p, j) in enumerate(zip(port, jax_script)):
        assert p == j, f"step {step}"
    outcomes = [t[0][0] for t in port[:len(SCRIPT)]]
    assert outcomes.count("shed") >= 5 and outcomes.count("admit") >= 8


def test_port_sheds_are_queue_full_errors():
    with pytest.raises(QueueFullError):
        tcore.SchedulingCore(quotas={"x": (0.0, 0.0)}).admit(tenant="x")
    with pytest.raises(ValueError, match="unknown admission class"):
        tcore.SchedulingCore(watermarks={"vip": 0.5})


def test_constants_equal_the_jax_package():
    for name in ("TENANT_HEADER", "PRIORITY_HEADER", "DEADLINE_HEADER",
                 "SHED_CLASS_HEADER", "SCHED_HEADERS", "CLASSES",
                 "PRIORITY", "DEFAULT_WATERMARKS", "INTERACTIVE", "BATCH",
                 "BEST_EFFORT", "__all__"):
        assert getattr(tcore, name) == getattr(jcore, name), name
    assert tcore.SchedulingCore.PRIORITY == jcore.SchedulingCore.PRIORITY


@pytest.mark.parametrize("steps", [
    [(0.0, 1.0), (0.0, 1.0), (0.0, 1.0), (0.25, 1.0), (0.5, 2.0),
     (10.0, 1.0), (0.0, 5.0), (0.0, 4.0)],
    [(0.0, 3.0), (0.1, 0.5), (0.1, 0.5), (1.0, 2.5), (0.0, 0.1)],
], ids=["unit_costs", "fractional"])
def test_token_bucket_equals_the_jax_bucket(steps):
    trails = {}
    for name, mod in CORES.items():
        clock = FakeClock()
        b = mod.TokenBucket(2.0, 4.0, clock=clock)
        trail = []
        for dt, cost in steps:
            clock.t += dt
            trail.append((b.try_take(cost), b.peek(), b.tokens))
        trails[name] = trail
    assert trails["torch"] == trails["jax"]


@pytest.mark.parametrize("sched", [
    {"tenant": "acme", "klass": "batch", "deadline_ms": 1500.0},
    {"tenant": None, "klass": "best_effort", "deadline_ms": 0.25},
    {"tenant": "x", "klass": "interactive", "deadline_ms": None},
    {},
    None,
])
def test_header_parse_build_round_trip_equals_jax(sched):
    hdrs = tcore.build_sched_headers(sched)
    assert hdrs == jcore.build_sched_headers(sched)
    assert tcore.parse_sched_headers(hdrs) == jcore.parse_sched_headers(hdrs)
    for raw in ({}, {tcore.PRIORITY_HEADER: "??"},
                {tcore.DEADLINE_HEADER: "soon"},
                {tcore.PRIORITY_HEADER: " Best-Effort ",
                 tcore.TENANT_HEADER: "t", tcore.DEADLINE_HEADER: "12.5"}):
        assert tcore.parse_sched_headers(raw) == \
            jcore.parse_sched_headers(raw)
    for name in (None, "", "batch", "BATCH", "best-effort", "vip"):
        assert tcore.normalize_class(name) == jcore.normalize_class(name)


def test_interactive_jumps_batch_backlog():
    """An interactive ticket submitted after five batch tickets is the
    next one served (strict priority, FIFO within a tier)."""
    gate = threading.Event()
    order = []

    def fwd(feats):
        order.append(int(feats[0][0, 0]))
        gate.wait(10)
        return feats[0]

    b = MicroBatcher(fwd, max_batch=1, batch_window_ms=0.0, max_queue=16,
                     min_batch=1)
    b.start()
    try:
        def tik(marker):
            return np.full((1, 2), marker, np.float32)

        first = b.submit([tik(100)], priority=1)
        deadline = time.time() + 5.0
        while b.depth > 0 and time.time() < deadline:
            time.sleep(0.01)
        assert b.depth == 0
        futs = [b.submit([tik(i)], priority=1) for i in range(1, 6)]
        vip = b.submit([tik(42)], priority=0)
        gate.set()
        for f in [vip, first] + futs:
            f.result(timeout=10)
        assert order == [100, 42, 1, 2, 3, 4, 5]
    finally:
        gate.set()
        b.stop(timeout=10)


def test_fleet_admission_counts_only_live_depth():
    """A dead replica's stranded queue stops counting against max_queue,
    through the scheduler's interactive watermark (100%)."""
    gate = threading.Event()

    def fwd(feats):
        gate.wait(10)
        return feats[0]

    core = tcore.SchedulingCore()
    rs = ReplicaSet(fwd, n=2, max_batch=1, batch_window_ms=0.0,
                    max_queue=4, min_batch=1, scheduler=core)
    rs.start()
    futs = []
    try:
        x = np.ones((1, 2), np.float32)
        futs += [rs.submit([x]), rs.submit([x])]
        deadline = time.time() + 5.0
        while rs.total_depth() > 0 and time.time() < deadline:
            time.sleep(0.01)
        futs += [rs.submit([x]) for _ in range(4)]
        with pytest.raises(tcore.ShedError) as ei:
            rs.submit([x])
        assert (ei.value.klass, ei.value.reason) == ("interactive",
                                                     "backpressure")
        # batch sheds at half the queue already
        with pytest.raises(tcore.ShedError):
            rs.submit([x], klass="batch")
        rs.replicas[0].status = DEAD
        assert rs.total_depth() == 4 and rs.live_depth() == 2
        futs.append(rs.submit([x]))
        gate.set()
        for f in futs:
            f.result(timeout=10)
        snap = core.snapshot()
        assert snap["admitted_total"]["interactive"] == 7
        assert snap["shed_by_reason"] == {"batch/backpressure": 1,
                                          "interactive/backpressure": 1}
    finally:
        gate.set()
        rs.stop()


def test_fleet_wait_estimate_is_read_only_with_a_deadline():
    """The derived wait estimate (stats.retry_after_s) is read only when a
    deadline is given, and a deadline it cannot meet sheds."""
    calls = []

    class Stats:
        queue_depth_fn = None

        def retry_after_s(self, depth=None):
            calls.append(depth)
            return 9.0

        def record_rejected(self):
            calls.append("rejected")

        def record_batch(self, *a, **k):
            pass

    core = tcore.SchedulingCore()
    rs = ReplicaSet(lambda f: f[0], n=1, batch_window_ms=0.0, min_batch=1,
                    stats=Stats(), scheduler=core)
    try:
        x = np.ones((1, 2), np.float32)
        rs.submit([x]).result(timeout=10)
        assert calls == []
        with pytest.raises(tcore.ShedError) as ei:
            rs.submit([x], deadline_ms=100.0)
        assert ei.value.reason == "deadline"
        assert calls == [0, "rejected"]
    finally:
        rs.stop()


def test_shed_503_carries_class_header_and_counters():
    """A quota shed through the server answers 503 with X-DL4J-Shed-Class
    and Retry-After, the 200 echoes the scheduling headers, and the shed
    lands in the dl4j_sched_* families; a plain full-queue reject is
    recorded as a shed of the request's own class."""
    sched = tcore.SchedulingCore(quotas={"acme": (0.0, 1.0)})
    server = ModelServer(_mlp(), port=0, replicas=1, warmup=False,
                         max_batch=4, scheduler=sched).start()
    try:
        body = {"features": [[0.1] * 6]}
        st, _, h = _post(server.url, "/predict", body,
                         headers={tcore.TENANT_HEADER: "acme",
                                  tcore.DEADLINE_HEADER: "30000"})
        assert st == 200
        assert h.get(tcore.PRIORITY_HEADER) == "interactive"
        assert h.get(tcore.TENANT_HEADER) == "acme"
        assert h.get(tcore.DEADLINE_HEADER) == "30000"
        st, out, h = _post(server.url, "/predict", body,
                           headers={tcore.TENANT_HEADER: "acme"})
        assert st == 503
        assert h.get(tcore.SHED_CLASS_HEADER) == "interactive"
        assert float(h.get("Retry-After")) >= 0.05
        assert "quota" in out["error"]
        text = _get_text(server.url + "/metrics?format=prometheus")
        assert 'dl4j_sched_shed_total{' in text and 'reason="quota"' in text
        assert server.metrics()["sched"]["shed_total"]["interactive"] == 1
        # a plain QueueFullError (no ShedError) sheds the request's class
        orig = server._fleet.submit

        def full(*a, **k):
            raise QueueFullError("full")
        server._fleet.submit = full
        try:
            st, _, h = _post(server.url, "/predict", body,
                             headers={tcore.PRIORITY_HEADER: "batch"})
        finally:
            server._fleet.submit = orig
        assert st == 503 and h.get(tcore.SHED_CLASS_HEADER) == "batch"
        assert sched.snapshot()["shed_by_reason"]["batch/backpressure"] == 1
    finally:
        server.stop()


def _sched_family_names(text):
    return sorted({ln.split()[2] for ln in text.splitlines()
                   if ln.startswith("# TYPE dl4j_sched_")})


def test_default_server_has_the_jax_packages_scheduler_families():
    """A default ModelServer builds a SchedulingCore (as the JAX package's
    does) whose families carry the JAX package's names; scheduler=False
    has none; predict takes the scheduling fields."""
    jnames = _sched_family_names("\n".join(
        f.render() for f in jcore.SchedulingCore().metric_families()))
    server = ModelServer(_mlp(), port=0, warmup=False, max_batch=4).start()
    try:
        assert isinstance(server.scheduler, tcore.SchedulingCore)
        out = server.predict(np.full((2, 6), 0.1, np.float32),
                             klass="batch", tenant="t", deadline_ms=60e3)
        assert out.shape == (2, 3)
        text = _get_text(server.url + "/metrics?format=prometheus")
        assert _sched_family_names(text) == jnames
        assert server.metrics()["sched"]["admitted_total"]["batch"] == 1
    finally:
        server.stop()
    off = ModelServer(_mlp(), port=0, warmup=False, max_batch=4,
                      scheduler=False).start()
    try:
        assert off.scheduler is None and off.fleet.scheduler is None
        text = _get_text(off.url + "/metrics?format=prometheus")
        assert _sched_family_names(text) == []
        assert "sched" not in off.metrics()
        st, _, h = _post(off.url, "/predict", {"features": [[0.1] * 6]},
                         headers={tcore.PRIORITY_HEADER: "batch"})
        assert st == 200 and h.get(tcore.PRIORITY_HEADER) == "batch"
    finally:
        off.stop()
