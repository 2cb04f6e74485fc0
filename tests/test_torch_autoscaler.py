"""The port's autoscaler and load generator
(deeplearning4j_tpu_torch/scheduling/{autoscaler,loadgen}.py) held against
the JAX package's on the CPU.

- ``Autoscaler``: scripted signal walks (hysteresis, cooldowns, bounds,
  failed actuations, reaction time) on one fake clock give equal
  decisions, snapshots and metric families in both packages.
- ``ReplicaSetActuator`` re-lights parked slots of a port ``ReplicaSet``
  and never drains the last live one; ``fleet_signals`` reads a port
  router's federation.
- ``TrafficModel(seed=...).arrivals()`` equals the JAX package's, and
  ``attainment`` is equal on the same rows; ``OpenLoopRunner`` on an
  injected clock records one row per arrival.

Host-only logic: results are held exactly. Every fleet and router is
stopped in ``finally``.
"""

import time

import numpy as np
import pytest

from deeplearning4j_tpu.scheduling import autoscaler as jauto
from deeplearning4j_tpu.scheduling import loadgen as jload
from deeplearning4j_tpu_torch.scheduling import autoscaler as tauto
from deeplearning4j_tpu_torch.scheduling import loadgen as tload

AUTO = {"jax": jauto, "torch": tauto}
LOAD = {"jax": jload, "torch": tload}


def _families(fams):
    return [(f.name, f.kind, f.help,
             [(s.suffix, dict(s.labels), s.value) for s in f.samples])
            for f in fams]


# (time, signals, up succeeds, down succeeds)
WALK = [
    (0.0, {"queue_depth": 50.0, "size": 1}, True, True),
    (1.0, {"queue_depth": 50.0, "size": 1}, True, True),
    (2.0, {"queue_depth": 50.0, "size": 1}, True, True),     # up
    (2.5, {"queue_depth": 60.0, "size": 2}, True, True),
    (3.0, {"queue_depth": 60.0}, True, True),
    (3.5, {"retry_after_s": 3.0, "size": 2}, True, True),
    (8.0, {"burn_rate": 20.0}, False, True),                 # up fails
    (8.5, {"burn_rate": 20.0, "size": 2}, True, True),
    (9.0, {"burn_rate": 20.0, "size": 2}, True, True),
    (9.5, {"queue_depth": 0.0, "size": 3}, True, True),
    (10.0, {"queue_depth": 0.0}, True, True),
    (11.0, {"queue_depth": 0.0}, True, True),
    (16.0, {"queue_depth": 0.0}, True, False),               # down fails
    (17.0, {"queue_depth": 0.0}, True, True),
    (18.0, {"queue_depth": 0.0}, True, True),
    (30.0, {"queue_depth": 0.5}, True, True),
    (31.0, {"queue_depth": 0.0, "size": 1}, True, True),
    (32.0, {"queue_depth": 0.0, "size": 1}, True, True),
    (33.0, {}, True, True),
]


def _walk(mod, **kw):
    t = [0.0]
    state = {"sig": {}, "up": True, "down": True}
    acts = []

    def up():
        acts.append(("up", t[0]))
        return state["up"]

    def down():
        acts.append(("down", t[0]))
        return state["down"]

    a = mod.Autoscaler(signals_fn=lambda: dict(state["sig"]), up=up,
                       down=down, clock=lambda: t[0], **kw)
    trail = []
    for when, sig, up_ok, down_ok in WALK:
        t[0] = when
        state.update(sig=sig, up=up_ok, down=down_ok)
        trail.append((a.step(), a.snapshot(),
                      _families(a.metric_families({"host": "h"}))))
    return trail, acts


@pytest.mark.parametrize("kw", [
    dict(min_size=1, max_size=3, up_queue_depth=10.0, up_retry_after_s=2.0,
         up_burn_rate=14.4, breach_n=3, clear_n=2, up_cooldown_s=5.0,
         down_cooldown_s=5.0),
    dict(min_size=1, max_size=8, up_queue_depth=10.0, breach_n=1,
         clear_n=1, up_cooldown_s=10.0, down_cooldown_s=0.0,
         down_queue_depth=1.0),
    dict(min_size=0, max_size=1, up_burn_rate=1.0),
], ids=["hysteresis", "cooldown", "bounds"])
def test_autoscaler_decisions_equal_the_jax_package(kw):
    port = _walk(tauto, **kw)
    ref = _walk(jauto, **kw)
    assert port == ref
    whys = {d["why"] for d, _, _ in port[0]}
    holds = [d for d, _, _ in port[0] if d["decision"] == "hold"]
    assert whys & {"breach", "at_max"} and holds


def test_autoscaler_bounds_are_checked_like_jax():
    for mod in AUTO.values():
        with pytest.raises(ValueError):
            mod.Autoscaler(signals_fn=dict, up=lambda: True, min_size=3,
                           max_size=2)
    a = tauto.Autoscaler(signals_fn=lambda: 1 / 0, up=lambda: True,
                         interval_s=0.01)
    a.start()
    try:
        assert a.start() is a          # a second start is a no-op
    finally:
        a.stop()
    assert a._thread is None and a.snapshot()["scale_ups_total"] == 0


def test_replica_set_actuator_relights_parked_slots():
    """The actuator never grows the slot count: up() restarts the highest
    parked slot, down() drains the highest live one, never the last."""
    from deeplearning4j_tpu_torch.serving.fleet import ReplicaSet
    rs = ReplicaSet(lambda f: f[0], n=3, batch_window_ms=0.0, min_batch=1)
    rs.start()
    try:
        act = tauto.ReplicaSetActuator(rs)
        assert act.up() is False and act.live() == 3
        assert act.down() and act.down() and act.down() is False
        assert [r.status for r in rs.replicas] == ["live", "draining",
                                                   "draining"]
        assert act.signals() == {"queue_depth": 0, "retry_after_s": 0.0,
                                 "size": 1}
        assert act.up() and [r.status for r in rs.replicas] == \
            ["live", "draining", "live"]
        x = np.ones((1, 2), np.float32)
        assert np.array_equal(rs.submit([x]).result(timeout=10), x)
    finally:
        rs.stop()


def test_fleet_signals_read_a_port_routers_federation():
    from deeplearning4j_tpu_torch.serving.router import FrontDoorRouter
    router = FrontDoorRouter(["http://127.0.0.1:59990"])
    fam = {"name": "dl4j_serving_queue_depth", "kind": "gauge", "help": "",
           "samples": [{"labels": {}, "suffix": "", "value": 7}]}
    ra = {"name": "dl4j_serving_retry_after_seconds", "kind": "gauge",
          "help": "", "samples": [{"labels": {}, "suffix": "",
                                   "value": 1.5}]}
    router.federation.ingest({
        "schema": 1, "identity": {"tag": "h"}, "time": time.time(),
        "families": [fam, ra],
        "health": {"server_url": "http://127.0.0.1:59990"}})
    sig = tauto.fleet_signals(router)
    assert sig == {"queue_depth": 7, "retry_after_s": 1.5,
                   "burn_rate": 0.0, "size": 1}


MODELS = [
    dict(seed=3, duration_s=20.0, base_rps=40.0, diurnal_amplitude=0.4,
         diurnal_period_s=10.0, flash_crowds=[(5.0, 2.0, 3.0)],
         class_mix={"interactive": 0.5, "batch": 0.3, "best_effort": 0.2},
         tenants={"t1": 0.6, "t2": 0.4},
         deadlines_ms={"interactive": 200.0, "batch": 2000.0},
         max_rows=8, session_fraction=0.2, think_s=0.5),
    dict(seed=11, duration_s=5.0, base_rps=100.0),
    dict(seed=0, duration_s=1.0, base_rps=0.0),
]


@pytest.mark.parametrize("kw", MODELS, ids=["mixed", "default", "silent"])
def test_traffic_model_arrivals_equal_the_jax_package(kw):
    tm, jm = tload.TrafficModel(**kw), jload.TrafficModel(**kw)
    port = [vars(a) for a in tm.arrivals()]
    assert port == [vars(a) for a in jm.arrivals()]
    assert tm.peak_rate() == jm.peak_rate()
    assert [tm.rate_at(t / 4) for t in range(40)] == \
        [jm.rate_at(t / 4) for t in range(40)]
    if port:
        a = tm.arrivals()[0]
        assert a.headers() == jload.Arrival(**vars(a)).headers()


def _rows(arrivals):
    rows = []
    for i, a in enumerate(arrivals):
        status = (200, 503, 200, None, 200)[i % 5]
        rows.append({"t": a.t, "tenant": a.tenant, "class": a.klass,
                     "rows": a.rows, "deadline_ms": a.deadline_ms,
                     "session": a.session, "status": status,
                     "latency_ms": None if status is None else
                     float((i * 37) % 300),
                     "shed_class": a.klass if status == 503 else None,
                     "error": None})
    return rows


def test_attainment_equals_the_jax_package():
    rows = _rows(tload.TrafficModel(**MODELS[0]).arrivals())
    assert len(rows) > 100
    for klass in ("interactive", "batch", "best_effort", "none"):
        for slo_ms in (None, 150.0):
            for window in (None, (0.0, 5.0), (5.0, 7.0)):
                assert tload.attainment(rows, klass, slo_ms, window) == \
                    jload.attainment(rows, klass, slo_ms, window)


def test_open_loop_runner_records_every_arrival_on_an_injected_clock():
    """The runner releases arrivals at their offsets without waiting for
    completions; on an injected clock the rows equal the JAX runner's."""
    arrivals = tload.TrafficModel(seed=5, duration_s=2.0,
                                  base_rps=20.0).arrivals()
    got = {}
    for name, mod in LOAD.items():
        now = [0.0]

        def sleep(s, now=now):
            now[0] += s

        def submit(a):
            if a.klass == "batch":
                return {"status": 503, "shed_class": "batch", "host": "h"}
            if a.rows > 3:
                raise RuntimeError("boom")
            return {"status": 200}
        runner = mod.OpenLoopRunner(
            submit, [mod.Arrival(**vars(a)) for a in arrivals],
            max_workers=1, clock=lambda now=now: now[0], sleep=sleep)
        got[name] = runner.run()
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) == len(arrivals)
    assert {r["status"] for r in got["torch"]} >= {200, 503}
