"""The port's replica set (deeplearning4j_tpu_torch/serving/fleet.py) against
the JAX package's, on stand-in forwards (each replica's forward answers
with its own tag): the same scenario runs on both fleets and must route
each ticket to the same replica and end with the same counters and health
rows: least-depth routing with round-robin ties, session affinity and its
rebinding, the per-ticket requeue when a replica's device thread dies,
drain and restart, global admission, a narrower ``restart_fleet``,
``swap_forward`` and the hoisted warm-up.
"""

import threading

import numpy as np
import pytest

from deeplearning4j_tpu.serving import batcher as jbatcher
from deeplearning4j_tpu.serving import fleet as jfleet
from deeplearning4j_tpu_torch.serving import batcher as tbatcher
from deeplearning4j_tpu_torch.serving import fleet as tfleet

PACKAGES = {"jax": (jfleet, jbatcher), "torch": (tfleet, tbatcher)}


def _tagged(tag, calls=None):
    def forward(feats):
        if calls is not None:
            calls.append(tag)
        return np.full((feats[0].shape[0], 1), float(tag), np.float32)
    return forward


def _row(x=0.0):
    return [np.full((1, 3), x, np.float32)]


def _served_by(fut):
    return int(fut.result(timeout=30)[0, 0])


def _state(rs):
    return {"requeued": rs.requeued, "hits": rs.affinity_hits,
            "misses": rs.affinity_misses, "describe": rs.describe(),
            "healthy": rs.healthy, "degraded": rs.degraded}


def routing(F, B):
    rs = F.ReplicaSet(None, forwards=[_tagged(i) for i in range(3)],
                      batch_window_ms=0.0)
    try:
        return [_served_by(rs.submit(_row())) for _ in range(7)], _state(rs)
    finally:
        rs.stop()


def affinity(F, B):
    rs = F.ReplicaSet(None, forwards=[_tagged(i) for i in range(2)],
                      batch_window_ms=0.0)
    try:
        order = ["a", "b", "a", "a", "b", None, "c", "c"]
        got = [_served_by(rs.submit(_row(), session=s)) for s in order]
        # the pinned replica drains: the session rebinds (a miss)
        rs.drain(got[0])
        got.append(_served_by(rs.submit(_row(), session="a")))
        rs.forget_session("b")
        got.append(_served_by(rs.submit(_row(), session="b")))
        return got, _state(rs)
    finally:
        rs.stop()


def requeue_on_dead_replica(F, B):
    entered, release = threading.Event(), threading.Event()

    def dies(feats):
        entered.set()
        release.wait(30)
        raise SystemExit("device gone")

    rs = F.ReplicaSet(None, forwards=[dies, _tagged(1)],
                      batch_window_ms=0.0)
    try:
        first = rs.submit(_row())          # replica 0 (round robin)
        assert entered.wait(30)
        release.set()
        got = [_served_by(first)]          # requeued onto replica 1
        got += [_served_by(rs.submit(_row())) for _ in range(3)]
        return got, _state(rs)
    finally:
        rs.stop()


def drain_and_restart(F, B):
    rs = F.ReplicaSet(None, forwards=[_tagged(i) for i in range(3)],
                      batch_window_ms=0.0)
    try:
        got = [_served_by(rs.submit(_row())) for _ in range(2)]
        rs.drain(1)
        got += [_served_by(rs.submit(_row())) for _ in range(4)]
        mid = _state(rs)
        try:
            rs.restart(0)                  # live and healthy: refused
            refused = False
        except RuntimeError:
            refused = True
        rs.restart(1)
        got += [_served_by(rs.submit(_row())) for _ in range(3)]
        return got, mid, refused, _state(rs)
    finally:
        rs.stop()


def admission(F, B):
    entered, release = threading.Event(), threading.Event()

    def slow(feats):
        entered.set()
        release.wait(30)
        return np.zeros((feats[0].shape[0], 1), np.float32)

    rs = F.ReplicaSet(slow, 1, max_queue=2, batch_window_ms=0.0)
    try:
        held = [rs.submit(_row())]
        assert entered.wait(30)
        held += [rs.submit(_row(1.0)), rs.submit(_row(2.0))]
        try:
            rs.submit(_row(3.0))
            rejected = None
        except B.QueueFullError as e:
            rejected = type(e).__name__
        release.set()
        for f in held:
            f.result(timeout=30)
        return rejected, rs.live_depth(), rs.total_depth()
    finally:
        release.set()
        rs.stop()


def narrower_restart_and_swap(F, B):
    rs = F.ReplicaSet(None, forwards=[_tagged(i) for i in range(3)],
                      batch_window_ms=0.0)
    try:
        rs.restart_fleet(n=2, forward=_tagged(7))
        narrow = _state(rs)
        got = [_served_by(rs.submit(_row())) for _ in range(2)]
        rs.swap_forward(1, _tagged(9))
        got += [_served_by(rs.submit(_row())) for _ in range(4)]
        rs.restart_fleet(forwards=[_tagged(i) for i in range(3)])
        return narrow, got, _state(rs)
    finally:
        rs.stop()


def hoisted_warm(F, B):
    shared = []
    rs = F.ReplicaSet(_tagged(0, shared), 3, max_batch=8,
                      batch_window_ms=0.0)
    distinct = []
    rs2 = F.ReplicaSet(None, forwards=[_tagged(i, distinct)
                                       for i in range(2)], max_batch=4)
    try:
        ran = rs.warm([(3,)])
        again = rs.warm([(3,)])
        ran2 = rs2.warm([(3,)])
        return (ran, again, len(shared), sorted(rs.shapes_seen), ran2,
                sorted(distinct))
    finally:
        rs.stop()
        rs2.stop()


SCENARIOS = [routing, affinity, requeue_on_dead_replica, drain_and_restart,
             admission, narrower_restart_and_swap, hoisted_warm]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax_fleet(scenario):
    got = scenario(*PACKAGES["torch"])
    want = scenario(*PACKAGES["jax"])
    assert got == want


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_requeue_facts():
    """What the requeue scenario shows, stated: the ticket in flight on
    the dying replica is served by the survivor, counted once, and the
    dead replica leaves routing."""
    got, state = requeue_on_dead_replica(*PACKAGES["torch"])
    assert got == [1, 1, 1, 1]
    assert state["requeued"] == 1
    assert [r["status"] for r in state["describe"]] == ["dead", "live"]


def test_scheduler_and_its_admission_fields_are_refused_by_name():
    """The scheduler is ported: a fleet built with one admits through it
    (the class is counted), and without one the admission fields are
    accepted and ignored, as in the JAX package."""
    from deeplearning4j_tpu_torch.scheduling import SchedulingCore
    core = SchedulingCore()
    rs = tfleet.ReplicaSet(_tagged(0), 1, scheduler=core)
    try:
        assert _served_by(rs.submit(_row(), klass="batch",
                                    tenant="t", deadline_ms=1e6)) == 0
        assert core.snapshot()["admitted_total"]["batch"] == 1
    finally:
        rs.stop()
    rs = tfleet.ReplicaSet(_tagged(0), 1)
    try:
        assert _served_by(rs.submit(_row(), klass="batch")) == 0
    finally:
        rs.stop()


def test_all_replicas_dead_raises_batcher_dead():
    rs = tfleet.ReplicaSet(_tagged(0), 2)
    try:
        for r in rs.replicas:
            r.batcher._crashed = True
        with pytest.raises(tbatcher.BatcherDeadError):
            rs.submit(_row())
        assert not rs.healthy
    finally:
        rs.stop()
