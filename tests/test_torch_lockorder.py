"""The port's lock-order detector (deeplearning4j_tpu_torch/analysis/
lockorder.py) against the JAX package's.

The same acquisition sequences, run through a private graph of each
package, give the same cycles and the same L001 findings. Every graph
here is private, so no poison edge reaches the global graph the JAX
package's test configuration checks at the end of the session; a test
that installs the port's detector uninstalls it in ``finally``, and
``uninstall`` must put back exactly the factories it found (under
pytest, the JAX package's detector's).
"""

import _thread
import threading
import time

import pytest

from deeplearning4j_tpu.analysis import lockorder as jlo
from deeplearning4j_tpu_torch.analysis import lockorder as lo
from deeplearning4j_tpu_torch.observability import trace


def _run(seq_by_thread, mod):
    """Acquire nested lock sequences, one thread after another (each
    nesting released before the next thread starts: an order, never a
    deadlock). -> the graph."""
    names = sorted({n for seq in seq_by_thread for n in seq})
    g = mod.LockOrderGraph()
    # the interpreter's own RLocks (reentrant, for the same-site case);
    # threading.RLock() here would be the installed detector's
    locks = {n: mod.instrument(_thread.RLock(), name=n, graph=g)
             for n in names}

    def nest(seq):
        if not seq:
            return
        with locks[seq[0]]:
            nest(seq[1:])

    for seq in seq_by_thread:
        t = threading.Thread(target=nest, args=(seq,), daemon=True)
        t.start()
        t.join(timeout=10.0)
        assert not t.is_alive()
    return g


SEQUENCES = {
    "two_cycle": [("A", "B"), ("B", "A")],
    "three_cycle": [("A", "B"), ("B", "C"), ("C", "A")],
    "consistent": [("A", "B", "C"), ("A", "C"), ("B", "C")],
    "two_cycles": [("A", "B"), ("B", "A"), ("C", "D"), ("D", "C")],
    "reentrant_site": [("A", "A"), ("A", "B")],
    "diamond_back_edge": [("A", "B", "D"), ("A", "C", "D"), ("D", "A")],
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_cycles_equal_the_jax_graph(case):
    mine = _run(SEQUENCES[case], lo)
    ref = _run(SEQUENCES[case], jlo)
    assert mine.cycles() == ref.cycles()
    assert mine.edges() == ref.edges()
    assert [(f.code, f.message) for f in mine.findings()] == \
        [(f.code, f.message) for f in ref.findings()]


def test_a_cycle_is_an_l001_finding():
    g = _run(SEQUENCES["two_cycle"], lo)
    (f,) = g.findings()
    assert f.code == "DL4J-L001" and "A <-> B" in f.message
    assert _run(SEQUENCES["consistent"], lo).findings() == []


def test_condition_wait_notify_roundtrip():
    lk = lo.instrument(_thread.allocate_lock(), name="cond_fixture",
                       graph=lo.LockOrderGraph())
    cond = threading.Condition(lk)
    hits = []

    def waiter():
        with cond:
            while not hits:
                if not cond.wait(timeout=10.0):
                    return
            hits.append("woke")

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.05)
    with cond:
        hits.append("set")
        cond.notify_all()
    t.join(timeout=10.0)
    assert hits == ["set", "woke"]


def test_rlock_condition_keeps_the_held_stack_honest():
    g = lo.LockOrderGraph()
    outer = lo.instrument(_thread.RLock(), name="outer", graph=g)
    inner = lo.instrument(_thread.allocate_lock(), name="inner", graph=g)
    cond = threading.Condition(outer)
    with cond:
        cond.wait(timeout=0.01)      # releases and re-acquires outer
        with inner:
            pass
    assert g.edges() == {("outer", "inner"): 1}


def test_long_hold_lands_in_the_ports_tracer(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_LOCK_HOLD_MS", "20")
    prev = trace.get_tracer()
    tracer = trace.Tracer()
    trace.set_tracer(tracer)
    try:
        lk = lo.instrument(_thread.allocate_lock(), name="hold_fixture",
                           graph=lo.LockOrderGraph())
        with lk:
            time.sleep(0.04)
        with lk:
            pass                      # a short hold: no span
    finally:
        trace.set_tracer(prev)
    spans = [s for s in tracer.spans() if s.name == "lock_hold"]
    assert len(spans) == 1 and spans[0].attrs["lock"] == "hold_fixture"
    assert spans[0].dur_us >= 20_000


def test_install_puts_back_exactly_what_it_found():
    """Under pytest the JAX package's detector is installed first; the
    port's install layers over it and uninstall restores it."""
    found = (threading.Lock, threading.RLock)
    assert not lo.installed()
    try:
        g = lo.install()
        assert lo.installed() and g is lo.get_graph()
        lk = threading.Lock()          # allocated in this repo: wrapped
        assert isinstance(lk, lo.InstrumentedLock)
        assert isinstance(lk._inner, type(_thread.allocate_lock()))
        assert lk.name.startswith("tests/test_torch_lockorder.py:")
        rl = threading.RLock()
        assert isinstance(rl, lo.InstrumentedLock)
        with lk:
            assert lk.locked()
        assert not lk.locked()
    finally:
        lo.uninstall()
    assert (threading.Lock, threading.RLock) == found
    assert not lo.installed()


def test_the_port_wraps_the_interpreters_own_locks():
    assert lo._RAW_LOCK is _thread.allocate_lock
    assert lo.instrument(name="x", graph=lo.LockOrderGraph())._inner \
        .__class__ is type(_thread.allocate_lock())


def test_maybe_install_honours_the_env(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_LOCK_CHECK", "0")
    assert lo.maybe_install() is None and not lo.installed()
    monkeypatch.setenv("DL4J_TPU_LOCK_CHECK", "1")
    try:
        assert lo.maybe_install() is lo.get_graph()
    finally:
        lo.uninstall()
    assert not lo.installed()
