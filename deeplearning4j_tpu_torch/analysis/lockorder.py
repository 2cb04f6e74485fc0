"""Runtime lock-order detector: would-be deadlocks without the hang
(counterpart of deeplearning4j_tpu/analysis/lockorder.py).

A deadlock needs two threads taking the same pair of locks in opposite
orders — but the *order violation* exists on every run, even when the
interleaving happens to win the race. This module makes the violation
observable: with instrumentation installed, every ``threading.Lock()`` /
``threading.RLock()`` becomes a thin wrapper that

- names itself after its allocation site
  (``deeplearning4j_tpu_torch/serving/batcher.py:58``),
- records a directed edge *held-lock -> newly-acquired-lock* into a
  process-global :class:`LockOrderGraph` on every acquisition made
  while other locks are held,
- times every hold and, when a lock was held longer than
  ``DL4J_TPU_LOCK_HOLD_MS`` (default 50), records a ``lock_hold`` span
  into the port's ambient tracer (observability/trace.py) — held-across-
  blocking-call spans show up right next to ``device_step`` in the same
  timeline.

A cycle in the accumulated graph is a would-be deadlock and is reported
as a ``DL4J-L001`` :class:`~deeplearning4j_tpu.analysis.Finding`.

Instrumentation is opt-in: :func:`install` (or :func:`maybe_install`
under ``DL4J_TPU_LOCK_CHECK=1``); importing this module installs
nothing. The wrapper is deliberately cheap — one thread-local list
append/pop per acquire/release and a set lookup per edge.

The factories :func:`install` replaces may already be another wrapper's
(the JAX package's detector, which its test configuration installs):
``install`` keeps what it found and :func:`uninstall` puts exactly that
back. The locks this module makes wrap the interpreter's own lock types,
whatever ``threading.Lock`` is at import.

Tests that *construct* deadlock cycles on purpose pass their own
``LockOrderGraph`` to :func:`instrument` so the poison edges never
touch the global graph.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
from time import perf_counter as _now
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.analysis import Finding

__all__ = [
    "LockOrderGraph", "InstrumentedLock", "instrument", "get_graph",
    "install", "uninstall", "installed", "maybe_install",
]

# the interpreter's own lock types: ``threading.Lock`` may already be
# another detector's factory when this module is imported
_RAW_LOCK = _thread.allocate_lock
_RAW_RLOCK = getattr(threading, "_CRLock", None) or threading._PyRLock

_THIS_FILE = os.path.abspath(__file__)
_THREADING_FILE = os.path.abspath(threading.__file__)
_PKG = "deeplearning4j_tpu_torch"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_THIS_FILE)))


def _hold_threshold_s() -> float:
    try:
        return float(os.environ.get("DL4J_TPU_LOCK_HOLD_MS", "50")) / 1e3
    except ValueError:
        return 0.05


#: cached hold threshold — the release path runs on every lock release,
#: so the env var is read once here and refreshed by install()/instrument()
#: rather than per release
_HOLD_S = _hold_threshold_s()


def _alloc_site() -> Tuple[str, bool]:
    """Allocation site of the lock being constructed: a stable
    repo-relative ``path:lineno`` label plus whether the allocating
    code lives inside this repo. Locks allocated by stdlib /
    third-party code (torch, concurrent.futures, ...) are not our
    audit surface and must keep exact raw-lock semantics — the
    installed factories leave them unwrapped."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.abspath(fn) not in (_THIS_FILE, _THREADING_FILE):
            afn = os.path.abspath(fn)
            in_repo = afn.startswith(_REPO_ROOT + os.sep)
            parts = fn.replace(os.sep, "/").split("/")
            if _PKG in parts:
                rel = "/".join(parts[parts.index(_PKG):])
            else:
                rel = "/".join(parts[-2:])
            return f"{rel}:{f.f_lineno}", in_repo
        f = f.f_back
    return "<unknown>", False


def _site_name() -> str:
    return _alloc_site()[0]


class LockOrderGraph:
    """Cross-thread lock acquisition-order graph.

    Nodes are allocation-site names; a directed edge a->b means some
    thread acquired lock b while holding lock a. Any cycle means two
    code paths disagree about ordering — a deadlock waiting for the
    right interleaving."""

    def __init__(self):
        self._lock = _RAW_LOCK()
        self._seen: set = set()                    # lock-free fast path
        self._edges: Dict[Tuple[str, str], int] = {}
        self._edge_thread: Dict[Tuple[str, str], str] = {}

    def record_edge(self, held: str, acquired: str, thread: str) -> None:
        if held == acquired:
            return          # reentrant / same-site locks are not an order
        key = (held, acquired)
        if key in self._seen:
            return
        with self._lock:
            self._seen.add(key)
            self._edges[key] = self._edges.get(key, 0) + 1
            self._edge_thread.setdefault(key, thread)

    def edges(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self._edges)

    def clear(self) -> None:
        with self._lock:
            self._seen = set()
            self._edges.clear()
            self._edge_thread.clear()

    # ------------------------------------------------------------- analysis
    def cycles(self) -> List[List[str]]:
        """Strongly-connected components with >1 node (each is at least
        one acquisition-order cycle), nodes sorted for determinism."""
        adj: Dict[str, set] = {}
        for a, b in self.edges():
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: set = set()
        stack: List[str] = []
        counter = [0]
        out: List[List[str]] = []

        def strongconnect(v: str):
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            for w in adj[v]:
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) > 1:
                    out.append(sorted(scc))

        for v in sorted(adj):
            if v not in index:
                strongconnect(v)
        return sorted(out)

    def findings(self) -> List[Finding]:
        found = []
        for cyc in self.cycles():
            found.append(Finding(
                code="DL4J-L001", path="<runtime>", line=0,
                symbol="lockorder",
                message="acquisition-order cycle: "
                        + " <-> ".join(cyc)))
        return found


_GLOBAL_GRAPH = LockOrderGraph()


def get_graph() -> LockOrderGraph:
    return _GLOBAL_GRAPH


# thread-local acquisition state, shared by every instrumented lock
class _TLS(threading.local):
    def __init__(self):
        self.held: List[Tuple[int, str, float]] = []  # (lock id, name, t0)
        self.busy = False          # reentrancy guard for bookkeeping


_tls = _TLS()


class InstrumentedLock:
    """Drop-in wrapper for ``threading.Lock``/``RLock`` objects that
    feeds a :class:`LockOrderGraph` and emits ``lock_hold`` tracer spans
    for long holds. Condition-compatible: forwards ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` (with the stdlib's documented
    fallbacks when the inner lock lacks them) and keeps the held-stack
    honest across ``Condition.wait``."""

    __slots__ = ("_inner", "name", "_graph")

    def __init__(self, inner, name: str, graph: LockOrderGraph):
        self._inner = inner
        self.name = name
        self._graph = graph

    # ---------------------------------------------------------- bookkeeping
    # (the common case — no other lock held — touches only the TLS list
    # and perf_counter)
    def _note_acquire(self) -> None:
        tls = _tls
        if tls.busy:
            return
        held = tls.held
        me = id(self)
        if held:
            tls.busy = True
            try:
                for h in held:
                    if h[0] == me:          # reentrant: no edges
                        break
                else:
                    thread = threading.current_thread().name
                    record = self._graph.record_edge
                    for _, hname, _ in held:
                        record(hname, self.name, thread)
            finally:
                tls.busy = False
        held.append((me, self.name, _now()))

    def _note_release(self) -> None:
        tls = _tls
        if tls.busy:
            return
        held = tls.held
        me = id(self)
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == me:
                t0 = held[i][2]
                del held[i]
                t1 = _now()
                if t1 - t0 >= _HOLD_S:      # rare: long hold -> tracer span
                    tls.busy = True
                    try:
                        from deeplearning4j_tpu_torch.observability.trace \
                            import get_tracer
                        get_tracer().record("lock_hold", t0, t1,
                                            {"lock": self.name})
                    finally:
                        tls.busy = False
                break

    # ------------------------------------------------------------- lock API
    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)  # analysis: ok(C001) — the wrapper IS the lock API
        if ok:
            self._note_acquire()
        return ok

    def release(self) -> None:
        self._note_release()
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()  # analysis: ok(C001) — __exit__ is the paired release
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<InstrumentedLock {self.name} {self._inner!r}>"

    def _at_fork_reinit(self) -> None:
        # os.register_at_fork handlers (concurrent.futures, logging)
        # reinit their module locks in the forked child
        self._inner._at_fork_reinit()

    # --------------------------------------------- Condition compatibility
    def _release_save(self):
        inner = self._inner
        save = getattr(inner, "_release_save", None)
        if save is not None:
            self._note_release()
            return save()
        self.release()
        return None

    def _acquire_restore(self, state) -> None:
        inner = self._inner
        restore = getattr(inner, "_acquire_restore", None)
        if restore is not None:
            restore(state)
            self._note_acquire()
        else:
            self.acquire()  # analysis: ok(C001) — Condition re-acquire protocol

    def _is_owned(self) -> bool:
        inner = self._inner
        owned = getattr(inner, "_is_owned", None)
        if owned is not None:
            return owned()
        # stdlib Condition's own fallback for plain locks
        if inner.acquire(False):  # analysis: ok(C001) — probe, released on next line
            inner.release()
            return False
        return True


def instrument(lock=None, *, name: Optional[str] = None,
               graph: Optional[LockOrderGraph] = None) -> InstrumentedLock:
    """Wrap one lock explicitly (tests building intentional deadlock
    cycles pass their own ``graph`` so the global gate stays clean)."""
    global _HOLD_S
    _HOLD_S = _hold_threshold_s()
    return InstrumentedLock(lock if lock is not None else _RAW_LOCK(),
                            name or _site_name(),
                            graph or _GLOBAL_GRAPH)


# --------------------------------------------------------------------------
# process-wide installation (monkeypatches the threading factories)
# --------------------------------------------------------------------------

_installed = False
# the factories install() replaced, put back by uninstall()
_found: Optional[Tuple] = None


def _make_lock(*a, **kw):
    name, in_repo = _alloc_site()
    raw = _RAW_LOCK(*a, **kw)
    if not in_repo:
        return raw      # stdlib/third-party lock: not our audit surface
    return InstrumentedLock(raw, name, _GLOBAL_GRAPH)


def _make_rlock(*a, **kw):
    name, in_repo = _alloc_site()
    raw = _RAW_RLOCK(*a, **kw)
    if not in_repo:
        return raw
    return InstrumentedLock(raw, name, _GLOBAL_GRAPH)


def install() -> LockOrderGraph:
    """Replace ``threading.Lock``/``RLock`` with instrumented factories,
    keeping the ones found for :func:`uninstall`. Only locks allocated
    from code inside this repo are wrapped — stdlib/third-party
    allocations (torch, concurrent.futures) get the raw lock back, both
    because they are not our audit surface and because stdlib
    import-time code touches raw-lock internals (``_at_fork_reinit``
    registration). Locks created *before* install (and modules that
    froze the factory with ``from threading import Lock``) stay as they
    were made: install before building what the graph should cover."""
    global _installed, _HOLD_S, _found
    _HOLD_S = _hold_threshold_s()
    if not _installed:
        _found = (threading.Lock, threading.RLock)
        threading.Lock = _make_lock
        threading.RLock = _make_rlock
        _installed = True
    return _GLOBAL_GRAPH


def uninstall() -> None:
    """Put back exactly the factories :func:`install` found."""
    global _installed, _found
    if _installed:
        threading.Lock, threading.RLock = _found
        _found = None
        _installed = False


def installed() -> bool:
    return _installed


def maybe_install() -> Optional[LockOrderGraph]:
    """Install when ``DL4J_TPU_LOCK_CHECK=1``."""
    if os.environ.get("DL4J_TPU_LOCK_CHECK", "0") == "1":
        return install()
    return None
