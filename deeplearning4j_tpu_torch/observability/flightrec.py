"""Crash flight recorder: a black-box ring flushed on the way down
(counterpart of deeplearning4j_tpu/observability/flightrec.py).

The flight recorder keeps a small always-on ring of the most recent
spans (fed straight off the tracer's sink seam, so it sees exactly what
the tracer saw, including sampled-in spans only) plus recent supervisor
events (recovery, NaN rollback, preemption, checkpoint activity) and, at
flush time, a full metrics snapshot. On SIGTERM, unhandled exception,
NaN rollback or preemption the ring is flushed atomically (tmp +
``os.replace``) to ``flight_<tag>.json`` — ``tag`` being the instance
name suffixed with the supervisor incarnation, so every relaunch leaves
its own readable artifact instead of overwriting the last one.

The recorder is deliberately cheap on the hot path: recording a span is
one deque append under the tracer's existing sink call; recording an
event is one deque append under its own lock; everything expensive
(metrics snapshot, JSON encode, file IO) happens only at flush. The JAX
package budgets the installed-vs-not fit-time delta at 1% (its
``identity_overhead`` bench); ``chip_smoke.py``'s ``[observability]``
measures the port's on the card.

The file is the JAX package's, schema 1: ``schema``, ``reason``,
``time``, ``identity``, ``exception``, ``events``, ``trace_ids``,
``spans``, ``metrics``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback as _tb
from collections import deque
from typing import Optional

from deeplearning4j_tpu_torch.observability import trace as _trace
from deeplearning4j_tpu_torch.observability.distributed import get_identity

__all__ = [
    "FlightRecorder", "get_flight_recorder", "install_flight_recorder",
    "uninstall_flight_recorder",
]

FLIGHT_SCHEMA_VERSION = 1


def _ring_trace_ids(spans) -> list:
    """Ordered unique trace ids riding the ring's span attrs (oldest
    first) — the ``trace_ids`` field of the flight artifact, and the
    join key that lets a post-mortem pull the same requests' stitched
    waterfalls out of the router's TraceStore."""
    seen: dict = {}
    for s in spans:
        attrs = s.attrs or {}
        tid = attrs.get("trace_id")
        if tid:
            seen[str(tid)] = None
        for t in attrs.get("trace_ids") or ():
            seen[str(t)] = None
    return list(seen)


def _sanitize(tag: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_.") else "_" for c in tag)


class FlightRecorder:
    """Bounded black-box ring of spans + events, flushed atomically to
    ``flight_<tag>.json`` when something goes wrong."""

    def __init__(self, dir: Optional[str] = None, capacity: int = 256,
                 event_capacity: int = 128):
        self.dir = (dir or os.environ.get("DL4J_TPU_FLIGHT_DIR")
                    or os.getcwd())
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._spans = deque(maxlen=int(capacity))
        self._events = deque(maxlen=int(event_capacity))
        self._installed = False
        self._prev_excepthook = None
        self._flushes = 0
        #: path of the most recent artifact (None until first flush)
        self.last_path: Optional[str] = None

    # ------------------------------------------------------------- recording
    def _sink(self, span) -> None:
        # called by the tracer outside its lock, per recorded span
        with self._lock:
            self._spans.append(span)

    def record_event(self, kind: str, step: Optional[int] = None,
                     detail: str = "") -> None:
        """Append one supervisor/runtime event (recovery, nan_rollback,
        preemption, checkpoint, ...) to the event ring."""
        with self._lock:
            self._events.append({"time": time.time(), "kind": str(kind),
                                 "step": step, "detail": str(detail)})

    # ----------------------------------------------------------- lifecycle
    def install(self) -> "FlightRecorder":
        """Attach to the current tracer's sink seam and chain into
        ``sys.excepthook`` so a crash flushes the box. Idempotent."""
        if self._installed:
            return self
        _trace.get_tracer().add_sink(self._sink)
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        try:
            _trace.get_tracer().remove_sink(self._sink)
        except Exception:
            pass
        # == not is: each attribute read makes a new bound method
        if sys.excepthook == self._excepthook:
            sys.excepthook = self._prev_excepthook or sys.__excepthook__
        self._prev_excepthook = None
        self._installed = False

    def _excepthook(self, exc_type, exc, tb):
        try:
            self.flush("unhandled_exception", exc=exc)
        except Exception:
            pass
        (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    # --------------------------------------------------------------- flush
    def flush(self, reason: str, exc: Optional[BaseException] = None
              ) -> Optional[str]:
        """Write the black box to ``flight_<tag>.json`` atomically;
        returns the path (None if the write failed — a flight recorder
        must never turn a crash into a different crash)."""
        ident = get_identity()
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
            self._flushes += 1
        doc = {
            "schema": FLIGHT_SCHEMA_VERSION,
            "reason": str(reason),
            "time": time.time(),
            "identity": ident.to_dict(),
            "exception": None,
            "events": events,
            # the last-N request trace ids this process saw — join
            # these against the aggregator's /api/trace/<id> store
            "trace_ids": _ring_trace_ids(spans),
            "spans": [
                {"name": s.name, "ts_us": s.ts_us, "dur_us": s.dur_us,
                 "thread": s.thread, "attrs": dict(s.attrs or {})}
                for s in spans],
            "metrics": None,
        }
        if exc is not None:
            doc["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": "".join(_tb.format_exception(
                    type(exc), exc, exc.__traceback__))[-8000:],
            }
        try:
            from deeplearning4j_tpu_torch.observability.metrics import get_registry
            doc["metrics"] = get_registry().snapshot()
        except Exception:
            pass
        # rank-suffixed in multi-process runs (rank 0 keeps the legacy
        # name): N workers sharing one checkpoint dir under a default
        # identity would otherwise clobber each other's post-mortems
        from deeplearning4j_tpu_torch.observability.distributed import rank_suffix
        path = os.path.join(
            self.dir, f"flight_{_sanitize(ident.tag)}{rank_suffix()}.json")
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            text = json.dumps(doc, indent=1, default=str)
            with open(tmp, "w") as fh:
                fh.write(text)    # one write: json.dump writes each token
            os.replace(tmp, path)
        except OSError:
            return None
        self.last_path = path
        return path


_rec_lock = threading.Lock()
_RECORDER: Optional[FlightRecorder] = None


def get_flight_recorder() -> Optional[FlightRecorder]:
    """The installed process-wide recorder, or None."""
    return _RECORDER


def install_flight_recorder(dir: Optional[str] = None,
                            capacity: int = 256) -> FlightRecorder:
    """Create-or-reuse the process-wide recorder and install it. A
    second call just repoints the flush directory (the supervisor calls
    this per launch with its checkpoint dir)."""
    global _RECORDER
    with _rec_lock:
        if _RECORDER is None:
            _RECORDER = FlightRecorder(dir=dir, capacity=capacity)
        elif dir is not None:
            _RECORDER.dir = dir
        return _RECORDER.install()


def uninstall_flight_recorder() -> None:
    """Detach and forget the process-wide recorder (tests)."""
    global _RECORDER
    with _rec_lock:
        if _RECORDER is not None:
            _RECORDER.uninstall()
            _RECORDER = None
