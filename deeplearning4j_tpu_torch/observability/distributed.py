"""Process identity across the observability plane (counterpart of the
identity part of deeplearning4j_tpu/observability/distributed.py).

Every process carries a stable :class:`ProcessIdentity`: a ``run_id``
shared by all members of one logical run (env ``DL4J_TPU_RUN_ID``,
generated otherwise), an ``instance`` name unique per process (env
``DL4J_TPU_INSTANCE``, default ``<host>-<pid>``) and an ``incarnation``
counter bumped on every supervisor relaunch (env
``DL4J_TPU_INCARNATION`` seeds it). The identity is stamped onto
Chrome-trace exports, RunReports, the ``dl4j_instance_info`` metric
family and flight-recorder artifacts. :func:`new_trace_id` mints the ids
of the ``X-DL4J-Trace-Id`` header.

A process's rank (``rank_suffix``) is ``torch.distributed``'s when a
process group is initialised, else 0, as the JAX package's is in one
process.

The cross-process half of the JAX module (snapshot export and push,
``MetricsFederation``, the heartbeat pusher, the span push buffer and
the trace store behind the health scoreboard) waits for ROADMAP.md A.5;
each of those names raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import os
import socket
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = [
    "ProcessIdentity", "get_identity", "set_identity", "reset_identity",
    "bump_incarnation", "new_trace_id", "stamp_run_marker", "TRACE_HEADER",
    "export_snapshot", "MetricsFederation", "SNAPSHOT_SCHEMA_VERSION",
    "rank_suffix", "push_snapshot", "HeartbeatPusher",
    "SpanPushBuffer", "TraceStore", "TRACE_PUSH_SCHEMA_VERSION",
]

#: the header /predict and /decode accept and echo
TRACE_HEADER = "X-DL4J-Trace-Id"

SNAPSHOT_SCHEMA_VERSION = 1

#: wire schema of the span-batch payload riding the metrics snapshot
TRACE_PUSH_SCHEMA_VERSION = 1


def _rank() -> int:
    """This process's rank: ``torch.distributed``'s when a process group
    is initialised, else 0."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


# ---------------------------------------------------------------------------
# identity
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ProcessIdentity:
    """Who this process is, fleet-wide. ``run_id`` groups the members of
    one logical run; ``instance`` is unique per process; ``incarnation``
    counts supervisor relaunches (same instance, new lifetime)."""

    run_id: str
    instance: str
    pid: int
    incarnation: int
    start_time: float

    @property
    def tag(self) -> str:
        """The fleet-unique name artifacts are keyed by: the instance,
        suffixed with the incarnation once the process has relaunched
        (``worker-0`` -> ``worker-0-i2``)."""
        if self.incarnation:
            return f"{self.instance}-i{self.incarnation}"
        return self.instance

    def labels(self) -> Dict[str, str]:
        """The label set stamped onto ``dl4j_instance_info``."""
        return {"run_id": self.run_id, "instance": self.instance,
                "incarnation": str(self.incarnation), "pid": str(self.pid)}

    def to_dict(self) -> dict:
        return {"run_id": self.run_id, "instance": self.instance,
                "pid": self.pid, "incarnation": self.incarnation,
                "start_time": self.start_time, "tag": self.tag}


_id_lock = threading.Lock()
_IDENTITY: Optional[ProcessIdentity] = None


def _build_identity() -> ProcessIdentity:
    run_id = os.environ.get("DL4J_TPU_RUN_ID") or uuid.uuid4().hex[:12]
    instance = os.environ.get("DL4J_TPU_INSTANCE") or (
        f"{socket.gethostname()}-{os.getpid()}")
    try:
        incarnation = int(os.environ.get("DL4J_TPU_INCARNATION", "0"))
    except ValueError:
        incarnation = 0
    return ProcessIdentity(run_id=run_id, instance=instance,
                           pid=os.getpid(), incarnation=incarnation,
                           start_time=time.time())


def get_identity() -> ProcessIdentity:
    """The process identity, built lazily from the ``DL4J_TPU_RUN_ID`` /
    ``DL4J_TPU_INSTANCE`` / ``DL4J_TPU_INCARNATION`` environment on
    first use (so a launcher exports them once and every subsystem —
    tracer export, RunReports, metrics, flight recorder — agrees)."""
    global _IDENTITY
    with _id_lock:
        if _IDENTITY is None:
            _IDENTITY = _build_identity()
        return _IDENTITY


def set_identity(**fields) -> ProcessIdentity:
    """Replace identity fields in place (``set_identity(instance="w0")``).
    Returns the new identity."""
    global _IDENTITY
    with _id_lock:
        base = _IDENTITY if _IDENTITY is not None else _build_identity()
        d = base.to_dict()
        d.pop("tag")
        d.update(fields)
        _IDENTITY = ProcessIdentity(**d)
        return _IDENTITY


def reset_identity() -> None:
    """Forget the cached identity (tests: re-read the environment)."""
    global _IDENTITY
    with _id_lock:
        _IDENTITY = None


def bump_incarnation() -> ProcessIdentity:
    """Advance the incarnation counter — called per supervisor relaunch
    so artifacts (flight recordings, federation tags) from different
    lifetimes of the same instance never collide, even when the
    relaunch happens in-process with an unchanged pid."""
    ident = get_identity()
    return set_identity(incarnation=ident.incarnation + 1,
                        start_time=time.time())


def rank_suffix() -> str:
    """Per-rank artifact disambiguator for multi-process runs writing
    into one shared directory: ``""`` on rank 0 (and outside any
    multi-process runtime — legacy names stay stable), ``".r<k>"`` on
    rank k>0. Inserted before the extension of ``run_report.json`` and
    ``flight_<tag>.json`` so a 2-process run stops silently clobbering
    its own post-mortems."""
    idx = _rank()
    return f".r{idx}" if idx else ""


def new_trace_id() -> str:
    """Mint a trace id for the ``X-DL4J-Trace-Id`` header (16 hex chars
    — W3C-traceparent-sized, stdlib-only)."""
    return uuid.uuid4().hex[:16]


def stamp_run_marker(kind: str) -> None:
    """Record a zero-duration ``run_start`` span carrying the process
    identity — the fit loops and servers call this at run start so any
    exported timeline says which fleet member and incarnation it came
    from even when sliced out of the full export."""
    try:
        from deeplearning4j_tpu_torch.observability.trace import get_tracer
        ident = get_identity()
        t = time.perf_counter()
        get_tracer().record("run_start", t, t, {
            "kind": str(kind), "run_id": ident.run_id,
            "instance": ident.instance,
            "incarnation": ident.incarnation})
    except Exception:
        pass


# ---------------------------------------------------------------------------
# the cross-process plane (ROADMAP.md A.5)
# ---------------------------------------------------------------------------

def _waits(name: str):
    raise NotImplementedError(
        f"{name}: metrics federation, the span push and the health "
        "scoreboard wait for ROADMAP.md A.5 (parallel/)")


def export_snapshot(registry=None, health: Optional[dict] = None,
                    **kw) -> dict:
    """The federation's snapshot wire form: waits for ROADMAP.md A.5."""
    _waits("export_snapshot")


def push_snapshot(url: str, registry=None, health: Optional[dict] = None,
                  **kw):
    """Push a snapshot to an aggregator: waits for ROADMAP.md A.5."""
    _waits("push_snapshot")


class MetricsFederation:
    """The merged fleet view of N processes' metrics: waits for
    ROADMAP.md A.5."""

    def __init__(self, *args, **kwargs):
        _waits("MetricsFederation")


class HeartbeatPusher:
    """Periodic snapshot push: waits for ROADMAP.md A.5."""

    def __init__(self, *args, **kwargs):
        _waits("HeartbeatPusher")


class SpanPushBuffer:
    """Spans batched onto the snapshot push: waits for ROADMAP.md A.5."""

    def __init__(self, *args, **kwargs):
        _waits("SpanPushBuffer")


class TraceStore:
    """The aggregator's stitched request traces: waits for ROADMAP.md
    A.5."""

    def __init__(self, *args, **kwargs):
        _waits("TraceStore")
