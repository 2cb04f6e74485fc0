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

The cross-process plane:

- **Federation.** :func:`export_snapshot` renders a registry into the
  JSON wire form (family name/kind/help plus samples with the canonical
  exposition-escaped key); :func:`push_snapshot` POSTs it to an
  aggregator's ``/api/metrics_push`` (optional retry with jittered
  exponential backoff); :class:`HeartbeatPusher` pushes on an interval
  and never raises. :class:`MetricsFederation` keeps the latest
  snapshot per instance and re-exports one merged Prometheus view
  (every sample instance-labeled, plus an ``instance="fleet"`` rollup:
  counters and histograms sum, gauges are last-write-wins).
- **Health scoreboard.** ``MetricsFederation.health()``: per-instance
  liveness from heartbeat age, readiness from the pushed ``*healthy``
  flags, queue depth, retry-after, drain rate; instances silent past
  ``evict_after_factor x stale_after_s`` are evicted.
- **Trace stitching.** :class:`SpanPushBuffer` is a tracer sink that
  batches request-scoped spans onto the push; :class:`TraceStore`
  indexes them by trace id on the aggregator and renders
  clock-skew-rebased waterfalls.

The wire form is the JAX package's, key for key, so either package's
aggregator ingests the other's pushes.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.observability.metrics import (MetricFamily,
                                                            get_registry,
                                                            sample_key)

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
# snapshot wire format
# ---------------------------------------------------------------------------

def export_snapshot(registry=None, health: Optional[dict] = None,
                    spans: Optional[dict] = None) -> dict:
    """Render a registry into the federation wire form: full fidelity
    (family kind/help, every sample's labels + suffix) plus the
    canonical exposition-escaped ``key`` per sample, so the aggregator
    merges and re-renders without re-deriving escaping. ``health`` is
    the pusher's self-reported readiness payload (e.g. the serving
    batcher's ``healthy`` flag). ``spans`` is a span-batch payload
    (:meth:`SpanPushBuffer.payload`) riding the same push — aggregators
    that predate it ignore the extra key (``MetricsFederation.ingest``
    validates only ``families``)."""
    reg = registry if registry is not None else get_registry()
    fams = []
    for fam in reg.collect():
        fams.append({
            "name": fam.name,
            "kind": fam.kind,
            "help": fam.help,
            "samples": [
                {"key": sample_key(fam.name, s.labels, s.suffix),
                 "labels": dict(s.labels), "suffix": s.suffix,
                 "value": s.value}
                for s in fam.samples],
        })
    out = {
        "schema": SNAPSHOT_SCHEMA_VERSION,
        "identity": get_identity().to_dict(),
        "time": time.time(),
        "families": fams,
        "health": dict(health or {}),
    }
    if spans:
        out["spans"] = spans
    return out


def push_snapshot(url: str, registry=None, health: Optional[dict] = None,
                  timeout: float = 5.0, *, attempts: int = 1,
                  backoff_initial_s: float = 0.2,
                  backoff_factor: float = 2.0, backoff_max_s: float = 5.0,
                  jitter: float = 0.5, sleep_fn=time.sleep,
                  spans_fn=None) -> dict:
    """POST :func:`export_snapshot` to an aggregator's
    ``/api/metrics_push`` endpoint; returns the aggregator's reply.

    ``attempts > 1`` opts into retry with exponential backoff + jitter:
    a restarting aggregator (connection refused, reset, 5xx) costs a
    worker one delayed heartbeat instead of dropping it permanently.
    The snapshot is re-exported per attempt so the delivered heartbeat
    timestamp is fresh, not the first attempt's stale one. Jitter
    de-synchronizes a fleet whose workers all lost the same aggregator
    at the same moment (the thundering-herd reconnect).

    ``spans_fn`` (no-arg -> span payload dict or None) is evaluated
    ONCE, before the first attempt — a drain-style source
    (:meth:`SpanPushBuffer.payload`) must not lose its batch to a retry,
    so the same batch rides every attempt."""
    import random
    import urllib.request
    attempts = max(1, int(attempts))
    delay = backoff_initial_s
    spans = spans_fn() if spans_fn is not None else None
    for attempt in range(attempts):
        try:
            body = json.dumps(
                export_snapshot(registry, health, spans)).encode()
            req = urllib.request.Request(
                url, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode())
        except OSError:
            # URLError (incl. HTTPError) subclasses OSError: covers
            # refused/reset connections, DNS blips, and 5xx restarts
            if attempt + 1 >= attempts:
                raise
            sleep_fn(min(backoff_max_s,
                         delay * (1.0 + jitter * random.random())))
            delay = min(delay * backoff_factor, backoff_max_s)


class HeartbeatPusher:
    """Background push loop: POST a fresh :func:`export_snapshot` to an
    aggregator every ``interval_s`` until stopped.

    This is the worker-fleet side of the cross-host serving federation
    (serving/router.py): each host's ``ModelServer`` runs one of these
    against the router's ``/api/metrics_push``, so the router's routing
    and liveness decisions ride live queue-depth/heartbeat gauges. The
    push retry is ON here (``attempts=3`` by default, jittered
    exponential backoff — the :func:`push_snapshot` opt-in): a router
    restart or transient refusal costs a host one delayed heartbeat,
    not its scoreboard row. The backoff schedule is pinned by
    ``tests/test_crosshost_serving.py``.

    ``health_fn`` (no-arg -> dict) is re-evaluated per push so the
    delivered readiness payload is current, not construction-time.
    ``spans_fn`` (no-arg -> span payload dict or None, e.g.
    :meth:`SpanPushBuffer.payload`) rides each push under the
    snapshot's ``spans`` key — the trace-stitching wire.
    """

    def __init__(self, url: str, interval_s: float = 2.0, *,
                 health_fn=None, registry=None, timeout: float = 5.0,
                 attempts: int = 3, backoff_initial_s: float = 0.2,
                 backoff_factor: float = 2.0, backoff_max_s: float = 2.0,
                 jitter: float = 0.5, spans_fn=None):
        self.url = url
        self.interval_s = float(interval_s)
        self.health_fn = health_fn
        self.spans_fn = spans_fn
        self.registry = registry
        self.timeout = float(timeout)
        self.attempts = int(attempts)
        self.backoff_initial_s = float(backoff_initial_s)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self.pushes_ok = 0
        self.pushes_failed = 0
        self.last_error: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def push_once(self) -> bool:
        """One push (with the retry policy applied); returns success.
        Exhausted retries are counted, never raised — a heartbeat loop
        must outlive its aggregator's bad day."""
        try:
            health = self.health_fn() if self.health_fn else None
            push_snapshot(self.url, self.registry, health,
                          timeout=self.timeout, attempts=self.attempts,
                          backoff_initial_s=self.backoff_initial_s,
                          backoff_factor=self.backoff_factor,
                          backoff_max_s=self.backoff_max_s,
                          jitter=self.jitter, spans_fn=self.spans_fn)
        except Exception as e:
            self.pushes_failed += 1
            self.last_error = f"{type(e).__name__}: {e}"
            return False
        self.pushes_ok += 1
        return True

    def start(self) -> "HeartbeatPusher":
        if self._thread is not None:
            return self
        # one synchronous push before the loop: the aggregator knows
        # this instance the moment start() returns, not one interval in
        self.push_once()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.push_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="dl4j-heartbeat-push")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=self.timeout + 1.0)


# ---------------------------------------------------------------------------
# federation
# ---------------------------------------------------------------------------

class MetricsFederation:
    """Aggregates the latest snapshot per instance and re-exports one
    merged Prometheus view.

    Ingest is last-write-wins per instance tag (a push wholly replaces
    that instance's previous snapshot, under one lock — concurrent
    pushes from N worker threads/processes are safe and the merge
    always reflects a consistent set of "latest" snapshots). Merge
    semantics per family across instances:

    - every sample re-emitted with an added ``instance=<tag>`` label
    - one fleet rollup sample per distinct (labels, suffix) series with
      ``instance="fleet"``: counters and histogram ``_bucket``/``_sum``
      /``_count`` samples SUM; gauges take the value from the most
      recently pushed snapshot that carries the series (last-write)
    - kind conflicts keep the first-seen kind and skip the conflicting
      family from later snapshots (a broken pusher must not corrupt the
      merged exposition)
    """

    FLEET = "fleet"

    def __init__(self, stale_after_s: float = 15.0,
                 evict_after_factor: Optional[float] = 4.0):
        self.stale_after_s = float(stale_after_s)
        #: auto-eviction threshold as a MULTIPLE of ``stale_after_s``:
        #: an instance whose heartbeat age exceeds
        #: ``evict_after_factor * stale_after_s`` is dropped from the
        #: scoreboard entirely (a shrunken fleet must not list its dead
        #: processes forever — stale marks the wobble, eviction the
        #: departure). None disables; ``drop()`` stays for explicit
        #: eviction either way.
        self.evict_after_factor = (None if evict_after_factor is None
                                   else float(evict_after_factor))
        if self.evict_after_factor is not None \
                and self.evict_after_factor < 1.0:
            raise ValueError("evict_after_factor must be >= 1 (eviction "
                             "below the stale threshold would hide "
                             "instances that are merely slow)")
        #: dead instances reaped by the heartbeat-age auto-eviction
        self.auto_evicted_total = 0
        self._lock = threading.Lock()
        #: tag -> {"snapshot", "received_at", "seq", "pushes",
        #:         "steps", "steps_changed_at"}
        self._instances: Dict[str, dict] = {}
        self._seq = 0

    # ---------------------------------------------------------------- ingest
    def ingest(self, snapshot: dict) -> str:
        """Accept one pushed/scraped snapshot; returns the instance tag
        it was filed under. Raises ValueError on a malformed payload."""
        if not isinstance(snapshot, dict) or "families" not in snapshot:
            raise ValueError("not a metrics snapshot (no 'families')")
        ident = snapshot.get("identity") or {}
        tag = ident.get("tag") or ident.get("instance")
        if not tag:
            raise ValueError("snapshot carries no identity.tag/instance")
        steps = _family_value(snapshot, "dl4j_fit_steps_total")
        now = time.time()
        with self._lock:
            self._seq += 1
            prev = self._instances.get(tag)
            ent = {
                "snapshot": snapshot,
                "received_at": now,
                "seq": self._seq,
                "pushes": (prev["pushes"] + 1) if prev else 1,
                "steps": steps,
                "steps_changed_at": now,
            }
            if prev is not None and steps is not None \
                    and steps == prev.get("steps"):
                ent["steps_changed_at"] = prev["steps_changed_at"]
            self._instances[tag] = ent
        return str(tag)

    def scrape(self, url: str, timeout: float = 5.0) -> str:
        """Pull one child's ``/metrics?format=snapshot`` and ingest it
        (the pull-mode twin of the push endpoint)."""
        import urllib.request
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return self.ingest(json.loads(resp.read().decode()))

    def drop(self, tag: str) -> None:
        with self._lock:
            self._instances.pop(tag, None)

    def instance_tags(self) -> List[str]:
        with self._lock:
            return sorted(self._instances)

    def instance_count(self) -> int:
        with self._lock:
            return len(self._instances)

    # ----------------------------------------------------------------- merge
    def merged_families(self, local: Optional[Tuple[str, list]] = None
                        ) -> List[MetricFamily]:
        """The merged view. ``local`` = ``(tag, families)`` folds the
        aggregator's own registry in as one more instance (the UIServer
        passes its own ``registry.collect()`` so the merged exposition
        covers the whole fleet including the host process)."""
        with self._lock:
            instances = [(tag, ent["seq"], ent["snapshot"])
                         for tag, ent in sorted(self._instances.items())]
        contributions: List[Tuple[str, int, dict]] = []
        if local is not None:
            tag, fams = local
            snap = {"families": [
                {"name": f.name, "kind": f.kind, "help": f.help,
                 "samples": [{"labels": dict(s.labels), "suffix": s.suffix,
                              "value": s.value} for s in f.samples]}
                for f in fams]}
            # the local process is always the freshest writer
            contributions.append((tag, 1 + max(
                [seq for _, seq, _ in instances], default=0), snap))
        contributions.extend(instances)

        merged: Dict[str, MetricFamily] = {}
        kinds: Dict[str, str] = {}
        # series -> rollup accumulator:
        # (family, suffix, labelkey) -> [labels, value, best_seq]
        rollup: Dict[Tuple[str, str, str], list] = {}
        order: List[str] = []
        for tag, seq, snap in contributions:
            for fdict in snap.get("families", ()):
                name, kind = fdict.get("name"), fdict.get("kind")
                if not name or kind not in ("counter", "gauge", "histogram"):
                    continue
                if name not in kinds:
                    kinds[name] = kind
                    merged[name] = MetricFamily(
                        name, kind, fdict.get("help") or "")
                    order.append(name)
                elif kinds[name] != kind:
                    continue  # conflicting kind: first writer wins
                fam = merged[name]
                for s in fdict.get("samples", ()):
                    labels = {str(k): str(v)
                              for k, v in (s.get("labels") or {}).items()}
                    labels.pop("instance", None)
                    suffix = s.get("suffix") or ""
                    try:
                        value = float(s.get("value"))
                    except (TypeError, ValueError):
                        continue
                    fam.add(value, {**labels, "instance": tag}, suffix)
                    rkey = (name, suffix,
                            sample_key(name, labels, suffix))
                    ent = rollup.get(rkey)
                    summed = (kinds[name] == "counter"
                              or kinds[name] == "histogram")
                    if ent is None:
                        rollup[rkey] = [labels, value, seq]
                    elif summed:
                        ent[1] += value
                    elif seq >= ent[2]:      # gauge: last write wins
                        ent[1], ent[2] = value, seq
        for (name, suffix, _), (labels, value, _) in rollup.items():
            merged[name].add(value, {**labels, "instance": self.FLEET},
                             suffix)
        return [merged[name] for name in order]

    def render_prometheus(self, local: Optional[Tuple[str, list]] = None
                          ) -> str:
        fams = self.merged_families(local)
        if not fams:
            return "\n"
        return "\n".join(f.render() for f in fams) + "\n"

    # ---------------------------------------------------------------- health
    def health(self) -> List[dict]:
        """The scoreboard: one dict per instance with liveness (heartbeat
        + push age vs ``stale_after_s``), readiness (the pushed
        ``healthy`` flags, e.g. the serving batcher's device-thread
        liveness), queue depth, step count and progress age.

        Instances whose heartbeat age exceeds
        ``evict_after_factor * stale_after_s`` are auto-evicted here —
        removed from the federation, not just flagged stale — so a
        fleet that shrank stops advertising its dead processes."""
        now = time.time()
        with self._lock:
            items = sorted(self._instances.items())
        evict = []
        out = []
        for tag, ent in items:
            snap = ent["snapshot"]
            push_age = max(0.0, now - ent["received_at"])
            hb = _family_value(snap, "dl4j_heartbeat_timestamp_seconds")
            snap_time = snap.get("time")
            # heartbeat age = staleness at push time (child clock) plus
            # how long ago the push landed (aggregator clock) — robust
            # to small cross-host clock skew
            hb_age = push_age
            if hb is not None and snap_time is not None:
                hb_age += max(0.0, float(snap_time) - float(hb))
            if self.evict_after_factor is not None and \
                    hb_age > self.evict_after_factor * self.stale_after_s:
                evict.append((tag, ent["seq"]))
                continue
            health_payload = snap.get("health") or {}
            flags = [bool(v) for k, v in health_payload.items()
                     if k.endswith("healthy") or k == "ready"]
            live = hb_age <= self.stale_after_s
            steps = ent.get("steps")
            row = {
                "instance": tag,
                "identity": snap.get("identity") or {},
                "live": live,
                "ready": live and all(flags) if flags else live,
                "heartbeat_age_s": round(hb_age, 3),
                "push_age_s": round(push_age, 3),
                "pushes": ent["pushes"],
                "queue_depth": _family_value(
                    snap, "dl4j_serving_queue_depth", agg=sum),
                # the cross-host routing gauges (serving/router.py):
                # backlog-derived Retry-After and observed drain rate,
                # straight off the host's pushed serving families
                "retry_after_s": _family_value(
                    snap, "dl4j_serving_retry_after_seconds", agg=min),
                "drain_rate_rows_per_s": _family_value(
                    snap, "dl4j_serving_drain_rate_rows_per_s", agg=sum),
                "steps_total": steps,
                "last_progress_age_s": (
                    round(max(0.0, now - ent["steps_changed_at"]), 3)
                    if steps is not None else None),
                "health": health_payload,
                # per-replica serving rows (status + queue depth), pushed
                # by a fleet-mode ModelServer — the scoreboard shows the
                # replica hole behind a "degraded" instance
                "replicas": health_payload.get("replicas"),
            }
            out.append(row)
        if evict:
            with self._lock:
                for tag, seq in evict:
                    ent = self._instances.get(tag)
                    # seq guard: a push that landed while we were
                    # scoring means the instance is alive after all
                    if ent is not None and ent["seq"] == seq:
                        self._instances.pop(tag)
                        self.auto_evicted_total += 1
        return out

    def fleet_payload(self) -> dict:
        """The ``/api/fleet`` JSON: scoreboard + aggregate counts."""
        rows = self.health()
        return {
            "time": time.time(),
            "instances": rows,
            "live": sum(1 for r in rows if r["live"]),
            "ready": sum(1 for r in rows if r["ready"]),
            "stale_after_s": self.stale_after_s,
            "evict_after_factor": self.evict_after_factor,
            "auto_evicted_total": self.auto_evicted_total,
        }


# ---------------------------------------------------------------------------
# request-scoped trace stitching: span push + the aggregator-side store
# ---------------------------------------------------------------------------

class SpanPushBuffer:
    """Bounded tracer sink collecting request-scoped spans (any span
    whose attrs carry a ``trace_id`` or ``trace_ids``) for the
    federation push channel.

    Registered via :meth:`install` as a ``Tracer`` sink, so it sees
    exactly the spans that survived the tracer's own sampling —
    ``DL4J_TPU_TRACE_SAMPLE`` throttles the push wire for free, and
    ``DL4J_TPU_TRACE=0`` silences it entirely (a disabled tracer records
    nothing, so nothing reaches any sink). The buffer is a drain-on-push
    ring: :meth:`payload` empties it into one schema-versioned batch
    (the ``spans`` key of :func:`export_snapshot`); overflow between
    pushes drops the OLDEST spans and counts them, so a stalled pusher
    degrades to losing history, never memory."""

    def __init__(self, tracer=None, capacity: int = 2048):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._spans: list = []
        self.dropped = 0
        self._tracer = None
        if tracer is not None:
            self.install(tracer)

    # ----------------------------------------------------------------- sink
    def _sink(self, span) -> None:
        attrs = span.attrs
        if not attrs or ("trace_id" not in attrs
                         and "trace_ids" not in attrs):
            return
        with self._lock:
            if len(self._spans) >= self.capacity:
                del self._spans[0]
                self.dropped += 1
            self._spans.append(span)

    def install(self, tracer=None) -> "SpanPushBuffer":
        from deeplearning4j_tpu_torch.observability.trace import get_tracer
        t = tracer if tracer is not None else get_tracer()
        if self._tracer is not None and self._tracer is not t:
            self._tracer.remove_sink(self._sink)
        self._tracer = t
        t.add_sink(self._sink)
        return self

    def remove(self) -> None:
        t, self._tracer = self._tracer, None
        if t is not None:
            t.remove_sink(self._sink)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # ---------------------------------------------------------------- export
    def drain(self) -> list:
        with self._lock:
            out, self._spans = self._spans, []
        return out

    def payload(self) -> Optional[dict]:
        """Drain into one push batch, or None when there is nothing to
        say (the snapshot then carries no ``spans`` key at all).
        ``epoch_unix`` anchors the batch's monotonic ``ts_us`` stamps to
        wall-clock so the TraceStore can lay spans from N processes on
        one timeline."""
        spans = self.drain()
        if not spans:
            return None
        tracer = self._tracer
        if tracer is not None:
            epoch = tracer.epoch_unix()
        else:
            epoch = time.time() - time.perf_counter()
        return {
            "schema": TRACE_PUSH_SCHEMA_VERSION,
            "epoch_unix": epoch,
            "count": len(spans),
            "dropped_total": self.dropped,
            "spans": [s.to_dict() for s in spans],
        }


class TraceStore:
    """Router/UIServer-side index of pushed spans by trace id, plus the
    stitcher that renders ``GET /api/trace/<id>`` waterfalls.

    Ingest side: :meth:`ingest_snapshot` pulls the ``spans`` batch out
    of a pushed metrics snapshot (the ``/api/metrics_push`` hook) and
    files every span under each trace id its attrs carry, stamped with
    the pushing instance and rebased to approximate unix time via the
    batch's ``epoch_unix`` anchor. The aggregator's OWN network spans
    (the router's per-hop send/recv timestamps) enter directly through
    :meth:`observe_network` — they are already on the local clock.

    Bounds: at most ``max_traces`` trace ids (LRU by last update) and
    ``max_spans_per_trace`` spans each (oldest dropped, counted) — a
    busy fleet ages out history, never grows without bound.

    Stitching (:meth:`waterfall`): per-process clocks only agree to
    within NTP skew, so spans from each instance are rebased against
    the router's send/recv anchors — for every proxied hop matched to
    its server-side handler span (same ``host``/``server_url``, paired
    in time order) the instance's clock offset is chosen so the handler
    span sits centered inside the hop's [send, recv] window (the
    classic RPC skew correction; the residual uncertainty is the
    asymmetry of the two network legs). What the hop window does not
    explain becomes explicit ``network`` segments — the queue_wait /
    batch_assembly / device_compute / network waterfall the dashboard
    renders."""

    #: server-side spans that cover one whole proxied request — the
    #: skew-correction partners of the router's network hops
    HANDLER_SPANS = frozenset({"predict_handler", "decode_op"})
    NETWORK_SPAN = "router_proxy"

    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 512):
        self.max_traces = max(1, int(max_traces))
        self.max_spans_per_trace = max(1, int(max_spans_per_trace))
        self._lock = threading.Lock()
        self._traces: Dict[str, dict] = {}   # insertion order = LRU
        self.ingested_spans = 0
        self.dropped_spans = 0
        self.evicted_traces = 0

    # ---------------------------------------------------------------- ingest
    def ingest_snapshot(self, snapshot: dict) -> int:
        """File the ``spans`` batch of one pushed snapshot (if any);
        returns the number of span records filed."""
        if not isinstance(snapshot, dict):
            return 0
        payload = snapshot.get("spans")
        if not isinstance(payload, dict):
            return 0
        ident = snapshot.get("identity") or {}
        tag = ident.get("tag") or ident.get("instance") or "unknown"
        return self.ingest_payload(str(tag), payload)

    def ingest_payload(self, instance: str, payload: dict) -> int:
        if payload.get("schema") != TRACE_PUSH_SCHEMA_VERSION:
            return 0   # unknown schema: drop whole batch, never guess
        try:
            epoch = float(payload.get("epoch_unix"))
        except (TypeError, ValueError):
            return 0
        n = 0
        for sd in payload.get("spans", ()):
            attrs = sd.get("attrs") or {}
            ids = []
            tid = attrs.get("trace_id")
            if tid:
                ids.append(str(tid))
            for t in attrs.get("trace_ids") or ():
                ids.append(str(t))
            if not ids:
                continue
            try:
                start = epoch + float(sd.get("ts_us", 0.0)) / 1e6
                dur_ms = float(sd.get("dur_us", 0.0)) / 1e3
            except (TypeError, ValueError):
                continue
            ent = {"name": sd.get("name") or "", "instance": instance,
                   "start_unix": start, "dur_ms": dur_ms,
                   "thread": sd.get("thread") or "", "attrs": attrs}
            for t in dict.fromkeys(ids):
                self._add(t, ent)
                n += 1
        return n

    def observe_network(self, trace_id: str, *, host: str, path: str,
                        send_unix: float, recv_unix: float,
                        status: Optional[int] = None,
                        instance: str = "router") -> None:
        """Record one proxied hop's send/recv anchor (the aggregator's
        own clock) — the timestamps every other instance's spans are
        rebased against."""
        self._add(str(trace_id), {
            "name": self.NETWORK_SPAN, "instance": instance,
            "start_unix": float(send_unix),
            "dur_ms": max(0.0, (float(recv_unix) - float(send_unix))
                          * 1e3),
            "thread": "",
            "attrs": {"trace_id": str(trace_id), "host": host,
                      "path": path, "send_unix": float(send_unix),
                      "recv_unix": float(recv_unix),
                      **({"status": int(status)}
                         if status is not None else {})},
        })

    def _add(self, trace_id: str, ent: dict) -> None:
        with self._lock:
            rec = self._traces.pop(trace_id, None)
            if rec is None:
                rec = {"spans": [], "dropped": 0}
            self._traces[trace_id] = rec      # re-insert: LRU freshest
            if len(rec["spans"]) >= self.max_spans_per_trace:
                del rec["spans"][0]
                rec["dropped"] += 1
                self.dropped_spans += 1
            rec["spans"].append(ent)
            self.ingested_spans += 1
            while len(self._traces) > self.max_traces:
                oldest = next(iter(self._traces))
                self._traces.pop(oldest)
                self.evicted_traces += 1

    # ----------------------------------------------------------------- views
    def trace_ids(self) -> List[str]:
        """Known trace ids, least recently updated first."""
        with self._lock:
            return list(self._traces)

    def get(self, trace_id: str) -> List[dict]:
        with self._lock:
            rec = self._traces.get(str(trace_id))
            spans = list(rec["spans"]) if rec else []
        return sorted(spans, key=lambda e: e["start_unix"])

    def describe(self) -> dict:
        with self._lock:
            return {"traces": len(self._traces),
                    "ingested_spans": self.ingested_spans,
                    "dropped_spans": self.dropped_spans,
                    "evicted_traces": self.evicted_traces,
                    "max_traces": self.max_traces,
                    "max_spans_per_trace": self.max_spans_per_trace}

    # ------------------------------------------------------------- stitching
    def waterfall(self, trace_id: str) -> dict:
        """The stitched per-request view: every span of the trace,
        clock-skew-rebased onto the aggregator's timeline, plus derived
        ``network`` gap segments per proxied hop and a per-phase summary
        (the ``/api/trace/<id>`` payload)."""
        spans = self.get(trace_id)
        if not spans:
            return {"trace_id": str(trace_id), "found": False,
                    "segments": []}
        hops = [s for s in spans if s["name"] == self.NETWORK_SPAN]
        offsets = self._clock_offsets(spans, hops)

        segments = []
        for s in spans:
            off = offsets.get(s["instance"], 0.0)
            segments.append({
                "name": s["name"], "instance": s["instance"],
                "start_unix": s["start_unix"] + off,
                "dur_ms": s["dur_ms"], "thread": s["thread"],
                "attrs": s["attrs"],
            })
        # derived network gaps: hop window minus its handler span
        for hop, handler in self._match_hops(spans, hops):
            send = hop["start_unix"]
            recv = send + hop["dur_ms"] / 1e3
            if handler is None:
                continue
            off = offsets.get(handler["instance"], 0.0)
            h0 = handler["start_unix"] + off
            h1 = h0 + handler["dur_ms"] / 1e3
            out_ms = max(0.0, (h0 - send) * 1e3)
            back_ms = max(0.0, (recv - h1) * 1e3)
            host = hop["attrs"].get("host", "")
            if out_ms > 0.0:
                segments.append({"name": "network", "instance": "wire",
                                 "start_unix": send, "dur_ms": out_ms,
                                 "thread": "",
                                 "attrs": {"direction": "request",
                                           "host": host}})
            if back_ms > 0.0:
                segments.append({"name": "network", "instance": "wire",
                                 "start_unix": h1, "dur_ms": back_ms,
                                 "thread": "",
                                 "attrs": {"direction": "response",
                                           "host": host}})
        segments.sort(key=lambda e: e["start_unix"])
        t0 = segments[0]["start_unix"]
        t1 = max(e["start_unix"] + e["dur_ms"] / 1e3 for e in segments)
        for e in segments:
            e["start_ms"] = round((e.pop("start_unix") - t0) * 1e3, 3)
            e["dur_ms"] = round(e["dur_ms"], 3)
        summary: Dict[str, float] = {}
        for e in segments:
            summary[e["name"]] = summary.get(e["name"], 0.0) + e["dur_ms"]
        return {
            "trace_id": str(trace_id),
            "found": True,
            "t0_unix": t0,
            "total_ms": round((t1 - t0) * 1e3, 3),
            "instances": sorted({e["instance"] for e in segments}),
            "clock_offsets_ms": {k: round(v * 1e3, 3)
                                 for k, v in offsets.items() if v},
            "summary_ms": {k: round(v, 3)
                           for k, v in sorted(summary.items())},
            "segments": segments,
        }

    def _match_hops(self, spans, hops):
        """Pair each network hop with the server-side handler span it
        carried: same target (hop ``host`` == handler ``server_url``),
        paired in time order — the k-th hop to a host matches the k-th
        handler span that host reported for this trace."""
        handlers: Dict[str, list] = {}
        for s in spans:
            if s["name"] in self.HANDLER_SPANS:
                url = str(s["attrs"].get("server_url", ""))
                handlers.setdefault(url.rstrip("/"), []).append(s)
        for url in handlers:
            handlers[url].sort(key=lambda e: e["start_unix"])
        cursor: Dict[str, int] = {}
        pairs = []
        for hop in sorted(hops, key=lambda e: e["start_unix"]):
            url = str(hop["attrs"].get("host", "")).rstrip("/")
            cand = handlers.get(url, [])
            i = cursor.get(url, 0)
            pairs.append((hop, cand[i] if i < len(cand) else None))
            cursor[url] = i + 1
        return pairs

    def _clock_offsets(self, spans, hops) -> Dict[str, float]:
        """Per-instance clock correction (seconds to ADD to that
        instance's timestamps): center each matched handler span inside
        its hop's [send, recv] window and take the median correction
        per instance. Instances with no matched hop keep offset 0 (they
        already share the aggregator's clock, or there is nothing to
        rebase against)."""
        by_instance: Dict[str, list] = {}
        for hop, handler in self._match_hops(spans, hops):
            if handler is None:
                continue
            hop_center = hop["start_unix"] + hop["dur_ms"] / 2e3
            h_center = handler["start_unix"] + handler["dur_ms"] / 2e3
            by_instance.setdefault(handler["instance"], []).append(
                hop_center - h_center)
        out = {}
        for inst, offs in by_instance.items():
            offs.sort()
            out[inst] = offs[len(offs) // 2]
        return out


def _family_value(snapshot: dict, name: str, agg=None) -> Optional[float]:
    """Pull one family's scalar out of a wire snapshot (sum of its plain
    samples by default — per-label children of a counter/gauge)."""
    for fdict in snapshot.get("families", ()):
        if fdict.get("name") != name:
            continue
        vals = []
        for s in fdict.get("samples", ()):
            if s.get("suffix"):
                continue
            try:
                vals.append(float(s.get("value")))
            except (TypeError, ValueError):
                continue
        if not vals:
            return None
        return float((agg or sum)(vals)) if len(vals) > 1 else vals[0]
    return None
