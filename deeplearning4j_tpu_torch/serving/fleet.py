"""Replica tier: N micro-batcher device workers behind one admission
queue (counterpart of deeplearning4j_tpu/serving/fleet.py).

- **Admission** is global: ``submit`` rejects with ``QueueFullError``
  once the sum of the live replicas' queue depths reaches ``max_queue``
  (a dead replica's stranded tickets are not capacity). With a
  ``scheduler`` (scheduling/core.py) admission runs its discipline
  instead: tenant quotas, class watermarks (batch sheds at 50% of
  ``max_queue``, interactive only at 100%) and deadline sheds against
  the derived wait estimate; the admitted class's tier rides the
  batcher ticket as its priority.
- **Routing** is by observed load: each ticket goes to the live replica
  with the shallowest queue, ties taken round-robin.
- **Eviction**: when a replica's device thread dies, its in-flight and
  queued tickets fail with ``BatcherDeadError`` (batcher.py ``_die``);
  the fleet catches that per ticket and resubmits onto a survivor, so the
  client's future still resolves. A ticket failed by ``_die`` never
  reached ``set_result``, so the requeue cannot deliver twice; the forward
  is pure inference, so a re-run is idempotent. ``BatcherDeadError``
  reaches the caller only when no live replica remains.
- **Draining** takes a replica out of routing while its accepted queue
  finishes; ``restart`` re-admits a slot with a fresh batcher over the
  same forward; ``swap_forward`` replaces a replica's forward with no gap
  in routing (publish the new batcher, then drain the old);
  ``restart_fleet`` rebuilds the tier, possibly narrower (``degraded``).
- **Warm-up is hoisted**: ``warm`` runs the bucket ladder once per
  distinct forward object, not once per replica.
- **Session affinity** (serving/decode.py): a ticket submitted with
  ``session=sid`` sticks to the replica that served the session last.
  It is a routing hint, never a correctness need: a decode ticket carries
  its session's cache, so when the pinned replica dies or drains the pin
  moves to the least-deep survivor (an ``affinity_miss``) and the requeue
  above applies unchanged.

Replicas share the forward, one ``ServingStats`` (its ``queue_depth_fn``
rebound to the fleet total) and one ``shapes_seen`` set. On the card they
share one device and launch on its default stream, each from its own
device thread.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional

from deeplearning4j_tpu_torch.analysis.guards import guarded_by
from deeplearning4j_tpu_torch.serving.batcher import (BatcherDeadError,
                                                      MicroBatcher,
                                                      QueueFullError)

LIVE = "live"
DRAINING = "draining"
DEAD = "dead"


class Replica:
    """One micro-batcher worker slot in the fleet."""

    __slots__ = ("index", "batcher", "status", "evicted_at")

    def __init__(self, index: int, batcher: MicroBatcher):
        self.index = index
        self.batcher = batcher
        self.status = LIVE
        self.evicted_at: Optional[float] = None

    @property
    def depth(self) -> int:
        return self.batcher.depth

    def describe(self) -> dict:
        """The per-replica health row (``/healthz``, ``/metrics``)."""
        return {"replica": self.index, "status": self.status,
                "queue_depth": self.depth}


@guarded_by("_lock", "_rr", "requeued", "_affinity", "affinity_hits",
            "affinity_misses", "replicas")
class ReplicaSet:
    """N replicas of one forward behind global admission and least-depth
    routing. With ``n=1`` this is the single batcher's behaviour."""

    def __init__(self, forward, n: int = 1, *, max_batch: int = 1024,
                 batch_window_ms: float = 2.0, max_queue: int = 1024,
                 min_batch: int = 2, stats=None, forwards=None,
                 scheduler=None):
        if forwards is None:
            forwards = [forward] * int(n)
        self.max_queue = int(max_queue)
        self.stats = stats
        #: optional SchedulingCore: admission classes, tenant quotas and
        #: deadline sheds run in submit()
        self.scheduler = scheduler
        self.shapes_seen: set[int] = set()
        self._batcher_cfg = dict(max_batch=max_batch,
                                 batch_window_ms=batch_window_ms,
                                 max_queue=max_queue, min_batch=min_batch)
        self._lock = threading.Lock()
        self._rr = 0          # round-robin tiebreak cursor
        self.requeued = 0     # tickets resubmitted after an eviction
        self._affinity = {}   # session id -> pinned Replica
        self.affinity_hits = 0
        self.affinity_misses = 0
        #: the width the tier was provisioned at (``degraded`` below it)
        self.target_n = len(forwards)
        self.replicas: List[Replica] = [
            Replica(i, self._make_batcher(fwd))
            for i, fwd in enumerate(forwards)]
        if stats is not None:
            stats.queue_depth_fn = self.total_depth

    def _make_batcher(self, forward) -> MicroBatcher:
        return MicroBatcher(forward, stats=self.stats,
                            shapes_seen=self.shapes_seen,
                            **self._batcher_cfg)

    # ------------------------------------------------------------- lifecycle
    def start(self):
        for r in self.replicas:
            if r.status == LIVE:
                r.batcher.start()
        return self

    def stop(self):
        """Graceful fleet drain: every replica finishes its accepted
        queue before its device thread exits."""
        for r in self.replicas:
            r.batcher.stop()

    def warm(self, row_shapes, skip=None):
        """Run the bucket ladder once per distinct forward object (the
        replicas sharing one forward share its warm state). Buckets in
        ``skip`` (default: those seen before this call) are left out, per
        forward. A caller warming several ladders in turn passes
        ``skip=()`` to each: ``shapes_seen`` holds bucket sizes only, not
        which ladder ran them. Returns the buckets run, sorted."""
        seen0 = set(self.shapes_seen) if skip is None else set(skip)
        warmed = set()
        ran: set[int] = set()
        for r in self.replicas:
            fid = id(r.batcher._forward)
            if fid in warmed:
                continue
            warmed.add(fid)
            ran.update(r.batcher.warm(row_shapes, skip=seen0))
        return sorted(ran)

    # ----------------------------------------------------------------- state
    @property
    def healthy(self) -> bool:
        """At least one replica can take traffic."""
        return any(r.status == LIVE and r.batcher.healthy
                   for r in self.replicas)

    def total_depth(self) -> int:
        return sum(r.depth for r in self.replicas)

    def live_depth(self) -> int:
        """Backlog that can still drain: the queue depths of replicas
        whose device thread is alive. Admission counts this."""
        return sum(r.depth for r in self.replicas
                   if r.status != DEAD and r.batcher.healthy)

    @property
    def degraded(self) -> bool:
        """Serving on fewer replicas than the tier was provisioned with."""
        return len(self.replicas) < self.target_n

    def describe(self) -> list[dict]:
        with self._lock:
            self._sweep_dead_locked()
            degraded = self.degraded
            rows = []
            for r in self.replicas:
                row = r.describe()
                if degraded:
                    row["degraded"] = True
                    row["target_replicas"] = self.target_n
                rows.append(row)
            return rows

    def _sweep_dead_locked(self):
        # a device thread that died between submissions shows up here
        for r in self.replicas:
            if r.status != DEAD and not r.batcher.healthy:
                r.status = DEAD
                r.evicted_at = time.time()

    def _mark_dead(self, replica: Replica):
        with self._lock:
            if replica.status != DEAD:
                replica.status = DEAD
                replica.evicted_at = time.time()

    # --------------------------------------------------------------- control
    def drain(self, index: int):
        """Take a replica out of routing; its accepted tickets still
        run. Re-admit it with ``restart``."""
        with self._lock:
            self.replicas[index].status = DRAINING

    def restart(self, index: int):
        """Re-admit a drained or dead slot with a fresh batcher over the
        same forward. Restarting a live, healthy replica raises: drain it
        first, or use ``swap_forward``."""
        r = self.replicas[index]
        old = r.batcher
        with self._lock:
            if r.status == LIVE and old.healthy:
                raise RuntimeError(
                    f"replica {index} is live and healthy — drain({index}) "
                    "before restart, or swap_forward() for an in-place "
                    "hot swap")
        if old.healthy:
            old.stop()
        fresh = self._make_batcher(old._forward).start()
        with self._lock:
            # batcher and status together: a concurrent _pick never routes
            # to a LIVE replica that still holds the dead batcher
            r.batcher = fresh
            r.status = LIVE
            r.evicted_at = None
        if self.stats is not None:
            self.stats.queue_depth_fn = self.total_depth
        return r

    def swap_forward(self, index: int, forward):
        """Replace one replica's forward with no gap in routing: a fresh
        batcher over ``forward`` is started and published under the lock,
        then the old batcher drains (its queue finishes on the old
        forward) while new admissions run the new one."""
        r = self.replicas[index]
        fresh = self._make_batcher(forward).start()
        with self._lock:
            old = r.batcher
            r.batcher = fresh
            r.status = LIVE
            r.evicted_at = None
        if self.stats is not None:
            self.stats.queue_depth_fn = self.total_depth
        if old.healthy:
            old.stop()
        return r

    def restart_fleet(self, forwards=None, *, n: Optional[int] = None,
                      forward=None):
        """Rebuild the whole tier, possibly narrower than it was
        provisioned: the old batchers drain, the new replicas share the
        forward. ``degraded`` is true while the width is below
        ``target_n``. Pass ``forwards`` (one per replica), or ``n`` (and
        optionally a shared ``forward``; default replica 0's)."""
        if forwards is None:
            if n is None or int(n) < 1:
                raise ValueError("restart_fleet needs forwards or n >= 1")
            fwd = forward if forward is not None \
                else self.replicas[0].batcher._forward
            forwards = [fwd] * int(n)
        if not forwards:
            raise ValueError("restart_fleet needs at least one replica")
        for r in self.replicas:
            if r.batcher.healthy:
                r.batcher.stop()
        with self._lock:
            self.replicas = [Replica(i, self._make_batcher(f))
                             for i, f in enumerate(forwards)]
            self._rr = 0
            self._affinity.clear()   # the old Replica objects are gone
        if self.stats is not None:
            self.stats.queue_depth_fn = self.total_depth
        return self

    # --------------------------------------------------------------- routing
    def _pick(self, session=None) -> Optional[Replica]:
        with self._lock:
            self._sweep_dead_locked()
            live = [r for r in self.replicas if r.status == LIVE]
            if not live:
                return None
            if session is not None:
                pinned = self._affinity.get(session)
                if pinned is not None and pinned.status == LIVE:
                    self.affinity_hits += 1
                    return pinned
                # first sighting, or the pinned replica died or drains
                self.affinity_misses += 1
            depths = [r.depth for r in live]
            lo = min(depths)
            tied = [r for r, d in zip(live, depths) if d == lo]
            pick = tied[self._rr % len(tied)]
            self._rr += 1
            if session is not None:
                self._affinity[session] = pick
            return pick

    def forget_session(self, session):
        """Drop a closed session's routing pin."""
        with self._lock:
            self._affinity.pop(session, None)

    def submit(self, feats: list, trace_id: str = None,
               session=None, klass=None, tenant=None,
               deadline_ms=None) -> Future:
        """Admit one ticket fleet-wide and route it to the shallowest live
        queue, or with ``session=`` to the session's pinned replica while
        it stays live. Admission counts only live replicas' depths. With
        a ``scheduler``, admission runs its discipline (``klass``,
        ``tenant``, ``deadline_ms``; the wait estimate is derived only
        when a deadline is given) and the admitted class's tier rides
        the ticket. Raises ``QueueFullError`` (or its ``ShedError``
        subclass) on reject and ``BatcherDeadError`` only when no live
        replica remains."""
        self.start()
        depth = self.live_depth()
        priority = 0
        if self.scheduler is not None:
            wait = self.stats.retry_after_s(depth) \
                if deadline_ms is not None and self.stats is not None \
                else None
            try:
                k = self.scheduler.admit(
                    tenant=tenant, klass=klass, deadline_ms=deadline_ms,
                    rows=int(feats[0].shape[0]), depth=depth,
                    capacity=self.max_queue, wait_estimate_s=wait)
            except QueueFullError:
                if self.stats is not None:
                    self.stats.record_rejected()
                raise
            priority = self.scheduler.PRIORITY[k]
        elif depth >= self.max_queue:
            if self.stats is not None:
                self.stats.record_rejected()
            raise QueueFullError(
                f"{depth} tickets pending across "
                f"{len(self.replicas)} replicas (max_queue="
                f"{self.max_queue})")
        outer = Future()
        self._dispatch(feats, trace_id, outer, first=True, session=session,
                       priority=priority)
        return outer

    def _dispatch(self, feats, trace_id, outer: Future, first: bool,
                  session=None, priority: int = 0):
        while True:
            r = self._pick(session)
            if r is None:
                err = BatcherDeadError("all replicas dead")
                if first:
                    raise err
                outer.set_exception(err)
                return
            b = r.batcher
            try:
                inner = b.submit(feats, trace_id, priority=priority)
            except BatcherDeadError:
                # lost the race with a dying device thread: evict it and
                # try the next live replica
                self._mark_dead(r)
                continue
            except QueueFullError:
                if first:
                    raise
                outer.set_exception(
                    QueueFullError("no capacity on surviving replicas"))
                return
            except RuntimeError:
                if r.batcher is not b:
                    # lost the race with a swap: the replica is live again
                    # under its fresh batcher, pick again
                    continue
                if first:
                    raise
                outer.set_exception(
                    QueueFullError("no capacity on surviving replicas"))
                return
            inner.add_done_callback(
                lambda f, rep=r: self._on_done(f, rep, feats, trace_id,
                                               outer, session, priority))
            return

    def _on_done(self, inner: Future, replica: Replica, feats, trace_id,
                 outer: Future, session=None, priority: int = 0):
        exc = inner.exception()
        if exc is None:
            outer.set_result(inner.result())  # analysis: ok(C003) — done-callback: future already resolved
        elif isinstance(exc, BatcherDeadError):
            # the replica died with this ticket in flight; _die failed its
            # future before any result, so a resubmit cannot deliver twice
            self._mark_dead(replica)
            with self._lock:
                self.requeued += 1
            self._dispatch(feats, trace_id, outer, first=False,
                           session=session, priority=priority)
        else:
            outer.set_exception(exc)
