"""Continuous micro-batching dispatcher (counterpart of
deeplearning4j_tpu/serving/batcher.py).

HTTP handler threads only enqueue: each request becomes a ticket
``(features, rows, future)`` in a bounded queue, and one device thread
drains what is pending, concatenates compatible tickets into one padded
power-of-two bucket forward, and scatters the result rows back to each
ticket's future.

- Compatibility: tickets coalesce only when their per-row shapes match,
  input by input (so a decode engine's prefill, step, extend and verify
  tickets never share a bucket: serving/decode.py).
- Linger: with a shallow queue the device thread waits up to
  ``batch_window_ms`` for more tickets; a full bucket launches at once.
- Priority: a ticket's ``priority`` is its strict-priority tier (0 first,
  FIFO within a tier); the device thread seeds each bucket from the
  oldest ticket of the highest tier present.
- Backpressure: ``submit`` raises ``QueueFullError`` once ``max_queue``
  tickets are pending (the server answers 503 + ``Retry-After``).
- Drain: ``stop()`` runs every pending ticket before the thread exits.
- ``min_batch`` (2 by default) is the smallest bucket, so every forward
  takes the same batched code path.
- Tracing: one ``queue_wait`` span per device forward (from the oldest
  ticket's submit), ``batch_assembly`` and ``device_compute`` spans, each
  carrying the batch's client trace ids; each forward's padding rows go
  to the goodput ledger as ``serving_bucket`` padding.

A forward returns one array or a list of arrays, each with ``bucket``
rows; each ticket's future gets its rows of each.

The scheduler (scheduling/core.py) sets ``priority``: the fleet maps an
admitted class to its tier (interactive 0, batch 1, best_effort 2).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from deeplearning4j_tpu_torch.analysis.guards import guarded_by
from deeplearning4j_tpu_torch.observability import goodput as _goodput
from deeplearning4j_tpu_torch.observability.trace import \
    get_tracer as _get_tracer

# the idle device thread re-checks its queue at least this often, so no
# wait of it is unbounded (a submit or stop wakes it at once)
_IDLE_RECHECK_S = 1.0


class QueueFullError(RuntimeError):
    """Admission control: the pending-ticket queue is at ``max_queue``."""


class BatcherDeadError(RuntimeError):
    """The device thread died on an error that was not a request's."""


def bucket_ladder(min_batch: int, max_batch: int) -> list[int]:
    """min_batch, 2*min_batch, ... capped at max_batch."""
    ladder = []
    b = max(1, int(min_batch))
    while True:
        ladder.append(min(b, int(max_batch)))
        if b >= max_batch:
            break
        b *= 2
    return ladder


def next_bucket(n: int, max_batch: int, min_batch: int = 1) -> int:
    """The power-of-two bucket for ``n`` rows, at least ``min_batch``,
    capped at ``max_batch`` (larger requests are chunked by the caller)."""
    b = max(1, int(min_batch))
    while b < n:
        b *= 2
    return min(b, max_batch)


class _Ticket:
    __slots__ = ("feats", "rows", "key", "future", "t_submit", "trace_id",
                 "priority")

    def __init__(self, feats, rows, key, trace_id=None, priority=0):
        self.feats = feats
        self.rows = rows
        self.key = key
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.trace_id = trace_id
        self.priority = priority


def _trace_ids(batch) -> list:
    """The distinct client trace ids riding a batch, in order."""
    out = []
    for t in batch:
        if t.trace_id and t.trace_id not in out:
            out.append(t.trace_id)
    return out


@guarded_by("_cond", "_pending", "_stopping", "_crashed", "_thread")
class MicroBatcher:
    """Bounded ticket queue + one device thread.

    ``forward(feats)`` receives the padded bucket-shaped input list and
    returns the model output (a numpy array, or a list of them) with
    ``bucket`` rows. It runs only on the device thread (and in
    ``warm()``)."""

    def __init__(self, forward, *, max_batch: int = 1024,
                 batch_window_ms: float = 2.0, max_queue: int = 1024,
                 min_batch: int = 2, stats=None, shapes_seen=None):
        self._forward = forward
        self.max_batch = int(max_batch)
        self.min_batch = min(int(min_batch), self.max_batch)
        self.batch_window_ms = float(batch_window_ms)
        self.max_queue = int(max_queue)
        self.stats = stats
        # shared by the replicas of one fleet (serving/fleet.py)
        self.shapes_seen: set[int] = (shapes_seen if shapes_seen is not None
                                      else set())
        self._pending: deque[_Ticket] = deque()
        self._cond = threading.Condition()
        self._thread = None
        self._stopping = False
        self._crashed = False
        if stats is not None:
            stats.queue_depth_fn = lambda: len(self._pending)

    @property
    def depth(self) -> int:
        return len(self._pending)

    @property
    def healthy(self) -> bool:
        if self._crashed:
            return False
        t = self._thread
        return not (t is not None and not t.is_alive() and not self._stopping)

    def warm(self, row_shapes, skip=None) -> list[int]:
        """Run the bucket ladder once on zero inputs of the given per-input
        row shapes, so the first requests pay no build or first-launch
        cost. Buckets in ``skip`` (default ``shapes_seen``) are left out.
        Returns the buckets run."""
        skip = self.shapes_seen if skip is None else skip
        ran = []
        for bucket in bucket_ladder(self.min_batch, self.max_batch):
            if bucket in skip:
                continue
            feats = [np.zeros((bucket,) + tuple(s), np.float32)
                     for s in row_shapes]
            self._forward(feats)
            self.shapes_seen.add(bucket)
            ran.append(bucket)
        return ran

    # ------------------------------------------------------------- lifecycle
    def start(self):
        if self._thread is not None:
            return self
        with self._cond:
            if self._thread is None:
                self._stopping = False
                t = threading.Thread(target=self._loop, daemon=True,
                                     name="microbatcher-device")
                t.start()
                self._thread = t
        return self

    def stop(self, timeout: float = 60.0):
        """Graceful drain: every accepted ticket runs before the device
        thread exits; later submits are refused."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            with self._cond:
                self._thread = None

    # --------------------------------------------------------------- enqueue
    def submit(self, feats: list, trace_id: str = None,
               priority: int = 0) -> Future:
        """Enqueue one request (one array per model input, equal leading
        row counts <= max_batch); the Future resolves to its rows of the
        output. ``trace_id`` rides the ticket onto the batcher's spans;
        ``priority`` is its tier (lower first)."""
        rows = int(feats[0].shape[0])
        if rows > self.max_batch:
            raise ValueError(f"ticket of {rows} rows > max_batch "
                             f"{self.max_batch} — chunk before submit")
        key = tuple(tuple(f.shape[1:]) for f in feats)
        t = _Ticket(feats, rows, key, trace_id, priority=int(priority))
        with self._cond:
            if not self.healthy:
                raise BatcherDeadError("device thread is dead")
            if self._stopping:
                raise RuntimeError("batcher is stopped")
            if len(self._pending) >= self.max_queue:
                if self.stats is not None:
                    self.stats.record_rejected()
                raise QueueFullError(
                    f"{len(self._pending)} tickets pending "
                    f"(max_queue={self.max_queue})")
            self._pending.append(t)
            self._cond.notify_all()
        return t.future

    # ----------------------------------------------------------- device side
    def _seed_locked(self) -> _Ticket:
        """The oldest ticket of the highest tier present. Lock held."""
        best = None
        for t in self._pending:
            if best is None or t.priority < best.priority:
                best = t
                if best.priority <= 0:
                    break
        if best is self._pending[0]:
            return self._pending.popleft()
        self._pending.remove(best)
        return best

    def _gather_locked(self):
        """Pop the seed ticket and every compatible one that fits the
        bucket, lingering up to batch_window_ms for more. Lock held."""
        batch = [self._seed_locked()]
        rows = batch[0].rows
        key = batch[0].key

        def sweep():
            nonlocal rows
            kept = deque()
            while self._pending:
                t = self._pending.popleft()
                if t.key == key and rows + t.rows <= self.max_batch:
                    batch.append(t)
                    rows += t.rows
                else:
                    kept.append(t)
            self._pending.extendleft(reversed(kept))

        sweep()
        if self.batch_window_ms > 0:
            deadline = time.monotonic() + self.batch_window_ms / 1000.0
            while rows < self.max_batch and not self._stopping:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
                sweep()
        return batch, rows

    def _loop(self):
        batch = None
        try:
            while True:
                with self._cond:
                    while not self._pending and not self._stopping:
                        self._cond.wait(_IDLE_RECHECK_S)
                    if not self._pending:
                        return  # stopping and fully drained
                    batch, rows = self._gather_locked()
                attrs = {"tickets": len(batch)}
                tids = _trace_ids(batch)
                if tids:
                    attrs["trace_ids"] = tids
                _get_tracer().record("queue_wait", batch[0].t_submit,
                                     time.perf_counter(), attrs)
                self._execute(batch, rows)
                batch = None
        except BaseException as e:  # noqa: BLE001 — the device thread dies
            # _execute absorbs each request's Exception; what reaches here
            # kills the thread, so fail every waiting ticket now
            self._die(batch, e)
            raise

    def _die(self, batch, exc):
        with self._cond:
            self._crashed = True
            stranded = list(self._pending)
            self._pending.clear()
        err = BatcherDeadError(
            f"device thread died: {type(exc).__name__}: {exc}")
        for t in list(batch or ()) + stranded:
            if not t.future.done():
                if self.stats is not None:
                    self.stats.record_error()
                t.future.set_exception(err)

    def _execute(self, batch, rows):
        n_inputs = len(batch[0].feats)
        tracer = _get_tracer()
        tids = _trace_ids(batch)
        tid_attrs = {"trace_ids": tids} if tids else {}
        try:
            with tracer.span("batch_assembly", tickets=len(batch),
                             **tid_attrs):
                feats = [np.concatenate([t.feats[i] for t in batch])
                         if len(batch) > 1 else batch[0].feats[i]
                         for i in range(n_inputs)]
                bucket = next_bucket(rows, self.max_batch, self.min_batch)
                if bucket != rows:
                    feats = [np.pad(f, [(0, bucket - rows)] + [(0, 0)]
                                    * (f.ndim - 1)) for f in feats]
                self.shapes_seen.add(bucket)
            t_fwd = time.perf_counter()
            with tracer.span("device_compute", bucket=bucket, rows=rows,
                             **tid_attrs):
                out = self._forward(feats)
            device_s = time.perf_counter() - t_fwd
        except Exception as e:
            # each ticket's caller sees the error (the HTTP handler counts it)
            for t in batch:
                t.future.set_exception(e)
            return
        if self.stats is not None:
            self.stats.record_batch(bucket, rows, len(batch),
                                    device_s=device_s)
        _goodput.record_padding("serving_bucket", rows, bucket - rows)
        many = isinstance(out, (list, tuple))
        outs = [np.asarray(o) for o in out] if many else [np.asarray(out)]
        off = 0
        for t in batch:
            sliced = [o[off:off + t.rows] for o in outs]
            off += t.rows
            t.future.set_result(sliced if many else sliced[0])
