"""Parallel worker prefetch with checkpoint-consistent state
(counterpart of deeplearning4j_tpu/datapipe/prefetch.py).

A background thread pulls batches from upstream ahead of the consumer
(bounded by ``depth``), overlapping host-side collation/IO with the
device step — this layers UNDER the fit loops' own
``AsyncDataSetIterator`` / ``DevicePrefetchIterator`` wrappers, which
see the pipeline as just another iterator.

The checkpoint subtlety: batches sitting in the prefetch buffer have
already advanced the upstream cursor but have not reached the trainer.
``_state()`` therefore captures (upstream state, buffered batches) as
one consistent pair: the worker's ``next(upstream)`` happens OUTSIDE the
lock (so the consumer never blocks behind a slow pull), guarded by a
``_pulling`` flag set before and cleared — together with the buffer
append — under the lock; ``state_dict()`` waits for any in-flight pull
to land before snapshotting. On restore, buffered batches are emitted
first, then the stream continues from the restored upstream cursor — no
record replayed, none dropped.
"""

from __future__ import annotations

import threading
import time
from typing import List

from deeplearning4j_tpu_torch.analysis.guards import guarded_by
from deeplearning4j_tpu_torch.datapipe.core import (Stage, decode_state_value,
                                              encode_state_value)
from deeplearning4j_tpu_torch.observability.trace import get_tracer

__all__ = ["PrefetchStage"]

_END = object()


# _cond wraps _lock (one underlying lock): either with-block satisfies
# the guard, but registration uses the name the writers take
@guarded_by("_cond", "_buf", "_pulling", "_done", "_stop", "_error",
            "_thread")
class PrefetchStage(Stage):
    name = "prefetch"

    def __init__(self, upstream: Stage, depth: int = 2):
        super().__init__(upstream)
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.depth = int(depth)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._buf: List[object] = []     # pulled, not yet consumed
        self._pulling = False
        self._done = False               # upstream exhausted this epoch
        self._stop = False
        self._error = None
        self._thread = None

    # ------------------------------------------------------------ worker
    def _worker(self):
        tracer = get_tracer()
        it = iter(self.upstream)
        while True:
            with self._cond:
                while len(self._buf) >= self.depth and not self._stop:
                    self._cond.wait(0.1)
                if self._stop:
                    return
                self._pulling = True
            item = _END
            err = None
            t0 = time.perf_counter()
            try:
                with tracer.span("pipe_prefetch_pull"):
                    item = next(it, _END)
            except BaseException as e:   # surface in the consumer
                err = e
            self._clock(t0)
            with self._cond:
                self._pulling = False
                if err is not None:
                    self._error = err
                    self._done = True
                elif item is _END:
                    self._done = True
                else:
                    self._buf.append(item)
                self._cond.notify_all()
                if self._done or self._stop:
                    return

    def _ensure_worker(self):
        with self._cond:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = False
            self._done = False
            self._error = None
            t = threading.Thread(
                target=self._worker, name="dl4j-pipe-prefetch", daemon=True)
            t.start()
            self._thread = t

    def stop(self):
        """Stop the worker and wait for it (consumer exit / close path)."""
        with self._cond:
            t = self._thread
            self._stop = True
            self._cond.notify_all()
        if t is not None and t.is_alive():
            t.join(timeout=10.0)
        with self._cond:
            self._thread = None

    # --------------------------------------------------------- iteration
    def __iter__(self):
        self._ensure_worker()
        try:
            while True:
                with self._cond:
                    while not self._buf and not self._done:
                        self._cond.wait(0.1)
                    if self._buf:
                        item = self._buf.pop(0)
                        self._cond.notify_all()
                    elif self._error is not None:
                        err, self._error = self._error, None
                        raise err
                    else:
                        break
                self.records_out += 1
                yield item
        finally:
            self.stop()

    def buffered(self) -> int:
        """Batches ready for the consumer (the queue-depth metric)."""
        with self._lock:
            return len(self._buf)

    def on_epoch(self, epoch: int):
        self.stop()
        super().on_epoch(epoch)
        with self._cond:
            self._buf = []
            self._done = False
            self._error = None

    # -------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        # snapshot (upstream, buffer) consistently: park the worker by
        # waiting out any in-flight pull, then read both under the lock
        with self._cond:
            deadline = time.monotonic() + 30.0
            while self._pulling:
                if not self._cond.wait(0.5) and time.monotonic() > deadline:
                    raise RuntimeError("prefetch worker stuck in pull "
                                       "during state_dict()")
            s = {"kind": self.name,
                 "buf": [encode_state_value(b) for b in self._buf],
                 "upstream": self.upstream.state_dict()}
        return s

    def load_state_dict(self, state: dict):
        if state.get("kind") != self.name:
            raise ValueError(
                f"pipeline state mismatch: stage {self.name!r} cannot load "
                f"state saved by {state.get('kind')!r}")
        self.stop()
        with self._cond:
            self._buf = [decode_state_value(b) for b in state["buf"]]
            self._done = False
            self._error = None
        self.upstream.load_state_dict(state["upstream"])
