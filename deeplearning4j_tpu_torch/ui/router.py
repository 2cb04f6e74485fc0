"""Remote stats routing: N training processes -> one dashboard
(counterpart of deeplearning4j_tpu/ui/router.py; host only).

Parity: the reference decouples stats producers from the UI via
StatsStorageRouter (deeplearning4j-core api/storage/StatsStorageRouter
.java) and ships a remote poster
(deeplearning4j-ui-remote-iterationlisteners/.../RemoteFlowIterationListener
.java:42) so workers on other machines feed one Play server's remote
module. Here the router POSTs JSON reports to ui/server.py's
``/api/post`` endpoint; it quacks like a StatsStorage, so it plugs
straight into ``StatsListener(storage=RemoteStatsStorageRouter(url))`` —
exactly how a DP-2 (multi-process, parallel/distributed.py) run gives
every worker's curves to the process-0 dashboard.

Delivery is best-effort with a bounded retry queue (the reference's
remote listener is also fire-and-forget over HTTP): a dashboard restart
drops nothing up to ``max_pending`` reports, and a dead dashboard never
blocks the training loop.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Optional


class RemoteStatsStorageRouter:
    """POSTs StatsReports to a UIServer's /api/post endpoint."""

    def __init__(self, url: str, timeout: float = 2.0,
                 max_pending: int = 1000, retry_interval: float = 10.0):
        # accept ".../" or base host:port
        self.url = url.rstrip("/") + "/api/post"
        self.timeout = timeout
        self.retry_interval = retry_interval
        self._pending: deque = deque(maxlen=max_pending)
        self._last_failure: Optional[float] = None
        self._flush_lock = threading.Lock()
        self._retry_scheduled = False
        self.dropped = 0
        self.posted = 0

    # ------------------------------------------------- StatsStorage duck
    def put_update(self, report) -> None:
        self._enqueue({"type": "update", "report": report.to_dict()})

    def put_static_info(self, session_id: str, worker_id: str,
                        info: dict) -> None:
        self._enqueue({"type": "static_info", "session_id": session_id,
                       "worker_id": worker_id, "info": info})

    # ---------------------------------------------------------- delivery
    def _enqueue(self, payload: dict) -> None:
        if len(self._pending) == self._pending.maxlen:
            self.dropped += 1
        self._pending.append(payload)
        # a black-holed dashboard must not stall every training
        # iteration for the connect timeout: after a failure, buffer
        # silently and only re-probe every retry_interval seconds
        # (``flush()`` ignores the backoff for an explicit final drain)
        if (self._last_failure is None
                or time.monotonic() - self._last_failure
                >= self.retry_interval):
            # never let the training thread block behind a background
            # retry that is mid-timeout on a dead host: if the lock is
            # held, that retry (or its successor) will drain the queue
            self._flush(blocking=False)

    def flush(self) -> int:
        """Attempt delivery of everything pending; returns #delivered.
        Stops at the first failure (order-preserving). A failure with
        items still queued schedules a background retry so the queue's
        TAIL is never stranded when training stops emitting (the daemon
        timer dies with the process; an explicit final flush() remains
        the reliable end-of-run drain)."""
        return self._flush(blocking=True)

    def _flush(self, blocking: bool) -> int:
        if not self._flush_lock.acquire(blocking=blocking):
            return 0
        try:
            delivered = 0
            while self._pending:
                payload = self._pending[0]
                if not self._post(payload):
                    self._last_failure = time.monotonic()
                    self._schedule_retry()
                    break
                self._last_failure = None
                self._pending.popleft()
                delivered += 1
                self.posted += 1
            return delivered
        finally:
            self._flush_lock.release()

    def _schedule_retry(self) -> None:
        # called under _flush_lock; a plain flag (NOT Timer.is_alive —
        # the currently-EXECUTING timer's thread is alive, which would
        # suppress re-arming from within its own failed retry)
        if self._retry_scheduled:
            return
        self._retry_scheduled = True

        def fire():
            with self._flush_lock:
                self._retry_scheduled = False
            self._flush(blocking=True)

        t = threading.Timer(self.retry_interval, fire)
        t.daemon = True
        t.start()

    def _post(self, payload: dict) -> bool:
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return 200 <= r.status < 300
        except (urllib.error.URLError, OSError):
            return False

    @property
    def pending(self) -> int:
        return len(self._pending)
