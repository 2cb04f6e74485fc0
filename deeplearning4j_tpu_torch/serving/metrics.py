"""Serving counters, latency percentiles and the executed-batch-size
histogram behind ``GET /metrics`` (counterpart of the JSON snapshot of
deeplearning4j_tpu/serving/metrics.py; the Prometheus registry bridge is
not ported).

Every event is O(1) under one lock: latencies go into a ring of the last
``window`` requests, batch sizes into a dict keyed by executed bucket.
"""

from __future__ import annotations

import threading
import time
from collections import deque

#: how far back the drain-rate estimate behind Retry-After looks
DRAIN_HORIZON_S = 30.0


class ServingStats:
    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._window = int(window)
        self._lat = [0.0] * self._window   # seconds, ring buffer
        self._lat_n = 0
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.batch_rows = 0
        self.batch_requests = 0
        self.rejected = 0
        self.errors = 0
        self.timeouts = 0
        self.batch_hist: dict[int, int] = {}
        self.bucket_device_s: dict[int, float] = {}
        self.padded_rows = 0
        self.queue_depth_fn = lambda: 0     # wired by the batcher
        self._clock = time.monotonic
        self._drain: deque = deque(maxlen=256)

    # ------------------------------------------------------------- recording
    def record_request(self, rows: int, latency_s: float):
        with self._lock:
            self.requests += 1
            self.rows += int(rows)
            self._lat[self._lat_n % self._window] = float(latency_s)
            self._lat_n += 1

    def record_batch(self, bucket: int, rows: int, n_tickets: int,
                     device_s: float | None = None):
        with self._lock:
            self.batches += 1
            self.batch_rows += int(rows)
            self.batch_requests += int(n_tickets)
            self.padded_rows += max(0, int(bucket) - int(rows))
            self.batch_hist[int(bucket)] = self.batch_hist.get(
                int(bucket), 0) + 1
            if device_s is not None:
                self.bucket_device_s[int(bucket)] = (
                    self.bucket_device_s.get(int(bucket), 0.0)
                    + float(device_s))
            self._drain.append((self._clock(), int(rows), int(n_tickets)))

    def record_rejected(self):
        with self._lock:
            self.rejected += 1

    def record_error(self):
        with self._lock:
            self.errors += 1

    def record_timeout(self):
        with self._lock:
            self.timeouts += 1

    # ------------------------------------------------------------ drain rate
    def _rates_locked(self):
        """(rows/s, tickets/s) over the recent horizon. Lock held."""
        now = self._clock()
        pts = [p for p in self._drain if now - p[0] <= DRAIN_HORIZON_S]
        if not pts:
            return 0.0, 0.0
        span = now - pts[0][0]
        if span <= 0:
            return 0.0, 0.0
        return (sum(p[1] for p in pts) / span,
                sum(p[2] for p in pts) / span)

    def retry_after_s(self, queue_tickets=None, lo: float = 0.05,
                      hi: float = 5.0) -> float:
        """Backlog over the observed ticket drain rate, clamped to
        [lo, hi]; ``hi`` when nothing has drained yet."""
        if queue_tickets is None:
            queue_tickets = self.queue_depth_fn()
        if queue_tickets <= 0:
            return lo
        with self._lock:
            ticket_rate = self._rates_locked()[1]
        if ticket_rate <= 0:
            return hi
        return round(min(hi, max(lo, queue_tickets / ticket_rate)), 3)

    # ------------------------------------------------------------- reporting
    @staticmethod
    def _percentiles(lats, qs):
        if not lats:
            return {f"p{int(q * 100)}": None for q in qs}
        s = sorted(lats)
        out = {}
        for q in qs:
            i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
            out[f"p{int(q * 100)}"] = round(s[i] * 1000.0, 3)
        return out

    def snapshot(self, shapes_seen=()) -> dict:
        """The ``/metrics`` payload."""
        depth = int(self.queue_depth_fn())
        with self._lock:
            n = min(self._lat_n, self._window)
            batches = self.batches
            out = {
                "requests_total": self.requests,
                "rows_total": self.rows,
                "batches_total": batches,
                "rejected_total": self.rejected,
                "errors_total": self.errors,
                "timeouts_total": self.timeouts,
                "queue_depth": depth,
                "latency_ms": self._percentiles(self._lat[:n],
                                                (0.50, 0.95, 0.99)),
                "latency_window": n,
                "batch_size_hist": {str(k): v for k, v in
                                    sorted(self.batch_hist.items())},
                "device_ms_by_bucket": {
                    str(k): round(1000.0 * s / self.batch_hist[k], 3)
                    for k, s in sorted(self.bucket_device_s.items())
                    if self.batch_hist.get(k)},
                "coalesce_rows_per_batch": (
                    round(self.batch_rows / batches, 3) if batches else None),
                "coalesce_requests_per_batch": (
                    round(self.batch_requests / batches, 3) if batches
                    else None),
                "padded_rows_total": self.padded_rows,
                "shapes_seen": sorted(int(s) for s in shapes_seen),
                "drain_rate_rows_per_s": round(self._rates_locked()[0], 3),
            }
        out["retry_after_s"] = self.retry_after_s(depth)
        return out
