"""Serving counters, latency percentiles and the executed-batch-size
histogram behind ``GET /metrics`` (counterpart of
deeplearning4j_tpu/serving/metrics.py).

Every event is O(1) under one lock: latencies go into a ring of the last
``window`` requests, batch sizes into a dict keyed by executed bucket.

The counters stay the one source of truth. The unified metrics registry
(observability/metrics.py) sees them through a collector called at render
time (``attach_to_registry``), so a Prometheus scrape and the JSON
snapshot cannot disagree; ``decode_metric_families`` renders a decode
engine's ``describe()`` the same way. The family names are the JAX
package's.
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
        self.nan_rows = 0                   # replies with non-finite values
        self.batch_hist: dict[int, int] = {}
        self.bucket_device_s: dict[int, float] = {}
        self.padded_rows = 0
        # unix time of the first reply (the cold-start clock's far edge)
        self.first_reply_unix: float | None = None
        self.queue_depth_fn = lambda: 0     # wired by the batcher
        self._clock = time.monotonic
        self._drain: deque = deque(maxlen=256)

    # ------------------------------------------------------------- recording
    def record_request(self, rows: int, latency_s: float):
        with self._lock:
            if self.first_reply_unix is None:
                self.first_reply_unix = time.time()
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

    def record_nan_rows(self, n: int = 1):
        """Rows whose reply carried a non-finite value (the serving NaN
        sentinel)."""
        with self._lock:
            self.nan_rows += int(n)

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

    def drain_rate(self) -> float:
        """Observed throughput, real rows/s over the recent horizon."""
        with self._lock:
            return self._rates_locked()[0]

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
                "nan_rows_total": self.nan_rows,
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
                "padding_waste_fraction": (
                    round(self.padded_rows
                          / (self.batch_rows + self.padded_rows), 4)
                    if self.batch_rows + self.padded_rows else None),
                "compile_count": len(shapes_seen),
                "shapes_seen": sorted(int(s) for s in shapes_seen),
                "drain_rate_rows_per_s": round(self._rates_locked()[0], 3),
            }
        out["retry_after_s"] = self.retry_after_s(depth)
        return out

    # ------------------------------------------- unified-registry bridge
    def metric_families(self, shapes_seen=(), labels=None):
        """The snapshot as MetricFamily rows, with the JAX package's
        family names."""
        from deeplearning4j_tpu_torch.observability.metrics import \
            MetricFamily

        snap = self.snapshot(shapes_seen)
        L = dict(labels or {})
        fams = []

        def fam(name, kind, help, value, extra=None):
            fams.append(MetricFamily(name, kind, help)
                        .add(value, {**L, **(extra or {})}))

        fam("dl4j_serving_requests_total", "counter",
            "Accepted /predict requests", snap["requests_total"])
        fam("dl4j_serving_rows_total", "counter",
            "Real (unpadded) rows served", snap["rows_total"])
        fam("dl4j_serving_batches_total", "counter",
            "Device forwards executed", snap["batches_total"])
        fam("dl4j_serving_rejected_total", "counter",
            "503 admission rejections", snap["rejected_total"])
        fam("dl4j_serving_errors_total", "counter",
            "Request failures", snap["errors_total"])
        fam("dl4j_serving_timeouts_total", "counter",
            "504 per-request deadline expiries", snap["timeouts_total"])
        fam("dl4j_serving_nan_rows_total", "counter",
            "Reply rows carrying non-finite values (the serving NaN "
            "sentinel)", snap["nan_rows_total"])
        fam("dl4j_serving_queue_depth", "gauge",
            "Tickets pending in the micro-batch queue",
            snap["queue_depth"])
        lat = MetricFamily(
            "dl4j_serving_latency_ms", "gauge",
            "Recent-window request latency percentiles (ms)")
        for q, v in snap["latency_ms"].items():
            if v is not None:
                lat.add(v, {**L, "quantile": q})
        if lat.samples:
            fams.append(lat)
        hist = MetricFamily(
            "dl4j_serving_batch_executions_total", "counter",
            "Device forwards by executed bucket size")
        for bucket, count in snap["batch_size_hist"].items():
            hist.add(count, {**L, "bucket": bucket})
        if hist.samples:
            fams.append(hist)
        if snap["coalesce_rows_per_batch"] is not None:
            fam("dl4j_serving_coalesce_rows_per_batch", "gauge",
                "Mean real rows per device forward (cross-request "
                "coalescing signal)", snap["coalesce_rows_per_batch"])
            fam("dl4j_serving_coalesce_requests_per_batch", "gauge",
                "Mean tickets per device forward",
                snap["coalesce_requests_per_batch"])
        fam("dl4j_serving_padded_rows_total", "counter",
            "Filler rows added by bucket-ladder padding",
            snap["padded_rows_total"])
        if snap["padding_waste_fraction"] is not None:
            fam("dl4j_serving_padding_waste_fraction", "gauge",
                "Padded rows over total rows through device forwards",
                snap["padding_waste_fraction"])
        fam("dl4j_serving_compiled_buckets", "gauge",
            "Distinct padded bucket shapes executed (the warm bucket "
            "ladder's footprint)", snap["compile_count"])
        fam("dl4j_serving_drain_rate_rows_per_s", "gauge",
            "Observed serving throughput over the recent horizon",
            snap["drain_rate_rows_per_s"])
        fam("dl4j_serving_retry_after_seconds", "gauge",
            "Derived Retry-After a 503 would answer now (backlog over "
            "observed drain rate, clamped)", snap["retry_after_s"])
        return fams

    def attach_to_registry(self, registry=None, *, labels=None,
                           shapes_fn=None):
        """Register a collector view of these stats on ``registry``
        (default: the process-global one). ``shapes_fn`` gives the
        server's live ``shapes_seen`` at render time."""
        from deeplearning4j_tpu_torch.observability.metrics import \
            get_registry

        self.detach_from_registry()
        reg = registry if registry is not None else get_registry()

        def _collect():
            shapes = shapes_fn() if shapes_fn is not None else ()
            return self.metric_families(shapes, labels)

        reg.register_collector(_collect)
        self._registry, self._collector = reg, _collect
        return reg

    def detach_from_registry(self):
        reg = getattr(self, "_registry", None)
        if reg is not None:
            reg.unregister_collector(self._collector)
            self._registry = self._collector = None


# ------------------------------------------------- decode-tier families
def decode_metric_families(describe: dict, labels=None):
    """A ``DecodeEngine.describe()`` as MetricFamily rows: the decode and
    KV-pool view of ``/metrics``, registered as a collector by
    ``ModelServer`` when a decode engine rides it."""
    from deeplearning4j_tpu_torch.observability.metrics import (MetricFamily,
                                                                _fmt_value)

    L = dict(labels or {})
    fams = []

    def fam(name, kind, help, value):
        if value is None:
            return
        fams.append(MetricFamily(name, kind, help).add(value, L))

    fam("dl4j_kv_pool_pages_used", "gauge",
        "Physical KV pages held (each shared page counted once)",
        describe.get("pages_used"))
    fam("dl4j_kv_pool_shared_pages", "gauge",
        "KV pages currently referenced by two or more sessions",
        describe.get("shared_pages"))
    fam("dl4j_kv_pool_dedup_ratio", "gauge",
        "Logical page charge over physical pages held (1.0 = nothing "
        "shared)", describe.get("dedup_ratio"))
    fam("dl4j_kv_pool_evictions_total", "counter",
        "Sessions LRU-released to free pages",
        describe.get("evictions"))
    fam("dl4j_decode_prefill_chunks_total", "counter",
        "Prompt segments submitted through the chunked-prefill path",
        describe.get("prefill_chunks"))
    fam("dl4j_decode_interleaved_prefills_total", "counter",
        "Chunked prefills during which decode steps dispatched between "
        "chunks", describe.get("interleaved_prefills"))
    fam("dl4j_decode_prefix_hits_total", "counter",
        "Prefills that adopted a shared prompt-prefix page chain",
        describe.get("prefix_hits"))
    fam("dl4j_decode_shared_tokens_total", "counter",
        "Prefill tokens skipped by adopting shared pages",
        describe.get("shared_tokens"))
    fam("dl4j_decode_reprefills_total", "counter",
        "Evicted sessions re-admitted bit-identically from history",
        describe.get("reprefills"))
    itok = describe.get("inter_token_hist")
    if itok and itok.get("count"):
        hist = MetricFamily(
            "dl4j_decode_inter_token_seconds", "histogram",
            "Wall time between consecutive emitted tokens per decode "
            "session")
        cum = 0
        for le, n in sorted(itok["buckets"].items(),
                            key=lambda kv: float(kv[0])):
            cum += int(n)
            hist.add(cum, {**L, "le": _fmt_value(float(le))},
                     suffix="_bucket")
        hist.add(round(float(itok["sum"]), 6), L, suffix="_sum")
        hist.add(int(itok["count"]), L, suffix="_count")
        fams.append(hist)
    if describe.get("speculative_k"):
        fam("dl4j_decode_spec_rounds_total", "counter",
            "Speculative draft-propose/target-verify rounds run",
            describe.get("spec_rounds"))
        fam("dl4j_decode_spec_proposed_total", "counter",
            "Draft tokens proposed for target verification",
            describe.get("spec_proposed"))
        fam("dl4j_decode_spec_accepted_total", "counter",
            "Draft proposals accepted by exact target-argmax match",
            describe.get("spec_accepted"))
        fam("dl4j_decode_spec_rejected_total", "counter",
            "Draft proposals truncated at the first argmax mismatch",
            describe.get("spec_rejected"))
        fam("dl4j_decode_spec_accept_tokens_per_step", "gauge",
            "Tokens emitted per target decode launch (1.0 = plain "
            "decode)", describe.get("spec_accept_tokens_per_step"))
    return fams
