"""SchedulingCore: one admission discipline for the whole serving tier
(counterpart of deeplearning4j_tpu/scheduling/core.py).

The micro-batcher's tiers, the fleet's admission, the decode engine and
the front-door router all ask this core "may this request enter?":

- **Admission classes.** Three strict-priority tiers, ``interactive`` >
  ``batch`` > ``best_effort``, parsed from ``X-DL4J-Priority`` (absent
  means interactive). The class rides the batcher ticket as an integer
  priority: the device thread seeds each bucket from the oldest ticket
  of the highest class present.
- **Per-tenant token-bucket quotas.** ``X-DL4J-Tenant`` names the
  bucket; rate and burst come from ``quotas`` (per tenant) or
  ``default_quota``. A tenant with no quota is unlimited. Quota sheds
  answer 503 with reason ``quota`` before the request touches a queue.
- **Watermark shedding, batch first.** ``best_effort`` sheds above 25%
  of queue capacity, ``batch`` above 50%, ``interactive`` only at 100%
  (the plain full-queue threshold).
- **Deadline-aware shedding.** When the derived wait estimate (the
  Retry-After signal) exceeds ``X-DL4J-Deadline-Ms``, the request sheds
  at once with reason ``deadline``.

Sheds raise :class:`ShedError` (a ``QueueFullError``, so every 503 +
Retry-After mapping applies) carrying the class and reason; the HTTP
layers echo the class in ``X-DL4J-Shed-Class`` and the per-class
``dl4j_sched_shed_total{class=...}`` counters show batch shedding before
interactive.

Host-only Python (the router imports it in a process with no model);
every clock is injectable.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from deeplearning4j_tpu_torch.analysis.guards import guarded_by
from deeplearning4j_tpu_torch.serving.batcher import QueueFullError

__all__ = [
    "SchedulingCore", "ShedError", "TokenBucket", "normalize_class",
    "CLASSES", "PRIORITY", "INTERACTIVE", "BATCH", "BEST_EFFORT",
    "TENANT_HEADER", "PRIORITY_HEADER", "DEADLINE_HEADER",
    "SHED_CLASS_HEADER", "SCHED_HEADERS", "DEFAULT_WATERMARKS",
    "parse_sched_headers", "build_sched_headers",
]

#: which tenant's quota bucket a request draws from (absent ⇒ "default")
TENANT_HEADER = "X-DL4J-Tenant"
#: admission class: interactive | batch | best_effort (absent ⇒ interactive)
PRIORITY_HEADER = "X-DL4J-Priority"
#: how long the client will wait, in milliseconds — the deadline-aware
#: shed compares this against the derived wait estimate
DEADLINE_HEADER = "X-DL4J-Deadline-Ms"
#: echoed on every scheduler 503: which class was shed (load tests
#: verify batch sheds before interactive)
SHED_CLASS_HEADER = "X-DL4J-Shed-Class"

#: the end-to-end scheduling headers, forwarded hop to hop and echoed
#: back exactly like X-DL4J-Trace-Id
SCHED_HEADERS = (TENANT_HEADER, PRIORITY_HEADER, DEADLINE_HEADER)

INTERACTIVE = "interactive"
BATCH = "batch"
BEST_EFFORT = "best_effort"
CLASSES: Tuple[str, ...] = (INTERACTIVE, BATCH, BEST_EFFORT)

#: strict-priority rank (lower = served first); also the integer the
#: batcher ticket carries
PRIORITY: Dict[str, int] = {INTERACTIVE: 0, BATCH: 1, BEST_EFFORT: 2}

#: queue-fraction watermark above which each class sheds. interactive
#: at 1.0 reproduces the legacy single-threshold reject exactly.
DEFAULT_WATERMARKS: Dict[str, float] = {
    INTERACTIVE: 1.0, BATCH: 0.5, BEST_EFFORT: 0.25}

_SHED_REASONS = ("quota", "backpressure", "deadline")


def normalize_class(name) -> str:
    """Map a header value onto a known class. Absent/unknown values
    become ``interactive`` — legacy clients (no header) must keep their
    exact pre-scheduler admission behavior, and an unrecognized class
    must not be silently demoted to shed-first."""
    if not name:
        return INTERACTIVE
    k = str(name).strip().lower().replace("-", "_")
    return k if k in PRIORITY else INTERACTIVE


def parse_sched_headers(headers) -> dict:
    """Pull (tenant, klass, deadline_ms) from an HTTP header mapping —
    the one parse shared by ModelServer and FrontDoorRouter. A
    malformed deadline is treated as absent (a bad client must not be
    able to 400 itself into a different admission tier)."""
    deadline = headers.get(DEADLINE_HEADER)
    if deadline is not None:
        try:
            deadline = float(deadline)
        except (TypeError, ValueError):
            deadline = None
    return {"tenant": headers.get(TENANT_HEADER),
            "klass": normalize_class(headers.get(PRIORITY_HEADER)),
            "deadline_ms": deadline}


def build_sched_headers(sched) -> dict:
    """The inverse of :func:`parse_sched_headers`: the header dict a
    forwarding hop (the router's proxy) attaches so the backend sees
    the same tenant/class/deadline the client declared."""
    out = {PRIORITY_HEADER: normalize_class((sched or {}).get("klass"))}
    if (sched or {}).get("tenant"):
        out[TENANT_HEADER] = str(sched["tenant"])
    if (sched or {}).get("deadline_ms") is not None:
        out[DEADLINE_HEADER] = f"{float(sched['deadline_ms']):g}"
    return out


class ShedError(QueueFullError):
    """Admission denied by the scheduler. Subclasses ``QueueFullError``
    so every existing 503 + Retry-After mapping (server handler, router
    retry-the-others loop, client backoff) applies unchanged; carries
    WHICH class was shed and WHY so the 503 can say so."""

    def __init__(self, msg: str, klass: str, reason: str):
        super().__init__(msg)
        self.klass = klass
        self.reason = reason


@guarded_by("_lock", "tokens", "_t_last")
class TokenBucket:
    """Per-tenant admission quota: ``rate`` tokens/s refill up to
    ``burst``; one request consumes ``cost`` tokens (callers pass rows,
    so a 64-row POST spends 64× what a 1-row POST does). Injectable
    clock — quota tests refill deterministically."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self.tokens = float(burst)
        self._t_last = clock()
        self._lock = threading.Lock()

    def try_take(self, cost: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t_last) * self.rate)
            self._t_last = now
            if self.tokens >= cost:
                self.tokens -= cost
                return True
            return False

    def peek(self) -> float:
        with self._lock:
            now = self._clock()
            return min(self.burst,
                       self.tokens + (now - self._t_last) * self.rate)


@guarded_by("_lock", "_buckets", "_quota_conf", "admitted_total",
            "shed_total", "shed_by_reason", "deepest_admitted_fraction")
class SchedulingCore:
    """The unified admission decision. Stateless with respect to the
    queues themselves: callers pass the observed ``depth``/``capacity``
    (fleet backlog over live replicas, or the router's federated sum)
    and the derived ``wait_estimate_s`` (the Retry-After signal), and
    ``admit`` answers by raising :class:`ShedError` or returning the
    normalized class — so ONE core serves the batcher, the fleet, the
    decode engine and the router without owning any of their locks.

    ``quotas`` maps tenant -> (rate_per_s, burst); ``default_quota``
    applies to tenants with no explicit entry (None = unlimited).
    ``watermarks`` maps class -> queue fraction above which it sheds
    (``DEFAULT_WATERMARKS`` degrades batch first, interactive last).
    """

    #: class -> strict-priority tier, exposed on the instance so
    #: queue owners (serving/fleet.py) can map an admitted class to
    #: its tier without importing this module — serving and
    #: scheduling import each other's packages in opposite
    #: directions, and the attribute breaks the cycle
    PRIORITY = PRIORITY

    def __init__(self, *, quotas=None, default_quota=None,
                 watermarks=None, clock=time.monotonic):
        self._clock = clock
        self._quota_conf = dict(quotas or {})
        self._default_quota = default_quota
        self.watermarks = dict(DEFAULT_WATERMARKS)
        if watermarks:
            self.watermarks.update(watermarks)
        for k in self.watermarks:
            if k not in PRIORITY:
                raise ValueError(f"unknown admission class {k!r}")
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self.admitted_total: Dict[str, int] = {c: 0 for c in CLASSES}
        self.shed_total: Dict[str, int] = {c: 0 for c in CLASSES}
        self.shed_by_reason: Dict[Tuple[str, str], int] = {}
        #: high-water mark of the queue fraction an admitted request
        #: saw — the "how close to the cliff did we run" gauge
        self.deepest_admitted_fraction = 0.0

    # ---------------------------------------------------------------- quotas
    def _bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        with self._lock:
            conf = self._quota_conf.get(tenant, self._default_quota)
            if conf is None:
                return None
            b = self._buckets.get(tenant)
            if b is None:
                rate, burst = conf
                b = TokenBucket(rate, burst, clock=self._clock)
                self._buckets[tenant] = b
            return b

    def set_quota(self, tenant: str, rate: float, burst: float):
        """(Re)configure one tenant's bucket; live buckets rebuild on
        next admit so a raised quota takes effect immediately."""
        with self._lock:
            self._quota_conf[tenant] = (float(rate), float(burst))
            self._buckets.pop(tenant, None)

    # ------------------------------------------------------------- admission
    def admit(self, *, tenant=None, klass=None, deadline_ms=None,
              rows: int = 1, depth=None, capacity=None,
              wait_estimate_s=None) -> str:
        """Admit or shed one request. Returns the normalized class on
        admission; raises :class:`ShedError` (a ``QueueFullError``) on
        shed. Checks run cheapest-first and each is skipped when its
        signal was not supplied, so the default path (no headers, no
        quotas, no deadline) costs two dict lookups and one compare."""
        k = klass if klass in PRIORITY else normalize_class(klass)
        # 1) tenant quota: shed before the request touches any queue
        bucket = self._bucket_for(tenant or "default")
        if bucket is not None and not bucket.try_take(max(1, int(rows))):
            self._record_shed(k, "quota")
            raise ShedError(
                f"tenant {tenant or 'default'!r} quota exhausted "
                f"({bucket.rate:g}/s, burst {bucket.burst:g})", k, "quota")
        # 2) class watermark against observed backlog: batch first
        if depth is not None and capacity:
            frac = depth / float(capacity)
            if frac >= self.watermarks[k]:
                self._record_shed(k, "backpressure")
                raise ShedError(
                    f"{k} sheds at {self.watermarks[k]:.0%} of queue "
                    f"capacity (depth {depth}/{capacity})",
                    k, "backpressure")
            with self._lock:
                if frac > self.deepest_admitted_fraction:
                    self.deepest_admitted_fraction = frac
        # 3) deadline vs the derived wait estimate (the Retry-After
        #    signal): a request that cannot make it sheds NOW
        if deadline_ms is not None and wait_estimate_s is not None \
                and wait_estimate_s * 1000.0 > float(deadline_ms):
            self._record_shed(k, "deadline")
            raise ShedError(
                f"estimated wait {wait_estimate_s * 1000.0:.0f}ms exceeds "
                f"deadline {float(deadline_ms):.0f}ms", k, "deadline")
        with self._lock:
            self.admitted_total[k] += 1
        return k

    def _record_shed(self, klass: str, reason: str):
        with self._lock:
            self.shed_total[klass] += 1
            key = (klass, reason)
            self.shed_by_reason[key] = self.shed_by_reason.get(key, 0) + 1

    def record_shed(self, klass, reason: str = "backpressure"):
        """Account a shed decided OUTSIDE admit() — the router's
        all-hosts-overloaded 503 and the legacy QueueFullError path
        still count into the same per-class families."""
        self._record_shed(normalize_class(klass), reason)

    # --------------------------------------------------------------- metrics
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "admitted_total": dict(self.admitted_total),
                "shed_total": dict(self.shed_total),
                "shed_by_reason": {f"{k}/{r}": n for (k, r), n
                                   in sorted(self.shed_by_reason.items())},
                "quota_tokens": {t: round(b.peek(), 3)
                                 for t, b in self._buckets.items()},
                "deepest_admitted_fraction": round(
                    self.deepest_admitted_fraction, 4),
                "watermarks": dict(self.watermarks),
            }

    def metric_families(self, labels=None):
        """``dl4j_sched_*`` families (OBSERVABILITY.md): per-class
        admitted/shed counters (a load test can
        watch batch shed while interactive is admitted), per-reason
        shed counters, and per-tenant quota-token gauges."""
        from deeplearning4j_tpu_torch.observability.metrics import MetricFamily
        L = dict(labels or {})
        snap = self.snapshot()
        admitted = MetricFamily(
            "dl4j_sched_admitted_total", "counter",
            "Requests admitted by the scheduling core, per class")
        shed = MetricFamily(
            "dl4j_sched_shed_total", "counter",
            "Requests shed (503) by the scheduling core, per class — "
            "batch must rise before interactive under overload")
        for c in CLASSES:
            admitted.add(snap["admitted_total"][c], {**L, "class": c})
            shed.add(snap["shed_total"][c], {**L, "class": c})
        reason = MetricFamily(
            "dl4j_sched_shed_reason_total", "counter",
            "Sheds by (class, reason): quota | backpressure | deadline")
        for key, n in snap["shed_by_reason"].items():
            c, r = key.split("/", 1)
            reason.add(n, {**L, "class": c, "reason": r})
        tokens = MetricFamily(
            "dl4j_sched_quota_tokens", "gauge",
            "Token-bucket balance per tenant (refills at the quota rate)")
        for t, v in snap["quota_tokens"].items():
            tokens.add(v, {**L, "tenant": t})
        frac = MetricFamily(
            "dl4j_sched_deepest_admitted_fraction", "gauge",
            "High-water queue fraction an admitted request has seen")
        frac.add(snap["deepest_admitted_fraction"], L)
        return [admitted, shed, reason, tokens, frac]
