"""Cross-host serving federation: a queue-depth front-door router over N
single-host fleets (counterpart of deeplearning4j_tpu/serving/router.py).

- **Least-loaded routing for stateless /predict.** Each backend host
  pushes its metrics snapshot (``HeartbeatPusher`` -> the router's
  ``/api/metrics_push``); the router scores every routable host by its
  pushed ``dl4j_serving_queue_depth`` plus its own in-flight count to
  that host and proxies to the minimum, round-robin on ties
  (``ReplicaSet._pick`` over hosts).
- **Session-affine routing for /decode.** The router pins ``sid ->
  host`` and keeps the session's full token history. Every forwarded
  ``step`` carries that history, so when the pinned host dies or goes
  heartbeat-stale the router re-pins to a survivor, whose
  ``DecodeEngine`` re-prefills from the history (bit-identical: the
  history grows only after a step's reply lands).
- **Host eviction + in-flight retry.** A connection-level failure
  evicts the host and retries the request on a survivor; a request
  fails only when every host is gone.
- **Global backpressure.** When every routable host answers 503 the
  router answers 503 with ``Retry-After`` = the minimum of the hosts'
  values (reply header, else the pushed
  ``dl4j_serving_retry_after_seconds`` gauge).
- **Health.** ``GET /healthz`` answers ``ok`` / ``degraded`` (200) /
  ``unhealthy`` (503, no routable host); ``GET /api/fleet`` serves the
  federation scoreboard plus the routing table; with ``push_url`` the
  router pushes its own snapshot.
- **Heartbeat auto-eviction.** A host that stops pushing is skipped
  once stale (``stale_after_s``) and evicted past ``evict_after_factor
  x stale_after_s``; a host that never pushed stays trusted.
- **Canaries.** ``start_canary`` pins a traffic fraction to one host
  through a token bucket; ``evaluate_canary`` differences the live
  federation counters against a baseline (error rate, NaN rows, p99
  ratio) and answers pass / fail / wait; ``promote_canary`` admits the
  host, ``rollback_canary`` quarantines it, drops its decode pins and
  flushes a flight-recorder artifact; ``reinstate`` lifts the
  quarantine.
- **Trace stitching and fleet SLOs.** Every proxied hop records its
  [send, recv] window; hosts push request-scoped spans on the same wire;
  ``GET /api/trace/<id>`` serves the skew-rebased waterfall
  (``TraceStore``). An ``SLOEngine`` over the federation rows exports
  ``dl4j_slo_*`` gauges.
- **Front-door admission.** A ``SchedulingCore`` runs tenant quotas and
  deadline sheds before any backend round trip.

The router is host-only Python: it imports no torch and runs no model.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import urlparse

from deeplearning4j_tpu_torch.analysis.guards import guarded_by
from deeplearning4j_tpu_torch.observability import metrics as _obs_metrics
from deeplearning4j_tpu_torch.observability import slo as _obs_slo
from deeplearning4j_tpu_torch.observability.distributed import (HeartbeatPusher,
                                                          MetricsFederation,
                                                          TRACE_HEADER,
                                                          TraceStore,
                                                          new_trace_id)
from deeplearning4j_tpu_torch.scheduling import core as _sched

__all__ = ["FrontDoorRouter", "HostHandle", "NoHostsError",
           "BACKEND_HEADER"]

#: echoed on every proxied reply: which backend host served it
BACKEND_HEADER = "X-DL4J-Backend"

#: Retry-After floor when no host supplied a derived value (matches the
#: ServingStats clamp's low end)
_RETRY_AFTER_FLOOR_S = 0.05

LIVE, DEAD = "live", "dead"


class NoHostsError(RuntimeError):
    """Every backend host is evicted or stale — nothing to route to."""


class _HostDown(Exception):
    """Connection-level failure talking to one host (refused / reset /
    timeout) — triggers eviction + retry, never escapes the router."""


@guarded_by("_lock", "_idle", "in_flight", "picks", "status", "errors")
class HostHandle:
    """One backend host: address, status, a small keep-alive connection
    pool, and the router-side load/accounting counters."""

    def __init__(self, base_url: str, timeout_s: float = 60.0):
        self.base_url = base_url.rstrip("/")
        u = urlparse(self.base_url)
        self.addr = (u.hostname or "127.0.0.1", u.port or 80)
        self.timeout_s = float(timeout_s)
        self.status = LIVE
        self.in_flight = 0
        self.picks = 0
        self.errors = 0
        #: unix time of the host's last observed federation push —
        #: derived from pushed heartbeat age, so it survives the
        #: federation's own auto-evict dropping the row (the router
        #: still knows how long this host has been silent)
        self.last_push_unix: Optional[float] = None
        self._lock = threading.Lock()
        self._idle: List[http.client.HTTPConnection] = []

    # ------------------------------------------------------- connection pool
    def acquire(self) -> http.client.HTTPConnection:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return http.client.HTTPConnection(*self.addr,
                                          timeout=self.timeout_s)

    def release(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if self.status == LIVE and len(self._idle) < 32:
                self._idle.append(conn)
                return
        conn.close()

    def discard(self, conn: http.client.HTTPConnection) -> None:
        try:
            conn.close()
        except Exception:
            pass

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for c in idle:
            self.discard(c)

    # ------------------------------------------------------------ accounting
    def enter(self) -> None:
        with self._lock:
            self.in_flight += 1
            self.picks += 1

    def leave(self) -> None:
        with self._lock:
            self.in_flight -= 1

    def describe(self) -> dict:
        with self._lock:
            return {"url": self.base_url, "status": self.status,
                    "in_flight": self.in_flight, "picks": self.picks,
                    "errors": self.errors}


@guarded_by("_lock", "_hosts", "_rr", "_affinity", "_history",
            "requests_total", "decode_steps_total", "retried_total",
            "evicted_total", "failovers_total", "affinity_hits",
            "affinity_misses", "shed_total", "auto_evicted_total",
            "rollbacks_total", "promotions_total", "_quarantined",
            "_canary", "_canary_credit", "canary_routed_total")
class FrontDoorRouter:
    """The front door: an HTTP server federating N backend
    ``ModelServer`` hosts.

    ``hosts`` are backend base URLs (``http://127.0.0.1:9500``); more
    can join live via :meth:`add_host` (the bench grows the fleet
    mid-run to measure scaling through ONE router). ``stale_after_s``
    is the heartbeat-age bound past which a host stops receiving new
    requests (it is not evicted — a paused host resumes when its pushes
    resume; eviction is for connection-level death).
    """

    def __init__(self, hosts=(), host: str = "127.0.0.1", port: int = 0,
                 *, stale_after_s: float = 10.0,
                 evict_after_factor: Optional[float] = 4.0,
                 request_timeout_s: float = 120.0,
                 federation: Optional[MetricsFederation] = None,
                 push_url: Optional[str] = None,
                 push_interval_s: float = 2.0,
                 scheduler=None, sched_capacity: Optional[int] = None):
        self.host = host
        self.port = port
        self.request_timeout_s = float(request_timeout_s)
        #: front-door admission : tenant
        #: quotas and deadline sheds run HERE, before a doomed request
        #: costs a backend round trip; class watermarks run here too
        #: when ``sched_capacity`` (aggregate queue bound) is set,
        #: otherwise the hosts' own schedulers enforce them. Default
        #: SchedulingCore = no quotas, so legacy traffic is untouched;
        #: scheduler=False disables front-door admission entirely.
        if scheduler is False:
            self.scheduler = None
        elif scheduler is None:
            self.scheduler = _sched.SchedulingCore()
        else:
            self.scheduler = scheduler
        self.sched_capacity = sched_capacity
        self.federation = federation if federation is not None else \
            MetricsFederation(stale_after_s=stale_after_s)
        #: auto-eviction threshold as a multiple of the federation's
        #: ``stale_after_s`` (mirrors MetricsFederation.health); None
        #: disables — stale hosts are then only skipped, never evicted
        #: request-scoped span index (OBSERVABILITY.md §Request
        #: tracing): hosts' pushed span batches land here via
        #: /api/metrics_push, the router's own per-hop send/recv
        #: anchors enter in _proxy, and GET /api/trace/<id> serves the
        #: stitched waterfall. Internally locked.
        self.trace_store = TraceStore()
        #: fleet-level SLO engine fed from the SAME federation rows the
        #: router routes by; its gauge families ride the router's
        #: /metrics exposition and push_url heartbeats. Internally
        #: locked.
        self.slo_engine = _obs_slo.SLOEngine(_obs_slo.default_serving_slos(
            p99_bound_ms=float(os.environ.get("DL4J_TPU_SLO_P99_MS",
                                              "500"))))
        self.evict_after_factor = (None if evict_after_factor is None
                                   else float(evict_after_factor))
        if self.evict_after_factor is not None \
                and self.evict_after_factor < 1.0:
            raise ValueError("evict_after_factor must be >= 1 (eviction "
                             "below the stale bound would drop hosts the "
                             "router still routes to)")
        self._hosts: List[HostHandle] = []
        self._lock = threading.Lock()
        self._rr = 0                       # round-robin tiebreak cursor
        #: sid -> pinned HostHandle (the affinity map, one level up)
        self._affinity: Dict[str, HostHandle] = {}
        #: sid -> full token history (prompt + accepted steps) — the
        #: cross-host recovery source; ints, so it stays tiny
        self._history: Dict[str, List[int]] = {}
        self.requests_total = 0
        self.decode_steps_total = 0
        self.retried_total = 0            # in-flight retries onto survivors
        self.evicted_total = 0
        self.failovers_total = 0          # decode sessions re-pinned
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.shed_total = 0               # global-backpressure 503s
        self.auto_evicted_total = 0       # heartbeat-silence evictions
        # ---- canary state (SERVING.md §Live reload) ----
        self._canary: Optional[dict] = None
        self._canary_credit = 0.0         # token bucket: += fraction/request
        self.canary_routed_total = 0
        self.rollbacks_total = 0
        self.promotions_total = 0
        #: hosts rolled back while still holding rejected weights — out
        #: of ALL routing until reinstate()
        self._quarantined: set = set()
        self.last_rollback_artifact: Optional[str] = None
        self._registry_collector = None
        self._httpd = None
        self._thread = None
        self._pusher: Optional[HeartbeatPusher] = None
        self._push_url = push_url
        self._push_interval_s = float(push_interval_s)
        for u in hosts:
            self.add_host(u)

    # -------------------------------------------------------------- topology
    def add_host(self, base_url: str) -> HostHandle:
        h = HostHandle(base_url, timeout_s=self.request_timeout_s)
        with self._lock:
            self._hosts.append(h)
        return h

    @property
    def hosts(self) -> List[HostHandle]:
        with self._lock:
            return list(self._hosts)

    def _fed_rows(self) -> Dict[str, dict]:
        """Federation health rows keyed by the pushing host's
        self-reported ``server_url`` (ModelServer puts it in the health
        payload) — the join between 'who pushed' and 'where I proxy'."""
        rows = {}
        for row in self.federation.health():
            url = (row.get("health") or {}).get("server_url")
            if url:
                rows[url.rstrip("/")] = row
        return rows

    def _evict(self, h: HostHandle) -> None:
        with self._lock:
            if h.status == DEAD:
                return
            h.status = DEAD
            h.errors += 1
            self.evicted_total += 1
        h.close()

    def _auto_evict(self, h: HostHandle) -> None:
        """Heartbeat-silence eviction (the MetricsFederation.health
        mirror): the host stops being a routing candidate permanently —
        a resurrected process rejoins via add_host, with fresh state."""
        with self._lock:
            if h.status == DEAD:
                return
            h.status = DEAD
            self.evicted_total += 1
            self.auto_evicted_total += 1
        h.close()

    # --------------------------------------------------------------- routing
    def _routable(self, exclude=()) -> List[HostHandle]:
        """Hosts new STABLE work may go to: not evicted, not
        quarantined (rolled-back canary weights), not the active canary
        host (it only receives its token-bucket fraction), not
        heartbeat-stale — and hosts silent past ``evict_after_factor ×
        stale_after_s`` are auto-evicted here, on the routing path, the
        same place staleness is already observed. A host that has never
        pushed is trusted (the metrics plane is a routing signal, not
        an admission gate)."""
        fed = self._fed_rows()
        now = time.time()
        with self._lock:
            canary_host = self._canary["host"] if self._canary else None
            quarantined = set(self._quarantined)
        out = []
        for h in self.hosts:
            if h.status != LIVE or h in exclude:
                continue
            row = fed.get(h.base_url)
            if row is not None:
                # stamp observed push recency so the silence clock keeps
                # running even after the federation drops the row
                h.last_push_unix = now - float(row["heartbeat_age_s"])
            if self.evict_after_factor is not None \
                    and h.last_push_unix is not None \
                    and (now - h.last_push_unix
                         > self.evict_after_factor
                         * self.federation.stale_after_s):
                self._auto_evict(h)
                continue
            if h in quarantined or h is canary_host:
                continue
            if row is not None and not row["live"]:
                continue
            out.append((h, row))
        return out

    def _pick(self, exclude=()) -> Optional[HostHandle]:
        """Least-loaded routable host: pushed queue depth + local
        in-flight, round-robin on ties — ``ReplicaSet._pick`` over
        hosts."""
        cands = self._routable(exclude)
        if not cands:
            return None
        scored = []
        for h, row in cands:
            depth = (row or {}).get("queue_depth") or 0
            scored.append((depth + h.in_flight, h))
        best = min(s for s, _ in scored)
        ties = [h for s, h in scored if s == best]
        with self._lock:
            self._rr += 1
            return ties[self._rr % len(ties)]

    def _pick_affine(self, sid: str) -> Optional[HostHandle]:
        """The session's pinned host while it remains routable; a
        fresh least-loaded pin otherwise (first touch = miss, re-pin
        after host loss = failover, both counted)."""
        with self._lock:
            pinned = self._affinity.get(sid)
        if pinned is not None:
            fed_row = self._fed_rows().get(pinned.base_url)
            stale = fed_row is not None and not fed_row["live"]
            if pinned.status == LIVE and not stale:
                with self._lock:
                    self.affinity_hits += 1
                return pinned
        h = self._pick()
        if h is None:
            return None
        with self._lock:
            if pinned is not None:
                self.failovers_total += 1
            self.affinity_misses += 1
            self._affinity[sid] = h
        return h

    def _min_retry_after(self, collected: List[float]) -> float:
        """The aggregated Retry-After for a fleet-wide 503: the soonest
        any host expects headroom — reply headers first, pushed
        ``retry_after_s`` gauges as the fallback."""
        vals = list(collected)
        for row in self._fed_rows().values():
            ra = row.get("retry_after_s")
            if ra is not None:
                vals.append(float(ra))
        return min(vals) if vals else _RETRY_AFTER_FLOOR_S

    # ---------------------------------------------------------------- canary
    def _serving_counters(self, url: str) -> Optional[dict]:
        """The host's pushed canary-gate slice (``health["serving"]``
        from ModelServer._push_health), or None before its first push."""
        row = self._fed_rows().get(url.rstrip("/"))
        if row is None:
            return None
        return (row.get("health") or {}).get("serving")

    def start_canary(self, base_url: str, *, version=None,
                     fraction: float = 0.1,
                     max_error_rate_delta: float = 0.02,
                     max_nan_rows: int = 0,
                     max_p99_ratio: float = 3.0,
                     min_requests: int = 20) -> dict:
        """Begin canarying one host: it leaves stable routing and
        receives exactly ``fraction`` of /predict traffic via a token
        bucket (credit accrues per request; the canary is picked only
        when a whole token is banked, so its share can NEVER exceed the
        fraction — containment by construction). The host may already
        be registered (add_host) or is registered here. Baselines for
        the promotion gates are snapshotted from the live federation
        plane now; ``evaluate_canary`` differences against them.

        Gates: ``max_error_rate_delta`` (canary errors per canary
        request above the stable fleet's rate), ``max_nan_rows``
        (NaN-sentinel rows since baseline — 0 means one poisoned reply
        kills it), ``max_p99_ratio`` (canary p99 over the stable
        median), all judged only after ``min_requests`` canary
        requests."""
        if not 0.0 < fraction <= 0.5:
            raise ValueError("canary fraction must be in (0, 0.5] — above "
                             "half, the 'canary' is the fleet")
        url = base_url.rstrip("/")
        h = next((x for x in self.hosts if x.base_url == url), None)
        if h is None:
            h = self.add_host(url)
        with self._lock:
            if self._canary is not None:
                raise RuntimeError(
                    f"canary already active (v{self._canary['version']} on "
                    f"{self._canary['host'].base_url}) — promote or roll "
                    "back first")
            if h in self._quarantined:
                raise RuntimeError(f"{url} is quarantined (rolled back) — "
                                   "reinstate() it first")
        baseline = {"canary": self._serving_counters(url) or {},
                    "stable": {x.base_url: self._serving_counters(x.base_url)
                               for x in self.hosts
                               if x is not h and x.status == LIVE}}
        canary = {"host": h, "version": version, "fraction": float(fraction),
                  "gates": {"max_error_rate_delta": float(
                                max_error_rate_delta),
                            "max_nan_rows": int(max_nan_rows),
                            "max_p99_ratio": float(max_p99_ratio),
                            "min_requests": int(min_requests)},
                  "baseline": baseline, "started_unix": time.time(),
                  "routed": 0}
        with self._lock:
            self._canary = canary
            self._canary_credit = 0.0
        return {"host": url, "version": version, "fraction": fraction}

    def _pick_canary_admitted(self, tried) -> Optional[HostHandle]:
        """The /predict pick: the canary host when the token bucket has
        banked a whole token (and the canary is still alive and not yet
        tried), the stable least-loaded pick otherwise. A canary that
        fails mid-request lands in ``tried`` and the retry goes stable —
        the client never pays for the canary's death."""
        with self._lock:
            can = self._canary
            take = False
            if can is not None and not tried \
                    and can["host"].status == LIVE:
                self._canary_credit += can["fraction"]
                if self._canary_credit >= 1.0:
                    self._canary_credit -= 1.0
                    can["routed"] += 1
                    self.canary_routed_total += 1
                    take = True
        if take:
            return can["host"]
        return self._pick(exclude=tried)

    def evaluate_canary(self) -> dict:
        """Judge the active canary against its gates using live
        federation deltas. Returns a verdict dict: ``decision`` is
        ``"pass"`` / ``"fail"`` / ``"wait"`` (not enough canary traffic
        yet, or no push since baseline); on fail, ``killed_by`` names
        the gate and the measured delta — exactly what the rollback
        flight record carries."""
        with self._lock:
            can = self._canary
        if can is None:
            raise RuntimeError("no active canary")
        gates = can["gates"]
        url = can["host"].base_url
        now = self._serving_counters(url)
        base = can["baseline"]["canary"]
        verdict = {"version": can["version"], "host": url,
                   "fraction": can["fraction"], "routed": can["routed"],
                   "decision": "wait", "killed_by": None, "deltas": {}}
        if now is None:
            return verdict  # nothing pushed since the canary booted
        d_req = (now.get("requests_total") or 0) \
            - (base.get("requests_total") or 0)
        d_err = (now.get("errors_total") or 0) \
            - (base.get("errors_total") or 0)
        d_nan = (now.get("nan_rows_total") or 0) \
            - (base.get("nan_rows_total") or 0)
        verdict["deltas"] = {"requests": d_req, "errors": d_err,
                             "nan_rows": d_nan}
        # stable p99 median for the ratio gate, from live pushes
        stable_p99 = sorted(
            s["latency_p99_ms"]
            for s in (self._serving_counters(u)
                      for u in can["baseline"]["stable"])
            if s and s.get("latency_p99_ms") is not None)
        p99 = now.get("latency_p99_ms")
        if p99 is not None and stable_p99:
            med = stable_p99[len(stable_p99) // 2]
            if med > 0:
                verdict["deltas"]["p99_ratio"] = round(p99 / med, 3)
        # NaN gate first: a poisoned version must die before min_requests
        # worth of users see it — one bad reply is already the evidence
        if d_nan > gates["max_nan_rows"]:
            verdict.update(decision="fail", killed_by={
                "gate": "max_nan_rows", "bound": gates["max_nan_rows"],
                "measured": d_nan})
            return verdict
        if d_req < gates["min_requests"]:
            return verdict
        err_rate = d_err / d_req if d_req else 0.0
        if err_rate > gates["max_error_rate_delta"]:
            verdict.update(decision="fail", killed_by={
                "gate": "max_error_rate_delta",
                "bound": gates["max_error_rate_delta"],
                "measured": round(err_rate, 4)})
            return verdict
        ratio = verdict["deltas"].get("p99_ratio")
        if ratio is not None and ratio > gates["max_p99_ratio"]:
            verdict.update(decision="fail", killed_by={
                "gate": "max_p99_ratio", "bound": gates["max_p99_ratio"],
                "measured": ratio})
            return verdict
        verdict["decision"] = "pass"
        return verdict

    def promote_canary(self) -> dict:
        """Admit the canary host to stable routing (the token bucket
        stops; it now competes least-loaded like everyone else).
        Promotion is the caller's decision — evaluate first; this does
        not re-judge."""
        with self._lock:
            can = self._canary
            if can is None:
                raise RuntimeError("no active canary")
            self._canary = None
            self._canary_credit = 0.0
            self.promotions_total += 1
        return {"promoted": can["host"].base_url,
                "version": can["version"], "routed": can["routed"]}

    def rollback_canary(self, verdict: Optional[dict] = None,
                        reason: str = "") -> dict:
        """The rollback verb, router side: quarantine the canary host
        (it still HOLDS the rejected weights — it must not rejoin
        stable routing until reinstate()), drop its decode pins so
        sessions fail over by history re-prefill, and flush a
        flight-recorder artifact (reason ``"rollback"``) naming the
        rejected version and the gate delta that killed it. The weight
        store's own ``rollback()`` (serving/publish.py) repoints LATEST;
        the orchestrator calls both."""
        with self._lock:
            can = self._canary
            if can is None:
                raise RuntimeError("no active canary")
            h = can["host"]
            self._canary = None
            self._canary_credit = 0.0
            self._quarantined.add(h)
            self.rollbacks_total += 1
            dropped = [sid for sid, ph in self._affinity.items() if ph is h]
            for sid in dropped:
                del self._affinity[sid]
        detail = {"rejected_version": can["version"],
                  "host": h.base_url, "routed": can["routed"],
                  "fraction": can["fraction"],
                  "reason": reason or None,
                  "killed_by": (verdict or {}).get("killed_by"),
                  "deltas": (verdict or {}).get("deltas")}
        from deeplearning4j_tpu_torch.observability.flightrec import (
            get_flight_recorder)
        rec = get_flight_recorder()
        if rec is not None:
            rec.record_event("canary_rollback",
                             detail=json.dumps(detail, sort_keys=True))
            self.last_rollback_artifact = rec.flush("rollback")
        return {"rolled_back": h.base_url, "version": can["version"],
                "quarantined": True, "sessions_dropped": len(dropped),
                "artifact": self.last_rollback_artifact, **detail}

    def reinstate(self, base_url: str) -> bool:
        """Lift a rolled-back host's quarantine — AFTER it has been
        swapped back to good weights (hot_swap / restart on a good
        publication). Returns whether anything changed."""
        url = base_url.rstrip("/")
        with self._lock:
            for h in list(self._quarantined):
                if h.base_url == url:
                    self._quarantined.discard(h)
                    return True
        return False

    # ---------------------------------------------------------------- proxy
    def _proxy(self, h: HostHandle, path: str, body: bytes,
               trace_id: str, headers=None):
        """One request/reply over the host's pooled connection. Raises
        ``_HostDown`` on any connection-level failure. ``headers``
        carries the end-to-end scheduling headers (tenant / priority /
        deadline) hop to hop, exactly like the trace id. Every hop's
        [send, recv] window lands in the trace store on the router's
        own clock — the anchors the stitcher rebases every remote
        instance's spans against (a dead hop records with no status:
        the waterfall shows the attempt that failed over)."""
        conn = h.acquire()  # analysis: ok(C001) — pooled connection, not a lock; released/discarded below
        send_unix = time.time()
        try:
            hdrs = {"Content-Type": "application/json",
                    TRACE_HEADER: trace_id}
            if headers:
                hdrs.update(headers)
            conn.request("POST", path, body, hdrs)
            resp = conn.getresponse()
            data = resp.read()
            retry_after = resp.getheader("Retry-After")
            h.release(conn)
            self.trace_store.observe_network(
                trace_id, host=h.base_url, path=path,
                send_unix=send_unix, recv_unix=time.time(),
                status=resp.status)
            return resp.status, data, retry_after
        except (OSError, http.client.HTTPException) as e:
            h.discard(conn)
            self.trace_store.observe_network(
                trace_id, host=h.base_url, path=path,
                send_unix=send_unix, recv_unix=time.time())
            raise _HostDown(f"{h.base_url}: {type(e).__name__}: {e}")

    def _route(self, path: str, body: bytes, trace_id: str,
               pick_fn, headers=None, shed_klass=None) -> tuple:
        """Pick -> proxy -> on host death evict + retry on a survivor;
        on fleet-wide 503, shed with the aggregated Retry-After (and
        the shed class, accounted per class in the scheduler).
        Returns (status, payload bytes, headers list)."""
        tried: List[HostHandle] = []
        retry_afters: List[float] = []
        while True:
            h = pick_fn(tried)
            if h is None:
                break
            h.enter()
            try:
                status, data, ra = self._proxy(h, path, body, trace_id,
                                               headers)
            except _HostDown:
                self._evict(h)
                tried.append(h)
                with self._lock:
                    self.retried_total += 1
                continue
            finally:
                h.leave()
            if status == 503:
                # overloaded (or draining) host: try the others before
                # bouncing the client — that IS the front door's job
                if ra is not None:
                    try:
                        retry_afters.append(float(ra))
                    except ValueError:
                        pass
                tried.append(h)
                continue
            return status, data, [(BACKEND_HEADER, h.base_url)], h
        if tried:
            with self._lock:
                self.shed_total += 1
            k = _sched.normalize_class(shed_klass)
            if self.scheduler is not None:
                self.scheduler.record_shed(k)
            ra = self._min_retry_after(retry_afters)
            return (503,
                    json.dumps({"error": "all hosts overloaded or "
                                         "unreachable"}).encode(),
                    [("Retry-After", f"{ra:g}"),
                     (_sched.SHED_CLASS_HEADER, k)], None)
        raise NoHostsError("no routable backend hosts")

    def _front_door_admit(self, sched) -> Optional[tuple]:
        """Run the scheduler BEFORE any backend round trip.
        Quota and deadline sheds are decided entirely from router-local
        state (token buckets; the min pushed retry_after_s as the wait
        estimate), so a doomed request costs nothing downstream. The
        class watermark runs here only when ``sched_capacity`` gives
        the router an aggregate queue bound — otherwise the hosts'
        own schedulers enforce it against their real capacity. Returns
        a (status, body, headers) 503 triple on shed, None on admit."""
        if self.scheduler is None:
            return None
        sched = sched or {}
        depth = capacity = None
        if self.sched_capacity:
            capacity = self.sched_capacity
            depth = sum(int(r.get("queue_depth") or 0)
                        for r in self._fed_rows().values() if r["live"])
        wait = None
        if sched.get("deadline_ms") is not None:
            wait = self._min_retry_after([])
        try:
            self.scheduler.admit(
                tenant=sched.get("tenant"), klass=sched.get("klass"),
                deadline_ms=sched.get("deadline_ms"),
                depth=depth, capacity=capacity, wait_estimate_s=wait)
        except _sched.ShedError as e:
            with self._lock:
                self.shed_total += 1
            ra = self._min_retry_after([])
            return (503, json.dumps({"error": f"overloaded: {e}"}).encode(),
                    [("Retry-After", f"{ra:g}"),
                     (_sched.SHED_CLASS_HEADER, e.klass)])
        return None

    # ------------------------------------------------------------- endpoints
    def handle_predict(self, body: bytes, trace_id: str,
                       sched=None) -> tuple:
        shed = self._front_door_admit(sched)
        if shed is not None:
            return shed
        with self._lock:
            self.requests_total += 1
        return self._route("/predict", body, trace_id,
                           self._pick_canary_admitted,
                           headers=_sched.build_sched_headers(sched),
                           shed_klass=(sched or {}).get("klass"))[:3]

    def handle_decode(self, payload: dict, trace_id: str,
                      sched=None) -> tuple:
        """Session-affine proxy for the host /decode protocol. The
        router owns the canonical token history; the host request
        always carries it, so ANY host can serve the step by
        re-prefilling (the host's DecodeEngine does exactly that for an
        unknown sid)."""
        op = payload.get("op")
        sid = payload.get("sid")
        if not sid or op not in ("prefill", "step", "generate", "close"):
            return (400, json.dumps(
                {"error": "decode payload needs op "
                          "(prefill|step|generate|close) and sid"})
                .encode(), [])
        fwd = _sched.build_sched_headers(sched)
        sk = (sched or {}).get("klass")
        if op != "close":
            # close is cleanup, never shed — a quota-exhausted tenant
            # must still be able to release its pool pages
            shed = self._front_door_admit(sched)
            if shed is not None:
                return shed
        if op == "prefill":
            ids = [int(i) for i in payload.get("ids") or ()]
            if not ids:
                return (400, json.dumps(
                    {"error": "prefill needs ids"}).encode(), [])
            with self._lock:
                self._history[sid] = list(ids)
            body = json.dumps({"op": "prefill", "sid": sid,
                               "ids": ids}).encode()
            status, data, headers, _ = self._route(
                "/decode", body, trace_id,
                lambda tried: (self._pick_affine(sid) if not tried
                               else self._pick(exclude=tried)),
                headers=fwd, shed_klass=sk)
            return status, data, headers
        if op == "close":
            # broadcast to EVERY live host, not just the pinned one: a
            # session that failed over (or whose prefix pages were
            # adopted after an eviction elsewhere) holds pool pages on
            # hosts it is no longer pinned to, and close must release
            # those page references fleet-wide. Close is idempotent on
            # hosts that never saw the sid, so this needs no protocol
            # change — `closed` reports whether ANY host knew it.
            with self._lock:
                self._history.pop(sid, None)
                pinned = self._affinity.pop(sid, None)
                hosts = [h for h in self._hosts if h.status == LIVE]
            if pinned is not None and pinned not in hosts \
                    and pinned.status == LIVE:
                hosts.append(pinned)
            closed = False
            body = json.dumps({"op": "close", "sid": sid}).encode()
            served = pinned
            for h in hosts:
                try:
                    status, data, ra = self._proxy(h, "/decode", body,
                                                   trace_id)
                    if status == 200 and json.loads(
                            data.decode() or "{}").get("closed"):
                        closed = True
                        served = h
                except _HostDown:
                    self._evict(h)
            backend = [(BACKEND_HEADER, served.base_url)] \
                if served is not None else []
            return 200, json.dumps({"closed": closed}).encode(), backend
        if op == "generate":
            # multi-token proxy: the host runs the whole greedy loop
            # (speculatively when its engine carries a draft); the
            # router still owns the canonical history, so failover and
            # replay semantics match step — history grows only by the
            # tokens a 200 reply confirmed
            with self._lock:
                ids = [int(i) for i in (payload.get("ids")
                                        or self._history.get(sid) or ())]
            if not ids:
                return (400, json.dumps(
                    {"error": "generate needs ids (or a prior "
                              "prefill)"}).encode(), [])
            with self._lock:
                self._history[sid] = list(ids)

            def gpick(tried):
                if not tried:
                    return self._pick_affine(sid)
                h = self._pick(exclude=tried)
                if h is not None:
                    with self._lock:
                        self.failovers_total += 1
                        self.affinity_misses += 1
                        self._affinity[sid] = h
                return h

            body = json.dumps({
                "op": "generate", "sid": sid, "ids": ids,
                "n_tokens": int(payload.get("n_tokens", 0))}).encode()
            status, data, headers, _ = self._route(
                "/decode", body, trace_id, gpick,
                headers=fwd, shed_klass=sk)
            if status == 200:
                toks = json.loads(data.decode() or "{}").get("tokens") \
                    or ()
                with self._lock:
                    hist = self._history.get(sid)
                    if hist is not None:
                        hist.extend(int(t) for t in toks)
                    self.decode_steps_total += len(toks)
            return status, data, headers
        # step
        with self._lock:
            history = list(self._history.get(sid) or ())
            self.decode_steps_total += 1
        if not history:
            return (404, json.dumps(
                {"error": f"unknown decode session '{sid}'"}).encode(), [])
        token = int(payload["token"])

        def pick(tried):
            if not tried:
                return self._pick_affine(sid)
            # failover mid-step: the pinned host just died under us —
            # re-pin to a survivor; its engine recovers from `ids`
            h = self._pick(exclude=tried)
            if h is not None:
                with self._lock:
                    self.failovers_total += 1
                    self.affinity_misses += 1
                    self._affinity[sid] = h
            return h

        body = json.dumps({"op": "step", "sid": sid, "token": token,
                           "ids": history}).encode()
        status, data, headers, _ = self._route("/decode", body, trace_id,
                                               pick, headers=fwd,
                                               shed_klass=sk)
        if status == 200:
            # history grows only on a confirmed reply: a retried lost
            # reply re-sends the SAME history, so the survivor's
            # re-prefill replays the session bit-identically
            with self._lock:
                hist = self._history.get(sid)
                if hist is not None:
                    hist.append(token)
        return status, data, headers

    def handle_hosts(self, payload: dict) -> tuple:
        """POST /api/hosts — topology as an HTTP verb, symmetric with
        eviction: ``{"url": ..., "action": "add"}`` registers a backend
        (the autoscaler's cross-host actuator calls this after the
        launcher boots a warm child), ``"evict"`` removes one. The next
        /api/fleet scrape reflects the change — the routing table and
        the federation scoreboard are both derived, not cached."""
        url = str(payload.get("url") or "").rstrip("/")
        action = payload.get("action") or "add"
        if not url or action not in ("add", "evict"):
            return 400, {"error": "needs url and action (add|evict)"}
        if action == "add":
            existing = next((h for h in self.hosts
                             if h.base_url == url and h.status == LIVE),
                            None)
            added = existing is None
            if added:
                self.add_host(url)
            return 200, {"ok": True, "action": "add", "url": url,
                         "added": added, "hosts": len(self.hosts)}
        target = next((h for h in self.hosts
                       if h.base_url == url and h.status == LIVE), None)
        if target is not None:
            self._evict(target)
        return 200, {"ok": True, "action": "evict", "url": url,
                     "evicted": target is not None,
                     "hosts": len(self.hosts)}

    # ----------------------------------------------------------------- state
    def route_table(self) -> List[dict]:
        """Per-host routing rows: status, load signals, traffic — the
        /api/fleet 'routing' section and the dashboard scoreboard."""
        fed = self._fed_rows()
        rows = []
        for h in self.hosts:
            row = fed.get(h.base_url)
            d = h.describe()
            d.update({
                "instance": row["instance"] if row else None,
                "routable": h.status == LIVE and (row is None
                                                  or row["live"]),
                "queue_depth": (row or {}).get("queue_depth"),
                "retry_after_s": (row or {}).get("retry_after_s"),
                "drain_rate_rows_per_s":
                    (row or {}).get("drain_rate_rows_per_s"),
                "heartbeat_age_s": (row or {}).get("heartbeat_age_s"),
            })
            rows.append(d)
        return rows

    def describe(self) -> dict:
        with self._lock:
            can = self._canary
            return {
                "hosts": len(self._hosts),
                "requests_total": self.requests_total,
                "decode_steps_total": self.decode_steps_total,
                "retried_total": self.retried_total,
                "evicted_total": self.evicted_total,
                "auto_evicted_total": self.auto_evicted_total,
                "failovers_total": self.failovers_total,
                "affinity_hits": self.affinity_hits,
                "affinity_misses": self.affinity_misses,
                "shed_total": self.shed_total,
                "sessions_live": len(self._history),
                "canary": (None if can is None else {
                    "host": can["host"].base_url,
                    "version": can["version"],
                    "fraction": can["fraction"],
                    "routed": can["routed"]}),
                "canary_routed_total": self.canary_routed_total,
                "rollbacks_total": self.rollbacks_total,
                "promotions_total": self.promotions_total,
                "quarantined": sorted(h.base_url
                                      for h in self._quarantined),
                "sched": (self.scheduler.snapshot()
                          if self.scheduler is not None else None),
            }

    def healthz(self) -> tuple:
        rows = self.route_table()
        n_live = sum(1 for r in rows if r["routable"])
        if rows and n_live == 0:
            return 503, {"status": "unhealthy",
                         "reason": "no routable backend hosts",
                         "hosts": rows}
        # some hosts down but traffic still flows: degraded, not down —
        # the fleet's own semantics, one level up
        status = "ok" if n_live == len(rows) else "degraded"
        return 200, {"status": status, "hosts": rows,
                     "router": self.describe()}

    def fleet_payload(self) -> dict:
        payload = self.federation.fleet_payload()
        payload["routing"] = self.route_table()
        payload["router"] = self.describe()
        # advance the SLO windows from the freshest federation rows
        # before reporting — /api/fleet is the bench's polling surface
        self.slo_engine.ingest_fed_rows(self.federation.health())
        payload["slo"] = self.slo_engine.report()
        payload["trace_store"] = self.trace_store.describe()
        return payload

    def _attach_registry_collector(self):
        """The router's own counters as registry families — rendered by
        its ``/metrics`` exposition via the federation AND carried by
        its push_url heartbeats (export_snapshot reads the same
        registry), so a dashboard sees canary/promotion/rollback state
        with no new endpoints."""
        from deeplearning4j_tpu_torch.observability.metrics import MetricFamily

        def _collect():
            d = self.describe()
            L = {"router": f"{self.host}:{self.port}"}
            fams = []

            def fam(name, kind, help, value):
                fams.append(MetricFamily(name, kind, help).add(value, L))

            fam("dl4j_router_requests_total", "counter",
                "/predict requests through the front door",
                d["requests_total"])
            fam("dl4j_router_evicted_total", "counter",
                "Hosts evicted (connection death + heartbeat silence)",
                d["evicted_total"])
            fam("dl4j_router_auto_evicted_total", "counter",
                "Hosts auto-evicted for heartbeat silence past "
                "evict_after_factor x stale_after_s",
                d["auto_evicted_total"])
            fam("dl4j_router_canary_routed_total", "counter",
                "Requests token-bucket-admitted to canary hosts",
                d["canary_routed_total"])
            fam("dl4j_router_canary_fraction", "gauge",
                "Active canary traffic fraction (0 = no canary)",
                (d["canary"] or {}).get("fraction") or 0.0)
            fam("dl4j_router_promotions_total", "counter",
                "Canary versions promoted to stable routing",
                d["promotions_total"])
            fam("dl4j_router_rollbacks_total", "counter",
                "Canary versions rolled back by their gates",
                d["rollbacks_total"])
            # fleet SLO gauges: every scrape/push folds the freshest
            # federation counters into the sliding windows, then
            # renders attainment / burn-rate / budget-remaining
            self.slo_engine.ingest_fed_rows(self.federation.health())
            fams.extend(self.slo_engine.families())
            # front-door scheduler families (dl4j_sched_*) — the
            # router-side view of quota/class/deadline sheds
            if self.scheduler is not None:
                fams.extend(self.scheduler.metric_families(L))
            return fams

        reg = _obs_metrics.get_registry()
        reg.register_collector(_collect)
        self._registry_collector = (reg, _collect)

    # ---------------------------------------------------------------- server
    def start(self) -> "FrontDoorRouter":
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass

            def _json(self, obj, code=200, headers=()):
                body = obj if isinstance(obj, bytes) \
                    else json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path.startswith("/healthz"):
                    code, obj = router.healthz()
                    self._json(obj, code)
                elif self.path.startswith("/api/fleet"):
                    self._json(router.fleet_payload())
                elif self.path.startswith("/api/trace"):
                    tid = self.path[len("/api/trace"):].strip("/")
                    tid = tid.split("?", 1)[0]
                    if tid:
                        wf = router.trace_store.waterfall(tid)
                        self._json(wf, 200 if wf["found"] else 404)
                    else:
                        self._json({
                            "traces": router.trace_store.trace_ids(),
                            "store": router.trace_store.describe()})
                elif self.path.startswith("/metrics"):
                    if _obs_metrics.wants_prometheus(
                            self.headers.get("Accept", ""), self.path):
                        # merged fleet exposition: every host's pushed
                        # families instance-labeled + the fleet rollup
                        text = router.federation.render_prometheus()
                        body = text.encode()
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            _obs_metrics.PROMETHEUS_CONTENT_TYPE)
                        self.send_header("Content-Length",
                                         str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._json(router.describe())
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):  # noqa: N802
                trace_id = (self.headers.get(TRACE_HEADER)
                            or new_trace_id())
                sched = _sched.parse_sched_headers(self.headers)
                # echo the scheduling headers back like the trace id —
                # the client sees the normalized class it was admitted
                # (or shed) as, plus its own tenant/deadline
                echo = ((TRACE_HEADER, trace_id),
                        (_sched.PRIORITY_HEADER, sched["klass"]))
                if sched["tenant"]:
                    echo += ((_sched.TENANT_HEADER, sched["tenant"]),)
                if sched["deadline_ms"] is not None:
                    echo += ((_sched.DEADLINE_HEADER,
                              f"{sched['deadline_ms']:g}"),)
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                try:
                    if self.path.startswith("/predict"):
                        code, data, hdrs = router.handle_predict(
                            body, trace_id, sched)
                    elif self.path.startswith("/decode"):
                        code, data, hdrs = router.handle_decode(
                            json.loads(body.decode()), trace_id, sched)
                    elif self.path.startswith("/api/hosts"):
                        code, obj = router.handle_hosts(
                            json.loads(body.decode() or "{}"))
                        data, hdrs = json.dumps(obj).encode(), []
                    elif self.path.startswith("/api/metrics_push"):
                        snap = json.loads(body.decode())
                        tag = router.federation.ingest(snap)
                        # same push, second consumer: any span batch
                        # riding the snapshot lands in the trace store
                        router.trace_store.ingest_snapshot(snap)
                        code, data, hdrs = 200, json.dumps(
                            {"ok": True, "instance": tag}).encode(), []
                    else:
                        code, data, hdrs = 404, json.dumps(
                            {"error": "not found"}).encode(), []
                except NoHostsError as e:
                    code, data, hdrs = 503, json.dumps(
                        {"error": str(e)}).encode(), []
                except Exception as e:
                    code, data, hdrs = 400, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(), []
                self._json(data, code, tuple(hdrs) + echo)

        class _RouterHTTPServer(ThreadingHTTPServer):
            request_queue_size = 128
            daemon_threads = True

        self._httpd = _RouterHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._attach_registry_collector()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        if self._push_url:
            # the router is a fleet member too: its pushed health
            # payload carries the routing table, so a dashboard
            # UIServer's scoreboard renders it without new endpoints
            self._pusher = HeartbeatPusher(
                self._push_url, self._push_interval_s,
                health_fn=lambda: {"router_healthy": True,
                                   "server_url": self.url,
                                   "routing": self.route_table(),
                                   "router": self.describe()}).start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._pusher is not None:
            self._pusher.stop()
            self._pusher = None
        if self._registry_collector is not None:
            reg, collect = self._registry_collector
            reg.unregister_collector(collect)
            self._registry_collector = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for h in self.hosts:
            h.close()
