"""Open-loop, trace-driven traffic generation (counterpart of
deeplearning4j_tpu/scheduling/loadgen.py).

A closed loop (each client waits for its reply) can never overload a
server: the offered rate falls as latency grows. Users arrive on their
own clock, so this module generates open-loop traffic:

- **Seeded arrival trace.** ``TrafficModel.arrivals()`` materializes one
  deterministic list of ``Arrival`` events from a seed: a nonhomogeneous
  Poisson process (thinning against the peak rate) whose intensity
  follows a diurnal sinusoid plus configured flash crowds. Same seed,
  same trace.
- **Heavy-tailed sizes.** Row counts draw from a clipped Pareto.
- **Mixed tenants and classes.** Each arrival carries a tenant, an
  admission class from configured weights and the class's deadline: the
  X-DL4J-Tenant / X-DL4J-Priority / X-DL4J-Deadline-Ms headers.
- **Sessions with think time.** A fraction of arrivals continue a
  session; think time shifts the scheduled arrival, never waits for a
  reply.

``OpenLoopRunner`` replays the trace against a ``submit_fn``: a
dispatcher thread releases each arrival at its offset into a worker pool
and never waits for completions. ``attainment`` summarizes the outcome
records per class (latency percentiles, rows/s, sheds).
"""

from __future__ import annotations

import math
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Arrival", "TrafficModel", "OpenLoopRunner", "attainment"]


@dataclass
class Arrival:
    """One scheduled request: fires at offset ``t`` seconds from the
    run start, no matter what happened to every earlier request."""
    t: float
    tenant: str
    klass: str
    rows: int
    deadline_ms: Optional[float] = None
    session: Optional[str] = None

    def headers(self) -> Dict[str, str]:
        from deeplearning4j_tpu_torch.scheduling.core import (
            DEADLINE_HEADER, PRIORITY_HEADER, TENANT_HEADER)
        h = {TENANT_HEADER: self.tenant, PRIORITY_HEADER: self.klass}
        if self.deadline_ms is not None:
            h[DEADLINE_HEADER] = f"{self.deadline_ms:g}"
        return h


@dataclass
class _Phase:
    """Flash crowd: multiply the base intensity by ``mult`` over
    [start, start+duration)."""
    start: float
    duration: float
    mult: float


class TrafficModel:
    """Deterministic open-loop arrival trace.

    ``class_mix`` / ``tenants`` map name -> weight; ``deadlines_ms``
    maps class -> deadline header value (None omits the header).
    ``base_rps`` is the diurnal *mean*; the sinusoid swings it by
    ``diurnal_amplitude`` over ``diurnal_period_s``; each
    ``flash_crowd`` (start_s, duration_s, multiplier) multiplies the
    instantaneous rate. ``session_fraction`` of arrivals spawn a
    follow-up ``think_s`` later under the same session id (same
    tenant/class — a user, not a new one)."""

    def __init__(self, *, seed: int = 0, duration_s: float,
                 base_rps: float, diurnal_amplitude: float = 0.3,
                 diurnal_period_s: float = 60.0,
                 flash_crowds: Sequence[Tuple[float, float, float]] = (),
                 class_mix: Optional[Dict[str, float]] = None,
                 tenants: Optional[Dict[str, float]] = None,
                 deadlines_ms: Optional[Dict[str, float]] = None,
                 pareto_alpha: float = 1.6, max_rows: int = 8,
                 session_fraction: float = 0.0,
                 think_s: float = 1.0):
        from deeplearning4j_tpu_torch.scheduling.core import BATCH, INTERACTIVE
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.base_rps = float(base_rps)
        self.diurnal_amplitude = float(diurnal_amplitude)
        self.diurnal_period_s = float(diurnal_period_s)
        self.phases = [_Phase(*fc) for fc in flash_crowds]
        self.class_mix = dict(class_mix or {INTERACTIVE: 0.5, BATCH: 0.5})
        self.tenants = dict(tenants or {"default": 1.0})
        self.deadlines_ms = dict(deadlines_ms or {})
        self.pareto_alpha = float(pareto_alpha)
        self.max_rows = int(max_rows)
        self.session_fraction = float(session_fraction)
        self.think_s = float(think_s)

    # ------------------------------------------------------------- intensity
    def rate_at(self, t: float) -> float:
        """Offered requests/sec at offset ``t`` — diurnal sinusoid
        times any active flash-crowd multiplier. Exposed so the bench
        can publish the offered-load curve next to attainment."""
        r = self.base_rps * (1.0 + self.diurnal_amplitude * math.sin(
            2.0 * math.pi * t / self.diurnal_period_s))
        for p in self.phases:
            if p.start <= t < p.start + p.duration:
                r *= p.mult
        return max(r, 0.0)

    def peak_rate(self) -> float:
        base_peak = self.base_rps * (1.0 + abs(self.diurnal_amplitude))
        mult = max((p.mult for p in self.phases), default=1.0)
        return base_peak * max(mult, 1.0)

    # --------------------------------------------------------------- drawing
    def _weighted(self, rng: random.Random, table: Dict[str, float]) -> str:
        names = list(table)
        total = sum(table.values())
        x = rng.random() * total
        for n in names:
            x -= table[n]
            if x <= 0:
                return n
        return names[-1]

    def _rows(self, rng: random.Random) -> int:
        # clipped Pareto: P(X > x) ~ x^-alpha, floor 1, cap max_rows
        x = rng.paretovariate(self.pareto_alpha)
        return max(1, min(self.max_rows, int(x)))

    def arrivals(self) -> List[Arrival]:
        """Materialize the whole trace (sorted by t). Thinning: draw
        candidate times from a homogeneous Poisson at the peak rate,
        keep each with probability rate(t)/peak — the textbook
        nonhomogeneous sampler, deterministic under the seed."""
        rng = random.Random(self.seed)
        peak = self.peak_rate()
        if peak <= 0:
            return []
        out: List[Arrival] = []
        t = 0.0
        n_sessions = 0
        while True:
            t += rng.expovariate(peak)
            if t >= self.duration_s:
                break
            if rng.random() * peak > self.rate_at(t):
                continue
            tenant = self._weighted(rng, self.tenants)
            klass = self._weighted(rng, self.class_mix)
            a = Arrival(t=round(t, 6), tenant=tenant, klass=klass,
                        rows=self._rows(rng),
                        deadline_ms=self.deadlines_ms.get(klass))
            out.append(a)
            if rng.random() < self.session_fraction:
                # a session user: reply -> think -> follow-up, scheduled
                # now (open loop — the follow-up fires on time even if
                # the first request is still queued somewhere)
                n_sessions += 1
                sid = f"s{self.seed}-{n_sessions}"
                a.session = sid
                t2 = t + max(0.05, rng.expovariate(1.0 / self.think_s))
                if t2 < self.duration_s:
                    out.append(Arrival(
                        t=round(t2, 6), tenant=tenant, klass=klass,
                        rows=self._rows(rng),
                        deadline_ms=self.deadlines_ms.get(klass),
                        session=sid))
        out.sort(key=lambda a: a.t)
        return out


@dataclass
class _Outcome:
    arrival: Arrival
    t_sent: float
    latency_ms: Optional[float] = None
    status: Optional[int] = None
    shed_class: Optional[str] = None
    error: Optional[str] = None
    extra: dict = field(default_factory=dict)


class OpenLoopRunner:
    """Replay an arrival trace against ``submit_fn(arrival) -> dict``.

    The dispatcher thread sleeps until each arrival's offset and hands
    it to a worker pool — it never waits for a completion before
    releasing the next arrival, which is the entire point. Workers
    record one outcome row per arrival: ``submit_fn`` returns
    ``{"status": int, "shed_class": str|None, ...}`` (extra keys are
    kept) or raises — an exception records as status None with the
    error string, still one row (offered load is accounted even when
    the fleet drops the connection).

    ``max_workers`` bounds concurrency; when all workers are busy the
    backlog queues HERE, time-stamped at the intended offset, so
    latency accounting still measures from the scheduled arrival (what
    the user experienced) rather than from the delayed send."""

    def __init__(self, submit_fn, arrivals: Sequence[Arrival], *,
                 max_workers: int = 32, clock=time.monotonic,
                 sleep=time.sleep):
        self._submit = submit_fn
        self.arrivals = list(arrivals)
        self.max_workers = int(max_workers)
        self._clock = clock
        self._sleep = sleep
        self.outcomes: List[_Outcome] = []
        self._out_lock = threading.Lock()

    def run(self) -> List[dict]:
        from concurrent.futures import ThreadPoolExecutor
        t0 = self._clock()
        with ThreadPoolExecutor(max_workers=self.max_workers,
                                thread_name_prefix="loadgen") as pool:
            for a in self.arrivals:
                delay = a.t - (self._clock() - t0)
                if delay > 0:
                    self._sleep(delay)
                pool.submit(self._one, a, t0)
        # pool __exit__ joined every worker; rows are complete
        return [self._row(o, t0) for o in
                sorted(self.outcomes, key=lambda o: o.arrival.t)]

    def _one(self, a: Arrival, t0: float):
        o = _Outcome(arrival=a, t_sent=self._clock() - t0)
        try:
            res = self._submit(a) or {}
            o.status = res.get("status")
            o.shed_class = res.get("shed_class")
            o.extra = {k: v for k, v in res.items()
                       if k not in ("status", "shed_class")}
        except Exception as e:
            o.error = f"{type(e).__name__}: {e}"
        # latency from the SCHEDULED arrival: queueing delay inside the
        # harness counts against the fleet, as it does for a real user
        o.latency_ms = max(0.0, (self._clock() - t0 - a.t) * 1000.0)
        with self._out_lock:
            self.outcomes.append(o)

    def _row(self, o: _Outcome, t0: float) -> dict:
        a = o.arrival
        row = {"t": a.t, "tenant": a.tenant, "class": a.klass,
               "rows": a.rows, "deadline_ms": a.deadline_ms,
               "session": a.session, "status": o.status,
               "latency_ms": (None if o.latency_ms is None
                              else round(o.latency_ms, 3)),
               "shed_class": o.shed_class, "error": o.error}
        row.update(o.extra)
        return row


def attainment(rows: Sequence[dict], klass: str,
               slo_ms: Optional[float] = None,
               window: Optional[Tuple[float, float]] = None) -> dict:
    """SLO attainment for one class over (optionally) one time window:
    offered = every arrival of the class, attained = 200 replies whose
    latency met the request's own deadline (falling back to ``slo_ms``
    when the arrival carried none). Sheds and errors count as offered
    but never attained — an open-loop generator's denominator is what
    was ASKED, not what was admitted."""
    sel = [r for r in rows if r["class"] == klass
           and (window is None or window[0] <= r["t"] < window[1])]
    offered = len(sel)
    ok = 0
    lat = []
    for r in sel:
        if r["status"] == 200 and r["latency_ms"] is not None:
            lat.append(r["latency_ms"])
            bound = r.get("deadline_ms") or slo_ms
            if bound is None or r["latency_ms"] <= float(bound):
                ok += 1
    lat.sort()

    def pct(p):
        return round(lat[min(len(lat) - 1,
                             int(p * len(lat)))], 3) if lat else None
    return {"class": klass, "offered": offered, "attained": ok,
            "attainment": round(ok / offered, 4) if offered else None,
            "served": len(lat), "p50_ms": pct(0.50), "p99_ms": pct(0.99)}
