"""Closed-loop autoscaler (counterpart of
deeplearning4j_tpu/scheduling/autoscaler.py).

The controller owns no infrastructure: signals come in through one
callable and actuation goes out through two (``up``, ``down``).
``ReplicaSetActuator`` wraps ``ReplicaSet.drain(i)`` / ``restart(i)``:
a parked slot restarts over the same forward, so it builds no kernel.
``fleet_signals(router)`` reads the signal bundle off a
``FrontDoorRouter``'s federation.

Control discipline (pinned by tests on an injected clock):

- **Hysteresis**: ``breach_n`` consecutive breached observations arm a
  scale-up, ``clear_n`` consecutive idle ones arm a scale-down.
- **Cooldowns**: ``up_cooldown_s`` / ``down_cooldown_s`` must pass after
  an action before the next one in that direction.
- **Bounds**: ``min_size`` / ``max_size`` clamp; at the bound the
  controller holds with ``at_max`` / ``at_min``.

Reaction time: the first breached observation of an episode stamps
``breach_started``; the scale-up that answers it sets
``last_reaction_s``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from deeplearning4j_tpu_torch.analysis.guards import guarded_by

__all__ = ["Autoscaler", "ReplicaSetActuator", "fleet_signals"]


def fleet_signals(router) -> dict:
    """The standard signal bundle read off a ``FrontDoorRouter``'s
    federation plane: total pushed queue depth, worst derived
    retry-after, worst SLO burn rate, live host count. This is a plain
    function (not a method) so a bench or operator loop can point the
    autoscaler at any router — including one in another process via
    its ``/api/fleet`` payload shaped the same way."""
    rows = router.federation.health()
    depth = 0
    retry_after = 0.0
    for row in rows:
        if not row.get("live"):
            continue
        depth += int(row.get("queue_depth") or 0)
        ra = row.get("retry_after_s")
        if ra is not None:
            retry_after = max(retry_after, float(ra))
    burn = 0.0
    try:
        router.slo_engine.ingest_fed_rows(rows)
        for windows in router.slo_engine.evaluate().values():
            for w in windows.values():
                b = w.get("burn_rate")
                if b is not None:
                    burn = max(burn, float(b))
    except Exception:
        pass  # a broken SLO source must not blind the depth signals
    live_hosts = sum(1 for h in router.hosts if h.status == "live")
    return {"queue_depth": depth, "retry_after_s": retry_after,
            "burn_rate": burn, "size": live_hosts}


@guarded_by("_lock", "size", "breach_streak", "clear_streak",
            "breach_started", "last_up_at", "last_down_at",
            "scale_ups_total", "scale_downs_total", "breaches_total",
            "last_reaction_s", "last_decision", "_thread", "_stop")
class Autoscaler:
    """Observe → decide → actuate, with hysteresis, cooldowns and
    bounds. ``signals_fn()`` returns a dict with any of
    ``queue_depth`` / ``retry_after_s`` / ``burn_rate`` (and optionally
    ``size`` — authoritative current capacity; otherwise the
    controller's own count is used). ``up()`` / ``down()`` perform one
    unit of scaling and return truthy on success.

    Thresholds are opt-in: only the ones passed non-None participate,
    and a breach is ANY armed threshold exceeded (queues lag burn
    rate, burn rate lags queues — either alone is cause)."""

    def __init__(self, *, signals_fn: Callable[[], dict],
                 up: Callable[[], object],
                 down: Optional[Callable[[], object]] = None,
                 min_size: int = 1, max_size: int = 4,
                 up_queue_depth: Optional[float] = None,
                 up_retry_after_s: Optional[float] = None,
                 up_burn_rate: Optional[float] = None,
                 down_queue_depth: float = 0.0,
                 breach_n: int = 2, clear_n: int = 10,
                 up_cooldown_s: float = 5.0, down_cooldown_s: float = 60.0,
                 interval_s: float = 0.5, clock=time.monotonic):
        if min_size < 0 or max_size < max(1, min_size):
            raise ValueError("need 0 <= min_size <= max_size, max_size >= 1")
        self._signals_fn = signals_fn
        self._up = up
        self._down = down
        self.min_size = int(min_size)
        self.max_size = int(max_size)
        self.up_queue_depth = up_queue_depth
        self.up_retry_after_s = up_retry_after_s
        self.up_burn_rate = up_burn_rate
        self.down_queue_depth = float(down_queue_depth)
        self.breach_n = int(breach_n)
        self.clear_n = int(clear_n)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self.size = self.min_size          # best-effort if signals lack it
        self.breach_streak = 0
        self.clear_streak = 0
        self.breach_started: Optional[float] = None
        self.last_up_at: Optional[float] = None
        self.last_down_at: Optional[float] = None
        self.scale_ups_total = 0
        self.scale_downs_total = 0
        self.breaches_total = 0
        self.last_reaction_s: Optional[float] = None
        self.last_decision = "idle"
        self._thread = None
        self._stop = threading.Event()

    # -------------------------------------------------------------- decision
    def _breached(self, sig: dict) -> bool:
        if self.up_queue_depth is not None and \
                float(sig.get("queue_depth") or 0) >= self.up_queue_depth:
            return True
        if self.up_retry_after_s is not None and \
                float(sig.get("retry_after_s") or 0) >= self.up_retry_after_s:
            return True
        if self.up_burn_rate is not None and \
                float(sig.get("burn_rate") or 0) >= self.up_burn_rate:
            return True
        return False

    def step(self) -> dict:
        """One observe-decide-actuate cycle; returns the decision
        record (also kept as ``last_decision`` for the gauges). Safe to
        call from a bench loop instead of ``start()``."""
        sig = self._signals_fn() or {}
        now = self._clock()
        breached = self._breached(sig)
        with self._lock:
            if "size" in sig and sig["size"] is not None:
                self.size = int(sig["size"])
            if breached:
                self.breaches_total += 1
                self.breach_streak += 1
                self.clear_streak = 0
                if self.breach_started is None:
                    self.breach_started = now
            else:
                self.breach_streak = 0
                idle = float(sig.get("queue_depth") or 0) \
                    <= self.down_queue_depth
                self.clear_streak = self.clear_streak + 1 if idle else 0
                if self.clear_streak >= self.clear_n:
                    # episode over: the next breach starts a new
                    # reaction-time clock
                    self.breach_started = None
            decision, why = self._decide_locked(now)
            self.last_decision = decision
        acted = None
        if decision == "up":
            acted = self._up()
            with self._lock:
                if acted:
                    self.scale_ups_total += 1
                    self.last_up_at = self._clock()
                    if self.breach_started is not None:
                        self.last_reaction_s = round(
                            self.last_up_at - self.breach_started, 3)
                    self.size += 1
                    self.breach_streak = 0
                else:
                    self.last_decision = "up_failed"
        elif decision == "down" and self._down is not None:
            acted = self._down()
            with self._lock:
                if acted:
                    self.scale_downs_total += 1
                    self.last_down_at = self._clock()
                    self.size -= 1
                    self.clear_streak = 0
        return {"decision": decision, "why": why, "signals": sig,
                "acted": bool(acted)}

    def _decide_locked(self, now: float):
        if self.breach_streak >= self.breach_n:
            if self.size >= self.max_size:
                return "hold", "at_max"
            if self.last_up_at is not None and \
                    now - self.last_up_at < self.up_cooldown_s:
                return "hold", "up_cooldown"
            return "up", "breach"
        if self._down is not None and self.clear_streak >= self.clear_n:
            if self.size <= self.min_size:
                return "hold", "at_min"
            last_act = max(x for x in (self.last_up_at, self.last_down_at,
                                       float("-inf")) if x is not None)
            if last_act != float("-inf") and \
                    now - last_act < self.down_cooldown_s:
                return "hold", "down_cooldown"
            return "down", "idle"
        return "hold", "settling"

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "Autoscaler":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            t = threading.Thread(target=self._loop, daemon=True,
                                 name="autoscaler")
            t.start()
            self._thread = t
        return self

    def stop(self):
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:
                # a failed observation/actuation must not kill the
                # control loop — the next tick re-evaluates
                continue

    # --------------------------------------------------------------- metrics
    def snapshot(self) -> dict:
        with self._lock:
            return {"size": self.size,
                    "min_size": self.min_size, "max_size": self.max_size,
                    "breach_streak": self.breach_streak,
                    "clear_streak": self.clear_streak,
                    "breaches_total": self.breaches_total,
                    "scale_ups_total": self.scale_ups_total,
                    "scale_downs_total": self.scale_downs_total,
                    "last_reaction_s": self.last_reaction_s,
                    "last_decision": self.last_decision}

    def metric_families(self, labels=None):
        """``dl4j_autoscaler_*`` families (OBSERVABILITY.md)."""
        from deeplearning4j_tpu_torch.observability.metrics import MetricFamily
        L = dict(labels or {})
        snap = self.snapshot()
        fams = []

        def fam(name, kind, help, value):
            fams.append(MetricFamily(name, kind, help).add(value, L))

        fam("dl4j_autoscaler_size", "gauge",
            "Capacity units (hosts or replicas) under control",
            snap["size"])
        fam("dl4j_autoscaler_breaches_total", "counter",
            "Observations with any scale-up threshold exceeded",
            snap["breaches_total"])
        fam("dl4j_autoscaler_scale_ups_total", "counter",
            "Successful scale-up actuations", snap["scale_ups_total"])
        fam("dl4j_autoscaler_scale_downs_total", "counter",
            "Successful scale-down actuations", snap["scale_downs_total"])
        fam("dl4j_autoscaler_last_reaction_s", "gauge",
            "Seconds from first breached observation to the actuation "
            "that answered it (the TRAFFIC receipt gate)",
            snap["last_reaction_s"] if snap["last_reaction_s"] is not None
            else -1.0)
        return fams


class ReplicaSetActuator:
    """Within-host actuation through the seams ``ReplicaSet`` already
    has: scale-up restarts the highest drained/dead slot (over the
    same forward, so no kernel is built), scale-down drains the highest
    live slot (its accepted queue still finishes). The replica COUNT
    never changes — slots park in ``draining`` instead of being
    destroyed, which is what makes up() cheap."""

    def __init__(self, replica_set):
        self.rs = replica_set

    def live(self) -> int:
        return sum(1 for r in self.rs.replicas if r.status == "live")

    def up(self) -> bool:
        for r in reversed(self.rs.replicas):
            if r.status != "live":
                self.rs.restart(r.index)
                return True
        return False

    def down(self) -> bool:
        live = [r for r in self.rs.replicas if r.status == "live"]
        if len(live) <= 1:
            return False   # never drain the last worker
        self.rs.drain(live[-1].index)
        return True

    def signals(self) -> dict:
        """Depth/size signals for an Autoscaler driving THIS tier."""
        stats = self.rs.stats
        ra = stats.retry_after_s() if stats is not None else 0.0
        return {"queue_depth": self.rs.live_depth(),
                "retry_after_s": ra, "size": self.live()}
