"""Declarative SLOs with sliding-window attainment and burn rate
(counterpart of deeplearning4j_tpu/observability/slo.py).

- An :class:`SLO` is a declaration: ``SLO("predict_p99",
  metric="latency_p99_ms", objective=0.99, bound=250.0)`` reads "in 99%
  of observation slices, predict p99 stays at or under 250 ms";
  ``SLO("availability", metric="availability", objective=0.999)`` reads
  "99.9% of concluded requests succeed".
- The :class:`SLOEngine` ingests ``ServingStats.snapshot()`` dicts (or
  per-instance federation rows), keeps timestamped good/total
  observations per SLO in a bounded ring and evaluates them over several
  sliding windows at once. :meth:`attach` registers the
  ``dl4j_slo_attainment`` / ``dl4j_slo_burn_rate`` /
  ``dl4j_slo_budget_remaining`` gauge families labeled ``{slo, window}``;
  :meth:`report` is the blob ``ModelServer.stop()`` stamps onto the
  drain RunReport's ``slo`` field.

Per SLO and window: ``attainment = good / total``; the error budget is
``1 - objective``; ``burn_rate = (1 - attainment) / (1 - objective)``;
``budget_remaining = 1 - burn_rate`` (unclamped). The clock is
injectable.

Two metric modes:

- ``metric="availability"``: good/total from cumulative counter deltas
  between ingests per source, ``total = Δrequests + Δerrors +
  Δtimeouts``, ``good = Δrequests`` (503 sheds stay out of the ratio); a
  counter going backwards is a reset, the new value standing as the
  delta.
- any numeric metric with ``bound`` set: each ingest is one slice, good
  iff the sampled value is at or under the bound.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["SLO", "SLOEngine", "DEFAULT_WINDOWS_S", "default_serving_slos"]

#: evaluation windows (seconds): fast page-trip window, mid sanity
#: window, slow budget window — the classic multi-window burn setup.
DEFAULT_WINDOWS_S = (60.0, 300.0, 3600.0)


@dataclass(frozen=True)
class SLO:
    """One declared objective.

    ``metric`` is either the literal ``"availability"`` (request-ratio
    mode) or the name of a numeric field to resolve out of ingested
    snapshots (threshold mode, requires ``bound``): a top-level
    snapshot key, the shorthand ``latency_pNN_ms`` (resolved through
    the snapshot's ``latency_ms`` percentile dict), or a dotted path
    like ``"latency_ms.p99"``. ``objective`` is the target attainment
    fraction in (0, 1]; ``window_s`` names the SLO's *primary* window —
    the one :meth:`SLOEngine.report` surfaces as headline numbers
    (every configured window is still evaluated and exported)."""

    name: str
    metric: str
    objective: float
    window_s: float = 3600.0
    bound: Optional[float] = None

    def __post_init__(self):
        if not 0.0 < self.objective <= 1.0:
            raise ValueError(
                f"SLO {self.name!r}: objective must be in (0, 1], "
                f"got {self.objective}")
        if self.metric != "availability" and self.bound is None:
            raise ValueError(
                f"SLO {self.name!r}: threshold metric {self.metric!r} "
                f"requires a bound")


def default_serving_slos(p99_bound_ms: float = 500.0) -> List[SLO]:
    """The stock serving pair: availability ≥ 99.9% and predict p99 at
    or under *p99_bound_ms* in 99% of observation slices."""
    return [
        SLO("availability", metric="availability", objective=0.999,
            window_s=3600.0),
        SLO("predict_p99", metric="latency_p99_ms", objective=0.99,
            window_s=3600.0, bound=float(p99_bound_ms)),
    ]


def _resolve_metric(snapshot: dict, metric: str) -> Optional[float]:
    """Pull one numeric value out of a ServingStats-shaped snapshot
    (top-level key, ``latency_pNN_ms`` shorthand, or dotted path);
    None when absent — an absent sample is no observation, never a
    failure."""
    v = snapshot.get(metric)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    if (metric.startswith("latency_p") and metric.endswith("_ms")
            and isinstance(snapshot.get("latency_ms"), dict)):
        v = snapshot["latency_ms"].get(metric[len("latency_"):-len("_ms")])
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    if "." in metric:
        node = snapshot
        for part in metric.split("."):
            if not isinstance(node, dict):
                return None
            node = node.get(part)
        if isinstance(node, (int, float)) and not isinstance(node, bool):
            return float(node)
    return None


class SLOEngine:
    """Sliding multi-window attainment + burn-rate computation over a
    set of :class:`SLO` declarations. Thread-safe; O(1) per ingest plus
    ring pruning; ``clock`` injectable for pinned tests."""

    #: counters whose deltas define the availability ratio
    _GOOD_COUNTER = "requests_total"
    _BAD_COUNTERS = ("errors_total", "timeouts_total")

    def __init__(self, slos: Sequence[SLO], *,
                 windows: Sequence[float] = DEFAULT_WINDOWS_S,
                 clock: Callable[[], float] = time.monotonic,
                 capacity: int = 4096):
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.slos: List[SLO] = list(slos)
        self.windows = tuple(sorted(float(w) for w in windows))
        if not self.windows:
            raise ValueError("need at least one evaluation window")
        self._clock = clock
        self._lock = threading.Lock()
        # slo name -> ring of (t, good, total) observations
        self._obs: Dict[str, deque] = {
            s.name: deque(maxlen=int(capacity)) for s in self.slos}
        # (slo name, source) -> last cumulative counter values, for
        # availability deltas per pushing instance
        self._last: Dict[tuple, Dict[str, float]] = {}
        self._registry = None
        self._collector = None

    # --------------------------------------------------------------- ingest
    def ingest(self, snapshot: dict, source: str = "local") -> None:
        """Fold one ServingStats-shaped snapshot into every SLO's ring.
        ``source`` keys the counter-delta state — pass the pushing
        instance name when feeding federation rows so N hosts' counters
        never cross-contaminate."""
        if not isinstance(snapshot, dict):
            return
        now = self._clock()
        with self._lock:
            for slo in self.slos:
                if slo.metric == "availability":
                    self._ingest_availability(slo, snapshot, source, now)
                else:
                    v = _resolve_metric(snapshot, slo.metric)
                    if v is None:
                        continue
                    self._obs[slo.name].append(
                        (now, 1 if v <= slo.bound else 0, 1))

    def _ingest_availability(self, slo: SLO, snapshot: dict,
                             source: str, now: float) -> None:
        cur = {}
        for key in (self._GOOD_COUNTER,) + self._BAD_COUNTERS:
            v = snapshot.get(key)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                return          # not a counters-bearing snapshot
            cur[key] = float(v)
        prev = self._last.get((slo.name, source))
        self._last[(slo.name, source)] = cur
        if prev is None:
            return              # first sight of this source: baseline only
        deltas = {}
        for key, v in cur.items():
            d = v - prev.get(key, 0.0)
            deltas[key] = v if d < 0 else d   # counter reset ⇒ restart
        good = deltas[self._GOOD_COUNTER]
        bad = sum(deltas[k] for k in self._BAD_COUNTERS)
        if good + bad <= 0:
            return              # idle interval: no observation
        self._obs[slo.name].append((now, good, good + bad))

    def ingest_fed_rows(self, rows) -> None:
        """Feed per-instance federation rows (each a dict carrying an
        ``instance`` tag and either serving counters at top level or
        under a ``"serving"`` key) — the aggregator-side ingest path."""
        for row in rows or ():
            if not isinstance(row, dict):
                continue
            source = str(row.get("instance") or row.get("tag") or "fed")
            snap = row.get("serving")
            if not isinstance(snap, dict):
                health = row.get("health")
                if isinstance(health, dict):
                    snap = health.get("serving")
            self.ingest(snap if isinstance(snap, dict) else row, source)

    # ------------------------------------------------------------- evaluate
    def evaluate(self) -> Dict[str, Dict[str, dict]]:
        """Per SLO, per window: attainment, burn_rate, budget_remaining
        plus the raw good/total behind them. Windows with no data
        report ``attainment=None`` (unknown ≠ failing)."""
        now = self._clock()
        with self._lock:
            rings = {name: list(ring) for name, ring in self._obs.items()}
        out: Dict[str, Dict[str, dict]] = {}
        for slo in self.slos:
            per = {}
            for w in self.windows:
                good = total = 0.0
                for (t, g, n) in rings[slo.name]:
                    if now - t <= w:
                        good += g
                        total += n
                ent: dict = {"good": round(good, 3),
                             "total": round(total, 3)}
                if total <= 0:
                    ent.update(attainment=None, burn_rate=None,
                               budget_remaining=None)
                else:
                    att = good / total
                    budget = 1.0 - slo.objective
                    if budget <= 0.0:
                        burn = 0.0 if att >= 1.0 else float("inf")
                    else:
                        burn = (1.0 - att) / budget
                    ent.update(attainment=round(att, 6),
                               burn_rate=round(burn, 4)
                               if burn != float("inf") else burn,
                               budget_remaining=round(1.0 - burn, 4)
                               if burn != float("inf") else -float("inf"))
                per[f"{int(w)}s"] = ent
            out[slo.name] = per
        return out

    def report(self) -> dict:
        """The RunReport-stampable summary: full per-window evaluation
        plus each SLO's declaration and primary-window headline."""
        ev = self.evaluate()
        slos = {}
        for slo in self.slos:
            primary = min(self.windows,
                          key=lambda w: abs(w - slo.window_s))
            head = ev[slo.name][f"{int(primary)}s"]
            slos[slo.name] = {
                "metric": slo.metric,
                "objective": slo.objective,
                "bound": slo.bound,
                "window_s": primary,
                "attainment": head["attainment"],
                "burn_rate": head["burn_rate"],
                "budget_remaining": head["budget_remaining"],
                "windows": ev[slo.name],
            }
        return {"windows_s": list(self.windows), "slos": slos}

    # -------------------------------------------------------------- exports
    def families(self):
        """The three gauge families, one sample per (slo, window) with
        data. Rendered at scrape time by the registry collector, so
        JSON, Prometheus and the federation push all agree."""
        from deeplearning4j_tpu_torch.observability.metrics import MetricFamily

        att = MetricFamily(
            "dl4j_slo_attainment", "gauge",
            "Good observations over total in the sliding window")
        burn = MetricFamily(
            "dl4j_slo_burn_rate", "gauge",
            "Error-budget burn multiplier ((1-attainment)/(1-objective)"
            "); 1.0 = spending exactly at the sustainable rate")
        rem = MetricFamily(
            "dl4j_slo_budget_remaining", "gauge",
            "Share of the window's error budget left at the observed "
            "failure rate (negative = overspent)")
        for name, per in self.evaluate().items():
            for window, ent in per.items():
                if ent["attainment"] is None:
                    continue
                L = {"slo": name, "window": window}
                att.add(ent["attainment"], L)
                burn.add(ent["burn_rate"], L)
                rem.add(ent["budget_remaining"], L)
        return [f for f in (att, burn, rem) if f.samples]

    def attach(self, registry=None):
        """Register the gauge families as a render-time collector on
        *registry* (default: the process-global one)."""
        from deeplearning4j_tpu_torch.observability.metrics import get_registry

        self.detach()
        reg = registry if registry is not None else get_registry()
        reg.register_collector(self.families)
        self._registry, self._collector = reg, self.families
        return reg

    def detach(self):
        reg = self._registry
        if reg is not None:
            reg.unregister_collector(self._collector)
            self._registry = self._collector = None
