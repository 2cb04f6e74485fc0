"""Per-phase distributed training statistics and timeline export
(counterpart of deeplearning4j_tpu/parallel/stats.py).

Parity: dl4j-spark's ParameterAveragingTrainingMasterStats: the reference
times every phase of a distributed training round (broadcast / fit /
aggregate / processParams) as ``EventStats`` (start time + duration +
worker id) and exports them as an HTML timeline (StatsUtils
exportStatsAsHtml). Here the phases are the round structure (local
``fit`` window, cross-process ``average``, ``checkpoint_barrier``, and
the supervisor's ``restore``, ``rollback``, ``checkpoint_snapshot``,
``checkpoint_write`` and ``score_sync``), recorded by the trainers in
parallel/distributed.py and resilience/supervisor.py, gathered across
processes through ``torch.distributed``, and rendered through the
ui/components.py ChartTimeline.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass
from typing import Dict, List, Sequence

#: stable phase -> color mapping for timeline rendering
PHASE_COLORS = {
    "fit": "#1f77b4",
    "average": "#ff7f0e",
    "checkpoint_barrier": "#2ca02c",
    "broadcast": "#9467bd",
    "vocab": "#8c564b",
}
_FALLBACK_COLOR = "#7f7f7f"


@dataclass
class EventStats:
    """One timed phase occurrence (BaseEventStats.java parity: machine/
    worker id + start + duration)."""
    worker_id: str
    phase: str
    start: float          # seconds since the collector's epoch
    duration_ms: float

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "EventStats":
        return EventStats(d["worker_id"], d["phase"], d["start"],
                          d["duration_ms"])


class TrainingStatsCollector:
    """Records EventStats for one worker; merges across workers for
    export (the TrainingMasterStats aggregation surface)."""

    def __init__(self, worker_id: str = "worker_0"):
        self.worker_id = worker_id
        self.events: List[EventStats] = []
        self._epoch = time.perf_counter()
        # phases may now be timed from a background thread (the async
        # checkpoint writer records checkpoint_barrier off the step path)
        self._lock = threading.Lock()

    @contextmanager
    def time_phase(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.record(phase, t0, t1)
            # phases land in the unified span timeline too, so a Spark-
            # tier `average` shows up against fit-loop/checkpoint spans
            from deeplearning4j_tpu_torch.observability.trace import get_tracer
            get_tracer().record(phase, t0, t1,
                                {"worker": self.worker_id})

    def record(self, phase: str, t0: float, t1: float) -> None:
        """One phase from ``time.perf_counter()`` stamps, with no span of
        its own: how the supervisor files the phases it already traces
        (``restore``, ``rollback``, ``checkpoint_*``, ``score_sync``)."""
        ev = EventStats(self.worker_id, phase, t0 - self._epoch,
                        (t1 - t0) * 1000.0)
        with self._lock:
            self.events.append(ev)

    def _snapshot(self) -> List[EventStats]:
        """Copy under the lock: the async checkpoint writer may still be
        appending while a reader iterates (seen as a mid-iteration
        ``RuntimeError: list changed size`` / missing-tail race before
        this existed). ALL readers go through here."""
        with self._lock:
            return list(self.events)

    # ------------------------------------------------------------ queries
    def phase_totals_ms(self) -> Dict[str, float]:
        """Total wall-clock per phase (the getSummaryStats table)."""
        out: Dict[str, float] = {}
        for e in self._snapshot():
            out[e.phase] = out.get(e.phase, 0.0) + e.duration_ms
        return out

    # ------------------------------------------------------- aggregation
    def gather_across_processes(self) -> List[EventStats]:
        """All-gather every process's events (the RDD collect the Spark
        master does before export). COLLECTIVE — every process must call
        it (a process outside a group gets its own events). Event
        ``start`` clocks stay per-worker-relative, which is what the
        per-lane timeline renders."""
        import torch.distributed as dist

        mine = [e.to_dict() for e in self._snapshot()]
        if not dist.is_initialized():
            return [EventStats.from_dict(d) for d in mine]
        gathered: list = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, mine)   # one collective
        events: List[EventStats] = []
        for rows in gathered:
            events.extend(EventStats.from_dict(d) for d in rows)
        return events

    # ------------------------------------------------------------ export
    def post_to(self, storage, session_id: str = "training") -> None:
        """Publish this worker's events through a StatsStorage/router
        (``put_static_info`` — the dashboard's /api/phases reads it)."""
        storage.put_static_info(session_id, self.worker_id, {
            "phase_stats": [e.to_dict() for e in self._snapshot()]})


def timeline_component(events: Sequence[EventStats],
                       title: str = "Training phases"):
    """Per-worker lanes of colored phase bars (StatsUtils.java
    exportStatsAsHtml -> ChartTimeline parity)."""
    from deeplearning4j_tpu_torch.ui.components import ChartTimeline, Style

    by_worker: Dict[str, List[EventStats]] = {}
    for e in events:
        by_worker.setdefault(e.worker_id, []).append(e)
    chart = ChartTimeline(title, Style(
        width=760, height=max(120, 46 + 34 * len(by_worker))),
        xlabel="seconds")
    for worker in sorted(by_worker):
        entries = [(e.start, e.start + e.duration_ms / 1000.0, e.phase,
                    PHASE_COLORS.get(e.phase, _FALLBACK_COLOR))
                   for e in sorted(by_worker[worker], key=lambda e: e.start)]
        chart.add_lane(worker, entries)
    return chart


def summary_table(events: Sequence[EventStats]):
    """Per-worker per-phase totals (the summary-stats table the HTML
    export leads with)."""
    from deeplearning4j_tpu_torch.ui.components import ComponentTable

    phases = sorted({e.phase for e in events})
    by_worker: Dict[str, Dict[str, float]] = {}
    counts: Dict[str, int] = {}
    for e in events:
        row = by_worker.setdefault(e.worker_id, {})
        row[e.phase] = row.get(e.phase, 0.0) + e.duration_ms
        counts[e.worker_id] = counts.get(e.worker_id, 0) + 1
    content = [
        [w, str(counts[w])] + [f"{by_worker[w].get(p, 0.0):.1f}"
                               for p in phases]
        for w in sorted(by_worker)]
    return ComponentTable(["worker", "events"] + [f"{p} (ms)"
                                                  for p in phases],
                          content, title="Per-phase totals")


def export_timeline_html(events: Sequence[EventStats], path: str,
                         title: str = "Distributed training timeline"):
    """StatsUtils.exportStatsAsHTML parity: standalone timeline page."""
    from deeplearning4j_tpu_torch.ui.components import render_components_to_file

    render_components_to_file(
        [summary_table(events), timeline_component(events)], path, title)
