"""Structured span tracing: the "where did step N spend its time" core
(counterpart of deeplearning4j_tpu/observability/trace.py).

The JAX package's tracer, for the port's runtime: the fit loops, the
prefetch worker of a datapipe and the supervisor's checkpoint writer run
beside each other, and a span tracer is the way to see them against
each other.

Design constraints, in order:

1. **Hot-path overhead**: recording one span is two ``perf_counter``
   calls plus one append into a bounded ring, under one uncontended
   lock — no allocation of dicts/strings beyond the tuple, no I/O, no
   wait on the card. The JAX package budgets the fit loop's slowdown at
   3% (its ``trace_overhead`` bench); ``chip_smoke.py``'s
   ``[observability]`` measures the port's on the card. A disabled
   tracer's span costs one attribute read.
2. **Thread lanes**: every span records its thread id + name, so the
   Chrome-trace export renders the fit loop, the ``dl4j-pipe-prefetch``
   worker and the ``dl4j-ckpt-writer`` thread as separate lanes in
   Perfetto / ``chrome://tracing``.
3. **Profiler correlation**: while a ``torch.profiler`` profile is
   recording, each span is also wrapped in
   ``torch.profiler.record_function``, so the same names appear inside
   device profiles (``ProfilerListener``, ``key_averages()``) — one
   taxonomy across the host timeline and the card's trace. Outside a
   profile the check costs one flag read.

Span taxonomy (the JAX package's names):

- fit loop (both nets): ``data_wait``, ``host_dispatch``,
  ``device_step``, ``score_sync``, ``flops_derive``
- resilience supervisor: ``checkpoint_snapshot``, ``checkpoint_write``,
  ``checkpoint_barrier``, ``rollback``, ``restore``
- datapipe: ``pipe_shuffle_fill``, ``pipe_collate``,
  ``pipe_prefetch_pull``
- the serving batcher's spans (``queue_wait``, ``batch_assembly``,
  ``device_compute``) wait for ROADMAP.md A.3, the distributed phases
  for A.5.

Launches are asynchronous on the card, so a span around them times the
host issuing them; no span waits on the card.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional, Sequence

import torch

__all__ = [
    "Span", "Tracer", "get_tracer", "set_tracer", "span", "trace_span",
    "trace_timeline_component",
]


class Span(NamedTuple):
    """One completed span. Times are microseconds since the tracer's
    epoch (``perf_counter`` based — monotonic, comparable across threads
    of one process)."""
    name: str
    ts_us: float
    dur_us: float
    tid: int
    thread: str
    attrs: Optional[dict]

    def to_dict(self) -> dict:
        d = {"name": self.name, "ts_us": round(self.ts_us, 3),
             "dur_us": round(self.dur_us, 3), "tid": self.tid,
             "thread": self.thread}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _SpanCtx:
    """Hand-rolled context manager: ~2x cheaper than
    ``@contextmanager`` on the per-step hot path."""

    __slots__ = ("_tracer", "_name", "_attrs", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, attrs):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._ann = None

    def __enter__(self):
        annotate = self._tracer.annotate
        if annotate or (annotate is None and _profiling()):
            self._ann = torch.profiler.record_function(self._name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._record(self._name, self._t0, t1, self._attrs)
        return False


class _NullCtx:
    """Returned by a disabled tracer — a shared no-op (no allocation)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


def _profiling() -> bool:
    """Whether a torch.profiler profile is recording in this process."""
    return torch.autograd.profiler._is_profiler_enabled


class Tracer:
    """Thread-safe bounded-ring span recorder.

    - ``capacity``: ring size (oldest spans evicted — a dashboard wants
      the recent window, not since-boot history; export what you need
      before it scrolls off).
    - ``sample_every``: keep 1 of every N occurrences *per span name*
      (N=1, the default, records everything — the fit-loop overhead
      budget already clears 3% unsampled; raise it for pathological
      span rates).
    - ``annotate``: also wrap each span in
      ``torch.profiler.record_function`` so names appear in profiler
      traces: None (the default) while a profile is recording, True
      always, False never.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 annotate: Optional[bool] = None, sample_every: int = 1):
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.annotate = None if annotate is None else bool(annotate)
        self.sample_every = max(1, int(sample_every))
        self._ring: deque[Span] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._seen: dict = {}       # name -> occurrence count (sampling)
        self.dropped = 0            # spans evicted or sampled away
        self._dropped_by_name: dict = {}  # name -> drop count
        self._sinks: list = []      # fns called with each recorded Span

    # ------------------------------------------------------------ recording
    def span(self, name: str, **attrs):
        """Context manager timing one span: ``with tracer.span("x"): ...``"""
        if not self.enabled:
            return _NULL
        return _SpanCtx(self, name, attrs or None)

    def record(self, name: str, t0: float, t1: float, attrs: dict = None,
               tid: int = None, thread: str = None):
        """Record an explicitly-timed span (``perf_counter`` endpoints) —
        for spans whose start lives on another thread (e.g. a serving
        ticket's ``queue_wait`` measured from its submit timestamp)."""
        if self.enabled:
            self._record(name, t0, t1, attrs, tid, thread)

    def _record(self, name, t0, t1, attrs, tid=None, thread=None):
        if tid is None:
            t = threading.current_thread()
            tid, thread = t.ident or 0, t.name
        with self._lock:
            if self.sample_every > 1:
                seen = self._seen.get(name, 0)
                self._seen[name] = seen + 1
                if seen % self.sample_every:
                    self.dropped += 1
                    self._dropped_by_name[name] = \
                        self._dropped_by_name.get(name, 0) + 1
                    return
            if len(self._ring) == self.capacity:
                # ring eviction loses the OLDEST span — count its name,
                # not the incoming one, so the drop table says which
                # phase's history actually scrolled off
                self.dropped += 1
                evicted = self._ring[0].name
                self._dropped_by_name[evicted] = \
                    self._dropped_by_name.get(evicted, 0) + 1
            span = Span(
                name, (t0 - self._epoch) * 1e6, (t1 - t0) * 1e6,
                tid, thread or "", attrs)
            self._ring.append(span)
            sinks = self._sinks
        for sink in sinks:
            try:
                sink(span)
            except Exception:
                pass  # a broken sink must never break the hot path

    # ---------------------------------------------------------------- sinks
    def add_sink(self, fn) -> None:
        """Register a callable invoked with every recorded Span (outside
        the ring lock; exceptions swallowed). Sinks see spans even when
        the ring later evicts them — the goodput ledger's feed."""
        with self._lock:
            if fn not in self._sinks:
                # copy-on-write: _record iterates a snapshot lock-free
                self._sinks = self._sinks + [fn]

    def remove_sink(self, fn) -> None:
        with self._lock:
            if fn in self._sinks:
                self._sinks = [s for s in self._sinks if s is not fn]

    # -------------------------------------------------------------- control
    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._seen.clear()
            self.dropped = 0
            self._dropped_by_name = {}

    # ---------------------------------------------------------------- clocks
    def epoch_unix(self) -> float:
        """Approximate unix time of the tracer's perf_counter epoch —
        the anchor that converts ``Span.ts_us`` (µs since epoch,
        monotonic, per-process) into wall-clock time so spans pushed
        from different processes can be laid on one timeline. Computed
        fresh per call from the current clock pair; the residual error
        is the clock-read skew (µs), far below the network gaps the
        cross-process waterfall resolves."""
        return time.time() - (time.perf_counter() - self._epoch)

    # ------------------------------------------------------------ drop stats
    def dropped_spans(self) -> dict:
        """Per-name dropped-span counts (ring eviction counts the
        evicted span's name; sampling counts the sampled-away name)."""
        with self._lock:
            return dict(self._dropped_by_name)

    # --------------------------------------------------------------- export
    def spans(self) -> List[Span]:
        """Snapshot of the ring (oldest first). Taken under the lock —
        recorder threads may keep appending while the caller iterates
        the returned list safely."""
        with self._lock:
            return list(self._ring)

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` form
        Perfetto and ``chrome://tracing`` load): one ``ph: "X"`` complete
        event per span, one ``ph: "M"`` thread_name metadata event per
        thread so lanes are labeled. Events are sorted by ``ts``."""
        spans = self.spans()
        pid = os.getpid()
        events = []
        threads = {}
        for s in spans:
            threads.setdefault(s.tid, s.thread)
            ev = {"ph": "X", "name": s.name, "cat": "dl4j_tpu",
                  "pid": pid, "tid": s.tid,
                  "ts": round(s.ts_us, 3), "dur": round(s.dur_us, 3)}
            if s.attrs:
                ev["args"] = s.attrs
            events.append(ev)
        events.sort(key=lambda e: e["ts"])
        meta = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                 "args": {"name": name or f"thread-{tid}"}}
                for tid, name in sorted(threads.items())]
        out = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        dropped = self.dropped_spans()
        if self.dropped or dropped:
            # stamp data loss into the artifact: a timeline missing its
            # oldest spans should say so rather than look complete
            out["otherData"] = {
                "dropped_spans_total": self.dropped,
                "dropped_spans_by_name": dropped,
            }
        try:
            # identity rides in otherData (NOT a metadata event — lanes
            # stay thread_name-only) so exports from different fleet
            # members can be attributed and merged after the fact
            from deeplearning4j_tpu_torch.observability.distributed import \
                get_identity
            out.setdefault("otherData", {})["identity"] = \
                get_identity().to_dict()
        except Exception:
            pass
        return out

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def export_jsonl(self, path: str) -> str:
        """One span per line — the grep/pandas-friendly raw form."""
        with open(path, "w") as f:
            for s in self.spans():
                f.write(json.dumps(s.to_dict()) + "\n")
        return path

    # ------------------------------------------------------------- analysis
    def totals_ms(self) -> dict:
        """Total recorded wall-clock per span name, in ms (the quick
        "what dominates" table)."""
        out: dict = {}
        for s in self.spans():
            out[s.name] = out.get(s.name, 0.0) + s.dur_us / 1000.0
        return out


# --------------------------------------------------------------------------
# process-global tracer (the one every runtime feeds by default)
# --------------------------------------------------------------------------

def _env_default() -> Tracer:
    """DL4J_TPU_TRACE=0 disables span recording process-wide;
    DL4J_TPU_TRACE_SAMPLE=N sets the default sampling."""
    enabled = os.environ.get("DL4J_TPU_TRACE", "1") != "0"
    sample = int(os.environ.get("DL4J_TPU_TRACE_SAMPLE", "1"))
    return Tracer(enabled=enabled, sample_every=sample)


_GLOBAL = _env_default()


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer (tests, custom capacities).
    Returns the previous one so callers can restore it."""
    global _GLOBAL
    prev, _GLOBAL = _GLOBAL, tracer
    return prev


def span(name: str, **attrs):
    """``with span("data_wait"): ...`` against the global tracer."""
    return _GLOBAL.span(name, **attrs)


def trace_span(name: str):
    """Decorator form: ``@trace_span("checkpoint_write")``."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with _GLOBAL.span(name):
                return fn(*a, **kw)
        return wrapped
    return deco


# --------------------------------------------------------------------------
# timeline rendering (the UI tier's ChartTimeline)
# --------------------------------------------------------------------------

_PALETTE = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
            "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")


def span_color(name: str) -> str:
    """Stable span-name -> color (shared by the dashboard JS panel and
    the exported HTML timeline)."""
    return _PALETTE[hash(name) % len(_PALETTE)]


def trace_timeline_component(spans: Sequence[Span],
                             title: str = "Runtime trace"):
    """Per-thread lanes of span bars through the UI tier's
    ``ChartTimeline``: waits for ROADMAP.md A.4 (``ui/``)."""
    raise NotImplementedError(
        "trace_timeline_component: the UI components wait for ROADMAP.md "
        "A.4 (ui/); export_chrome_trace gives the same lanes for Perfetto")


def export_trace_html(spans: Sequence[Span], path: str,
                      title: str = "Runtime trace") -> None:
    """Standalone HTML timeline: waits for ROADMAP.md A.4 (``ui/``)."""
    raise NotImplementedError(
        "export_trace_html: the UI components wait for ROADMAP.md A.4 "
        "(ui/); export_chrome_trace gives the same lanes for Perfetto")
