"""Observability core (counterpart of deeplearning4j_tpu/observability):
span tracing, the metrics registry, goodput attribution, process
identity and the crash flight recorder.

``trace`` answers "where did step N spend its time" (bounded-ring span
tracer, Chrome-trace/JSONL export, per-thread Perfetto lanes, span names
inside ``torch.profiler`` traces); ``metrics`` is the single registry
the runtime feeds (Prometheus text exposition + JSON snapshot);
``goodput`` turns both into efficiency accounting — a per-run wall-time
ledger, live MFU/goodput gauges with derived FLOPs, padding-waste
fractions, and the RunReport JSON artifact; ``distributed`` holds the
process identity and the cross-process plane (snapshot export and push,
the heartbeat pusher, the metrics federation with its health scoreboard,
the span push buffer and the trace store);
``slo`` declares SLOs and evaluates their sliding-window attainment and
burn rate; ``flightrec`` is the crash flight recorder flushed on
SIGTERM/NaN/preemption/crash.

Environment (the JAX package's names): ``DL4J_TPU_TRACE``,
``DL4J_TPU_TRACE_SAMPLE``, ``DL4J_TPU_GOODPUT``, ``DL4J_TPU_AUTO_FLOPS``,
``DL4J_TPU_PEAK_FLOPS``, ``DL4J_TPU_RUN_REPORT_DIR``,
``DL4J_TPU_FLIGHT_DIR``, ``DL4J_TPU_RUN_ID``, ``DL4J_TPU_INSTANCE``,
``DL4J_TPU_INCARNATION``, ``DL4J_TPU_SLO_P99_MS``.
"""

from deeplearning4j_tpu_torch.observability.trace import (  # noqa: F401
    Span, Tracer, get_tracer, set_tracer, span, trace_span,
    trace_timeline_component, export_trace_html, span_color,
)
from deeplearning4j_tpu_torch.observability.metrics import (  # noqa: F401
    MetricFamily, MetricsRegistry, get_registry, set_registry,
    install_runtime_metrics, observe_step, observe_rate,
    observe_dispatch_lag, compile_stats, update_memory_watermark,
    memory_watermark_bytes,
)
from deeplearning4j_tpu_torch.observability.goodput import (  # noqa: F401
    EfficiencyLedger, RunReport, start_run, end_run, current_ledger,
    last_report, record_padding, live_snapshot, goodput_collector,
)
from deeplearning4j_tpu_torch.observability.distributed import (  # noqa: F401
    MetricsFederation, ProcessIdentity, TRACE_HEADER, bump_incarnation,
    export_snapshot, get_identity, new_trace_id, push_snapshot,
    reset_identity, set_identity, stamp_run_marker,
)
from deeplearning4j_tpu_torch.observability.flightrec import (  # noqa: F401
    FlightRecorder, get_flight_recorder, install_flight_recorder,
    uninstall_flight_recorder,
)

__all__ = [
    "Span", "Tracer", "get_tracer", "set_tracer", "span", "trace_span",
    "trace_timeline_component", "export_trace_html", "span_color",
    "MetricFamily", "MetricsRegistry", "get_registry", "set_registry",
    "install_runtime_metrics", "observe_step", "observe_rate",
    "observe_dispatch_lag", "compile_stats", "update_memory_watermark",
    "memory_watermark_bytes",
    "EfficiencyLedger", "RunReport", "start_run", "end_run",
    "current_ledger", "last_report", "record_padding", "live_snapshot",
    "goodput_collector",
    "MetricsFederation", "ProcessIdentity", "TRACE_HEADER",
    "bump_incarnation", "export_snapshot", "get_identity", "new_trace_id",
    "push_snapshot", "reset_identity", "set_identity", "stamp_run_marker",
    "FlightRecorder", "get_flight_recorder", "install_flight_recorder",
    "uninstall_flight_recorder",
]
