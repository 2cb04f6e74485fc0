"""SLO-aware traffic engine (counterpart of deeplearning4j_tpu/scheduling).

``core.SchedulingCore`` is the one admission discipline of the serving
tier (batcher tiers, fleet admission, decode engine, front-door router):
strict-priority classes interactive > batch > best_effort, per-tenant
token-bucket quotas, and deadline-aware shedding that degrades batch
traffic first. Requests carry ``X-DL4J-Tenant`` / ``X-DL4J-Priority`` /
``X-DL4J-Deadline-Ms`` end to end, echoed like the trace id.

``autoscaler.Autoscaler`` closes the loop over the federation's gauges
(queue depth, retry-after, SLO burn rate) through the ``ReplicaSet``
drain/restart seams, with hysteresis, cooldowns and bounds.

``loadgen`` is the seeded open-loop arrival generator (diurnal ramps,
flash crowds, heavy-tailed sizes, mixed tenants and classes) and the
per-class attainment summary.

Every module here is host-only Python: none imports torch.
"""

from deeplearning4j_tpu_torch.scheduling.autoscaler import (  # noqa: F401
    Autoscaler, ReplicaSetActuator, fleet_signals)
from deeplearning4j_tpu_torch.scheduling.core import (  # noqa: F401
    BATCH, BEST_EFFORT, CLASSES, DEADLINE_HEADER, INTERACTIVE, PRIORITY,
    PRIORITY_HEADER, SCHED_HEADERS, SHED_CLASS_HEADER, SchedulingCore,
    ShedError, TENANT_HEADER, TokenBucket, build_sched_headers,
    normalize_class, parse_sched_headers)
from deeplearning4j_tpu_torch.scheduling.loadgen import (  # noqa: F401
    Arrival, OpenLoopRunner, TrafficModel, attainment)

__all__ = [
    "SchedulingCore", "ShedError", "TokenBucket", "normalize_class",
    "parse_sched_headers", "build_sched_headers",
    "CLASSES", "PRIORITY", "INTERACTIVE", "BATCH", "BEST_EFFORT",
    "TENANT_HEADER", "PRIORITY_HEADER", "DEADLINE_HEADER",
    "SHED_CLASS_HEADER", "SCHED_HEADERS",
    "Autoscaler", "ReplicaSetActuator", "fleet_signals",
    "TrafficModel", "OpenLoopRunner", "Arrival", "attainment",
]
