"""Fault-tolerant training (counterpart of deeplearning4j_tpu/resilience;
RESILIENCE.md describes the JAX package's).

``TrainingSupervisor`` / ``resilient_fit`` wrap ``fit_batch`` with
periodic checkpoints, an atomic latest pointer and retention GC,
auto-resume from the newest valid checkpoint, transient-step retry with
exponential backoff, a NaN/Inf rollback sentinel with learning-rate
backoff, and clean SIGTERM preemption, coordinated across the processes
of a group (one consensus round a decision, barriered checkpoints, a
lost peer ending the run with status ``peer_lost``). ``faultinject`` is
the deterministic fault harness that keeps each of those paths under
test. ``FleetLauncher`` (resilience/launcher.py) spawns a coordinated
fleet, watches it, and relaunches it smaller when a worker dies."""

from deeplearning4j_tpu_torch.resilience.faultinject import (
    FaultInjector,
    InjectedCrash,
    TransientStepError,
)
from deeplearning4j_tpu_torch.resilience.launcher import (
    PEER_LOST_EXIT,
    FleetLauncher,
    FleetResult,
    LaunchRecord,
    WorkerRecord,
    free_port,
)
from deeplearning4j_tpu_torch.resilience.supervisor import (
    RecoveryEvent,
    ResilienceStats,
    SupervisorConfig,
    SupervisorResult,
    TrainingDivergedError,
    TrainingSupervisor,
    resilient_fit,
)

__all__ = [
    "FaultInjector",
    "FleetLauncher",
    "FleetResult",
    "LaunchRecord",
    "PEER_LOST_EXIT",
    "WorkerRecord",
    "free_port",
    "InjectedCrash",
    "RecoveryEvent",
    "ResilienceStats",
    "SupervisorConfig",
    "SupervisorResult",
    "TrainingDivergedError",
    "TrainingSupervisor",
    "TransientStepError",
    "resilient_fit",
]
