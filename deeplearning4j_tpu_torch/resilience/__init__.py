"""Fault-tolerant training (counterpart of deeplearning4j_tpu/resilience;
RESILIENCE.md describes the JAX package's).

``TrainingSupervisor`` / ``resilient_fit`` wrap ``fit_batch`` with
periodic checkpoints, an atomic latest pointer and retention GC,
auto-resume from the newest valid checkpoint, transient-step retry with
exponential backoff, a NaN/Inf rollback sentinel with learning-rate
backoff, and clean SIGTERM preemption. ``faultinject`` is the
deterministic fault harness that keeps each of those paths under test.
The multi-process ``FleetLauncher`` (resilience/launcher.py) waits for
ROADMAP.md A.5's open half."""

from deeplearning4j_tpu_torch.resilience.faultinject import (
    FaultInjector,
    InjectedCrash,
    TransientStepError,
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
