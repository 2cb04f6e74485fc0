"""Training listeners, early stopping and the full-batch solvers
(counterpart of deeplearning4j_tpu/optimize: listeners.py,
earlystopping.py and solvers.py)."""

from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener,
    ComposableIterationListener,
    ParamAndGradientIterationListener,
    PerformanceListener,
    ProfilerListener,
    RecoveryEventListener,
    ScoreIterationListener,
    TrainingListener,
)

__all__ = ["CollectScoresIterationListener", "ComposableIterationListener",
           "ParamAndGradientIterationListener", "PerformanceListener",
           "ProfilerListener", "RecoveryEventListener",
           "ScoreIterationListener", "TrainingListener"]
