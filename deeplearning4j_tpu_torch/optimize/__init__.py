"""Training listeners and early stopping (counterpart of
deeplearning4j_tpu/optimize: listeners.py and earlystopping.py; the
full-batch solvers are not ported yet)."""

from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener,
    ComposableIterationListener,
    ParamAndGradientIterationListener,
    PerformanceListener,
    ProfilerListener,
    ScoreIterationListener,
    TrainingListener,
)

__all__ = ["CollectScoresIterationListener", "ComposableIterationListener",
           "ParamAndGradientIterationListener", "PerformanceListener",
           "ProfilerListener", "ScoreIterationListener", "TrainingListener"]
