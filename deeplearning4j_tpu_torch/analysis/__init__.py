"""Static-analysis support (counterpart of deeplearning4j_tpu/analysis):
only ``guards.guarded_by`` so far, which the threaded datapipe stages
declare their locks with. The lints themselves (concurrency, lock order,
the jaxpr lint's torch.fx counterpart) wait for ROADMAP.md A.4."""

from deeplearning4j_tpu_torch.analysis.guards import guarded_by

__all__ = ["guarded_by"]
