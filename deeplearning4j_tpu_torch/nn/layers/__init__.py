"""Runtime layers."""

from deeplearning4j_tpu_torch.nn.layers.base import Layer

__all__ = ["Layer"]
