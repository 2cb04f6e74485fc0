"""Network and layer configurations (builders, JSON round trip)."""

from deeplearning4j_tpu_torch.nn.conf import layers_recurrent  # noqa: F401  registers the recurrent layer types
from deeplearning4j_tpu_torch.nn.conf.core import (
    DtypePolicy,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["DtypePolicy", "InputType", "MultiLayerConfiguration",
           "NeuralNetConfiguration"]
