"""Network and layer configurations (builders, JSON round trip)."""

from deeplearning4j_tpu_torch.nn.conf import layers_recurrent  # noqa: F401  registers the recurrent layer types
from deeplearning4j_tpu_torch.nn.conf import layers_attention  # noqa: F401  registers the transformer layer types
from deeplearning4j_tpu_torch.nn.conf import layers_conv  # noqa: F401  registers the convolutional layer types
from deeplearning4j_tpu_torch.nn.conf import layers_pretrain  # noqa: F401  registers Frozen
from deeplearning4j_tpu_torch.nn.conf.core import (
    DtypePolicy,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["ComputationGraphConfiguration", "DtypePolicy", "InputType",
           "MultiLayerConfiguration", "NeuralNetConfiguration"]
