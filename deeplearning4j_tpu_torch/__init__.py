"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

Plain tensor code is PyTorch; each kernel the JAX package wrote in Pallas
for the TPU is a hand-written Hopper kernel here (ops/csrc/). The package
imports neither jax nor deeplearning4j_tpu. Entry points run on the card
unless the caller passes another device (``device="cpu"`` runs the plain
PyTorch versions).

This slice serves the GravesLSTM char-RNN: configs with the JAX JSON round
trip, ``MultiLayerNetwork`` inference (``output``, ``feed_forward``,
``rnn_time_step``), the model zip in both directions, and ``ModelServer``.
"""

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf import (DtypePolicy, InputType,
                                              MultiLayerConfiguration,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

__all__ = ["DtypePolicy", "InputType", "MultiLayerConfiguration",
           "MultiLayerNetwork", "NeuralNetConfiguration", "resolve_device"]
