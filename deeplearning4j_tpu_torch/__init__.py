"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

Plain tensor code is PyTorch; each kernel the JAX package wrote in Pallas
for the TPU is a hand-written Hopper kernel here (ops/csrc/). The package
imports neither jax nor deeplearning4j_tpu. Entry points run on the card
unless the caller passes another device (``device="cpu"`` runs the plain
PyTorch versions).

Ported so far, for the GravesLSTM char-RNN (``zoo.char_rnn``), the
gpt_mini transformer (``zoo.gpt_mini``), the feed-forward and conv nets
(``zoo.mnist_mlp``, ``zoo.lenet``, ``zoo.vgg16``) and ResNet-18/50
(``zoo.resnet18``, ``zoo.resnet50``): configs with the JAX JSON round trip
and the input preprocessors; ``MultiLayerNetwork`` inference (``output``,
``feed_forward``, ``rnn_time_step``) and training (``fit``,
``fit_batch``, truncated BPTT, ``score``) with the updaters, schedules,
losses and loss scaling; ``ComputationGraph`` training and inference with
the block-fusion pass; ``evaluate``/``evaluate_regression`` and the
evaluation classes (``eval``); training listeners and early stopping
(``optimize``); datasets and in-memory iterators; the model zips, updater
state included, in both directions; step-directory checkpoints and the
fault-tolerant supervisor (``utils.checkpoint``, ``resilience``); the
full-batch solvers and gradient checks; transfer learning with frozen
layers; the pretrain and VAE layers; and ``ModelServer``. On the card the
LSTM runs forward and backward as hand-written kernels
(ops/csrc/lstm_fwd.cu, lstm_bwd.cu), causal attention's forward as a
hand-written flash kernel (ops/csrc/flash_attn_fwd.cu), and the fused
bottleneck tail (1x1 conv + batch norm + add + relu) forward and backward
as four hand-written kernels (ops/csrc/fused_block.cu).
"""

from deeplearning4j_tpu_torch.ops import activations, initializers, losses
from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                               DataSet,
                                               ListDataSetIterator,
                                               MultiDataSet)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf import (ComputationGraphConfiguration,
                                              DtypePolicy, InputType,
                                              MultiLayerConfiguration,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo import (char_rnn, gpt_mini, gpt_mini_draft,
                                          lenet, mnist_mlp, resnet18,
                                          resnet50, vgg16)

__all__ = ["ArrayDataSetIterator", "ComputationGraph",
           "ComputationGraphConfiguration", "DataSet", "DtypePolicy",
           "InputType", "ListDataSetIterator", "MultiDataSet",
           "MultiLayerConfiguration", "MultiLayerNetwork",
           "NeuralNetConfiguration", "activations", "char_rnn", "gpt_mini",
           "gpt_mini_draft", "initializers", "lenet", "losses", "mnist_mlp",
           "resnet18", "resnet50", "resolve_device", "vgg16"]
