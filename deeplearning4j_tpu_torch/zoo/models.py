"""Model builders (counterpart of deeplearning4j_tpu/zoo/models.py):
``mnist_mlp``, ``lenet``, ``vgg16`` (with ``vgg16_preprocess``),
``char_rnn``, ``gpt_mini``, ``gpt_mini_draft``, ``resnet18`` and
``resnet50``, with the JAX package's configurations and defaults. Each
runs on ``device`` (default: the card)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.core import (DtypePolicy,
                                                   NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer, Dense,
                                                     Output)
from deeplearning4j_tpu_torch.nn.conf.layers_attention import (
    GptEmbedding, GptOutput, TransformerBlock)
from deeplearning4j_tpu_torch.nn.conf.layers_conv import (BatchNorm,
                                                          Convolution2D,
                                                          GlobalPooling,
                                                          Subsampling)
from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import (GravesLSTM,
                                                               RnnOutput)
from deeplearning4j_tpu_torch.nn.conf.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, Nesterovs

BF16 = DtypePolicy(param_dtype="float32", compute_dtype="bfloat16")
F32 = DtypePolicy(param_dtype="float32", compute_dtype="float32")


def mnist_mlp(seed: int = 42, dtype: Optional[DtypePolicy] = None,
              device=None) -> MultiLayerNetwork:
    """784-256-128-10 MLP: relu, softmax head, Adam(1e-3), F32 by
    default."""
    conf = (NeuralNetConfiguration.builder()
            .seed(seed).updater(Adam(1e-3)).activation("relu")
            .dtype(dtype or F32)
            .list()
            .layer(Dense(n_out=256))
            .layer(Dense(n_out=128))
            .layer(Output(n_out=10, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.feed_forward(784))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def lenet(seed: int = 42, n_classes: int = 10,
          dtype: Optional[DtypePolicy] = None,
          device=None) -> MultiLayerNetwork:
    """LeNet on 28 x 28 x 1 images (BASELINE.md config #1): conv 5x5x20 ->
    max pool 2 -> conv 5x5x50 -> max pool 2 -> dense 500 (relu) ->
    softmax; BF16 and Nesterovs(0.01, 0.9) by default. ``set_input_type``
    puts a CnnToFeedForward before the dense layer."""
    conf = (NeuralNetConfiguration.builder()
            .seed(seed).updater(Nesterovs(0.01, 0.9)).activation("relu")
            .dtype(dtype or BF16)
            .list()
            .layer(Convolution2D(n_out=20, kernel=(5, 5), stride=(1, 1),
                                 activation="identity"))
            .layer(Subsampling(kernel=(2, 2), stride=(2, 2), pooling="max"))
            .layer(Convolution2D(n_out=50, kernel=(5, 5), stride=(1, 1),
                                 activation="identity"))
            .layer(Subsampling(kernel=(2, 2), stride=(2, 2), pooling="max"))
            .layer(Dense(n_out=500, activation="relu"))
            .layer(Output(n_out=n_classes, loss="mcxent",
                          activation="softmax"))
            .set_input_type(InputType.convolutional(28, 28, 1))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def vgg16(seed: int = 42, n_classes: int = 1000, image_size: int = 224,
          dtype: Optional[DtypePolicy] = None, updater=None,
          device=None) -> MultiLayerNetwork:
    """VGG-16: five blocks of 3x3 same convs (2, 2, 3, 3, 3 of 64, 128,
    256, 512, 512 channels, relu), each closed by a 2x2 max pool, then
    dense 4096, dense 4096 and a softmax head; BF16 and Nesterovs(0.01,
    0.9) by default. At 224 x 224 and 1000 classes it has 138,357,544
    parameters. ``vgg16_preprocess`` makes its inputs."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(updater or Nesterovs(0.01, 0.9))
         .dtype(dtype or BF16).activation("relu")
         .list())
    blocks = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
    for n_convs, ch in blocks:
        for _ in range(n_convs):
            b = b.layer(Convolution2D(n_out=ch, kernel=(3, 3), mode="same",
                                      activation="relu"))
        b = b.layer(Subsampling(kernel=(2, 2), stride=(2, 2),
                                pooling="max"))
    conf = (b.layer(Dense(n_out=4096, activation="relu"))
            .layer(Dense(n_out=4096, activation="relu"))
            .layer(Output(n_out=n_classes, loss="mcxent",
                          activation="softmax"))
            .set_input_type(InputType.convolutional(image_size, image_size,
                                                    3))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


#: VGG-16's per-channel ImageNet means, RGB order
VGG16_MEAN_RGB = (123.68, 116.779, 103.939)


def vgg16_preprocess(images):
    """[b, h, w, 3] RGB images (0-255) -> f32 with VGG16_MEAN_RGB
    subtracted: a tensor stays on its device, anything else becomes a
    numpy array, as in the JAX package."""
    if isinstance(images, torch.Tensor):
        x = images.to(torch.float32)
        return x - torch.tensor(VGG16_MEAN_RGB, dtype=torch.float32,
                                device=x.device)
    x = np.asarray(images, np.float32)
    return x - np.asarray(VGG16_MEAN_RGB, np.float32)


def char_rnn(vocab_size: int = 80, hidden: int = 512, n_layers: int = 2,
             seed: int = 42, dtype: Optional[DtypePolicy] = None,
             device=None) -> MultiLayerNetwork:
    """GravesLSTM char-RNN: stacked LSTMs -> per-timestep softmax. Same
    configuration (and configuration.json) as the JAX package's
    ``zoo.char_rnn``; BF16 policy by default; runs on ``device``
    (default: the card)."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(Adam(2e-3)).dtype(dtype or BF16)
         .list())
    for _ in range(n_layers):
        b = b.layer(GravesLSTM(n_out=hidden, activation="tanh"))
    conf = (b.layer(RnnOutput(n_out=vocab_size, loss="mcxent",
                              activation="softmax"))
            .set_input_type(InputType.recurrent(vocab_size))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def gpt_mini(vocab_size: int = 80, width: int = 256, n_layers: int = 4,
             n_heads: int = 4, max_len: int = 256,
             max_cache_len: Optional[int] = None, seed: int = 42,
             dtype: Optional[DtypePolicy] = None,
             device=None) -> MultiLayerNetwork:
    """GPT-style decoder-only LM: one-hot tokens -> GptEmbedding (learned
    positions) -> ``n_layers`` pre-LN TransformerBlocks (GELU, 4x MLP) ->
    softmax head. Same configuration (and configuration.json) as the JAX
    package's ``zoo.gpt_mini``: BF16 policy and Adam(3e-4) by default;
    streaming carries a KV cache of ``max_cache_len`` (default
    ``max_len``) per block. Runs on ``device`` (default: the card)."""
    cache = int(max_cache_len or max_len)
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(Adam(3e-4)).dtype(dtype or BF16)
         .list()
         .layer(GptEmbedding(n_out=width, max_len=max_len)))
    for _ in range(n_layers):
        b = b.layer(TransformerBlock(n_heads=n_heads, activation="gelu",
                                     max_cache_len=cache))
    conf = (b.layer(GptOutput(n_out=vocab_size, loss="mcxent",
                              activation="softmax"))
            .set_input_type(InputType.recurrent(vocab_size))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def gpt_mini_draft(vocab_size: int = 80, width: int = 128,
                   n_layers: int = 2, n_heads: int = 2, max_len: int = 256,
                   max_cache_len: Optional[int] = None, seed: int = 43,
                   dtype: Optional[DtypePolicy] = None,
                   device=None) -> MultiLayerNetwork:
    """The draft-sized companion of ``gpt_mini`` (same vocabulary and
    extent, half the width and depth), as in the JAX package."""
    return gpt_mini(vocab_size=vocab_size, width=width, n_layers=n_layers,
                    n_heads=n_heads, max_len=max_len,
                    max_cache_len=max_cache_len, seed=seed, dtype=dtype,
                    device=device)


def _conv_bn(g, name: str, n_out: int, kernel, stride, inputs: str,
             activation: str = "relu"):
    g.add_layer(f"{name}_conv",
                Convolution2D(n_out=n_out, kernel=kernel, stride=stride,
                              mode="same", has_bias=False,
                              activation="identity"),
                inputs)
    # an EXPLICIT identity: a bare BatchNorm() inherits the global default
    # activation (sigmoid)
    g.add_layer(f"{name}_bn", BatchNorm(activation="identity"),
                f"{name}_conv")
    if activation != "identity":
        g.add_layer(f"{name}_act", ActivationLayer(activation=activation),
                    f"{name}_bn")
        return f"{name}_act"
    return f"{name}_bn"


def _bottleneck(g, name: str, inputs: str, filters: int, stride: int,
                project: bool) -> str:
    """ResNet-v1 bottleneck: 1x1 (reduce, strided) -> 3x3 -> 1x1 (expand,
    x4), with an identity or projection shortcut, then add and relu (the
    tail the fusion pass matches)."""
    x = _conv_bn(g, f"{name}_a", filters, (1, 1), (stride, stride), inputs)
    x = _conv_bn(g, f"{name}_b", filters, (3, 3), (1, 1), x)
    x = _conv_bn(g, f"{name}_c", filters * 4, (1, 1), (1, 1), x,
                 activation="identity")
    if project:
        shortcut = _conv_bn(g, f"{name}_proj", filters * 4, (1, 1),
                            (stride, stride), inputs, activation="identity")
    else:
        shortcut = inputs
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, shortcut)
    g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                f"{name}_add")
    return f"{name}_out"


def _basic_block(g, name: str, inputs: str, filters: int, stride: int,
                 project: bool) -> str:
    """ResNet-v1 basic block (3x3 -> 3x3) for ResNet-18/34, with an
    identity or projection (1x1, strided) shortcut, then add and relu."""
    x = _conv_bn(g, f"{name}_a", filters, (3, 3), (stride, stride), inputs)
    x = _conv_bn(g, f"{name}_b", filters, (3, 3), (1, 1), x,
                 activation="identity")
    if project:
        shortcut = _conv_bn(g, f"{name}_proj", filters, (1, 1),
                            (stride, stride), inputs, activation="identity")
    else:
        shortcut = inputs
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, shortcut)
    g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                f"{name}_add")
    return f"{name}_out"


def _resnet(stage_blocks, block_fn, bottleneck: bool, *, image_size: int,
            n_classes: int, seed: int, dtype: Optional[DtypePolicy],
            updater=None, device=None) -> ComputationGraph:
    g = (NeuralNetConfiguration.builder()
         .seed(seed).updater(updater or Nesterovs(0.1, 0.9))
         .dtype(dtype or BF16)
         .graph_builder()
         .add_inputs("img"))
    x = _conv_bn(g, "stem", 64, (7, 7), (2, 2), "img")
    g.add_layer("stem_pool",
                Subsampling(kernel=(3, 3), stride=(2, 2), pooling="max",
                            mode="same"),
                x)
    x = "stem_pool"
    filters = 64
    in_ch = 64
    for stage, n_blocks in enumerate(stage_blocks):
        out_ch = filters * 4 if bottleneck else filters
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            # a projection shortcut only where the shape changes
            project = b == 0 and (stride != 1 or in_ch != out_ch)
            x = block_fn(g, f"s{stage}b{b}", x, filters, stride, project)
            in_ch = out_ch
        filters *= 2
    g.add_layer("head_pool", GlobalPooling(pooling="avg"), x)
    g.add_layer("fc", Output(n_out=n_classes, loss="mcxent",
                             activation="softmax"), "head_pool")
    conf = (g.set_outputs("fc")
            .set_input_types(InputType.convolutional(image_size, image_size,
                                                     3))
            .build())
    return ComputationGraph(conf, device=device).init()


def resnet18(seed: int = 42, n_classes: int = 10, image_size: int = 32,
             dtype: Optional[DtypePolicy] = None, updater=None,
             device=None) -> ComputationGraph:
    """ResNet-18: basic-block stages [2, 2, 2, 2], sized for CIFAR-10 by
    default (32 x 32 x 3, 10 classes); BF16 and Nesterovs(0.1, 0.9). Its
    block tails are 3x3 convs, so the fusion pass matches none of them.
    Same configuration (and configuration.json) as the JAX package's
    ``zoo.resnet18``."""
    return _resnet([2, 2, 2, 2], _basic_block, False, image_size=image_size,
                   n_classes=n_classes, seed=seed, dtype=dtype,
                   updater=updater, device=device)


def resnet50(seed: int = 42, n_classes: int = 1000, image_size: int = 224,
             dtype: Optional[DtypePolicy] = None, updater=None,
             device=None) -> ComputationGraph:
    """ResNet-50 v1: bottleneck stages [3, 4, 6, 3] on NHWC images. Same
    configuration (and configuration.json) as the JAX package's
    ``zoo.resnet50``: BF16 policy and Nesterovs(0.1, 0.9) by default. With
    ``DL4J_TPU_FUSE_BLOCKS=1`` its training walk runs the 13 expand tails
    of stages 2-4 through the fused op (K4-K7 on the card). Runs on
    ``device`` (default: the card)."""
    return _resnet([3, 4, 6, 3], _bottleneck, True, image_size=image_size,
                   n_classes=n_classes, seed=seed, dtype=dtype,
                   updater=updater, device=device)
