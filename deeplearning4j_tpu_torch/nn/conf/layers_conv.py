"""Convolutional-family layer configs (counterpart of
deeplearning4j_tpu/nn/conf/layers_conv.py): ``Convolution2D``,
``Convolution1D``, ``Subsampling``, ``Subsampling1D``, ``ZeroPadding``,
``BatchNorm``, ``LocalResponseNormalization`` and ``GlobalPooling``, with
the same fields and JSON ``layer_type``s. Layout is NHWC ([batch, time,
features] for the 1-D variants).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseLayerConfig,
    FeedForwardLayerConfig,
    register_layer,
)
from deeplearning4j_tpu_torch.ops.convolution import out_size
from deeplearning4j_tpu_torch.ops.convolution import pair as _pair


@register_layer
@dataclass(frozen=True)
class Convolution2D(FeedForwardLayerConfig):
    """2D convolution. n_in = input channels (inferred), n_out = output
    channels. ``mode`` is the ConvolutionMode: 'truncate', 'strict' or
    'same'."""

    layer_type = "conv2d"
    expects_cnn_input = True

    kernel: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    mode: str = "truncate"
    has_bias: bool = True

    def with_n_in(self, input_type: InputType):
        if self.n_in is None:
            if input_type.kind not in ("convolutional", "convolutional_flat"):
                raise ValueError(
                    f"Convolution2D needs convolutional input, got "
                    f"{input_type.kind}")
            return self.replace(n_in=input_type.channels)
        return self

    def get_output_type(self, input_type: InputType) -> InputType:
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        h = out_size(input_type.height, kh, sh, ph, self.mode, dh)
        w = out_size(input_type.width, kw, sw, pw, self.mode, dw)
        return InputType.convolutional(h, w, self.n_out)

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.convolution import (
            ConvolutionLayer)
        return ConvolutionLayer(self, input_type, global_conf, policy)


# DL4J name alias
Convolution = Convolution2D


@register_layer
@dataclass(frozen=True)
class Convolution1D(FeedForwardLayerConfig):
    """1D convolution over [batch, time, features]; W is
    [kernel, n_in, n_out]."""

    layer_type = "conv1d"
    expects_rnn_input = True

    kernel: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    mode: str = "truncate"
    has_bias: bool = True

    def with_n_in(self, input_type: InputType):
        if self.n_in is None:
            if input_type.kind != "recurrent":
                raise ValueError(
                    f"Convolution1D needs recurrent input, got "
                    f"{input_type.kind}")
            return self.replace(n_in=input_type.size)
        return self

    def get_output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        t_out = None if t is None else out_size(
            t, self.kernel, self.stride, self.padding, self.mode,
            self.dilation)
        return InputType.recurrent(self.n_out, t_out)

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.convolution import (
            Convolution1DLayerImpl)
        return Convolution1DLayerImpl(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class Subsampling(BaseLayerConfig):
    """2D pooling; ``pooling`` in {max, avg, pnorm}, ``pnorm`` the p
    exponent."""

    layer_type = "subsampling"
    expects_cnn_input = True

    kernel: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    pooling: str = "max"
    pnorm: int = 2
    mode: str = "truncate"

    def get_output_type(self, input_type: InputType) -> InputType:
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        h = out_size(input_type.height, kh, sh, ph, self.mode)
        w = out_size(input_type.width, kw, sw, pw, self.mode)
        return InputType.convolutional(h, w, input_type.channels)

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.convolution import (
            SubsamplingLayerImpl)
        return SubsamplingLayerImpl(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class Subsampling1D(BaseLayerConfig):
    """1D pooling over [batch, time, features]."""

    layer_type = "subsampling1d"
    expects_rnn_input = True

    kernel: int = 2
    stride: int = 2
    padding: int = 0
    pooling: str = "max"
    pnorm: int = 2
    mode: str = "truncate"

    def get_output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        t_out = None if t is None else out_size(
            t, self.kernel, self.stride, self.padding, self.mode)
        return InputType.recurrent(input_type.size, t_out)

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.convolution import (
            Subsampling1DLayerImpl)
        return Subsampling1DLayerImpl(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class ZeroPadding(BaseLayerConfig):
    """Spatial zero padding; pad = (top, bottom, left, right)."""

    layer_type = "zero_padding"
    expects_cnn_input = True

    pad: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def get_output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = self.pad
        return InputType.convolutional(
            input_type.height + t + b, input_type.width + l + r,
            input_type.channels)

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.convolution import (
            ZeroPaddingLayerImpl)
        return ZeroPaddingLayerImpl(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class BatchNorm(BaseLayerConfig):
    """Batch normalization: learnable gamma/beta (unless
    ``lock_gamma_beta``); running mean/var in the layer state, updated with
    ``decay`` while training. Works on [b, f] and [b, h, w, c] inputs."""

    layer_type = "batch_norm"

    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0
    lock_gamma_beta: bool = False

    def has_params(self) -> bool:
        return True

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.normalization import (
            BatchNormLayer)
        return BatchNormLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class LocalResponseNormalization(BaseLayerConfig):
    """Across-channel LRN (defaults k=2, n=5, alpha=1e-4, beta=0.75)."""

    layer_type = "lrn"
    expects_cnn_input = True

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.normalization import LRNLayer
        return LRNLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class GlobalPooling(BaseLayerConfig):
    """Global pooling over time ([b, t, f]) or space ([b, h, w, c]);
    ``pooling`` in {max, avg, sum, pnorm}."""

    layer_type = "global_pooling"

    pooling: str = "max"
    pnorm: int = 2

    def get_output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "recurrent":
            return InputType.feed_forward(input_type.size)
        if input_type.kind == "convolutional":
            return InputType.feed_forward(input_type.channels)
        return input_type

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.pooling import (
            GlobalPoolingLayerImpl)
        return GlobalPoolingLayerImpl(self, input_type, global_conf, policy)
