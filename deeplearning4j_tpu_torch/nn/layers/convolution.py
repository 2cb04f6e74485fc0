"""Convolution, pooling and padding runtime layers (counterpart of
deeplearning4j_tpu/nn/layers/convolution.py: ``ConvolutionLayer``,
``Convolution1DLayerImpl``, ``SubsamplingLayerImpl``,
``Subsampling1DLayerImpl``, ``ZeroPaddingLayerImpl``). NHWC activations,
HWIO weights ([b, t, f] and [k, C_in, C_out] in 1-D); the product runs in
the compute dtype and the output stays in it.

``ConvolutionLayer`` takes the JAX package's two exact stride-2 rewrites
under its gates and flags, both off by default: space-to-depth for an
odd kxk/s2 conv (k >= 5) on at most 8 channels (``DL4J_TPU_S2D_STEM=1``),
and an unpadded strided 1x1 as slice + 1x1 (``DL4J_TPU_SLICE_1X1=1``).
The flags are read at each call, as there.

On a mesh's model axis (parallel/tensor.py) a convolution whose W is
sharded on its output channels computes this rank's channels from the
whole input (its gradient all-reduced), adds its slice of the bias,
applies the activation to its channels (after the gather where it mixes
channels, as softmax does) and gathers the channel axis.
"""

from __future__ import annotations

import os

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.ops import convolution as conv_ops
from deeplearning4j_tpu_torch.ops import initializers as init_mod
from deeplearning4j_tpu_torch.ops.activations import mixes_features
from deeplearning4j_tpu_torch.ops.convolution import pair as _pair
from deeplearning4j_tpu_torch.ops.convolution import spatial_padding


def _s2d_stem_enabled() -> bool:
    return os.environ.get("DL4J_TPU_S2D_STEM", "0") == "1"


def _slice_1x1_enabled() -> bool:
    return os.environ.get("DL4J_TPU_SLICE_1X1", "0") == "1"


class ConvolutionLayer(Layer):
    def init_params(self, gen, device):
        kh, kw = _pair(self.conf.kernel)
        c_in, c_out = self.conf.n_in, self.conf.n_out
        w_fn = init_mod.resolve(self.resolve("weight_init", "xavier"))
        params = {"W": w_fn(gen, (kh, kw, c_in, c_out), c_in * kh * kw,
                            c_out * kh * kw, self.param_dtype, device)}
        if self.conf.has_bias:
            params["b"] = torch.full(
                (c_out,), float(self.resolve("bias_init", 0.0)),
                dtype=self.param_dtype, device=device)
        return params

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._input_dropout(x, train, gen)
        kh, kw = _pair(self.conf.kernel)
        sh, sw = _pair(self.conf.stride)
        dh, dw = _pair(self.conf.dilation)
        pads = spatial_padding(
            (x.shape[1], x.shape[2]), (kh, kw), (sh, sw),
            _pair(self.conf.padding), self.conf.mode, (dh, dw))
        cd = self.compute_dtype
        # on a model axis: this rank's output channels from the whole x
        tp = self.tp if self.tp is not None and self.tp.rendered else None
        xc, wc = x.to(cd), params["W"].to(cd)
        if tp is not None:
            xc = tp.copy(xc)
        if (kh == kw == 1 and (sh > 1 or sw > 1) and (dh, dw) == (1, 1)
                and all(p == (0, 0) for p in pads) and _slice_1x1_enabled()):
            z = conv_ops.conv2d_strided_1x1_as_slice(xc, wc,
                                                     strides=(sh, sw))
        elif ((sh, sw) == (2, 2) and (dh, dw) == (1, 1) and kh % 2 == 1
                and kw % 2 == 1 and kh >= 5 and x.shape[-1] <= 8
                and _s2d_stem_enabled()):
            z = conv_ops.conv2d_space_to_depth(xc, wc, padding=pads)
        else:
            z = conv_ops.conv2d(xc, wc, strides=(sh, sw), padding=pads,
                                dilation=(dh, dw))
        return _channels_out(self, tp, z, params, cd), state


class Convolution1DLayerImpl(Layer):
    def feed_forward_mask(self, mask):
        c = self.conf
        eff_k = (c.kernel - 1) * c.dilation + 1
        return _downsample_time_mask(mask, eff_k, c.stride, c.padding, c.mode)

    def init_params(self, gen, device):
        k = int(self.conf.kernel)
        c_in, c_out = self.conf.n_in, self.conf.n_out
        w_fn = init_mod.resolve(self.resolve("weight_init", "xavier"))
        params = {"W": w_fn(gen, (k, c_in, c_out), c_in * k, c_out * k,
                            self.param_dtype, device)}
        if self.conf.has_bias:
            params["b"] = torch.full(
                (c_out,), float(self.resolve("bias_init", 0.0)),
                dtype=self.param_dtype, device=device)
        return params

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._input_dropout(x, train, gen)
        c = self.conf
        pads = spatial_padding((x.shape[1],), (c.kernel,), (c.stride,),
                               (c.padding,), c.mode, (c.dilation,))
        cd = self.compute_dtype
        tp = self.tp if self.tp is not None and self.tp.rendered else None
        xc = x.to(cd) if tp is None else tp.copy(x.to(cd))
        z = conv_ops.conv1d(xc, params["W"].to(cd), stride=c.stride,
                            padding=pads, dilation=c.dilation)
        return _channels_out(self, tp, z, params, cd), state


def _channels_out(layer, tp, z, params, cd):
    """A convolution's output from its product ``z``: the bias and the
    activation, and on a model axis (``tp``: z is this rank's output
    channels) the bias's slice, the activation on those channels and the
    gather of the channel axis (parallel/tensor.py)."""
    if "b" in params:
        b = params["b"] if tp is None else tp.bias(params["b"], "b")
        z = z + b.to(cd)
    if tp is None:
        return layer.activation_fn(z)
    if mixes_features(layer):    # softmax over channels: on them all
        return layer.activation_fn(tp.gather(z))
    return tp.gather(layer.activation_fn(z))


def _pool2d(x, *, kernel, strides, padding, pooling, pnorm):
    """The pooling op of ``pooling`` (the 2-D and 1-D subsampling layers
    share it)."""
    if pooling == "max":
        return conv_ops.max_pool2d(x, kernel=kernel, strides=strides,
                                   padding=padding)
    if pooling == "avg":
        return conv_ops.avg_pool2d(x, kernel=kernel, strides=strides,
                                   padding=padding)
    if pooling == "pnorm":
        return conv_ops.pnorm_pool2d(x, kernel=kernel, strides=strides,
                                     padding=padding, p=pnorm)
    raise ValueError(f"Unknown pooling type: {pooling}")


class SubsamplingLayerImpl(Layer):
    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        c = self.conf
        kernel, strides = _pair(c.kernel), _pair(c.stride)
        pads = spatial_padding(
            (x.shape[1], x.shape[2]), kernel, strides, _pair(c.padding),
            c.mode)
        return _pool2d(x, kernel=kernel, strides=strides, padding=pads,
                       pooling=c.pooling, pnorm=c.pnorm), state


def _downsample_time_mask(mask, kernel, stride, padding, mode):
    """A [b, t] mask downsampled with a conv's or pool's geometry: an
    output step is valid if ANY input step in its window is (f32, as in
    the JAX package)."""
    if mask is None:
        return None
    m = mask.reshape(mask.shape[0], -1)[:, :, None, None].to(torch.float32)
    pads = spatial_padding((m.shape[1],), (kernel,), (stride,), (padding,),
                           mode) + [(0, 0)]
    out = conv_ops.max_pool2d(m, kernel=(kernel, 1), strides=(stride, 1),
                              padding=pads)
    return out[:, :, 0, 0]


class Subsampling1DLayerImpl(Layer):
    """1D pooling on [b, t, f]: the 2-D pooling with a unit W axis."""

    def feed_forward_mask(self, mask):
        c = self.conf
        return _downsample_time_mask(mask, c.kernel, c.stride, c.padding,
                                     c.mode)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        c = self.conf
        pads = spatial_padding((x.shape[1],), (c.kernel,), (c.stride,),
                               (c.padding,), c.mode) + [(0, 0)]
        y = _pool2d(x[:, :, None, :], kernel=(c.kernel, 1),
                    strides=(c.stride, 1), padding=pads, pooling=c.pooling,
                    pnorm=c.pnorm)
        return y[:, :, 0, :], state


class ZeroPaddingLayerImpl(Layer):
    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        t, b, l, r = self.conf.pad
        return torch.nn.functional.pad(x, (0, 0, l, r, t, b)), state
