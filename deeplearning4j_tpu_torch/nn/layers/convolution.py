"""Convolution and pooling runtime layers (counterpart of
deeplearning4j_tpu/nn/layers/convolution.py: ``ConvolutionLayer`` and
``SubsamplingLayerImpl``). NHWC activations, HWIO weights; the product
runs in the compute dtype and the output stays in it.

The JAX package's exact stride-2 rewrites (space-to-depth for the stem,
strided 1x1 as slice + 1x1), both off by default there, and p-norm
subsampling are not ported.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.ops import convolution as conv_ops
from deeplearning4j_tpu_torch.ops import initializers as init_mod
from deeplearning4j_tpu_torch.ops.convolution import pair as _pair
from deeplearning4j_tpu_torch.ops.convolution import spatial_padding


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
        z = conv_ops.conv2d(x.to(cd), params["W"].to(cd), strides=(sh, sw),
                            padding=pads, dilation=(dh, dw))
        if "b" in params:
            z = z + params["b"].to(cd)
        return self.activation_fn(z), state


class SubsamplingLayerImpl(Layer):
    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        c = self.conf
        kernel, strides = _pair(c.kernel), _pair(c.stride)
        pads = spatial_padding(
            (x.shape[1], x.shape[2]), kernel, strides, _pair(c.padding),
            c.mode)
        if c.pooling == "max":
            y = conv_ops.max_pool2d(x, kernel=kernel, strides=strides,
                                    padding=pads)
        elif c.pooling == "avg":
            y = conv_ops.avg_pool2d(x, kernel=kernel, strides=strides,
                                    padding=pads)
        elif c.pooling == "pnorm":
            raise NotImplementedError(
                "Subsampling with pooling='pnorm' is not ported to "
                "deeplearning4j_tpu_torch yet")
        else:
            raise ValueError(f"Unknown pooling type: {c.pooling}")
        return y, state
