"""Batch-norm and LRN runtime layers (counterpart of
deeplearning4j_tpu/nn/layers/normalization.py: ``BatchNormLayer``,
``LRNLayer``).

Training uses the batch statistics through ops/normalization.py's
``batch_norm_train`` with the RUNNING mean as the variance shift, and
returns the new running statistics, d * old + (1 - d) * batch, in the
param dtype. Inference uses the running statistics.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.ops.convolution import lrn
from deeplearning4j_tpu_torch.ops.normalization import batch_norm_train


class BatchNormLayer(Layer):
    def _num_features(self):
        it = self.input_type
        if it is None:
            raise ValueError("BatchNorm requires an input_type for init")
        if it.kind == "convolutional":
            return it.channels
        return it.flat_size()

    def init_params(self, gen, device):
        if self.conf.lock_gamma_beta:
            return {}
        f = self._num_features()
        return {
            "gamma": torch.full((f,), float(self.conf.gamma),
                                dtype=self.param_dtype, device=device),
            "beta": torch.full((f,), float(self.conf.beta),
                               dtype=self.param_dtype, device=device),
        }

    def init_state(self, device="cpu"):
        f = self._num_features()
        return {"mean": torch.zeros((f,), dtype=self.param_dtype,
                                    device=device),
                "var": torch.ones((f,), dtype=self.param_dtype,
                                  device=device)}

    def gamma_beta(self, params, f, device):
        """The layer's (gamma, beta): its params, or the configured
        constants when ``lock_gamma_beta``."""
        if params:
            return params["gamma"], params["beta"]
        c = self.conf
        return (torch.full((f,), float(c.gamma), dtype=self.param_dtype,
                           device=device),
                torch.full((f,), float(c.beta), dtype=self.param_dtype,
                           device=device))

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        c = self.conf
        gamma, beta = self.gamma_beta(params, x.shape[-1], x.device)
        if train:
            xhat, mean, var = batch_norm_train(x, gamma, beta,
                                               state["mean"], c.eps)
            d = c.decay
            sd = self.param_dtype
            new_state = {
                "mean": d * state["mean"] + (1 - d) * mean.to(sd),
                "var": d * state["var"] + (1 - d) * var.to(sd),
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = {}
            inv = torch.rsqrt(var + c.eps)
            scale, shift = gamma * inv, beta - mean * gamma * inv
            xhat = x * scale.to(x.dtype) + shift.to(x.dtype)
        return self.activation_fn(xhat), new_state


class LRNLayer(Layer):
    """Across-channel local response normalization on NHWC
    (ops/convolution.py's ``lrn``)."""

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        c = self.conf
        return lrn(x, k=c.k, n=c.n, alpha=c.alpha, beta=c.beta), state
