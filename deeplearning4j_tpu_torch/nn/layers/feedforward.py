"""Dense, output and activation runtime layers (counterpart of
deeplearning4j_tpu/nn/layers/feedforward.py: ``DenseLayer``,
``OutputLayer``, ``ActivationOnlyLayer``).

The product runs in the layer's compute dtype (bf16 under the BF16
policy, params stay f32); the output head forms its activation and its
loss in the param dtype.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.ops import initializers as init_mod
from deeplearning4j_tpu_torch.ops import losses as losses_mod


class DenseLayer(Layer):
    def init_params(self, gen, device):
        n_in, n_out = self.conf.n_in, self.conf.n_out
        w_fn = init_mod.resolve(self.resolve("weight_init", "xavier"))
        params = {"W": w_fn(gen, (n_in, n_out), n_in, n_out,
                            self.param_dtype, device)}
        if getattr(self.conf, "has_bias", True):
            params["b"] = torch.full(
                (n_out,), float(self.resolve("bias_init", 0.0)),
                dtype=self.param_dtype, device=device)
        return params

    def preout(self, params, x):
        cd = self.compute_dtype
        z = torch.matmul(x.to(cd), params["W"].to(cd))
        if "b" in params:
            z = z + params["b"].to(cd)
        return z

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._input_dropout(x, train, gen)
        return self.activation_fn(self.preout(params, x)), state


class OutputLayer(DenseLayer):
    """Dense layer + loss head."""

    @property
    def loss_fn(self) -> losses_mod.Loss:
        return losses_mod.get(self.conf.loss)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        # the head's activation in the param dtype, so served outputs are
        # full precision under any policy
        x = self._input_dropout(x, train, gen)
        z = self.preout(params, x).to(self.param_dtype)
        return self.activation_fn(z), state

    def loss(self, params, x, labels, *, train=False, gen=None, mask=None):
        x = self._input_dropout(x, train, gen)
        z = self.preout(params, x).to(self.param_dtype)
        return self.loss_fn.score(labels.to(z.dtype), z, self.activation_fn,
                                  mask)


class ActivationOnlyLayer(Layer):
    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        return self.activation_fn(x), state
