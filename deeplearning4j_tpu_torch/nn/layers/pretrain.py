"""The AutoEncoder, RBM, center-loss output and frozen-layer runtime
layers, and the pretraining step (counterpart of
deeplearning4j_tpu/nn/layers/pretrain.py).

A pretrainable layer (``is_pretrainable``: AutoEncoder, RBM, and the VAE
of nn/layers/variational.py) has ``pretrain_loss(params, x, gen)``, its
unsupervised objective; ``pretrain_step`` differentiates it and applies
the layer's updater in place, the step ``MultiLayerNetwork.pretrain`` and
``ComputationGraph.pretrain`` run. The random draws (the AE's corruption
mask, the RBM's Gibbs samples) come from the net's ``torch.Generator``;
the JAX package's ``jax.random`` bits cannot be reproduced.

The frozen wrapper delegates the forward, the loss and every capability
flag to the wrapped layer; its updater is ``NoOp`` and its
regularization zero. A train step hands a frozen layer's parameters to
autograd without ``requires_grad`` (nn/multistep.py's ``step_leaves``),
so no weight gradient is computed for them, and the multi-tensor update
leaves them alone. Batch-norm running statistics in a frozen layer still
move under ``train=True``, as the delegated ``apply`` returns them.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.feedforward import (DenseLayer,
                                                            OutputLayer)
from deeplearning4j_tpu_torch.nn.precision import tree_grads
from deeplearning4j_tpu_torch.nn.updater import (NoOp, _map,
                                                 apply_layer_updates)
from deeplearning4j_tpu_torch.ops import losses as losses_mod


def pretrain_step(layer, gc, params, opt_state, iteration, x, gen):
    """One pretraining step of ``layer`` on its input ``x``: autograd of
    ``layer.pretrain_loss`` and the layer's updater, in place on
    ``params[layer.name]`` and ``opt_state[layer.name]``. Returns the loss
    as a 0-d tensor."""
    name = layer.name
    leaves = {name: _map(lambda t: t.detach().requires_grad_(),
                         params[name])}
    loss = layer.pretrain_loss(leaves[name], x, gen)
    grads = {name: tree_grads(loss, leaves[name])}
    apply_layer_updates([layer], gc, leaves, grads, opt_state, iteration)
    return loss.detach()


class AutoEncoderLayer(DenseLayer):
    """Denoising autoencoder: the encoder is the dense forward; the
    pretraining loss reconstructs the uncorrupted input through the tied
    decoder (W^T and a visible bias ``vb``)."""

    is_pretrainable = True

    def init_params(self, gen, device):
        params = super().init_params(gen, device)
        params["vb"] = torch.zeros((self.conf.n_in,), dtype=self.param_dtype,
                                   device=device)
        return params

    def pretrain_loss(self, params, x, gen):
        c = self.conf
        x = x.to(self.param_dtype)
        corrupted = x
        if c.corruption_level > 0:
            keep = torch.rand(x.shape, generator=gen,
                              device=x.device) < 1.0 - c.corruption_level
            corrupted = torch.where(keep, x, torch.zeros_like(x))
        h = self.activation_fn(self.preout(params, corrupted))
        recon = h @ params["W"].T + params["vb"]
        return losses_mod.get(c.loss).score(x, recon, self.activation_fn,
                                            None)


class RBMLayer(DenseLayer):
    """Bernoulli-Bernoulli RBM. Pretraining is CD-k: the free-energy
    difference F(v_data) - F(v_model) with the Gibbs chain's end detached,
    whose gradient is the classic CD update."""

    is_pretrainable = True

    def init_params(self, gen, device):
        params = super().init_params(gen, device)
        params["vb"] = torch.zeros((self.conf.n_in,), dtype=self.param_dtype,
                                   device=device)
        return params

    def _hidden_bias(self, params):
        W = params["W"]
        return params.get("b", torch.zeros((self.conf.n_out,),
                                           dtype=W.dtype, device=W.device))

    def _propup(self, params, v):
        return torch.sigmoid(v @ params["W"] + self._hidden_bias(params))

    def _propdown(self, params, h):
        return torch.sigmoid(h @ params["W"].T + params["vb"])

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._input_dropout(x, train, gen)
        return self._propup(params, x.to(self.param_dtype)), state

    def _free_energy(self, params, v):
        wx_b = v @ params["W"] + self._hidden_bias(params)
        return (-v @ params["vb"]
                - torch.logaddexp(wx_b, torch.zeros_like(wx_b)).sum(-1))

    def pretrain_loss(self, params, x, gen):
        v0 = x.to(self.param_dtype)
        v = v0
        for _ in range(self.conf.k):
            h = torch.bernoulli(self._propup(params, v).detach(),
                                generator=gen)
            v = self._propdown(params, h)
        v_model = v.detach()
        return torch.mean(self._free_energy(params, v0)
                          - self._free_energy(params, v_model))


class CenterLossOutputLayer(OutputLayer):
    """Softmax + center loss: total = dataLoss + lambda/2 * ||f - c_y||^2.
    The class centers live in layer STATE and track the class-mean
    features with an ``alpha`` moving average (``update_centers``, applied
    in the train step outside the differentiated loss)."""

    loss_uses_state = True

    def init_state(self, device="cpu"):
        return {"centers": torch.zeros((self.conf.n_out, self.conf.n_in),
                                       dtype=self.param_dtype,
                                       device=device)}

    def loss(self, params, x, labels, *, train=False, gen=None, mask=None,
             state=None):
        base = super().loss(params, x, labels, train=train, gen=gen,
                            mask=mask)
        centers = state["centers"] if state is not None else None
        if centers is None:
            return base
        c_y = labels.to(centers.dtype) @ centers  # each example's center
        sq = torch.sum((x - c_y) ** 2, dim=-1)
        if mask is not None:
            m = mask.reshape(-1).to(sq.dtype)
            center_term = 0.5 * self.conf.lmbda * (
                torch.sum(sq * m) / torch.clamp(torch.sum(m), min=1.0))
        else:
            center_term = 0.5 * self.conf.lmbda * torch.mean(sq)
        return base + center_term

    def update_centers(self, state, x, labels, mask=None):
        """The alpha moving-average center update; masked examples are
        left out."""
        centers = state["centers"]
        labels = labels.to(centers.dtype)
        if mask is not None:
            labels = labels * mask.reshape(-1, 1).to(labels.dtype)
        counts = torch.clamp(labels.sum(dim=0), min=1.0)[:, None]
        batch_means = (labels.T @ x.to(centers.dtype)) / counts
        present = (labels.sum(dim=0) > 0)[:, None]
        a = self.conf.alpha
        return {"centers": torch.where(
            present, (1 - a) * centers + a * batch_means, centers)}


class FrozenLayerWrapper(Layer):
    """Delegates the forward to the wrapped layer; freezing comes from
    ``resolve("updater")`` -> ``NoOp`` and zero regularization."""

    # pinned (not delegated): pretraining a frozen layer is a no-op
    is_pretrainable = False

    def __init__(self, conf, input_type, global_conf, policy):
        super().__init__(conf, input_type, global_conf, policy)
        self.inner = conf.inner.make_layer(input_type, global_conf, policy)

    def resolve(self, name, default=None):
        if name == "updater":
            return NoOp()
        return self.inner.resolve(name, default)

    def init_params(self, gen, device):
        return self.inner.init_params(gen, device)

    def init_state(self, device="cpu"):
        return self.inner.init_state(device)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        return self.inner.apply(params, state, x, train=train, gen=gen,
                                mask=mask)

    def feed_forward_mask(self, mask):
        return self.inner.feed_forward_mask(mask)

    def regularization(self, params):
        device = next(iter(params.values())).device if params else "cpu"
        return torch.zeros((), dtype=self.param_dtype, device=device)

    def loss(self, params, x, labels, *, train=False, gen=None, mask=None,
             **kwargs):
        return self.inner.loss(params, x, labels, train=train, gen=gen,
                               mask=mask, **kwargs)

    def update_centers(self, state, x, labels, mask=None):
        """Frozen: a center-loss term still enters the loss through the
        delegated ``loss``, but the centers do not move."""
        return state

    def __getattr__(self, name):
        # capability flags and hooks of the wrapped layer, so wrapping an
        # output layer drops none of its loss terms
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)
