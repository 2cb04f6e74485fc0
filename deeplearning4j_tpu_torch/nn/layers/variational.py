"""The variational autoencoder runtime layer (counterpart of
deeplearning4j_tpu/nn/layers/variational.py).

Encoder and decoder MLPs inside ONE layer, the reparameterization, and
the -ELBO with a pluggable reconstruction distribution as the layer's
``pretrain_loss``. The supervised forward emits the posterior mean. The
reparameterization's draws come from the net's ``torch.Generator``;
``pretrain_loss(..., eps=...)`` takes them from the caller instead (the
seam the tests hold the -ELBO against the JAX package's through).
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn.conf.layers_pretrain import (
    BernoulliReconstruction, CompositeReconstruction,
    ExponentialReconstruction, GaussianReconstruction,
    LossWrapperReconstruction)
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.ops import activations as act_mod
from deeplearning4j_tpu_torch.ops import initializers as init_mod
from deeplearning4j_tpu_torch.ops import losses as losses_mod


def _neg_log_prob(dist, x, raw):
    """-log p(x|z) summed over features, mean over the batch. ``raw`` is
    the reconstruction head's raw output (the distribution's
    parameters)."""
    if isinstance(dist, BernoulliReconstruction):
        p = torch.sigmoid(raw)
        eps = 1e-7
        ll = x * torch.log(p + eps) + (1 - x) * torch.log(1 - p + eps)
        return -torch.mean(torch.sum(ll, dim=-1))
    if isinstance(dist, GaussianReconstruction):
        n = x.shape[-1]
        mean = act_mod.get(dist.activation)(raw[..., :n])
        logvar = raw[..., n:]
        ll = -0.5 * (math.log(2 * math.pi) + logvar
                     + (x - mean) ** 2 / torch.exp(logvar))
        return -torch.mean(torch.sum(ll, dim=-1))
    if isinstance(dist, ExponentialReconstruction):
        gamma = raw  # log(lambda)
        ll = gamma - torch.exp(gamma) * x
        return -torch.mean(torch.sum(ll, dim=-1))
    if isinstance(dist, LossWrapperReconstruction):
        return losses_mod.get(dist.loss).score(
            x, raw, act_mod.get(dist.activation), None)
    if isinstance(dist, CompositeReconstruction):
        total = 0.0
        x_off = p_off = 0
        for n, inner in dist.distributions:
            psize = inner.param_size(n)
            total = total + _neg_log_prob(
                inner, x[..., x_off:x_off + n], raw[..., p_off:p_off + psize])
            x_off += n
            p_off += psize
        return total
    raise TypeError(f"Unknown reconstruction distribution {type(dist)}")


class VAELayer(Layer):
    is_pretrainable = True

    def _sizes(self):
        c = self.conf
        return [c.n_in, *c.encoder_layer_sizes], [c.n_out,
                                                  *c.decoder_layer_sizes]

    def init_params(self, gen, device):
        c = self.conf
        w_fn = init_mod.resolve(self.resolve("weight_init", "xavier"))
        dt = self.param_dtype
        enc, dec = self._sizes()

        def dense(n_in, n_out):
            return {"W": w_fn(gen, (n_in, n_out), n_in, n_out, dt, device),
                    "b": torch.zeros((n_out,), dtype=dt, device=device)}

        params = {}
        for i in range(len(enc) - 1):
            params[f"enc{i}"] = dense(enc[i], enc[i + 1])
        params["mean"] = dense(enc[-1], c.n_out)
        params["logvar"] = dense(enc[-1], c.n_out)
        for i in range(len(dec) - 1):
            params[f"dec{i}"] = dense(dec[i], dec[i + 1])
        params["recon"] = dense(dec[-1], c.reconstruction.param_size(c.n_in))
        return params

    def _mlp(self, params, prefix, n_layers, x):
        act = self.activation_fn
        for i in range(n_layers):
            p = params[f"{prefix}{i}"]
            x = act(x @ p["W"] + p["b"])
        return x

    def encode(self, params, x):
        """(posterior mean, posterior log variance)."""
        h = self._mlp(params, "enc", len(self.conf.encoder_layer_sizes), x)
        mean = h @ params["mean"]["W"] + params["mean"]["b"]
        logvar = h @ params["logvar"]["W"] + params["logvar"]["b"]
        return mean, logvar

    def decode(self, params, z):
        """The reconstruction head's raw output at latent ``z``."""
        d = self._mlp(params, "dec", len(self.conf.decoder_layer_sizes), z)
        return d @ params["recon"]["W"] + params["recon"]["b"]

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._input_dropout(x, train, gen)
        mean, _ = self.encode(params, x)
        return mean, state  # the posterior mean

    @staticmethod
    def kl(mean, logvar):
        """KL(q(z|x) || N(0, I)) per example."""
        return -0.5 * torch.sum(1 + logvar - mean ** 2 - torch.exp(logvar),
                                dim=-1)

    def pretrain_loss(self, params, x, gen, eps=None):
        """-ELBO = reconstruction NLL + KL(q(z|x) || N(0, I)), averaged over
        the batch and ``num_samples`` draws of z. ``eps`` ([num_samples,
        *mean.shape]) gives the reparameterization's standard-normal draws;
        by default they come from ``gen``."""
        c = self.conf
        x = x.to(self.param_dtype)
        mean, logvar = self.encode(params, x)
        recon = 0.0
        for s in range(c.num_samples):
            e = (eps[s] if eps is not None else
                 torch.randn(mean.shape, generator=gen, dtype=mean.dtype,
                             device=mean.device))
            z = mean + torch.exp(0.5 * logvar) * e
            recon = recon + _neg_log_prob(c.reconstruction, x,
                                          self.decode(params, z))
        return recon / c.num_samples + torch.mean(self.kl(mean, logvar))

    def reconstruction_error(self, params, x, gen=None):
        """The reconstruction NLL at the posterior mean (deterministic;
        usable as an anomaly score)."""
        mean, _ = self.encode(params, x)
        return _neg_log_prob(self.conf.reconstruction, x,
                             self.decode(params, mean))

    def generate_at_mean_given_z(self, params, z):
        """Decode latent codes to the distribution's mean."""
        raw = self.decode(params, z)
        dist = self.conf.reconstruction
        if isinstance(dist, BernoulliReconstruction):
            return torch.sigmoid(raw)
        if isinstance(dist, GaussianReconstruction):
            n = raw.shape[-1] // 2
            return act_mod.get(dist.activation)(raw[..., :n])
        return raw
