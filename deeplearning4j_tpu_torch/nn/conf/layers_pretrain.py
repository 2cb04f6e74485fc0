"""The pretrain-family and special-output layer configs: the
reconstruction distributions, ``VariationalAutoencoder``, ``AutoEncoder``,
``RBM``, ``CenterLossOutput`` and ``Frozen`` (counterpart of
deeplearning4j_tpu/nn/conf/layers_pretrain.py).

Fields, kinds and JSON are the JAX package's: a VAE's reconstruction
distribution is a nested dict (``kind``; a composite's distributions as
[n, dict] pairs) and ``Frozen``'s inner layer a nested layer dict, so
these nets cross between the packages through the zip.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

from deeplearning4j_tpu_torch.nn.conf.layers import (BaseLayerConfig,
                                                     FeedForwardLayerConfig,
                                                     layer_from_dict,
                                                     register_layer)


# ---------------------------------------------------------------------------
# Reconstruction distributions (specs; the math is in layers/variational.py)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReconstructionDistribution:
    kind = "base"

    def to_dict(self):
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "distributions":
                v = [[n, inner.to_dict()] for n, inner in v]
            d[f.name] = v
        d["kind"] = self.kind
        return d

    def param_size(self, data_size: int) -> int:
        raise NotImplementedError


_DISTRIBUTIONS: dict[str, type] = {}


def register_distribution(cls):
    _DISTRIBUTIONS[cls.kind] = cls
    return cls


def distribution_from_dict(d: dict) -> ReconstructionDistribution:
    d = dict(d)
    kind = d.pop("kind")
    if kind == "composite":
        d["distributions"] = tuple(
            (n, distribution_from_dict(inner))
            for n, inner in d.get("distributions", ()))
    cls = _DISTRIBUTIONS[kind]
    names = {f.name for f in dataclasses.fields(cls)}
    for k, v in list(d.items()):
        if isinstance(v, list) and k in names and k != "distributions":
            d[k] = tuple(v)
    return cls(**{k: v for k, v in d.items() if k in names})


@register_distribution
@dataclass(frozen=True)
class BernoulliReconstruction(ReconstructionDistribution):
    """p(x|z) Bernoulli with sigmoid'd logits."""

    kind = "bernoulli"

    def param_size(self, data_size: int) -> int:
        return data_size


@register_distribution
@dataclass(frozen=True)
class GaussianReconstruction(ReconstructionDistribution):
    """p(x|z) diagonal Gaussian: the head emits [mean, log var]."""

    kind = "gaussian"
    activation: str = "identity"

    def param_size(self, data_size: int) -> int:
        return 2 * data_size


@register_distribution
@dataclass(frozen=True)
class ExponentialReconstruction(ReconstructionDistribution):
    """p(x|z) exponential; the head emits gamma = log(lambda)."""

    kind = "exponential"

    def param_size(self, data_size: int) -> int:
        return data_size


@register_distribution
@dataclass(frozen=True)
class LossWrapperReconstruction(ReconstructionDistribution):
    """-log p(x|z) := a standard loss."""

    kind = "loss_wrapper"
    loss: str = "mse"
    activation: str = "identity"

    def param_size(self, data_size: int) -> int:
        return data_size


@register_distribution
@dataclass(frozen=True)
class CompositeReconstruction(ReconstructionDistribution):
    """Different distributions over feature ranges: a tuple of
    (num_features, distribution)."""

    kind = "composite"
    distributions: Tuple = ()

    def param_size(self, data_size: int) -> int:
        if sum(n for n, _ in self.distributions) != data_size:
            raise ValueError("Composite distribution sizes must sum to the "
                             f"data size {data_size}")
        return sum(d.param_size(n) for n, d in self.distributions)


# ---------------------------------------------------------------------------
# Layer configs
# ---------------------------------------------------------------------------

@register_layer
@dataclass(frozen=True)
class VariationalAutoencoder(FeedForwardLayerConfig):
    """A VAE as ONE layer: encoder and decoder MLPs, the
    reparameterization, the ELBO. n_out is the latent size; the supervised
    forward emits the posterior mean. Pretrains on unlabeled features
    through ``pretrain``."""

    layer_type = "vae"
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    reconstruction: ReconstructionDistribution = field(
        default_factory=BernoulliReconstruction)
    num_samples: int = 1

    @classmethod
    def _decode_fields(cls, d):
        if isinstance(d.get("reconstruction"), dict):
            d["reconstruction"] = distribution_from_dict(d["reconstruction"])
        return d

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.variational import VAELayer
        return VAELayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class AutoEncoder(FeedForwardLayerConfig):
    """Denoising autoencoder: ``corruption_level`` zeroes inputs during
    pretraining; the supervised forward is the encoder."""

    layer_type = "autoencoder"
    corruption_level: float = 0.3
    loss: str = "mse"

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.pretrain import (
            AutoEncoderLayer)
        return AutoEncoderLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class RBM(FeedForwardLayerConfig):
    """Restricted Boltzmann machine: CD-k pretraining, the sigmoid
    propup as the forward."""

    layer_type = "rbm"
    k: int = 1  # contrastive divergence steps

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.pretrain import RBMLayer
        return RBMLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class CenterLossOutput(FeedForwardLayerConfig):
    """Softmax classification + center loss: loss = dataLoss + lambda/2 *
    ||f - c_y||^2; the class centers live in layer state and track the
    features with an ``alpha`` moving average."""

    layer_type = "center_loss_output"
    loss: str = "mcxent"
    alpha: float = 0.05
    lmbda: float = 2e-4
    has_bias: bool = True

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.pretrain import (
            CenterLossOutputLayer)
        return CenterLossOutputLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class Frozen(BaseLayerConfig):
    """Freeze a wrapped layer: the forward passes through; the parameters
    get no update and no regularization."""

    layer_type = "frozen"
    inner: Optional[BaseLayerConfig] = None

    def with_n_in(self, input_type):
        return self.replace(inner=self.inner.with_n_in(input_type))

    def get_output_type(self, input_type):
        return self.inner.get_output_type(input_type)

    def has_params(self) -> bool:
        return self.inner.has_params()

    def replace(self, **kw):
        # keep the wrapper's name and the inner layer's in step
        if "name" in kw and self.inner is not None:
            kw = dict(kw, inner=dataclasses.replace(self.inner,
                                                    name=kw["name"]))
        return dataclasses.replace(self, **kw)

    @classmethod
    def _decode_fields(cls, d):
        if isinstance(d.get("inner"), dict):
            d["inner"] = layer_from_dict(d["inner"])
        return d

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.pretrain import (
            FrozenLayerWrapper)
        return FrozenLayerWrapper(self, input_type, global_conf, policy)
