"""Layer configuration base classes, the layer-type registry and the
feed-forward configs ``Dense``, ``Output``, ``LossLayer``,
``ActivationLayer``, ``Dropout`` and ``Embedding`` (counterpart of
deeplearning4j_tpu/nn/conf/layers.py).

Each config is a frozen dataclass registered by ``layer_type``, with the
same fields in the same order as in the JAX package, so that
``layer_to_dict`` gives the same JSON. A layer type the registry does not
know is refused by name when a configuration names it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.updater import Updater, updater_from_dict

LAYER_REGISTRY: dict[str, type] = {}


def register_layer(cls):
    LAYER_REGISTRY[cls.layer_type] = cls
    return cls


def _encode(v):
    if isinstance(v, BaseLayerConfig):
        return layer_to_dict(v)
    if hasattr(v, "to_dict"):
        return v.to_dict()
    if isinstance(v, tuple):
        return [_encode(x) for x in v]
    return v


def layer_to_dict(layer: "BaseLayerConfig") -> dict:
    d = {}
    for f in dataclasses.fields(layer):
        v = getattr(layer, f.name)
        if v is None:
            continue
        d[f.name] = _encode(v)
    d["layer_type"] = layer.layer_type
    return d


def layer_from_dict(d: dict) -> "BaseLayerConfig":
    d = dict(d)
    ltype = d.pop("layer_type")
    cls = LAYER_REGISTRY.get(ltype)
    if cls is None:
        raise ValueError(
            f"unknown layer type {ltype!r} (known: {sorted(LAYER_REGISTRY)})")
    if "updater" in d and isinstance(d["updater"], dict):
        d["updater"] = updater_from_dict(d["updater"])
    if hasattr(cls, "_decode_fields"):  # nested configs (Frozen's inner)
        d = cls._decode_fields(d)
    fields = {f.name for f in dataclasses.fields(cls)}
    # tuple-valued fields arrive as lists from JSON
    for k, v in list(d.items()):
        if isinstance(v, list) and k in fields:
            d[k] = tuple(v)
    return cls(**{k: v for k, v in d.items() if k in fields})


@dataclass(frozen=True)
class BaseLayerConfig:
    """Common per-layer hyperparameters. ``None`` means "inherit from the
    global NeuralNetConfiguration"."""

    layer_type = "base"

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[Any] = None     # str name or distribution dict
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    dropout: Optional[float] = None       # drop probability (0 disables)
    updater: Optional[Updater] = None
    learning_rate: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    def with_n_in(self, input_type: InputType) -> "BaseLayerConfig":
        """A copy with n_in (etc.) inferred from the input type."""
        return self

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type

    def make_layer(self, input_type: InputType, global_conf, policy):
        raise NotImplementedError

    def has_params(self) -> bool:
        return False

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FeedForwardLayerConfig(BaseLayerConfig):
    """Base for layers with (n_in, n_out) dense-style params."""

    layer_type = "feed_forward"
    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def with_n_in(self, input_type: InputType) -> "FeedForwardLayerConfig":
        if self.n_in is None:
            return self.replace(n_in=input_type.flat_size())
        return self

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def has_params(self) -> bool:
        return True


@register_layer
@dataclass(frozen=True)
class Dense(FeedForwardLayerConfig):
    """Fully connected layer."""

    layer_type = "dense"
    has_bias: bool = True

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
        return DenseLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class Output(FeedForwardLayerConfig):
    """Dense + loss head. ``loss`` names an ops/losses.py entry."""

    layer_type = "output"
    loss: str = "mcxent"
    has_bias: bool = True

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayer
        return OutputLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class LossLayer(BaseLayerConfig):
    """Loss-only head without params."""

    layer_type = "loss"
    loss: str = "mcxent"

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.feedforward import (
            LossOnlyLayer)
        return LossOnlyLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class ActivationLayer(BaseLayerConfig):
    """Standalone activation."""

    layer_type = "activation"

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.feedforward import (
            ActivationOnlyLayer)
        return ActivationOnlyLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class Dropout(BaseLayerConfig):
    """Standalone dropout layer: the layer's ``dropout`` (or the global
    one) is the drop probability of its input."""

    layer_type = "dropout"

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.feedforward import (
            DropoutOnlyLayer)
        return DropoutOnlyLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class Embedding(FeedForwardLayerConfig):
    """Embedding lookup of integer indices (a column of them, or one-hot
    rows), plus bias."""

    layer_type = "embedding"
    has_bias: bool = True

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.feedforward import (
            EmbeddingLayerImpl)
        return EmbeddingLayerImpl(self, input_type, global_conf, policy)
