"""Input preprocessors: shape adapters between layer families (counterpart
of deeplearning4j_tpu/nn/conf/preprocessors.py, same ``kind`` names,
fields and JSON form).

Layouts are the JAX package's: convolutional activations NHWC
``[b, h, w, c]``, recurrent ``[b, t, f]``. Flattening keeps the h, w, c
order, so a Dense ``W`` carried over from the JAX package multiplies the
same rows. Each adapter is a ``reshape`` (never ``view``): a convolution's
output on the card is a channels-last view, not contiguous in NHWC order.
"""

from __future__ import annotations

from dataclasses import dataclass

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

PREPROCESSOR_REGISTRY: dict[str, type] = {}


def register_preprocessor(cls):
    PREPROCESSOR_REGISTRY[cls.kind] = cls
    return cls


def preprocessor_to_dict(p):
    d = {f: getattr(p, f) for f in p.__dataclass_fields__}
    d["kind"] = p.kind
    return d


def preprocessor_from_dict(d):
    d = dict(d)
    kind = d.pop("kind")
    if kind not in PREPROCESSOR_REGISTRY:
        raise ValueError(f"Unknown preprocessor kind {kind!r}")
    return PREPROCESSOR_REGISTRY[kind](**d)


@dataclass(frozen=True)
class InputPreProcessor:
    kind = "identity"

    def __call__(self, x):
        return x

    def output_type(self, input_type: InputType) -> InputType:
        return input_type


@register_preprocessor
@dataclass(frozen=True)
class CnnToFeedForward(InputPreProcessor):
    """[b, h, w, c] -> [b, h*w*c]."""

    kind = "cnn_to_ff"
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x):
        return x.reshape(x.shape[0], -1)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(
            input_type.height * input_type.width * input_type.channels)


@register_preprocessor
@dataclass(frozen=True)
class FeedForwardToCnn(InputPreProcessor):
    """[b, h*w*c] -> [b, h, w, c]."""

    kind = "ff_to_cnn"
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preprocessor
@dataclass(frozen=True)
class RnnToFeedForward(InputPreProcessor):
    """[b, t, f] -> [b*t, f]."""

    kind = "rnn_to_ff"

    def __call__(self, x):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.size)


@register_preprocessor
@dataclass(frozen=True)
class FeedForwardToRnn(InputPreProcessor):
    """[b*t, f] -> [b, t, f], t the configured ``timesteps``."""

    kind = "ff_to_rnn"
    timesteps: int = 0

    def __call__(self, x):
        return x.reshape(-1, self.timesteps, x.shape[-1])

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.flat_size(), self.timesteps)


@register_preprocessor
@dataclass(frozen=True)
class CnnToRnn(InputPreProcessor):
    """[b*t, h, w, c] -> [b, t, h*w*c], t the configured ``timesteps``."""

    kind = "cnn_to_rnn"
    timesteps: int = 0

    def __call__(self, x):
        flat = x.reshape(x.shape[0], -1)
        return flat.reshape(-1, self.timesteps, flat.shape[-1])

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(
            input_type.height * input_type.width * input_type.channels,
            self.timesteps)


@register_preprocessor
@dataclass(frozen=True)
class RnnToCnn(InputPreProcessor):
    """[b, t, h*w*c] -> [b*t, h, w, c]."""

    kind = "rnn_to_cnn"
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x):
        return x.reshape(-1, self.height, self.width, self.channels)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)
