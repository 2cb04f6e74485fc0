"""Recurrent-family layer configs (counterpart of
deeplearning4j_tpu/nn/conf/layers_recurrent.py). Layout is
[batch, time, features].
"""

from __future__ import annotations

from dataclasses import dataclass

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    FeedForwardLayerConfig,
    register_layer,
)


@dataclass(frozen=True)
class BaseRecurrentConfig(FeedForwardLayerConfig):
    layer_type = "base_recurrent"
    expects_rnn_input = True

    def with_n_in(self, input_type: InputType):
        if self.n_in is None:
            if input_type.kind != "recurrent":
                raise ValueError(
                    f"{type(self).__name__} needs recurrent input, got "
                    f"{input_type.kind}")
            return self.replace(n_in=input_type.size)
        return self

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(
            self.n_out, None if input_type is None else input_type.timesteps)


@register_layer
@dataclass(frozen=True)
class GravesLSTM(BaseRecurrentConfig):
    """Graves LSTM with peepholes. ``gate_activation`` applies to the
    gates; ``activation`` to the cell candidate and cell output."""

    layer_type = "graves_lstm"
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.recurrent import (
            GravesLSTMLayer)
        return GravesLSTMLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class GravesBidirectionalLSTM(BaseRecurrentConfig):
    """Bidirectional Graves LSTM; the two directions are summed, so the
    output size is n_out."""

    layer_type = "graves_bi_lstm"
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.recurrent import (
            GravesBidirectionalLSTMLayer)
        return GravesBidirectionalLSTMLayer(self, input_type, global_conf,
                                            policy)


@register_layer
@dataclass(frozen=True)
class RnnOutput(BaseRecurrentConfig):
    """Per-timestep dense head: [b, t, n_in] -> [b, t, n_out]."""

    layer_type = "rnn_output"
    loss: str = "mcxent"
    has_bias: bool = True

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.recurrent import (
            RnnOutputLayerImpl)
        return RnnOutputLayerImpl(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class LastTimeStep(BaseRecurrentConfig):
    """[b, t, f] -> [b, f]: the last step, or the last unmasked step of
    each example."""

    layer_type = "last_time_step"

    def with_n_in(self, input_type: InputType):
        if self.n_in is None and input_type.kind == "recurrent":
            return self.replace(n_in=input_type.size, n_out=input_type.size)
        return self

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.size)

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.recurrent import (
            LastTimeStepLayer)
        return LastTimeStepLayer(self, input_type, global_conf, policy)
