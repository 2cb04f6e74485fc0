"""Transformer-family layer configs (counterpart of
deeplearning4j_tpu/nn/conf/layers_attention.py). Registered under the same
``layer_type`` names with the same fields in the same order, so a
``configuration.json`` of either package loads in the other.

Layout is [batch, time, features]. Streaming state is carried per layer
under the ``rnn_time_step`` contract GravesLSTM uses for (h, c): here the
carries are the KV cache ("k"/"v") and each row's absolute position
("pos"). ``max_cache_len`` fixes the cache extent at the first streaming
call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import register_layer
from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import (
    BaseRecurrentConfig,
    RnnOutput,
)


@register_layer
@dataclass(frozen=True)
class GptEmbedding(BaseRecurrentConfig):
    """Token + learned positional embedding: one-hot [b, t, vocab] ->
    [b, t, n_out]. The token lookup is a gather at the argmax of the
    one-hot; the positional table has ``max_len`` rows."""

    layer_type = "gpt_embedding"
    max_len: int = 512

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.attention import (
            GptEmbeddingLayer)
        return GptEmbeddingLayer(self, input_type, global_conf, policy)


@dataclass(frozen=True)
class BaseAttentionConfig(BaseRecurrentConfig):
    """Shared shape inference for width-preserving attention layers:
    n_out defaults to n_in."""

    layer_type = "base_attention"
    n_heads: int = 4
    max_cache_len: Optional[int] = None

    def with_n_in(self, input_type: InputType):
        c = super().with_n_in(input_type)
        if c.n_out is None:
            c = c.replace(n_out=c.n_in)
        return c


@register_layer
@dataclass(frozen=True)
class SelfAttention(BaseAttentionConfig):
    """Causal multi-head self-attention: QKV projections, the
    ``causal_mha`` op and the output projection; no residual or norm."""

    layer_type = "self_attention"

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.attention import (
            SelfAttentionLayer)
        return SelfAttentionLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class TransformerBlock(BaseAttentionConfig):
    """Pre-LN transformer block: ``x + attn(ln1(x))`` then
    ``a + mlp(ln2(a))`` with an ``ffn_mult * width`` hidden MLP;
    ``activation`` (default gelu) is the MLP nonlinearity."""

    layer_type = "transformer_block"
    ffn_mult: int = 4
    ln_eps: float = 1e-5

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.attention import (
            TransformerBlockLayer)
        return TransformerBlockLayer(self, input_type, global_conf, policy)


@register_layer
@dataclass(frozen=True)
class GptOutput(RnnOutput):
    """RnnOutput whose streaming pre-output is the f32 projection of the
    streaming path (nn/layers/attention.py)."""

    layer_type = "gpt_output"

    def make_layer(self, input_type, global_conf, policy):
        from deeplearning4j_tpu_torch.nn.layers.attention import (
            GptOutputLayer)
        return GptOutputLayer(self, input_type, global_conf, policy)
