"""Model builders (counterpart of deeplearning4j_tpu/zoo/models.py):
``char_rnn``, ``gpt_mini`` and ``gpt_mini_draft``, with the JAX package's
configurations and defaults."""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.nn.conf.core import (DtypePolicy,
                                                   NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers_attention import (
    GptEmbedding, GptOutput, TransformerBlock)
from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import (GravesLSTM,
                                                               RnnOutput)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam

BF16 = DtypePolicy(param_dtype="float32", compute_dtype="bfloat16")
F32 = DtypePolicy(param_dtype="float32", compute_dtype="float32")


def char_rnn(vocab_size: int = 80, hidden: int = 512, n_layers: int = 2,
             seed: int = 42, dtype: Optional[DtypePolicy] = None,
             device=None) -> MultiLayerNetwork:
    """GravesLSTM char-RNN: stacked LSTMs -> per-timestep softmax. Same
    configuration (and configuration.json) as the JAX package's
    ``zoo.char_rnn``; BF16 policy by default; runs on ``device``
    (default: the card)."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(Adam(2e-3)).dtype(dtype or BF16)
         .list())
    for _ in range(n_layers):
        b = b.layer(GravesLSTM(n_out=hidden, activation="tanh"))
    conf = (b.layer(RnnOutput(n_out=vocab_size, loss="mcxent",
                              activation="softmax"))
            .set_input_type(InputType.recurrent(vocab_size))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def gpt_mini(vocab_size: int = 80, width: int = 256, n_layers: int = 4,
             n_heads: int = 4, max_len: int = 256,
             max_cache_len: Optional[int] = None, seed: int = 42,
             dtype: Optional[DtypePolicy] = None,
             device=None) -> MultiLayerNetwork:
    """GPT-style decoder-only LM: one-hot tokens -> GptEmbedding (learned
    positions) -> ``n_layers`` pre-LN TransformerBlocks (GELU, 4x MLP) ->
    softmax head. Same configuration (and configuration.json) as the JAX
    package's ``zoo.gpt_mini``: BF16 policy and Adam(3e-4) by default;
    streaming carries a KV cache of ``max_cache_len`` (default
    ``max_len``) per block. Runs on ``device`` (default: the card)."""
    cache = int(max_cache_len or max_len)
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(Adam(3e-4)).dtype(dtype or BF16)
         .list()
         .layer(GptEmbedding(n_out=width, max_len=max_len)))
    for _ in range(n_layers):
        b = b.layer(TransformerBlock(n_heads=n_heads, activation="gelu",
                                     max_cache_len=cache))
    conf = (b.layer(GptOutput(n_out=vocab_size, loss="mcxent",
                              activation="softmax"))
            .set_input_type(InputType.recurrent(vocab_size))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def gpt_mini_draft(vocab_size: int = 80, width: int = 128,
                   n_layers: int = 2, n_heads: int = 2, max_len: int = 256,
                   max_cache_len: Optional[int] = None, seed: int = 43,
                   dtype: Optional[DtypePolicy] = None,
                   device=None) -> MultiLayerNetwork:
    """The draft-sized companion of ``gpt_mini`` (same vocabulary and
    extent, half the width and depth), as in the JAX package."""
    return gpt_mini(vocab_size=vocab_size, width=width, n_layers=n_layers,
                    n_heads=n_heads, max_len=max_len,
                    max_cache_len=max_cache_len, seed=seed, dtype=dtype,
                    device=device)
