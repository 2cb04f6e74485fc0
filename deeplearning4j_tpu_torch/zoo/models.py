"""Model builders (counterpart of deeplearning4j_tpu/zoo/models.py).
Only ``char_rnn`` is ported in this slice."""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.nn.conf.core import (DtypePolicy,
                                                   NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
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
