"""Streamed against one-shot probabilities of a trained char-RNN graph in
the JAX package, on the weights and the prefix that
``chip_smoke.py --slice14 --save-stream`` writes.

    python scripts/stream_vs_one_shot.py [DIR] [--rows N] [--interpret]

Reads DIR/skip_char_rnn.zip and DIR/stream.npz (default DIR:
chiprun_out/graph_stream), feeds the prefix to the JAX package's
ComputationGraph on the CPU backend, once through ``rnn_time_step`` one
character at a time and once through ``output`` over the whole prefix,
and prints one JSON object: the JAX stream against the JAX one-shot
(max abs error), and each of them against the card's and the port's
plain CPU path's probabilities stored in stream.npz (the first rows).
``--rows N`` tiles the prefix's rows to N: the JAX package's Pallas LSTM
takes bf16 batches of a multiple of 16 rows only, smaller ones run its
XLA scan. ``--interpret`` sets DL4J_TPU_PALLAS_INTERPRET=1, so that on
the CPU such a batch runs the Pallas kernel in interpret mode.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", nargs="?",
                    default=os.path.join("chiprun_out", "graph_stream"))
    ap.add_argument("--rows", type=int, default=0)
    ap.add_argument("--interpret", action="store_true")
    a = ap.parse_args()
    if a.interpret:
        os.environ["DL4J_TPU_PALLAS_INTERPRET"] = "1"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from deeplearning4j_tpu.utils.serialization import (
        restore_computation_graph)
    saved = np.load(os.path.join(a.dir, "stream.npz"))
    prefix = saved["prefix"]
    rows, steps = prefix.shape
    if a.rows:
        prefix = np.tile(prefix, (-(-a.rows // rows), 1))[:a.rows]
    net = restore_computation_graph(os.path.join(a.dir, "skip_char_rnn.zip"))
    vocab = saved["card_one_shot"].shape[-1]
    eye = np.eye(vocab, dtype=np.float32)
    net.rnn_clear_previous_state()
    stream = np.stack([np.asarray(net.rnn_time_step(eye[prefix[:, t]]),
                                  np.float32) for t in range(steps)], axis=1)
    net.rnn_clear_previous_state()
    one_shot = np.asarray(net.output(eye[prefix]), np.float32)

    def err(x, y):
        return float(np.abs(x[:rows] - y[:rows]).max())

    out = {"rows": int(prefix.shape[0]), "steps": steps,
           "interpret": a.interpret,
           "jax_stream_vs_one_shot": float(np.abs(stream - one_shot).max())}
    for name in ("card_stream", "card_one_shot", "cpu_stream",
                 "cpu_one_shot"):
        out[f"jax_stream_vs_{name}"] = err(stream, saved[name])
        out[f"jax_one_shot_vs_{name}"] = err(one_shot, saved[name])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
