"""GloVe: co-occurrence counting + batched AdaGrad factorization
(counterpart of deeplearning4j_tpu/nlp/glove.py).

Parity: models/glove/Glove.java (429 LoC) + models/embeddings/learning/
impl/elements/GloVe.java (406 LoC) + models/glove/count/ (co-occurrence
counting). The host counts co-occurrences into COO arrays (the JAX
package's order); the tables' device runs the classic GloVe objective
J = f(X_ij)(w_i·w~_j + b_i + b~_j - log X_ij)^2 with per-parameter
AdaGrad, one step per shuffled batch, the tables updated in place.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, List

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.elements import _row_sums
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor


def _add_rows_(vectors, biases, idx, dv, db):
    """vectors[idx[i]] += dv[i] and biases[idx[i]] += db[i], in place:
    each row's entries summed first (``elements._row_sums``, one call
    for both), then added to it once."""
    sums = _row_sums(vectors.shape[0], idx, torch.cat([dv, db[:, None]], 1))
    vectors.add_(sums[:, :-1])
    biases.add_(sums[:, -1])


@torch.no_grad()
def _glove_step(w, wc, b, bc, hw, hwc, hb, hbc, rows, cols, logx, fx, lr):
    """One AdaGrad batch: w/wc word+context vectors, b/bc biases, h* the
    AdaGrad accumulators, updated in place. Row adds are SUMS over
    duplicates (the JAX package's ``.at[].add``): the accumulators are
    added first, then gathered at their updated values."""
    wi = w[rows]
    wj = wc[cols]
    diff = torch.sum(wi * wj, dim=1) + b[rows] + bc[cols] - logx
    fdiff = fx * diff                                    # [B]
    # gradients
    gw = fdiff[:, None] * wj
    gwc = fdiff[:, None] * wi
    gb = fdiff
    gbc = fdiff
    # AdaGrad scatter updates
    _add_rows_(hw, hb, rows, gw * gw, gb * gb)
    _add_rows_(hwc, hbc, cols, gwc * gwc, gbc * gbc)
    _add_rows_(w, b, rows, -lr * gw / torch.sqrt(hw[rows] + 1e-8),
               -lr * gb / torch.sqrt(hb[rows] + 1e-8))
    _add_rows_(wc, bc, cols, -lr * gwc / torch.sqrt(hwc[cols] + 1e-8),
               -lr * gbc / torch.sqrt(hbc[cols] + 1e-8))
    return w, wc, b, bc, hw, hwc, hb, hbc


def _cooccurrences(vocab, sequences, window: int, symmetric: bool):
    """Distance-weighted co-occurrence counts (models/glove/count
    parity) as COO host arrays (rows int32, cols int32, counts f32), in
    the JAX package's order."""
    cooc = defaultdict(float)
    for tokens in sequences:
        idxs = [vocab.index_of(t) for t in tokens]
        idxs = [i for i in idxs if i >= 0]
        for pos, wi in enumerate(idxs):
            for off in range(1, window + 1):
                j = pos + off
                if j >= len(idxs):
                    break
                wj = idxs[j]
                weight = 1.0 / off  # distance weighting (GloVe paper)
                cooc[(wi, wj)] += weight
                if symmetric:
                    cooc[(wj, wi)] += weight
    if not cooc:
        raise ValueError("Empty co-occurrence matrix")
    rows = np.fromiter((k[0] for k in cooc), np.int32, len(cooc))
    cols = np.fromiter((k[1] for k in cooc), np.int32, len(cooc))
    xs = np.fromiter(cooc.values(), np.float32, len(cooc))
    return rows, cols, xs


class Glove:
    def __init__(self, vector_size: int = 100, window: int = 15,
                 min_word_frequency: int = 1, epochs: int = 25,
                 learning_rate: float = 0.05, x_max: float = 100.0,
                 alpha: float = 0.75, batch_size: int = 4096,
                 symmetric: bool = True, seed: int = 42, device=None):
        self.vector_size = vector_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.batch_size = batch_size
        self.symmetric = symmetric
        self.seed = seed
        self.device = resolve_device(device)
        self.vocab = None
        self.lookup = None

    def fit(self, sequences: Iterable[List[str]]):
        # Materialize one-shot iterators: they must survive both the vocab
        # pass and the co-occurrence pass below.
        if iter(sequences) is sequences:
            sequences = list(sequences)
        self.vocab = VocabConstructor(self.min_word_frequency).build(sequences)
        V, D = len(self.vocab), self.vector_size
        rng = np.random.default_rng(self.seed)
        dev = self.device

        rows, cols, xs = _cooccurrences(self.vocab, sequences, self.window,
                                        self.symmetric)
        logx = np.log(xs)
        fx = np.minimum((xs / self.x_max) ** self.alpha, 1.0).astype(np.float32)
        rows_d = torch.as_tensor(rows.astype(np.int64), device=dev)
        cols_d = torch.as_tensor(cols.astype(np.int64), device=dev)
        logx_d = torch.as_tensor(logx, device=dev)
        fx_d = torch.as_tensor(fx, device=dev)

        # ---- tables + AdaGrad state -------------------------------------
        def init(shape):
            return torch.as_tensor(
                ((rng.random(shape) - 0.5) / D).astype(np.float32),
                device=dev)

        def full(shape, value):
            return torch.full(shape, value, dtype=torch.float32, device=dev)
        w, wc = init((V, D)), init((V, D))
        b, bc = full((V,), 0.0), full((V,), 0.0)
        hw, hwc = full((V, D), 1.0), full((V, D), 1.0)
        hb, hbc = full((V,), 1.0), full((V,), 1.0)

        n = len(xs)
        bs = self.batch_size
        for _ in range(self.epochs):
            perm = torch.as_tensor(rng.permutation(n), device=dev)
            for s in range(0, n, bs):
                sl = perm[s:s + bs]
                _glove_step(w, wc, b, bc, hw, hwc, hb, hbc, rows_d[sl],
                            cols_d[sl], logx_d[sl], fx_d[sl],
                            self.learning_rate)

        # final vectors = w + wc (GloVe paper / reference convention)
        self.lookup = InMemoryLookupTable(self.vocab, D, seed=self.seed,
                                          use_hs=True, negative=0, device=dev)
        self.lookup.syn0 = w + wc
        self.lookup.syn1 = None
        return self

    def similarity(self, a, b):
        return self.lookup.similarity(a, b)

    def words_nearest(self, word, top_n: int = 10):
        return self.lookup.words_nearest(word, top_n)

    def get_word_vector(self, word):
        return self.lookup.vector(word)
