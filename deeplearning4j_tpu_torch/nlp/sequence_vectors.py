"""SequenceVectors — the generic embedding trainer (counterpart of
deeplearning4j_tpu/nlp/sequence_vectors.py).

Parity: models/sequencevectors/SequenceVectors.java (1,218 LoC; buildVocab
:103, fit :187). The host generates the (center, target) training pairs
in numpy with the JAX package's generator stream, in its order (the
permutation, frequent-word subsampling, the dynamic window, the negative
draws, linear lr decay), accumulates them into fixed-size batches, and
each batch is one update step on the tables' device (elements.py). So
the card sees the JAX package's exact pair stream. The Huffman arrays
live on the tables' device and are indexed there by each batch's target
ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp import elements
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import (
    VocabCache,
    VocabConstructor,
    make_subsample_keep_probs,
)


@dataclass
class SequenceVectorsConfig:
    vector_size: int = 100
    window: int = 5
    min_word_frequency: int = 1
    epochs: int = 1
    iterations: int = 1          # passes per sequence per epoch
    learning_rate: float = 0.025
    min_learning_rate: float = 1e-4
    negative: int = 0            # 0 => hierarchical softmax
    use_hs: Optional[bool] = None  # default: negative == 0
    sample: float = 0.0          # frequent-word subsampling threshold
    batch_size: int = 1024
    seed: int = 42
    algorithm: str = "skipgram"  # or "cbow"


class SequenceVectors:
    """Train embeddings over an iterable of token sequences; the tables
    live on ``device`` (None: the card)."""

    def __init__(self, config: SequenceVectorsConfig | None = None,
                 device=None, **kw):
        if config is None:
            config = SequenceVectorsConfig(**kw)
        self.config = config
        if config.use_hs is None:
            config.use_hs = config.negative == 0
        if not config.use_hs and config.negative == 0:
            raise ValueError("Enable hierarchical softmax or negative "
                             "sampling (negative > 0)")
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.lookup: Optional[InMemoryLookupTable] = None
        self._rng = np.random.default_rng(config.seed)

    # ------------------------------------------------------------- vocab
    def build_vocab(self, sequences: Iterable[List[str]]):
        self.vocab = VocabConstructor(
            self.config.min_word_frequency).build(sequences)
        self.lookup = InMemoryLookupTable(
            self.vocab, self.config.vector_size, seed=self.config.seed,
            use_hs=self.config.use_hs, negative=self.config.negative,
            device=self.device)
        # fixed-width Huffman code arrays for the steps, on the tables'
        # device (the JAX package's values)
        if self.config.use_hs:
            L = max((len(w.code) for w in self.vocab.vocab_words), default=1)
            V = len(self.vocab)
            codes = np.zeros((V, L), np.float32)
            points = np.zeros((V, L), np.int32)
            code_mask = np.zeros((V, L), np.float32)
            for w in self.vocab.vocab_words:
                n = len(w.code)
                codes[w.index, :n] = w.code
                points[w.index, :n] = w.points
                code_mask[w.index, :n] = 1.0
            self._hs_device = (self._ids(points), self._on_device(codes),
                               self._on_device(code_mask))
        self._keep_probs = make_subsample_keep_probs(self.vocab,
                                                     self.config.sample)
        return self

    def _ids(self, a) -> torch.Tensor:
        """Host row ids as an int64 tensor on the tables' device."""
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------ training
    def _sequences_to_indices(self, sequences):
        out = []
        for tokens in sequences:
            idxs = [self.vocab.index_of(t) for t in tokens]
            idxs = [i for i in idxs if i >= 0]
            if len(idxs) >= 2:
                out.append(np.asarray(idxs, np.int32))
        return out

    def _subsample(self, seq):
        if self._keep_probs is None:
            return seq
        keep = self._rng.random(len(seq)) < self._keep_probs[seq]
        return seq[keep]

    def _gen_pairs(self, seq):
        """(center, target) pairs with word2vec's random dynamic window."""
        cfg = self.config
        n = len(seq)
        bs = self._rng.integers(1, cfg.window + 1, size=n)
        pairs_c, pairs_t, ctx_rows = [], [], []
        for pos in range(n):
            b = bs[pos]
            lo, hi = max(0, pos - b), min(n, pos + b + 1)
            ctx = [seq[j] for j in range(lo, hi) if j != pos]
            if not ctx:
                continue
            if cfg.algorithm == "skipgram":
                # predict current word from each context word: the context
                # word's vector updates (SkipGram.java iterateSample parity)
                for c in ctx:
                    pairs_c.append(c)
                    pairs_t.append(seq[pos])
            else:  # cbow
                ctx_rows.append((ctx, seq[pos]))
        return pairs_c, pairs_t, ctx_rows

    def fit(self, sequences: Iterable[List[str]],
            lr_range: Optional[tuple] = None):
        """Train (SequenceVectors.fit :187 parity). ``sequences`` may be any
        re-iterable of token lists.

        ``lr_range=(start, end)`` overrides the learning-rate window this
        call sweeps linearly (floored at min_learning_rate). Default is
        the full word2vec schedule (learning_rate -> 0). A multi-epoch
        driver that calls fit once per epoch (nlp/distributed.py) passes
        successive windows so the GLOBAL schedule matches a single
        multi-epoch call."""
        cfg = self.config
        # Materialize one-shot iterators (iter(x) is x) so they survive the
        # two passes (vocab build + training); re-iterable streaming corpora
        # are left alone.
        if iter(sequences) is sequences:
            sequences = list(sequences)
        if self.vocab is None:
            self.build_vocab(sequences)
        seqs = self._sequences_to_indices(sequences)
        total_words = sum(len(s) for s in seqs) * cfg.epochs * cfg.iterations
        seen = 0
        lr_start, lr_end = (lr_range if lr_range is not None
                            else (cfg.learning_rate, 0.0))
        lr = max(cfg.min_learning_rate, lr_start)

        buf_c, buf_t, buf_ctx = [], [], []
        for _ in range(cfg.epochs):
            order = self._rng.permutation(len(seqs))
            for si in order:
                for _ in range(cfg.iterations):
                    seq = self._subsample(seqs[si])
                    if len(seq) < 2:
                        seen += len(seqs[si])
                        continue
                    pc, pt, ctx = self._gen_pairs(seq)
                    buf_c.extend(pc)
                    buf_t.extend(pt)
                    buf_ctx.extend(ctx)
                    seen += len(seqs[si])
                    frac = seen / max(total_words, 1)
                    lr = max(cfg.min_learning_rate,
                             lr_start + (lr_end - lr_start) * frac)
                    while len(buf_c) >= cfg.batch_size:
                        self._apply_skipgram(buf_c[:cfg.batch_size],
                                             buf_t[:cfg.batch_size], lr)
                        del buf_c[:cfg.batch_size], buf_t[:cfg.batch_size]
                    while len(buf_ctx) >= cfg.batch_size:
                        self._apply_cbow(buf_ctx[:cfg.batch_size], lr)
                        del buf_ctx[:cfg.batch_size]
        # tail flush at the schedule's CURRENT lr (for the default full
        # schedule this is ~min_learning_rate; for a windowed call it must
        # not collapse to the floor mid-training)
        if buf_c:
            self._apply_skipgram(buf_c, buf_t, lr)
        if buf_ctx:
            self._apply_cbow(buf_ctx, lr)
        return self

    # ------------------------------------------------------- batch applies
    def _hs_arrays(self, targets):
        """The targets' Huffman rows (points, codes, mask), gathered on
        the tables' device."""
        t = self._ids(targets)
        points, codes, mask = self._hs_device
        return points[t], codes[t], mask[t]

    def _draw_negatives(self, targets):
        cfg = self.config
        t = np.asarray(targets, np.int32)
        neg = self.lookup.neg_table[
            self._rng.integers(0, len(self.lookup.neg_table),
                               size=(len(t), cfg.negative))]
        # avoid sampling the positive as its own negative: resample once
        clash = neg == t[:, None]
        if clash.any():
            neg = np.where(clash, (neg + 1) % len(self.vocab), neg)
        targets_all = np.concatenate([t[:, None], neg], axis=1)
        labels = np.zeros_like(targets_all, np.float32)
        labels[:, 0] = 1.0
        return self._ids(targets_all), self._on_device(labels)

    def _apply_skipgram(self, centers, targets, lr):
        lk = self.lookup
        c = self._ids(centers)
        if self.config.use_hs:
            points, codes, mask = self._hs_arrays(targets)
            elements.skipgram_hs_step(lk.syn0, lk.syn1, c, points, codes,
                                      mask, lr)
        if self.config.negative > 0:
            tgt, labels = self._draw_negatives(targets)
            elements.skipgram_ns_step(lk.syn0, lk.syn1neg, c, tgt, labels,
                                      lr)

    def _cbow_rows(self, rows):
        """(context ids [B, W], context mask [B, W], targets [B]) host
        arrays for a batch of (context, target) rows, W the batch's
        widest context."""
        W = max(len(ctx) for ctx, _ in rows)
        B = len(rows)
        ctx_arr = np.zeros((B, W), np.int32)
        ctx_mask = np.zeros((B, W), np.float32)
        targets = np.empty(B, np.int32)
        for i, (ctx, t) in enumerate(rows):
            ctx_arr[i, :len(ctx)] = ctx
            ctx_mask[i, :len(ctx)] = 1.0
            targets[i] = t
        return ctx_arr, ctx_mask, targets

    def _apply_cbow(self, rows, lr):
        lk = self.lookup
        ctx_arr, ctx_mask, targets = self._cbow_rows(rows)
        ctx = self._ids(ctx_arr)
        mask = self._on_device(ctx_mask)
        if self.config.use_hs:
            points, codes, cmask = self._hs_arrays(targets)
            elements.cbow_hs_step(lk.syn0, lk.syn1, ctx, mask, points, codes,
                                  cmask, lr)
        if self.config.negative > 0:
            tgt, labels = self._draw_negatives(targets)
            elements.cbow_ns_step(lk.syn0, lk.syn1neg, ctx, mask, tgt,
                                  labels, lr)

    # -------------------------------------------------------------- queries
    def similarity(self, a: str, b: str) -> float:
        return self.lookup.similarity(a, b)

    def words_nearest(self, word, top_n: int = 10):
        return self.lookup.words_nearest(word, top_n)

    def get_word_vector(self, word: str):
        return self.lookup.vector(word)
