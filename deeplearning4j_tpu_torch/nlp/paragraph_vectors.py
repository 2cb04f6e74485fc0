"""ParagraphVectors (doc2vec): PV-DM and PV-DBOW + inferVector
(counterpart of deeplearning4j_tpu/nlp/paragraph_vectors.py).

Parity: models/paragraphvectors/ParagraphVectors.java (1,436 LoC) with
learning algorithms embeddings/learning/impl/sequence/{DM, DBOW}.java.
Documents are (label, text) pairs; label vectors live in their own table
on the tables' device, drawn from the JAX package's numpy stream.
``infer_vector`` trains a fresh doc vector against FROZEN word tables —
exactly the reference's inference path.
"""

from __future__ import annotations

from typing import List

import numpy as np

from deeplearning4j_tpu_torch.nlp import elements
from deeplearning4j_tpu_torch.nlp.sequence_vectors import (
    SequenceVectors,
    SequenceVectorsConfig,
)
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory


class ParagraphVectors(SequenceVectors):
    def __init__(self, config: SequenceVectorsConfig | None = None,
                 sequence_algorithm: str = "dbow", device=None, **kw):
        """sequence_algorithm: 'dbow' (PV-DBOW) or 'dm' (PV-DM)."""
        super().__init__(config, device=device, **kw)
        if not self.config.use_hs:
            raise ValueError("ParagraphVectors here uses hierarchical "
                             "softmax (negative-sampling variant TBD); "
                             "leave negative=0")
        self.sequence_algorithm = sequence_algorithm
        self.doc_labels: List[str] = []
        self.doc_vecs = None

    def _doc_table(self, rng, n):
        """``n`` doc vectors U(-0.5/D, 0.5/D) from ``rng`` on the tables'
        device (the JAX package's draws)."""
        D = self.config.vector_size
        return self._on_device((rng.random((n, D)) - 0.5) / D)

    # ------------------------------------------------------------- training
    def fit_documents(self, documents, tokenizer_factory=None):
        """documents: LabelAwareIterator / iterable of (label, text)."""
        tf = tokenizer_factory or DefaultTokenizerFactory()
        labels, token_seqs = [], []
        for label, text in documents:
            tokens = tf.create(text).get_tokens()
            if tokens:
                labels.append(label)
                token_seqs.append(tokens)
        self.doc_labels = labels
        self.build_vocab(token_seqs)
        cfg = self.config
        self.doc_vecs = self._doc_table(np.random.default_rng(cfg.seed + 1),
                                        len(labels))

        seqs = self._sequences_to_indices(token_seqs)
        total = sum(len(s) for s in seqs) * cfg.epochs
        seen = 0
        for _ in range(cfg.epochs):
            for di in self._rng.permutation(len(seqs)):
                seq = self._subsample(seqs[di])
                if len(seq) < 1:
                    seen += len(seqs[di])
                    continue
                lr = max(cfg.min_learning_rate,
                         cfg.learning_rate * (1 - seen / max(total, 1)))
                self._train_doc(int(di), seq, lr, frozen_words=False)
                seen += len(seqs[di])
        return self

    def _train_doc(self, doc_idx, seq, lr, *, frozen_words, doc_vecs=None):
        """One pass of DM/DBOW updates for one document; updates the doc
        table (``doc_vecs``, else the model's) in place and returns it."""
        cfg = self.config
        lk = self.lookup
        dv = self.doc_vecs if doc_vecs is None else doc_vecs
        if self.sequence_algorithm == "dbow":
            points, codes, mask = self._hs_arrays(seq)
            docs = self._ids(np.full(len(seq), doc_idx))
            if frozen_words:
                elements.dbow_hs_step_frozen(lk.syn1, dv, docs, points, codes,
                                             mask, lr)
            else:
                elements.dbow_hs_step(lk.syn1, dv, docs, points, codes, mask,
                                      lr)
            return dv
        n = len(seq)  # dm
        rows = []
        bs = self._rng.integers(1, cfg.window + 1, size=n)
        for pos in range(n):
            b = bs[pos]
            ctx = [seq[j] for j in range(max(0, pos - b),
                                         min(n, pos + b + 1)) if j != pos]
            if ctx:
                rows.append((ctx, seq[pos]))
        if not rows:
            return dv
        ctx_arr, ctx_mask, targets = self._cbow_rows(rows)
        docs = self._ids(np.full(len(rows), doc_idx))
        points, codes, mask = self._hs_arrays(targets)
        step = (elements.dm_hs_step_frozen if frozen_words
                else elements.dm_hs_step)
        step(lk.syn0, lk.syn1, dv, docs, self._ids(ctx_arr),
             self._on_device(ctx_mask), points, codes, mask, lr)
        return dv

    # ------------------------------------------------------------ inference
    def infer_vector(self, text: str, tokenizer_factory=None,
                     iterations: int = 10, lr: float = 0.025) -> np.ndarray:
        """Train a fresh doc vector for unseen text with word tables frozen
        (ParagraphVectors.inferVector parity)."""
        tf = tokenizer_factory or DefaultTokenizerFactory()
        tokens = tf.create(text).get_tokens()
        seq = np.asarray([self.vocab.index_of(t) for t in tokens
                          if self.vocab.index_of(t) >= 0], np.int32)
        dv = self._doc_table(np.random.default_rng(0), 1)
        if len(seq) == 0:
            return dv[0].cpu().numpy()
        for i in range(iterations):
            step_lr = lr * (1 - i / iterations) + 1e-4
            self._train_doc(0, seq, step_lr, frozen_words=True, doc_vecs=dv)
        return dv[0].cpu().numpy()

    # -------------------------------------------------------------- queries
    def doc_vector(self, label: str) -> np.ndarray:
        return self.doc_vecs[self.doc_labels.index(label)].cpu().numpy()

    def similarity_doc(self, a: str, b: str) -> float:
        va, vb = self.doc_vector(a), self.doc_vector(b)
        return float(va @ vb / max(np.linalg.norm(va) * np.linalg.norm(vb),
                                   1e-12))

    def nearest_labels(self, vec_or_label, top_n: int = 5):
        if isinstance(vec_or_label, str):
            v = self.doc_vector(vec_or_label)
            exclude = {self.doc_labels.index(vec_or_label)}
        else:
            v, exclude = np.asarray(vec_or_label), set()
        dvs = self.doc_vecs.cpu().numpy()
        dvs = dvs / np.maximum(np.linalg.norm(dvs, axis=1, keepdims=True),
                               1e-12)
        sims = dvs @ (v / max(np.linalg.norm(v), 1e-12))
        order = np.argsort(-sims)
        return [(self.doc_labels[i], float(sims[i]))
                for i in order if i not in exclude][:top_n]
