"""In-memory embedding lookup table + nearest-neighbor queries
(counterpart of deeplearning4j_tpu/nlp/lookup.py).

Parity: models/embeddings/inmemory/InMemoryLookupTable.java (731 LoC:
syn0/syn1/syn1neg + negative table) and wordvectors.WordVectors query API
(similarity, wordsNearest). The tables are f32 tensors on the table's
device (``device=None`` is the card), initialised from the same
``np.random.default_rng(seed)`` draws as the JAX package's, so both
packages start from identical tables. A similarity query is one product
of the normalized table by the query on that device; the ranking is done
on the host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, make_negative_table


class InMemoryLookupTable:
    def __init__(self, cache: VocabCache, vector_size: int, seed: int = 42,
                 use_hs: bool = True, negative: int = 0,
                 negative_table_size: int = 1_000_000, device=None):
        self.cache = cache
        self.vector_size = vector_size
        self.device = resolve_device(device)
        V = len(cache)
        rng = np.random.default_rng(seed)
        # word2vec init: syn0 ~ U(-0.5/D, 0.5/D), syn1 zeros
        self.syn0 = self._table(
            (rng.random((V, vector_size)) - 0.5) / vector_size)
        self.syn1 = (torch.zeros((V, vector_size), dtype=torch.float32,
                                 device=self.device) if use_hs else None)
        self.syn1neg = (torch.zeros((V, vector_size), dtype=torch.float32,
                                    device=self.device)
                        if negative > 0 else None)
        self.negative = negative
        self.neg_table = (make_negative_table(cache, negative_table_size)
                          if negative > 0 else None)

    def _table(self, values) -> torch.Tensor:
        """An f32 table on this lookup's device from host values."""
        return torch.as_tensor(np.asarray(values, np.float32),
                               device=self.device)

    # ------------------------------------------------------------- queries
    def vector(self, word: str) -> np.ndarray:
        idx = self.cache.index_of(word)
        if idx < 0:
            raise KeyError(f"Word '{word}' not in vocabulary")
        return self.syn0[idx].cpu().numpy()

    def _normed(self) -> torch.Tensor:
        norms = torch.linalg.norm(self.syn0, dim=1, keepdim=True)
        return self.syn0 / torch.clamp_min(norms, 1e-12)

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.vector(a), self.vector(b)
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / max(denom, 1e-12))

    def _ranked(self, v, exclude, top_n) -> List[Tuple[str, float]]:
        """The ``top_n`` words by cosine similarity to the host vector
        ``v`` (normalized here), leaving out the row indices ``exclude``."""
        v = v / max(np.linalg.norm(v), 1e-12)
        q = torch.as_tensor(np.asarray(v, np.float32), device=self.device)
        sims = (self._normed() @ q).cpu().numpy()
        order = np.argsort(-sims)
        out = []
        for idx in order:
            if int(idx) in exclude:
                continue
            out.append((self.cache.word_for_index(int(idx)),
                        float(sims[idx])))
            if len(out) >= top_n:
                break
        return out

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[Tuple[str, float]]:
        if isinstance(word_or_vec, str):
            v = self.vector(word_or_vec)
            exclude = {self.cache.index_of(word_or_vec)}
        else:
            v = np.asarray(word_or_vec)
            exclude = set()
        return self._ranked(v, exclude, top_n)

    def words_nearest_sum(self, positive: Sequence[str],
                          negative: Sequence[str] = (), top_n: int = 10):
        """king - man + woman style analogy queries
        (WordVectorsImpl.wordsNearestSum parity)."""
        v = np.zeros(self.vector_size, dtype=np.float64)
        for w in positive:
            v += self.vector(w)
        for w in negative:
            v -= self.vector(w)
        exclude = {self.cache.index_of(w) for w in (*positive, *negative)}
        return self._ranked(v, exclude, top_n)
