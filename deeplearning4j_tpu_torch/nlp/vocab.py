"""Vocabulary: cache, construction, Huffman coding, negative-sampling table
(counterpart of deeplearning4j_tpu/nlp/vocab.py; host code, kept as a copy:
the codes, points and tables are the JAX package's, tie order included).

Parity: models/word2vec/wordstore/ in the reference — VocabCache (word ->
VocabWord with counts/index), VocabConstructor (corpus scan + min-frequency
pruning), Huffman.java (binary tree over word frequencies -> codes/points
for hierarchical softmax), and InMemoryLookupTable's unigram^0.75 negative
sampling table (InMemoryLookupTable.java:731).
"""

from __future__ import annotations

import heapq
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

MAX_CODE_LENGTH = 40


@dataclass
class VocabWord:
    word: str
    count: int = 0
    index: int = -1
    code: List[int] = field(default_factory=list)    # Huffman code (0/1)
    points: List[int] = field(default_factory=list)  # inner-node indices


class VocabCache:
    """word -> VocabWord store (wordstore/VocabCache.java parity)."""

    def __init__(self):
        self.words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []

    def __len__(self):
        return len(self._by_index)

    def __contains__(self, word):
        return word in self.words

    def add(self, word: str, count: int = 1):
        vw = self.words.get(word)
        if vw is None:
            vw = VocabWord(word=word, count=0)
            self.words[word] = vw
        vw.count += count
        return vw

    def finalize_indices(self):
        """Assign indices by descending frequency (word2vec convention)."""
        self._by_index = sorted(self.words.values(),
                                key=lambda w: (-w.count, w.word))
        for i, vw in enumerate(self._by_index):
            vw.index = i

    def word_for_index(self, idx: int) -> str:
        return self._by_index[idx].word

    def index_of(self, word: str) -> int:
        vw = self.words.get(word)
        return -1 if vw is None else vw.index

    def total_count(self) -> int:
        return sum(w.count for w in self._by_index)

    @property
    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)


class VocabConstructor:
    """Scan tokenized sequences, count, prune by min_word_frequency, index,
    and build the Huffman tree (VocabConstructor.java + Huffman.java)."""

    def __init__(self, min_word_frequency: int = 1):
        self.min_word_frequency = min_word_frequency

    def build(self, sequences) -> VocabCache:
        counts = Counter()
        for tokens in sequences:
            counts.update(tokens)
        cache = VocabCache()
        for word, c in counts.items():
            if c >= self.min_word_frequency:
                cache.add(word, c)
        cache.finalize_indices()
        build_huffman(cache)
        return cache


def build_huffman(cache: VocabCache):
    """Huffman.java parity: binary tree over word counts; each word gets its
    root-to-leaf ``code`` (0/1 branch choices) and ``points`` (inner-node
    row indices into syn1)."""
    words = cache.vocab_words
    n = len(words)
    if n == 0:
        return
    if n == 1:
        words[0].code, words[0].points = [0], [0]
        return
    # heap of (count, tiebreak, node_id); nodes 0..n-1 = leaves
    heap = [(w.count, i, i) for i, w in enumerate(words)]
    heapq.heapify(heap)
    parent = {}
    binary = {}
    next_id = n
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        parent[n1], parent[n2] = next_id, next_id
        binary[n1], binary[n2] = 0, 1
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    root = heap[0][2]
    for i, w in enumerate(words):
        code, points = [], []
        node = i
        while node != root:
            code.append(binary[node])
            node = parent[node]
            points.append(node - n)  # inner nodes index syn1 rows
        code.reverse()
        points.reverse()
        w.code = code[:MAX_CODE_LENGTH]
        w.points = points[:MAX_CODE_LENGTH]


def make_negative_table(cache: VocabCache, table_size: int = 10_000_000,
                        power: float = 0.75) -> np.ndarray:
    """Unigram^power sampling table (InMemoryLookupTable.makeTable parity).
    Entry j holds a word index; sampling uniform j gives P(w) ∝ count^0.75."""
    counts = np.array([w.count for w in cache.vocab_words], dtype=np.float64)
    probs = counts ** power
    probs /= probs.sum()
    bounds = np.cumsum(probs)
    table = np.searchsorted(bounds, np.arange(table_size) / table_size)
    return np.minimum(table, len(counts) - 1).astype(np.int32)


def make_subsample_keep_probs(cache: VocabCache,
                              sample: float) -> Optional[np.ndarray]:
    """word2vec frequent-word subsampling: keep prob per word index
    (SequenceVectors sampling parity); None when disabled (sample <= 0)."""
    if sample <= 0:
        return None
    total = cache.total_count()
    freqs = np.array([w.count for w in cache.vocab_words],
                     dtype=np.float64) / max(total, 1)
    keep = (np.sqrt(freqs / sample) + 1) * (sample / np.maximum(freqs, 1e-12))
    return np.minimum(keep, 1.0)
