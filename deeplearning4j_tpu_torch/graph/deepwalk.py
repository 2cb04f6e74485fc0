"""DeepWalk: random walks -> SkipGram with hierarchical softmax over vertex
"words" (counterpart of deeplearning4j_tpu/graph/deepwalk.py).

Parity: models/deepwalk/DeepWalk.java (254 LoC; fit(IGraph, walkLength)
:95-103 — walks feed SkipGram-style updates on a GraphHuffman tree) +
models/embeddings/GraphVectorsImpl.java. Here the walks feed the same
batched SequenceVectors trainer the NLP stack uses (degree-weighted Huffman
tree replaces GraphHuffman), whose tables live on ``device`` (None: the
card).
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.graph.walks import RandomWalkIterator
from deeplearning4j_tpu_torch.nlp.sequence_vectors import (
    SequenceVectors,
    SequenceVectorsConfig,
)


class DeepWalk:
    def __init__(self, vector_size: int = 100, window: int = 5,
                 walk_length: int = 40, walks_per_vertex: int = 1,
                 learning_rate: float = 0.025, epochs: int = 1,
                 negative: int = 0, seed: int = 42, device=None):
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window = window
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.negative = negative
        self.seed = seed
        self.vectors: SequenceVectors | None = None

    def _default_walks(self, graph):
        return RandomWalkIterator(
            graph, self.walk_length, seed=self.seed,
            walks_per_vertex=self.walks_per_vertex)

    def _config(self) -> SequenceVectorsConfig:
        return SequenceVectorsConfig(
            vector_size=self.vector_size, window=self.window,
            min_word_frequency=1, epochs=self.epochs,
            learning_rate=self.learning_rate, negative=self.negative,
            seed=self.seed)

    def fit(self, graph, walk_iterator=None):
        """DeepWalk.fit(IGraph, walkLength) parity."""
        if walk_iterator is None:
            walk_iterator = self._default_walks(graph)
        walks = [[str(v) for v in walk] for walk in walk_iterator]
        self.vectors = SequenceVectors(self._config(), device=self.device)
        self.vectors.build_vocab(walks)
        self.vectors.fit(walks)
        return self

    def vertex_vector(self, v: int) -> np.ndarray:
        return self.vectors.get_word_vector(str(v))

    def similarity(self, a: int, b: int) -> float:
        return self.vectors.similarity(str(a), str(b))

    def verts_nearest(self, v: int, top_n: int = 5):
        return [(int(w), s)
                for w, s in self.vectors.words_nearest(str(v), top_n)]
