"""node2vec: biased second-order random walks -> SkipGram embeddings
(counterpart of deeplearning4j_tpu/graph/node2vec.py; the walks are host
code with the JAX package's draws, the embeddings train on the port's
SequenceVectors). A hop takes ``Generator.choice``'s draw written out
(graph/walks.py), so the walks are the JAX package's for a seed.

Parity-plus: the reference ships only a STUB
(deeplearning4j-nlp/.../models/node2vec/ — empty scaffolding, SURVEY.md
§2.6 "models/node2vec/ (stub)"); this is the real algorithm (Grover &
Leskovec 2016) built on the same pieces DeepWalk uses: the adjacency
Graph (graph/graph.py) and the batched SequenceVectors trainer.

The walk bias: having stepped t -> v, the next hop x is drawn with
unnormalized probability

    w(v,x) * 1/p   if x == t            (return)
    w(v,x) * 1     if dist(t, x) == 1   (stay close — BFS-like)
    w(v,x) * 1/q   otherwise            (explore — DFS-like)

p == q == 1 degenerates to DeepWalk's first-order walks.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk
from deeplearning4j_tpu_torch.graph.walks import cumulative, draw


class Node2VecWalkIterator:
    """Second-order (p, q)-biased walk generator over a Graph."""

    def __init__(self, graph, walk_length: int, p: float = 1.0,
                 q: float = 1.0, walks_per_vertex: int = 1, seed: int = 0):
        if p <= 0 or q <= 0:
            raise ValueError("p and q must be positive")
        self.graph = graph
        self.walk_length = walk_length
        self.p = float(p)
        self.q = float(q)
        self.walks_per_vertex = walks_per_vertex
        self.seed = seed
        # neighbor sets for the dist(t, x) == 1 test
        self._nbr_sets = [set(graph.neighbors(v))
                          for v in range(graph.num_vertices())]

    def _step(self, rng, prev: Optional[int], cur: int) -> Optional[int]:
        nbrs = self.graph.weighted_neighbors(cur)
        if not nbrs:
            return None
        if prev is None:
            w = np.asarray([wt for _, wt in nbrs], np.float64)
        else:
            prev_nbrs = self._nbr_sets[prev]
            w = np.asarray(
                [wt / self.p if x == prev
                 else (wt if x in prev_nbrs else wt / self.q)
                 for x, wt in nbrs], np.float64)
        w /= w.sum()
        return nbrs[draw(rng, cumulative(w))][0]

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        n = self.graph.num_vertices()
        for _ in range(self.walks_per_vertex):
            for start in rng.permutation(n):
                walk: List[int] = [int(start)]
                prev: Optional[int] = None
                while len(walk) < self.walk_length:
                    nxt = self._step(rng, prev, walk[-1])
                    if nxt is None:
                        break
                    prev = walk[-1]
                    walk.append(int(nxt))
                yield walk

    def reset(self):
        pass


class Node2Vec(DeepWalk):
    """node2vec trainer: DeepWalk with (p, q)-biased second-order walks
    (and optional negative sampling); the fit/query surface is inherited."""

    def __init__(self, vector_size: int = 100, window: int = 5,
                 walk_length: int = 40, walks_per_vertex: int = 1,
                 p: float = 1.0, q: float = 1.0,
                 learning_rate: float = 0.025, epochs: int = 1,
                 negative: int = 0, seed: int = 42, device=None):
        super().__init__(vector_size=vector_size, window=window,
                         walk_length=walk_length,
                         walks_per_vertex=walks_per_vertex,
                         learning_rate=learning_rate, epochs=epochs,
                         negative=negative, seed=seed, device=device)
        self.p = p
        self.q = q

    def _default_walks(self, graph):
        return Node2VecWalkIterator(
            graph, self.walk_length, p=self.p, q=self.q,
            walks_per_vertex=self.walks_per_vertex, seed=self.seed)
