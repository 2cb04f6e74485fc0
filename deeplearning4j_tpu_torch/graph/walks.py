"""Random-walk sequence generators (parity: iterator/RandomWalkIterator.java
and WeightedRandomWalkIterator.java in deeplearning4j-graph; counterpart
of deeplearning4j_tpu/graph/walks.py: the same numpy draws, so the same
walks for a seed).

Each hop takes the draw ``Generator.choice`` would take, written out so
that no hop converts a neighbour list to an array: a uniform hop is
``integers(0, degree)`` (choice's draw without weights), a weighted hop
one ``random()`` searched in the normalized cumulative weights (choice's
draw with ``p``), whose tables are built once a pass.
"""

from __future__ import annotations

import numpy as np


def cumulative(p: np.ndarray) -> np.ndarray:
    """``Generator.choice``'s table for the probabilities ``p``: their
    cumulative sum, normalized by its last entry."""
    cdf = p.cumsum()
    cdf /= cdf[-1]
    return cdf


def draw(rng, cdf) -> int:
    """The index ``rng.choice(len(cdf), p=...)`` draws, from its table."""
    return int(cdf.searchsorted(rng.random(), side="right"))


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex
    (RandomWalkIterator.java parity; ``no_edge_handling`` SELF_LOOP keeps
    the walker in place at sinks)."""

    def __init__(self, graph, walk_length: int, seed: int = 0,
                 walks_per_vertex: int = 1):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.walks_per_vertex = walks_per_vertex

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        nbrs = [self.graph.neighbors(v)
                for v in range(self.graph.num_vertices())]
        for _ in range(self.walks_per_vertex):
            for start in range(self.graph.num_vertices()):
                walk = [start]
                cur = start
                for _ in range(self.walk_length - 1):
                    nb = nbrs[cur]
                    if nb:
                        cur = nb[int(rng.integers(0, len(nb)))]
                    walk.append(cur)
                yield walk

    def reset(self):
        pass


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional walks (WeightedRandomWalkIterator.java)."""

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        hops = []
        for v in range(self.graph.num_vertices()):
            wn = self.graph.weighted_neighbors(v)
            ws = np.array([w for _, w in wn], dtype=np.float64)
            hops.append(([b for b, _ in wn], cumulative(ws / ws.sum()))
                        if wn else None)
        for _ in range(self.walks_per_vertex):
            for start in range(self.graph.num_vertices()):
                walk = [start]
                cur = start
                for _ in range(self.walk_length - 1):
                    if hops[cur] is not None:
                        targets, cdf = hops[cur]
                        cur = targets[draw(rng, cdf)]
                    walk.append(cur)
                yield walk
