"""Spatial trees for nearest-neighbor queries: KD-tree and VP-tree
(counterpart of deeplearning4j_tpu/clustering/trees.py).

Parity: deeplearning4j-core clustering/kdtree/KDTree.java and
clustering/vptree/VPTree.java (used by t-SNE and the NLP wordsNearest
paths). Host-side float64 numpy structures, as in the JAX package: bulk
queries are a matrix product on the card, the trees cover the
incremental/online API of the reference.
"""

from __future__ import annotations

import numpy as np


class KDTree:
    def __init__(self, points):
        self.points = np.asarray(points, np.float64)
        n = self.points.shape[0]
        self._root = self._build(np.arange(n), depth=0)

    def _build(self, idxs, depth):
        if len(idxs) == 0:
            return None
        axis = depth % self.points.shape[1]
        order = idxs[np.argsort(self.points[idxs, axis])]
        mid = len(order) // 2
        return {
            "idx": int(order[mid]),
            "axis": axis,
            "left": self._build(order[:mid], depth + 1),
            "right": self._build(order[mid + 1:], depth + 1),
        }

    def nn(self, query):
        return self.knn(query, 1)[0]

    def knn(self, query, k):
        query = np.asarray(query, np.float64)
        heap = []  # list of (dist, idx), kept sorted, max size k

        def visit(node):
            if node is None:
                return
            p = self.points[node["idx"]]
            d = float(np.linalg.norm(p - query))
            if len(heap) < k or d < heap[-1][0]:
                heap.append((d, node["idx"]))
                heap.sort()
                if len(heap) > k:
                    heap.pop()
            axis = node["axis"]
            diff = query[axis] - p[axis]
            near, far = ((node["left"], node["right"]) if diff < 0
                         else (node["right"], node["left"]))
            visit(near)
            if len(heap) < k or abs(diff) < heap[-1][0]:
                visit(far)

        visit(self._root)
        return [(idx, d) for d, idx in heap]


class VPTree:
    """Vantage-point tree over any metric (default euclidean)
    (VPTree.java parity)."""

    def __init__(self, points, metric=None, seed: int = 0):
        self.points = np.asarray(points, np.float64)
        self.metric = metric or (lambda a, b: float(np.linalg.norm(a - b)))
        self._rng = np.random.default_rng(seed)
        self._root = self._build(list(range(self.points.shape[0])))

    def _build(self, idxs):
        if not idxs:
            return None
        vp = idxs[self._rng.integers(0, len(idxs))]
        rest = [i for i in idxs if i != vp]
        if not rest:
            return {"vp": vp, "mu": 0.0, "inside": None, "outside": None}
        dists = np.array([self.metric(self.points[vp], self.points[i])
                          for i in rest])
        mu = float(np.median(dists))
        inside = [i for i, d in zip(rest, dists) if d < mu]
        outside = [i for i, d in zip(rest, dists) if d >= mu]
        return {"vp": vp, "mu": mu, "inside": self._build(inside),
                "outside": self._build(outside)}

    def knn(self, query, k):
        query = np.asarray(query, np.float64)
        heap = []

        def visit(node):
            if node is None:
                return
            d = self.metric(self.points[node["vp"]], query)
            if len(heap) < k or d < heap[-1][0]:
                heap.append((d, node["vp"]))
                heap.sort()
                if len(heap) > k:
                    heap.pop()
            tau = heap[-1][0] if len(heap) == k else np.inf
            if d < node["mu"]:
                visit(node["inside"])
                if d + tau >= node["mu"]:
                    visit(node["outside"])
            else:
                visit(node["outside"])
                if d - tau <= node["mu"]:
                    visit(node["inside"])

        visit(self._root)
        return [(idx, d) for d, idx in heap]
