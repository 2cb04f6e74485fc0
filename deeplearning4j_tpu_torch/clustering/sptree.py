"""Space-partitioning tree (SPTree) with center-of-mass aggregation
(counterpart of deeplearning4j_tpu/clustering/sptree.py).

Parity: deeplearning4j-core clustering/sptree/SpTree.java (+ the 2D
special case clustering/quadtree/QuadTree.java — here ``QuadTree`` is the
d=2 instantiation). Used by Barnes-Hut t-SNE: cells far enough away
(cell_size / distance < theta) are approximated by their center of mass,
turning the O(N^2) repulsive-force sum into O(N log N).

Host-side float64 numpy, as in the JAX package: tree construction and
pointer-chasing traversal are control-flow-heavy and tiny; the card's
path is the exact [N, N] t-SNE in plot/tsne.py.
"""

from __future__ import annotations

import numpy as np


class SPTree:
    """One node: either a leaf holding <= ``leaf_size`` points or 2^d
    children splitting the cell at its center."""

    __slots__ = ("center", "width", "n", "com", "children", "idx",
                 "points", "leaf_size")

    def __init__(self, points, center=None, width=None, leaf_size=1):
        points = np.asarray(points, np.float64)
        if center is None:
            lo = points.min(axis=0)
            hi = points.max(axis=0)
            center = (lo + hi) / 2.0
            width = np.maximum(hi - lo, 1e-10) * (1.0 + 1e-6)
        self.center = np.asarray(center, np.float64)
        self.width = np.asarray(width, np.float64)
        self.leaf_size = leaf_size
        self.children = None
        self.n = 0
        self.com = np.zeros_like(self.center)
        self.idx = []
        self.points = points
        for i in range(points.shape[0]):
            self._insert(i)

    # ------------------------------------------------------------ build
    def _child_index(self, p):
        return int(sum((1 << k) for k in range(p.shape[0])
                       if p[k] > self.center[k]))

    def _subdivide(self):
        d = self.center.shape[0]
        self.children = [None] * (1 << d)

    def _make_child(self, ci):
        d = self.center.shape[0]
        off = np.asarray([(1 if (ci >> k) & 1 else -1) for k in range(d)],
                         np.float64)
        child = SPTree.__new__(SPTree)
        child.center = self.center + off * self.width / 4.0
        child.width = self.width / 2.0
        child.leaf_size = self.leaf_size
        child.children = None
        child.n = 0
        child.com = np.zeros_like(self.center)
        child.idx = []
        child.points = self.points
        return child

    def _insert(self, i):
        p = self.points[i]
        self.com = (self.com * self.n + p) / (self.n + 1)
        self.n += 1
        if self.children is None:
            self.idx.append(i)
            if len(self.idx) > self.leaf_size and np.max(self.width) > 1e-8:
                self._subdivide()
                pending, self.idx = self.idx, []
                for j in pending:
                    self._route(j)
            return
        self._route(i)

    def _route(self, i):
        ci = self._child_index(self.points[i])
        if self.children[ci] is None:
            self.children[ci] = self._make_child(ci)
        c = self.children[ci]
        c.com = (c.com * c.n + self.points[i]) / (c.n + 1)
        c.n += 1
        if c.children is None:
            c.idx.append(i)
            if len(c.idx) > c.leaf_size and np.max(c.width) > 1e-8:
                c._subdivide()
                pending, c.idx = c.idx, []
                for j in pending:
                    c._route(j)
        else:
            c._route(i)

    # -------------------------------------------------------- traversal
    def non_edge_forces(self, point, skip_index, theta):
        """Barnes-Hut repulsive accumulation for one query point.

        Returns (neg_force [d], z_sum): contributions q^2 * N * (p - com)
        and q * N with q = 1/(1 + |p - com|^2), descending only into
        cells with cell_width / dist >= theta (SpTree.java
        computeNonEdgeForces parity)."""
        d = self.center.shape[0]
        neg = np.zeros(d)
        z = 0.0
        stack = [self]
        max_w = float(np.max(self.width))
        while stack:
            node = stack.pop()
            if node is None or node.n == 0:
                continue
            diff = point - node.com
            dist2 = float(diff @ diff)
            is_leaf = node.children is None
            w = float(np.max(node.width))
            if is_leaf or (w * w < theta * theta * dist2):
                if is_leaf and node.idx == [skip_index]:
                    continue
                n_eff = node.n
                if is_leaf and skip_index in node.idx:
                    n_eff -= 1
                    # remove the skipped point's own contribution from the
                    # leaf's aggregate
                    if n_eff == 0:
                        continue
                    com = (node.com * node.n - point) / n_eff
                    diff = point - com
                    dist2 = float(diff @ diff)
                q = 1.0 / (1.0 + dist2)
                z += n_eff * q
                neg += n_eff * q * q * diff
            else:
                stack.extend(c for c in node.children if c is not None)
        return neg, z


class QuadTree(SPTree):
    """2D SPTree (clustering/quadtree/QuadTree.java parity)."""

    def __init__(self, points, **kw):
        points = np.asarray(points)
        if points.shape[1] != 2:
            raise ValueError("QuadTree requires 2d points; use SPTree")
        super().__init__(points, **kw)
