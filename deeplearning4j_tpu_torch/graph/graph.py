"""Adjacency-list graph (parity: graph/api/IGraph.java + graph/graph/
Graph.java + data/GraphLoader.java in deeplearning4j-graph; counterpart of
deeplearning4j_tpu/graph/graph.py, host code kept as a copy)."""

from __future__ import annotations

from typing import List, Optional, Tuple


class Graph:
    def __init__(self, num_vertices: int, directed: bool = False):
        self.num_vertices_count = num_vertices
        self.directed = directed
        self._adj: List[List[Tuple[int, float]]] = [
            [] for _ in range(num_vertices)]

    def num_vertices(self) -> int:
        return self.num_vertices_count

    def add_edge(self, a: int, b: int, weight: float = 1.0):
        self._adj[a].append((b, weight))
        if not self.directed:
            self._adj[b].append((a, weight))

    def neighbors(self, v: int) -> List[int]:
        return [b for b, _ in self._adj[v]]

    def weighted_neighbors(self, v: int) -> List[Tuple[int, float]]:
        return list(self._adj[v])

    def degree(self, v: int) -> int:
        return len(self._adj[v])

    @staticmethod
    def from_edge_list(edges, num_vertices: Optional[int] = None,
                       directed: bool = False) -> "Graph":
        """GraphLoader.loadUndirectedGraphEdgeListFile parity for in-memory
        edge lists: iterable of (a, b) or (a, b, weight)."""
        edges = list(edges)
        if num_vertices is None:
            num_vertices = 1 + max(max(e[0], e[1]) for e in edges)
        g = Graph(num_vertices, directed)
        for e in edges:
            g.add_edge(e[0], e[1], e[2] if len(e) > 2 else 1.0)
        return g
