"""The port's graph embeddings (deeplearning4j_tpu_torch/graph) against the
JAX package's (deeplearning4j_tpu/graph): the same graphs and the same
walks for a seed (host code with the same numpy draws), DeepWalk and
Node2Vec vertex vectors within 1e-4 of the table's largest entry, and
tests/test_nlp.py's two-clique and biased-walk checks on the port.
(tests/test_torch_graph.py holds the ComputationGraph.)"""

import numpy as np
import pytest

from deeplearning4j_tpu import graph as jgraph
from deeplearning4j_tpu_torch import graph as tgraph

FIT_TOL = 1e-4

DEEPWALK_KW = dict(vector_size=16, window=4, walk_length=20,
                   walks_per_vertex=8, epochs=5, seed=3)
NODE2VEC_KW = dict(vector_size=16, window=4, walk_length=20,
                   walks_per_vertex=16, p=1.0, q=2.0, epochs=8, seed=3)


def two_cliques(pkg):
    edges = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    edges += [(i, j) for i in range(6, 12) for j in range(i + 1, 12)]
    edges.append((5, 6))
    return pkg.Graph.from_edge_list(edges)


def star_with_tail(pkg):
    return pkg.Graph.from_edge_list([(0, i) for i in range(1, 8)]
                                    + [(1, 8), (8, 9)])


def weighted(pkg):
    rng = np.random.default_rng(4)
    edges = [(int(a), int(b), float(w)) for a, b, w in zip(
        rng.integers(0, 15, 40), rng.integers(0, 15, 40),
        rng.uniform(0.1, 3.0, 40)) if a != b]
    return pkg.Graph.from_edge_list(edges, num_vertices=16)


def directed(pkg):
    return pkg.Graph.from_edge_list([(0, 1), (1, 2), (2, 0), (2, 3)],
                                    directed=True)


def random_weighted(pkg):
    """300 vertices, 1,500 weighted edges (repeats kept): walks of many
    hops over varied degrees."""
    rng = np.random.default_rng(11)
    a, b = rng.integers(0, 300, (2, 1500))
    w = rng.uniform(0.1, 4.0, 1500)
    return pkg.Graph.from_edge_list(
        [(int(x), int(y), float(z)) for x, y, z in zip(a, b, w) if x != y],
        num_vertices=300)


GRAPHS = {"two_cliques": two_cliques, "star_with_tail": star_with_tail,
          "weighted": weighted, "directed": directed,
          "random_weighted": random_weighted}


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("make", list(GRAPHS.values()), ids=list(GRAPHS))
def test_graphs_equal(make):
    j, t = make(jgraph), make(tgraph)
    assert t.num_vertices() == j.num_vertices()
    for v in range(j.num_vertices()):
        assert t.weighted_neighbors(v) == j.weighted_neighbors(v)
        assert t.degree(v) == j.degree(v)


WALKS = {
    "uniform": lambda p, g: p.RandomWalkIterator(g, 12, seed=5,
                                                 walks_per_vertex=3),
    "weighted": lambda p, g: p.WeightedRandomWalkIterator(
        g, 12, seed=6, walks_per_vertex=3),
    "node2vec_bfs": lambda p, g: p.Node2VecWalkIterator(
        g, 12, p=0.25, q=4.0, walks_per_vertex=3, seed=7),
    "node2vec_dfs": lambda p, g: p.Node2VecWalkIterator(
        g, 12, p=4.0, q=0.25, walks_per_vertex=3, seed=8),
    "node2vec_quarter": lambda p, g: p.Node2VecWalkIterator(
        g, 12, p=0.25, q=0.25, walks_per_vertex=2, seed=9),
}


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("walk", list(WALKS))
def test_walks_equal_for_a_seed(graph, walk):
    want = list(WALKS[walk](jgraph, GRAPHS[graph](jgraph)))
    got = list(WALKS[walk](tgraph, GRAPHS[graph](tgraph)))
    assert got == want and len(want) > 0


@pytest.fixture(scope="module")
def jax_embeddings():
    dw = jgraph.DeepWalk(**DEEPWALK_KW).fit(two_cliques(jgraph))
    n2v = jgraph.Node2Vec(**NODE2VEC_KW).fit(two_cliques(jgraph))
    return {name: (np.asarray(m.vectors.lookup.syn0),
                   np.asarray(m.vectors.lookup.syn1),
                   [m.vectors.vocab.word_for_index(i)
                    for i in range(len(m.vectors.vocab))])
            for name, m in (("deepwalk", dw), ("node2vec", n2v))}


def _clique_gap(m):
    same = np.mean([m.similarity(0, 1), m.similarity(2, 3),
                    m.similarity(7, 8), m.similarity(9, 10)])
    cross = np.mean([m.similarity(0, 11), m.similarity(1, 9),
                     m.similarity(3, 8), m.similarity(2, 10)])
    return same, cross


@pytest.mark.parametrize("name", ["deepwalk", "node2vec"])
def test_vertex_vectors_match_and_cluster_the_cliques(name, jax_embeddings):
    cls, kw = ((tgraph.DeepWalk, DEEPWALK_KW) if name == "deepwalk"
               else (tgraph.Node2Vec, NODE2VEC_KW))
    m = cls(device="cpu", **kw).fit(two_cliques(tgraph))
    syn0, syn1, words = jax_embeddings[name]
    assert [m.vectors.vocab.word_for_index(i)
            for i in range(len(m.vectors.vocab))] == words
    assert rel_err(m.vectors.lookup.syn0.numpy(), syn0) <= FIT_TOL
    assert rel_err(m.vectors.lookup.syn1.numpy(), syn1) <= FIT_TOL
    np.testing.assert_allclose(m.vertex_vector(4),
                               syn0[words.index("4")], rtol=0,
                               atol=FIT_TOL * np.abs(syn0).max())
    same, cross = _clique_gap(m)
    assert same > cross + 0.1, (same, cross)
    if name == "node2vec":
        nearest = [v for v, _ in m.verts_nearest(8, top_n=3)]
        assert all(v >= 6 for v in nearest), nearest


def test_walk_bias_statistics():
    """Low q explores: fewer immediate returns than a high q
    (tests/test_nlp.py's check, on the port's walks)."""
    g = star_with_tail(tgraph)

    def return_rate(p, q):
        returns = steps = 0
        for walk in tgraph.Node2VecWalkIterator(g, walk_length=30, p=p, q=q,
                                                walks_per_vertex=30, seed=0):
            for i in range(2, len(walk)):
                steps += 1
                returns += walk[i] == walk[i - 2]
        return returns / max(steps, 1)
    high, low = return_rate(0.25, 4.0), return_rate(4.0, 0.25)
    assert high > low + 0.1, (high, low)


def test_p_q_validation():
    with pytest.raises(ValueError):
        tgraph.Node2VecWalkIterator(tgraph.Graph.from_edge_list([(0, 1)]),
                                    10, p=0.0)
