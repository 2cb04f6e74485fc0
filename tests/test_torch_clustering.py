"""The port's clustering (deeplearning4j_tpu_torch/clustering/) and
Barnes-Hut t-SNE (plot/tsne.py) held against the JAX package's on the
CPU: the clustering cases of tests/test_datasets_clustering.py.

- K-means: the k-means++ seeding picks the JAX package's indices (the
  port keeps a running minimum where the JAX package recomputes every
  chosen centroid's distances); centroids and cost after the Lloyd
  iterations within 1e-5 relative; the same assignments; the clusters
  recovered; duplicate points with more clusters than distinct points.
- KD-tree and VP-tree: the same kNN as the JAX package's and as brute
  force.
- SPTree: the same counts and centers of mass; ``non_edge_forces``
  within 1e-12 of the JAX package's at theta 0 and 0.5, and of the exact
  sum at theta 0.
- Barnes-Hut t-SNE: theta = 0.5 within 1e-9 of the JAX package's
  embedding and KL, the clusters separated; theta = 0 is the exact
  ``Tsne`` bit for bit.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.clustering import kmeans as jkmeans
from deeplearning4j_tpu.clustering import sptree as jsptree
from deeplearning4j_tpu.clustering import trees as jtrees
from deeplearning4j_tpu.plot import tsne as jtsne
from deeplearning4j_tpu_torch.clustering import (KDTree, KMeansClustering,
                                                 QuadTree, SPTree, VPTree)
from deeplearning4j_tpu_torch.clustering import kmeans as pkmeans
from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne

KM_RTOL = 1e-5


def cluster_data(seed=0, k=3, n=300, d=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 8, (k, d))
    idx = rng.integers(0, k, n)
    return centers[idx] + rng.normal(0, 0.6, (n, d)), idx


def jax_fit(monkeypatch, x, **kw):
    """The JAX package's KMeansClustering fitted on ``x``, with the row
    indices of its seeded centroids (read from the first Lloyd step's
    input)."""
    first = []
    step = jkmeans._lloyd_step

    def spy(xs, centroids, k):
        if not first:
            first.append(np.asarray(centroids))
        return step(xs, centroids, k)
    monkeypatch.setattr(jkmeans, "_lloyd_step", spy)
    km = jkmeans.KMeansClustering(**kw).fit(x)
    xf = np.asarray(x, np.float32)
    idx = [int(np.flatnonzero((xf == c).all(axis=1))[0]) for c in first[0]]
    return km, idx


@pytest.mark.parametrize("k,seed,data_seed", [(3, 1, 0), (8, 4, 5),
                                              (20, 2, 6)])
def test_kmeans_matches_the_jax_package(monkeypatch, k, seed, data_seed):
    x, _ = cluster_data(seed=data_seed, k=min(k, 6), n=400, d=5)
    jkm, jidx = jax_fit(monkeypatch, x, k=k, seed=seed)
    km = KMeansClustering(k=k, seed=seed, device="cpu")
    assert km._seed_indices(km._points(x)) == jidx
    km.fit(x)
    want = np.asarray(jkm.centroids)
    got = km.centroids.numpy()
    np.testing.assert_allclose(got, want, rtol=KM_RTOL,
                               atol=KM_RTOL * np.abs(want).max())
    assert km.cost == pytest.approx(jkm.cost, rel=KM_RTOL)
    np.testing.assert_array_equal(km.predict(x), jkm.predict(x))


def test_lloyd_step_matches_the_jax_package():
    """One step from the same centroids, with an empty cluster kept."""
    x, _ = cluster_data(seed=7, k=3, n=200, d=6)
    c = np.concatenate([x[:3], np.full((1, 6), 1e3)]).astype(np.float32)
    jc, ja, jcost = jkmeans._lloyd_step(np.asarray(x, np.float32), c, 4)
    pc, pa, pcost = pkmeans._lloyd_step(torch.as_tensor(x, dtype=torch.float32),
                                        torch.as_tensor(c), 4)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=KM_RTOL,
                               atol=KM_RTOL * 10)
    assert pc[3].tolist() == c[3].tolist()          # empty: kept as it was
    assert float(pcost) == pytest.approx(float(jcost), rel=KM_RTOL)


def test_kmeans_recovers_clusters():
    x, true = cluster_data()
    pred = KMeansClustering(k=3, seed=1, device="cpu").fit(x).predict(x)
    purity = 0
    for c in range(3):
        members = true[pred == c]
        if len(members):
            purity += np.bincount(members).max()
    assert purity / len(true) > 0.95


def test_kmeans_duplicate_points_more_clusters_than_distinct(monkeypatch):
    # the seeding must not fail when all remaining points coincide with
    # chosen centroids (zero total distance)
    x = np.array([[1.0, 1.0]] * 6 + [[2.0, 2.0]] * 2, np.float32)
    first = []
    step = jkmeans._lloyd_step
    monkeypatch.setattr(jkmeans, "_lloyd_step", lambda xs, c, k: (
        first.append(np.asarray(c)) if not first else None) or step(xs, c, k))
    jkm = jkmeans.KMeansClustering(k=4, max_iterations=5, seed=0).fit(x)
    km = KMeansClustering(k=4, max_iterations=5, seed=0, device="cpu")
    idx = km._seed_indices(km._points(x))
    np.testing.assert_array_equal(x[idx], first[0])
    km.fit(x)
    assert km.centroids.shape == (4, 2)
    np.testing.assert_array_equal(km.centroids.numpy(),
                                  np.asarray(jkm.centroids))


@pytest.mark.parametrize("k", [1, 5])
def test_kdtree_vptree_knn_match_the_jax_package(k):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 5))
    q = rng.normal(size=5)
    brute = sorted(np.argsort(np.linalg.norm(pts - q, axis=1))[:k].tolist())
    for ours, theirs in ((KDTree(pts), jtrees.KDTree(pts)),
                         (VPTree(pts), jtrees.VPTree(pts))):
        got = ours.knn(q, k)
        assert got == theirs.knn(q, k)
        assert sorted(i for i, _ in got) == brute
    assert KDTree(pts).nn(q) == jtrees.KDTree(pts).nn(q)


def test_sptree_com_and_counts():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 2))
    t, jt = QuadTree(pts), jsptree.QuadTree(pts)
    assert t.n == jt.n == 50
    np.testing.assert_allclose(t.com, pts.mean(axis=0), rtol=1e-9)
    np.testing.assert_array_equal(t.com, jt.com)
    with pytest.raises(ValueError):
        QuadTree(rng.normal(size=(5, 3)))
    p3 = rng.normal(size=(30, 3))
    assert SPTree(p3).n == jsptree.SPTree(p3).n == 30


@pytest.mark.parametrize("theta", [0.0, 0.5])
def test_non_edge_forces_match_the_jax_package(theta):
    rng = np.random.default_rng(2)
    y = rng.normal(size=(120, 2)) * 3
    tree, jtree = SPTree(y), jsptree.SPTree(y)
    for i in (0, 3, 60, 119):
        neg, z = tree.non_edge_forces(y[i], i, theta)
        jneg, jz = jtree.non_edge_forces(y[i], i, theta)
        np.testing.assert_allclose(neg, jneg, rtol=1e-12, atol=1e-12)
        assert z == pytest.approx(jz, rel=1e-12)
        if theta == 0.0:
            # theta -> 0: the tree sum equals the brute-force O(N^2) sum
            diff = y[i] - np.delete(y, i, axis=0)
            q = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
            np.testing.assert_allclose(z, q.sum(), rtol=1e-9)
            np.testing.assert_allclose(neg, ((q * q)[:, None] * diff).sum(0),
                                       rtol=1e-9, atol=1e-12)


# ------------------------------------------------------- Barnes-Hut t-SNE
BH = dict(perplexity=10, max_iter=250, theta=0.5, seed=0,
          learning_rate=50.0)


def two_blobs():
    rng = np.random.default_rng(3)
    a = rng.normal(0, 0.3, (30, 8)) + 4
    b = rng.normal(0, 0.3, (30, 8)) - 4
    return np.concatenate([a, b])


@pytest.fixture(scope="module")
def jax_barnes_hut():
    ts = jtsne.BarnesHutTsne(**BH)
    return ts.fit_transform(two_blobs()), ts.kl


def test_barnes_hut_matches_the_jax_package(jax_barnes_hut):
    want, want_kl = jax_barnes_hut
    ts = BarnesHutTsne(device="cpu", **BH)
    y = ts.fit_transform(two_blobs())
    assert y.shape == (60, 2) and y.dtype == np.float32
    np.testing.assert_allclose(y, want, rtol=1e-9, atol=1e-9)
    assert ts.kl == pytest.approx(want_kl, rel=1e-9)
    da, db = y[:30].mean(axis=0), y[30:].mean(axis=0)
    within = max(np.linalg.norm(y[:30] - da, axis=1).mean(),
                 np.linalg.norm(y[30:] - db, axis=1).mean())
    assert np.linalg.norm(da - db) > 2 * within


def test_barnes_hut_theta_zero_is_the_exact_tsne():
    x = two_blobs()
    kw = dict(perplexity=10, max_iter=30, seed=0, learning_rate=50.0,
              device="cpu")
    bh = BarnesHutTsne(theta=0.0, **kw)
    ex = Tsne(**kw)
    assert np.array_equal(bh.fit_transform(x), ex.fit_transform(x))
    assert bh.kl == ex.kl
