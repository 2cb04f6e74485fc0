"""The port's exact t-SNE (deeplearning4j_tpu_torch/plot/tsne.py) on the
CPU against the JAX package's: P (the perplexity search over the pairwise
distances) within 1e-5, the KL gradient and the KL at a given Y within
1e-5, 10 iterations from the same numpy-seeded init within 1e-4, the
embedding the UI publishes, and BarnesHutTsne refused by name.

Why 10 iterations at learning rate 10: at the default 200 the early
exaggeration (x12) grows a one-ulp difference between the two packages'
products by about a decade an iteration, so after 10 iterations the two
embeddings are different ones; the trajectory is held where differences
do not grow, and the gradient under exaggeration is held on its own.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deeplearning4j_tpu.plot import tsne as jtsne
from deeplearning4j_tpu_torch.plot import tsne as ttsne
from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne

P_TOL, GRAD_TOL, TRAJ_TOL = 1e-5, 1e-5, 1e-4


def _x(n=40, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _jax_p(x, perplexity):
    n = x.shape[0]
    d2 = jtsne._pairwise_sq_dists(jnp.asarray(x))
    P = jtsne._cond_probs_for_perplexity(
        d2, min(perplexity, max((n - 1) / 3.0, 2.0)))
    return np.asarray(jnp.maximum((P + P.T) / (2.0 * n), 1e-12),
                      np.float32)


@pytest.mark.parametrize("n,d,perplexity", [(40, 16, 10.0), (25, 3, 30.0),
                                            (80, 64, 15.0)])
def test_p_matches_the_jax_search(n, d, perplexity):
    x = _x(n, d, seed=n)
    got = ttsne.joint_probabilities(torch.from_numpy(x), perplexity)
    assert np.abs(got.numpy() - _jax_p(x, perplexity)).max() <= P_TOL
    # each row's conditional distribution sums to one before the symmetry
    cond = ttsne._cond_probs_for_perplexity(
        ttsne._pairwise_sq_dists(torch.from_numpy(x)), perplexity)
    assert torch.allclose(cond.sum(1), torch.ones(n), atol=1e-5)


@pytest.mark.parametrize("exaggeration", [1.0, 12.0])
def test_gradient_and_kl_at_a_given_y(exaggeration):
    x = _x()
    P = _jax_p(x, 10.0) * exaggeration
    y = (np.random.default_rng(1).standard_normal((40, 2)) * 3).astype(
        np.float32)
    jg, jkl = jtsne._tsne_grad(jnp.asarray(y), jnp.asarray(P))
    tg, tkl = ttsne._tsne_grad(torch.from_numpy(y), torch.from_numpy(P))
    scale = max(1.0, float(np.abs(np.asarray(jg)).max()))
    assert np.abs(tg.numpy() - np.asarray(jg)).max() <= GRAD_TOL * scale
    assert abs(float(tkl) - float(jkl)) <= GRAD_TOL * abs(float(jkl))
    g2, kl2 = ttsne._tsne_grad(torch.from_numpy(y), torch.from_numpy(P),
                               with_kl=False)
    assert kl2 is None and torch.equal(g2, tg)


def test_ten_iterations_from_the_same_init():
    x = _x()
    kw = dict(perplexity=10.0, max_iter=10, learning_rate=10.0, seed=4)
    got = Tsne(device="cpu", **kw)
    want = jtsne.Tsne(**kw)
    gy, wy = got.fit_transform(x), want.fit_transform(x)
    assert gy.shape == (40, 2) and gy.dtype == np.float32
    assert np.abs(gy - wy).max() <= TRAJ_TOL
    assert abs(got.kl - want.kl) <= 1e-4 * abs(want.kl)
    assert np.abs(got.P.numpy() - _jax_p(x, 10.0)).max() <= P_TOL


def test_published_embedding_runs_the_exact_tsne():
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage
    from deeplearning4j_tpu_torch.ui.embedding import (EMBEDDING_KEY,
                                                       get_embedding,
                                                       publish_embedding)
    x = _x(30, 8, seed=2)
    st = InMemoryStatsStorage()
    xy = publish_embedding(st, "s", x, [f"w{i}" for i in range(30)],
                           iterations=20, device="cpu")
    want = Tsne(perplexity=15.0, max_iter=20, device="cpu").fit_transform(x)
    assert np.array_equal(xy, want)
    info = get_embedding([st], "s")
    assert info == st.get_static_info("s", EMBEDDING_KEY)
    assert info["labels"][3] == "w3" and len(info["xy"]) == 30
    with pytest.raises(ValueError, match="labels"):
        publish_embedding(st, "s", x, ["a"], device="cpu")
    flat = publish_embedding(st, "s", x[:, :1], [str(i) for i in range(30)])
    assert np.array_equal(flat[:, 0], x[:, 0]) and not flat[:, 1].any()


def test_barnes_hut_is_refused_by_name_and_the_card_is_the_default():
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.6"):
        BarnesHutTsne(theta=0.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Tsne()
