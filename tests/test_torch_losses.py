"""Every loss of the port's registry (deeplearning4j_tpu_torch/ops/losses.py)
against the JAX package's on the same pre-outputs and labels, with and
without a mask and per-output weights. f32; tolerance 1e-6 relative and
absolute: the same f32 formulas, reduced in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import losses as tlosses

N, C = 12, 7

# (loss, head activation, label kind)
CASES = [
    ("mcxent", "softmax", "onehot"), ("mcxent", "sigmoid", "onehot"),
    ("negativeloglikelihood", "softmax", "onehot"),
    ("mse", "identity", "real"), ("l2", "tanh", "real"),
    ("l1", "identity", "real"), ("mae", "identity", "real"),
    ("xent", "sigmoid", "binary"), ("xent", "softmax", "binary"),
    ("hinge", "identity", "sign"), ("squaredhinge", "identity", "sign"),
    ("kldivergence", "softmax", "dist"), ("mape", "identity", "real"),
    ("msle", "sigmoid", "positive"), ("poisson", "softplus", "positive"),
    ("cosineproximity", "identity", "real"),
]


def _labels(kind, rng):
    if kind == "onehot":
        return np.eye(C)[rng.integers(0, C, N)]
    if kind == "binary":
        return (rng.random((N, C)) > 0.5).astype(np.float64)
    if kind == "sign":
        return np.where(rng.random((N, C)) > 0.5, 1.0, -1.0)
    if kind == "dist":
        e = np.exp(rng.normal(0, 1, (N, C)))
        return e / e.sum(-1, keepdims=True)
    if kind == "positive":
        return rng.random((N, C)) * 3.0
    return rng.normal(0, 1, (N, C))


def test_every_registered_loss_is_covered():
    assert tlosses.names() == jlosses.names()
    assert {c[0] for c in CASES} == set(tlosses.names())


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("use_weights", [False, True])
@pytest.mark.parametrize("name,act,kind", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_loss_matches_jax(name, act, kind, use_mask, use_weights):
    rng = np.random.default_rng(CASES.index((name, act, kind)))
    preout = rng.normal(0, 2, (N, C)).astype(np.float32)
    labels = _labels(kind, rng).astype(np.float32)
    mask = weights = None
    if use_mask:
        mask = (rng.random(N) > 0.3).astype(np.float32)
    if use_weights:
        weights = rng.random(C).astype(np.float32) + 0.5
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = jlosses.get(name)(j(labels), j(preout), jact.get(act), j(mask),
                             j(weights))
    got = tlosses.get(name)(t(labels), t(preout), tact.get(act), t(mask),
                            t(weights))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_all_masked_scores_zero_not_nan():
    labels = torch.eye(C)[:3]
    got = tlosses.get("mcxent").score(labels, torch.zeros(3, C),
                                      tact.get("softmax"), torch.zeros(3))
    assert float(got) == 0.0


def test_unknown_loss_is_refused_by_name():
    with pytest.raises(ValueError, match="bogus"):
        tlosses.get("bogus")
    inst = tlosses.get("mse")
    assert tlosses.get(inst) is inst and tlosses.get("MSE") is inst
