"""The port's small pure modules against the JAX package's: activations
(f32, 1e-6: the same formula in another library), initializers (moments
and bounds only: jax.random's bits are not reproduced), updater and
schedule configs (the same dicts), DtypePolicy validation, and
``ops/sequence.py::last_unmasked_step`` (exact: an index gather).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import updater as jupd
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JPolicy
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import initializers as jinit
from deeplearning4j_tpu_torch.nn import updater as tupd
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy as TPolicy
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import initializers as tinit

ACTIVATIONS = ["cube", "elu", "gelu", "hardsigmoid", "hardtanh", "identity",
               "leakyrelu", "logsoftmax", "rationaltanh", "rectifiedtanh",
               "relu", "rrelu", "selu", "sigmoid", "softmax", "softplus",
               "softsign", "swish", "tanh", "thresholdedrelu"]
INITS = ["normal", "ones", "relu", "relu_uniform", "sigmoid_uniform",
         "uniform", "xavier", "xavier_fan_in", "xavier_legacy",
         "xavier_uniform", "zero"]


def test_registries_cover_the_jax_names():
    assert sorted(jact._REGISTRY) == sorted(tact._REGISTRY) == ACTIVATIONS
    assert sorted(jinit._REGISTRY) == sorted(tinit._REGISTRY) == INITS
    assert sorted(jupd._UPDATERS) == sorted(tupd._UPDATERS)
    assert sorted(jupd._SCHEDULES) == sorted(tupd._SCHEDULES)


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_matches_jax(name):
    x = np.random.default_rng(0).normal(0, 2, (4, 7)).astype(np.float32)
    x[0, :3] = [0.0, 1.0, -1.0]
    want = np.asarray(jact.get(name)(jnp.asarray(x, jnp.float32)))
    got = tact.get(name.upper())(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _draw_both(spec, shape=(300, 400), fan_in=300, fan_out=400):
    want = np.asarray(jinit.resolve(spec)(jax.random.PRNGKey(0), shape,
                                          fan_in, fan_out, jnp.float32))
    gen = torch.Generator().manual_seed(0)
    got = tinit.resolve(spec)(gen, shape, fan_in, fan_out).numpy()
    return got, want


@pytest.mark.parametrize("spec", INITS + [
    {"type": "normal", "mean": 0.5, "std": 0.01},
    {"type": "uniform", "lower": -0.2, "upper": 0.6},
    {"type": "binomial", "trials": 3, "probability": 0.25}],
    ids=lambda s: s if isinstance(s, str) else s["type"])
def test_initializer_moments_and_bounds_match_jax(spec):
    got, want = _draw_both(spec)
    assert got.shape == want.shape and got.dtype == np.float32
    scale = max(float(want.std()), 1e-3)
    assert abs(got.mean() - want.mean()) < 0.02 * scale + 1e-7
    np.testing.assert_allclose(got.std(), want.std(), rtol=0.02, atol=1e-7)
    if "uniform" in str(spec) or spec in ("zero", "ones"):
        rng = max(float(want.max() - want.min()), 1e-7)
        assert abs(got.min() - want.min()) < 0.01 * rng + 1e-7
        assert abs(got.max() - want.max()) < 0.01 * rng + 1e-7


def test_initializer_is_reproducible_from_its_generator():
    a = tinit.xavier(torch.Generator().manual_seed(5), (6, 7), 6, 7)
    b = tinit.xavier(torch.Generator().manual_seed(5), (6, 7), 6, 7)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["adadelta", "adagrad", "adam", "adamax",
                                  "nesterovs", "noop", "rmsprop", "sgd"])
def test_updater_config_round_trips_with_jax(kind):
    j = jupd._UPDATERS[kind]()
    d = j.to_dict()
    t = tupd.updater_from_dict(d)
    assert t.to_dict() == d
    assert jupd.updater_from_dict(t.to_dict()) == j


@pytest.mark.parametrize("kind", ["exponential", "inverse", "map", "none",
                                  "poly", "sigmoid", "step"])
def test_schedule_config_round_trips_with_jax(kind):
    j = (jupd.MapSchedule({0: 0.1, 100: 0.01}) if kind == "map"
         else jupd._SCHEDULES[kind]())
    d = j.to_dict()
    t = tupd.schedule_from_dict(d)
    assert t.to_dict() == d
    assert jupd.schedule_from_dict(t.to_dict()) == j


@pytest.mark.parametrize("kw", [
    {"compute_dtype": "f32"}, {"param_dtype": "float8"},
    {"overrides": (("(", "float32"),)}, {"overrides": (("x", "f16"),)},
    {"loss_scale": "sometimes"}, {"loss_scale": -1.0},
    {"loss_scale_factor": 1.0}, {"loss_scale_growth_interval": 0}])
def test_dtype_policy_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        JPolicy(**kw)
    with pytest.raises(ValueError):
        TPolicy(**kw)


def test_dtype_policy_overrides_resolve_like_jax():
    kw = dict(compute_dtype="bfloat16",
              overrides=(("^layer_1$", "float32"), ("layer", "float16")))
    j, t = JPolicy(**kw), TPolicy(**kw)
    for path in ("layer_0", "layer_1", "head", None):
        assert t.compute_dtype_for(path) == j.compute_dtype_for(path)
    assert t.to_dict() == j.to_dict()


# (name, [b, t] mask or None): prefix padding, end-aligned padding, a gap
# inside the sequence, an all-masked row, and no mask
LAST_STEP_MASKS = [
    ("none", None),
    ("prefix", [[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]]),
    ("align_end", [[0, 0, 1, 1, 1], [0, 0, 0, 0, 1], [1, 1, 1, 1, 1]]),
    ("gapped", [[1, 0, 1, 0, 0], [1, 1, 0, 1, 0], [0, 1, 0, 0, 1]]),
    ("all_masked_row", [[1, 1, 0, 0, 0], [0, 0, 0, 0, 0], [0, 1, 1, 0, 0]]),
]


@pytest.mark.parametrize("name,mask", LAST_STEP_MASKS,
                         ids=[m[0] for m in LAST_STEP_MASKS])
def test_last_time_step_layer_matches_jax(name, mask):
    """``LastTimeStepLayer`` takes ``last_unmasked_step`` from
    ops/sequence.py (moved there from nn/layers/recurrent.py): the same
    rows as the JAX package's function and as a plain loop (the last
    nonzero mask entry; step 0 for an all-masked row)."""
    from deeplearning4j_tpu.ops.sequence import last_unmasked_step as jlast
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.core import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import (
        LastTimeStep)
    from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
    from deeplearning4j_tpu_torch.ops import sequence as tseq

    assert trec.last_unmasked_step is tseq.last_unmasked_step
    x = np.random.default_rng(1).normal(size=(3, 5, 4)).astype(np.float32)
    m = None if mask is None else np.asarray(mask, np.float32)
    it = InputType.recurrent(4)
    layer = LastTimeStep().with_n_in(it).make_layer(
        it, NeuralNetConfiguration(), TPolicy())
    got, _ = layer.apply({}, {}, torch.from_numpy(x),
                         mask=None if m is None else torch.from_numpy(m))
    want = np.asarray(jlast(jnp.asarray(x),
                            None if m is None else jnp.asarray(m)))
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(3):
        if m is None:
            step = 4
        else:
            nz = np.flatnonzero(m[i])
            step = int(nz[-1]) if nz.size else 0
        np.testing.assert_array_equal(got[i].numpy(), x[i, step])
    assert layer.feed_forward_mask(m) is None
