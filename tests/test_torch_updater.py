"""The port's updaters, schedules, gradient normalization, per-layer update
and loss-scale transition (deeplearning4j_tpu_torch/nn/{updater,precision}.py)
against the JAX package's, on the same f32 gradients.

Tolerance: 1e-6 relative and 1e-7 absolute for the update rules, the
schedules and the normalizations: the same f32 operations in the same
order, where XLA and PyTorch may differ in the last bit of a pow, sqrt or
sum. The loss-scale transition is exact.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import precision as jprec
from deeplearning4j_tpu.nn import updater as jupd
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JPolicy
from deeplearning4j_tpu.nn.conf.core import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu_torch.nn import precision as tprec
from deeplearning4j_tpu_torch.nn import updater as tupd
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy as TPolicy
from deeplearning4j_tpu_torch.nn.conf.core import NeuralNetConfiguration as TNNC

TOL = dict(rtol=1e-6, atol=1e-7)


def _grads(seed, scale=1e-2):
    rng = np.random.default_rng(seed)
    return {"W": (scale * rng.normal(0, 1, (6, 5))).astype(np.float32),
            "b": (scale * rng.normal(0, 1, (5,))).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _close(got[k], want[k])
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_allclose(g, w, **TOL)


UPDATERS = {
    "sgd": dict(learning_rate=0.1),
    "nesterovs": dict(learning_rate=0.1, momentum=0.9),
    "adam": dict(learning_rate=2e-3),
    "adamax": dict(learning_rate=2e-3),
    "adagrad": dict(learning_rate=0.1),
    "adadelta": dict(),
    "rmsprop": dict(learning_rate=0.05),
    "noop": dict(),
}


@pytest.mark.parametrize("kind", sorted(UPDATERS))
def test_update_rule_matches_jax(kind):
    """Three updates in a row (state carried) on the same gradients."""
    jcls, tcls = jupd._UPDATERS[kind], tupd._UPDATERS[kind]
    ju, tu = jcls(**UPDATERS[kind]), tcls(**UPDATERS[kind])
    assert ju.to_dict() == tu.to_dict()
    params = _grads(0, scale=1.0)
    js, ts = ju.init_state(_j(params)), tu.init_state(_t(params))
    for step in range(3):
        g = _grads(step + 1)
        lr = 0.5 * (step + 1) * UPDATERS[kind].get("learning_rate", 1.0)
        jd, js = ju.update(_j(g), js, jnp.asarray(lr, jnp.float32))
        td, ts = tu.update(_t(g), ts, torch.tensor(lr, dtype=torch.float32))
        _close(td, jd)
        _close(ts, js)


SCHEDULES = [
    ("none", {}), ("exponential", dict(decay_rate=0.97)),
    ("inverse", dict(gamma=0.01, power=0.75)),
    ("poly", dict(power=2.0, max_iter=50)),
    ("sigmoid", dict(gamma=0.1, steps=20)),
    ("step", dict(decay_rate=0.5, steps=7)),
    ("map", dict(schedule={0: 0.3, 5: 0.2, 30: 0.05})),
]


@pytest.mark.parametrize("kind,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax(kind, kw):
    js, ts = jupd._SCHEDULES[kind](**kw), tupd._SCHEDULES[kind](**kw)
    assert js.to_dict() == ts.to_dict()
    for step in (0, 1, 6, 7, 25, 49, 80):
        want = js(0.1, jnp.asarray(step, jnp.int32), dtype=jnp.float32)
        got = ts(0.1, step, dtype=torch.float32)
        assert got.dtype == torch.float32 and got.dim() == 0
        _close(got, want)


MODES = [None, "renormalize_l2_per_layer", "renormalize_l2_per_param_type",
         "clip_element_wise_absolute_value", "clip_l2_per_layer",
         "clip_l2_per_param_type"]


@pytest.mark.parametrize("threshold", [0.005, 10.0])
@pytest.mark.parametrize("mode", MODES, ids=[str(m) for m in MODES])
def test_normalize_gradients_matches_jax(mode, threshold):
    g = _grads(7)
    _close(tupd.normalize_gradients(_t(g), mode, threshold),
           jupd.normalize_gradients(_j(g), mode, threshold))


def test_normalize_gradients_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="bogus"):
        tupd.normalize_gradients(_t(_grads(8)), "bogus")


def _layer(updater, mode=None, lr=None):
    """A stand-in for a runtime layer: what apply_layer_updates reads."""
    conf = SimpleNamespace(learning_rate=lr, updater=updater,
                           gradient_normalization=mode,
                           gradient_normalization_threshold=0.5)
    return SimpleNamespace(
        name="layer_0", conf=conf,
        resolve=lambda k, d=None: getattr(conf, k, None) or d)


@pytest.mark.parametrize("mode", [None, "clip_l2_per_layer"])
def test_apply_layer_updates_upcasts_bf16_grads_and_updates_in_place(mode):
    """A bf16 gradient (what the LSTM backward hands back under BF16)
    against f32 master params: the rule runs in f32, the params are
    updated in place, and the result is the JAX package's."""
    jgc = JNNC(learning_rate=0.02, lr_schedule=jupd.Exponential(0.9),
               dtype=JPolicy(compute_dtype="bfloat16"))
    tgc = TNNC(learning_rate=0.02, lr_schedule=tupd.Exponential(0.9),
               dtype=TPolicy(compute_dtype="bfloat16"))
    params = _grads(9, scale=1.0)
    g = {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
         for k, v in _grads(10).items()}
    jl = _layer(jupd.Adam(1e-3), mode)
    tl = _layer(tupd.Adam(1e-3), mode)
    jp = {"layer_0": _j(params)}
    jo = {"layer_0": jl.conf.updater.init_state(jp["layer_0"])}
    tp = {"layer_0": _t(params)}
    to = {"layer_0": tl.conf.updater.init_state(tp["layer_0"]),
          "_loss_scale": "untouched"}
    storage = tp["layer_0"]["W"].data_ptr()
    for it in range(2):
        jg = {"layer_0": {k: jnp.asarray(v, jnp.bfloat16)
                          for k, v in g.items()}}
        tg = {"layer_0": {k: torch.tensor(v).to(torch.bfloat16)
                          for k, v in g.items()}}
        jp, jo = jupd.apply_layer_updates([jl], jgc, jp, jg, jo,
                                          jnp.asarray(it, jnp.int32), 0.5)
        tupd.apply_layer_updates([tl], tgc, tp, tg, to, it, 0.5)
    assert tp["layer_0"]["W"].data_ptr() == storage
    assert tp["layer_0"]["W"].dtype == torch.float32
    assert to["_loss_scale"] == "untouched"
    _close(tp, jp)
    _close({"layer_0": to["layer_0"]}, jo)


SCALE_CASES = {
    # (scale, good_steps, finite, policy overrides)
    "skip_backs_off": (2.0 ** 15, 7, False, {}),
    "skip_floors_at_one": (1.0, 0, False, {}),
    "finite_counts": (2.0 ** 15, 3, True, {}),
    "regrowth_at_interval": (2.0 ** 15, 199, True, {}),
    "ceiling": (2.0 ** 24, 4, True, dict(loss_scale_growth_interval=5)),
    "static_skip": (128.0, 2, False, dict(loss_scale=128.0)),
    "static_finite": (128.0, 2, True, dict(loss_scale=128.0)),
}


@pytest.mark.parametrize("case", sorted(SCALE_CASES))
def test_loss_scale_transition_matches_jax(case):
    scale, good, finite, over = SCALE_CASES[case]
    kw = dict(param_dtype="float32", compute_dtype="float16", **over)
    jpol, tpol = JPolicy(**kw), TPolicy(**kw)
    mode = tpol.loss_scale_mode()
    assert mode == jpol.loss_scale_mode()
    want = jprec._next_scale_state(
        {"scale": jnp.asarray(scale, jnp.float32),
         "good_steps": jnp.asarray(good, jnp.int32)},
        jnp.asarray(finite), mode, jpol)
    got = tprec.next_scale_state(
        {"scale": torch.tensor(scale, dtype=torch.float32),
         "good_steps": torch.tensor(good, dtype=torch.int32)},
        torch.tensor(finite), mode, tpol)
    assert got["scale"].dtype == torch.float32
    assert got["good_steps"].dtype == torch.int32
    assert float(got["scale"]) == float(want["scale"])
    assert int(got["good_steps"]) == int(want["good_steps"])


@pytest.mark.parametrize("loss_scale,compute", [
    ("auto", "float16"), ("auto", "bfloat16"), ("none", "float16"),
    ("dynamic", "float32"), (512.0, "bfloat16")])
def test_loss_scale_mode_and_init_state_match_jax(loss_scale, compute):
    kw = dict(compute_dtype=compute, loss_scale=loss_scale)
    jpol, tpol = JPolicy(**kw), TPolicy(**kw)
    assert tpol.loss_scale_mode() == jpol.loss_scale_mode()
    assert dataclasses.asdict(tpol) == dataclasses.asdict(jpol)
    want = jprec.init_loss_scale_state(jpol)
    got = tprec.init_loss_scale_state(tpol)
    if want is None:
        assert got is None
    else:
        assert float(got["scale"]) == float(want["scale"])
        assert int(got["good_steps"]) == int(want["good_steps"])


def test_all_finite():
    g = _t(_grads(11))
    assert bool(tprec.all_finite({"a": g}))
    g["b"][2] = float("inf")
    assert not bool(tprec.all_finite({"a": g}))
    g["b"][2] = float("nan")
    assert not bool(tprec.all_finite({"a": g}))
    assert bool(tprec.all_finite({}))
