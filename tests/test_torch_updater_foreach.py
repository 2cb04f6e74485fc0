"""The in-place multi-tensor update (``apply_layer_updates``) against the
per-tensor path it replaced (``apply_layer_updates_plain``), bit for bit,
for every updater x schedule x gradient-normalization mode; and against
the JAX package's ``apply_layer_updates``.

Three layers share one updater config and a fourth has a base rate of
its own, so the update runs as two groups; one layer's gradients come in
bf16 (what the LSTM backward hands back under BF16). Three updates in a
row carry the state. The JAX comparison uses test_torch_updater.py's
tolerance (1e-6 relative, 1e-7 absolute: the same f32 operations, where
XLA and PyTorch may differ in the last bit of a pow, sqrt or sum).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import updater as jupd
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JPolicy
from deeplearning4j_tpu.nn.conf.core import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu_torch.nn import updater as tupd
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy as TPolicy
from deeplearning4j_tpu_torch.nn.conf.core import NeuralNetConfiguration as TNNC

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
SCHEDULES = {
    "none": {}, "exponential": dict(decay_rate=0.97),
    "inverse": dict(gamma=0.01, power=0.75),
    "poly": dict(power=2.0, max_iter=50),
    "sigmoid": dict(gamma=0.1, steps=20),
    "step": dict(decay_rate=0.5, steps=2),
    "map": dict(schedule={0: 0.3, 1: 0.2, 30: 0.05}),
}
MODES = [None, "renormalize_l2_per_layer", "renormalize_l2_per_param_type",
         "clip_element_wise_absolute_value", "clip_l2_per_layer",
         "clip_l2_per_param_type"]
SHAPES = {"layer_0": {"W": (6, 5), "b": (5,)},
          "layer_1": {"W": (5, 7), "b": (7,), "p": (3, 7)},
          "layer_2": {"W": (7, 3), "b": (3,)},
          "layer_3": {"W": (3, 2)}}
OWN_LR = {"layer_3": 0.03}   # a group of its own
BF16_GRADS = "layer_1"


def _layer(name, updater, mode):
    conf = SimpleNamespace(learning_rate=OWN_LR.get(name), updater=updater,
                           gradient_normalization=mode,
                           gradient_normalization_threshold=0.5)
    return SimpleNamespace(
        name=name, conf=conf,
        resolve=lambda k, d=None: getattr(conf, k, None) or d)


def _arrays(seed, scale):
    rng = np.random.default_rng(seed)
    return {ln: {k: (scale * rng.normal(0, 1, sh)).astype(np.float32)
                 for k, sh in sub.items()} for ln, sub in SHAPES.items()}


def _torch_grads(arrays):
    out = {}
    for ln, sub in arrays.items():
        out[ln] = {k: torch.from_numpy(v.copy()) for k, v in sub.items()}
        if ln == BF16_GRADS:
            out[ln] = {k: v.to(torch.bfloat16) for k, v in out[ln].items()}
    return out


def _state(kind, mode, sched, module, nnc, policy):
    upd = module._UPDATERS[kind](**UPDATERS[kind])
    layers = [_layer(n, upd, mode) for n in SHAPES]
    gc = nnc(learning_rate=0.02,
             lr_schedule=module._SCHEDULES[sched](**SCHEDULES[sched]),
             dtype=policy(compute_dtype="bfloat16"))
    return upd, layers, gc


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
        return
    assert a.dtype == b.dtype and torch.equal(a, b), (a, b)


@pytest.mark.parametrize("mode", MODES, ids=[str(m) for m in MODES])
@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("kind", sorted(UPDATERS))
def test_multi_tensor_update_is_the_per_tensor_path_bit_for_bit(kind, sched,
                                                                mode):
    upd, layers, gc = _state(kind, mode, sched, tupd, TNNC, TPolicy)
    params = _arrays(0, 1.0)
    fast_p = {ln: {k: torch.from_numpy(v.copy()) for k, v in sub.items()}
              for ln, sub in params.items()}
    plain_p = tupd._copy_tree(fast_p)
    fast_o = {ln: upd.init_state(fast_p[ln]) for ln in SHAPES}
    fast_o["_loss_scale"] = "untouched"
    plain_o = {ln: upd.init_state(plain_p[ln]) for ln in SHAPES}
    storage = {ln: [t.data_ptr() for t in tupd._leaves(fast_o[ln])]
               for ln in SHAPES}
    for it in range(3):
        g = _arrays(it + 1, 1e-2)
        grads_fast, grads_plain = _torch_grads(g), _torch_grads(g)
        # the device-iteration form of ``it`` on the fast path
        tupd.apply_layer_updates(layers, gc, fast_p, grads_fast, fast_o,
                                 torch.tensor(it, dtype=torch.int32), 0.5)
        tupd.apply_layer_updates_plain(layers, gc, plain_p, grads_plain,
                                       plain_o, it, 0.5)
        _equal_trees(grads_fast, _torch_grads(g))   # gradients left alone
    _equal_trees(fast_p, plain_p)
    _equal_trees({ln: fast_o[ln] for ln in SHAPES}, plain_o)
    assert fast_o["_loss_scale"] == "untouched"
    for ln in SHAPES:   # every slot written where it was
        assert [t.data_ptr() for t in tupd._leaves(fast_o[ln])] == storage[ln]


@pytest.mark.parametrize("mode", [None, "clip_l2_per_layer",
                                  "renormalize_l2_per_param_type"])
@pytest.mark.parametrize("kind", sorted(UPDATERS))
def test_multi_tensor_update_matches_jax(kind, mode):
    sched = "exponential"
    upd, layers, gc = _state(kind, mode, sched, tupd, TNNC, TPolicy)
    jup, jlayers, jgc = _state(kind, mode, sched, jupd, JNNC, JPolicy)
    params = _arrays(0, 1.0)
    tp = {ln: {k: torch.from_numpy(v.copy()) for k, v in sub.items()}
          for ln, sub in params.items()}
    jp = {ln: {k: jnp.asarray(v) for k, v in sub.items()}
          for ln, sub in params.items()}
    to = {ln: upd.init_state(tp[ln]) for ln in SHAPES}
    jo = {ln: jup.init_state(jp[ln]) for ln in SHAPES}
    for it in range(3):
        g = _arrays(it + 1, 1e-2)
        jg = {ln: {k: jnp.asarray(v, jnp.bfloat16 if ln == BF16_GRADS
                                  else jnp.float32)
                   for k, v in sub.items()} for ln, sub in g.items()}
        jp, jo = jupd.apply_layer_updates(jlayers, jgc, jp, jg, jo,
                                          jnp.asarray(it, jnp.int32), 0.5)
        tupd.apply_layer_updates(layers, gc, tp, _torch_grads(g), to,
                                 torch.tensor(it, dtype=torch.int32), 0.5)
    for tree_t, tree_j in ((tp, jp), (to, jo)):
        for a, b in zip(tupd._leaves(tree_t), _jleaves(tree_j)):
            w = np.asarray(b)
            assert a.numpy().dtype == w.dtype
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-6, atol=1e-7)


def _jleaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jleaves(tree[k])
    else:
        yield tree


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_schedule_from_a_device_iteration_equals_the_int_one(sched):
    """The schedule read from an int32 tensor (the net's device twin of
    its iteration) equals the one read from the Python int, bit for bit,
    and lies on the tensor's device."""
    s = tupd._SCHEDULES[sched](**SCHEDULES[sched])
    for step in (0, 1, 2, 6, 7, 25, 49, 80):
        for dtype in (torch.float32, torch.float64):
            want = s(0.1, step, dtype=dtype)
            got = s(0.1, torch.tensor(step, dtype=torch.int32), dtype=dtype)
            assert got.dtype == want.dtype == dtype
            assert got.device == want.device and torch.equal(got, want)
