"""VGG-16's backward pass and training steps in the port (zoo.vgg16
through MultiLayerNetwork) against the JAX package, on the CPU.

- Under F64, at 32 x 32 x 3 and 7 classes: the gradients at the initial
  weights and the parameters after three Nesterov steps, held tightly
  (both packages compute the same function; see the test).
- Under F32, at 64 x 64 x 3 with the published 1000 classes, on b = 8
  batches of 0-255 RGB noise around a per-class colour through
  vgg16_preprocess, made from a seed with numpy:
  - at the zoo's Nesterovs(0.01, 0.9) this xavier-initialised net
    without batch norm diverges on such images, in the JAX package as in
    the port: the score of both passes 100 at the same step (ln 1000 =
    6.9 at the start) and is NaN by the ninth;
  - at Nesterovs(1e-3, 0.9) both lower the score and stay finite.

Each JAX net is carried to the port through the zip with its updater;
F32 and F64 are set explicitly (tests/conftest.py turns on JAX's x64).

F32 tolerances: the parameters after the first update 1e-4 of each
tensor's largest magnitude plus 1e-6 (the same f32 arithmetic, sums in
another order through 13 convolutions); the first three scores 1e-4
relative. The F32 gradients are not held to each other: PyTorch's CPU
convolutions round differently from XLA's, and at these weights that
moves the winner of a 2 x 2 max-pool window after the 12th layer; such a
switch moves the gradients below it by a finite amount
(tests/test_torch_graph.py::
test_f64_gradients_jump_under_a_tiny_input_change).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.datasets import DataSet as JDS
from deeplearning4j_tpu.nn.updater import Nesterovs as JNesterovs
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.datasets import DataSet as TDS
from deeplearning4j_tpu_torch.nn import precision as tprec
from deeplearning4j_tpu_torch.nn.updater import _leaves, _map
from deeplearning4j_tpu_torch.utils import serialization as tser

SIZE, CLASSES, B = 64, 1000, 8


def _batches(seed, n=2):
    rng = np.random.default_rng(seed)
    colour = rng.uniform(0, 255, (CLASSES, 3))
    out = []
    for _ in range(n):
        lab = rng.integers(0, CLASSES, B)
        img = np.clip(colour[lab][:, None, None, :]
                      + 40 * rng.normal(size=(B, SIZE, SIZE, 3)), 0, 255)
        out.append((tzoo.vgg16_preprocess(img),
                    np.eye(CLASSES, dtype=np.float32)[lab]))
    return out


def _max_close(got, want, what, rel=1e-4, floor=1e-6):
    got = got.detach().double().numpy()
    want = np.asarray(want, dtype=np.float64)
    err = float(np.abs(got - want).max())
    tol = rel * float(np.abs(want).max()) + floor
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


def _pair(tmp_path, lr):
    jnet = jzoo.vgg16(image_size=SIZE, n_classes=CLASSES, dtype=jzoo.F32,
                      updater=JNesterovs(lr, 0.9))
    path = tmp_path / "vgg16.zip"
    jser.write_model(jnet, str(path))
    return jnet, tser.restore_multi_layer_network(str(path), device="cpu")


def test_vgg16_f64_gradients_and_steps_match_jax(tmp_path):
    """Under F64 both packages compute the same function, so VGG-16's
    backward pass through 13 convolutions and 5 max-pools and its
    Nesterov updates are held tightly: vgg16(image_size=32, n_classes=7)
    at b = 2, gradients at the initial weights 1e-10 of each gradient's
    largest magnitude, parameters after 3 steps 1e-9 of each tensor's
    largest magnitude (f64 sums in another order)."""
    from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
    jnet = jzoo.vgg16(image_size=32, n_classes=7, dtype=JDtypePolicy(
        param_dtype="float64", compute_dtype="float64"))
    path = tmp_path / "vgg16_f64.zip"
    jser.write_model(jnet, str(path))
    tnet = tser.restore_multi_layer_network(str(path), device="cpu")
    assert tnet.conf.to_json() == jnet.conf.to_json()
    rng = np.random.default_rng(5)
    data = [(tzoo.vgg16_preprocess(rng.uniform(0, 255, (2, 32, 32, 3)))
             .astype(np.float64), np.eye(7)[rng.integers(0, 7, 2)])
            for _ in range(3)]
    x, y = data[0]
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jnet._loss(
        p, jnet.state, jnp.asarray(x), jnp.asarray(y), None, None, None,
        train=True)[0]))(jnet.params)
    leaves = _map(lambda p: p.detach().requires_grad_(), tnet.params)
    tl, _ = tnet._loss(leaves, tnet.state, torch.from_numpy(x),
                       torch.from_numpy(y))
    tg = tprec._fill(leaves, iter(torch.autograd.grad(
        tl, list(_leaves(leaves)))))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-12 * abs(float(jl))
    assert sum(len(lp) for lp in tg.values()) == 32
    for ln, lp in tg.items():
        for k, g in lp.items():
            _max_close(g, jg[ln][k], f"grad {ln}.{k}", 1e-10, 0.0)
    for step, (x, y) in enumerate(data):
        js = float(jnet.fit_batch(JDS(x, y)))
        ts = float(tnet.fit_batch(TDS(x, y)))
        assert abs(ts - js) <= 1e-12 * abs(js), (step, ts, js)
    for ln, lp in tnet.params.items():
        for k, t in lp.items():
            assert t.dtype == torch.float64
            _max_close(t, jnet.params[ln][k], f"param {ln}.{k}", 1e-9, 0.0)


@pytest.mark.parametrize("lr", [0.01, 1e-3], ids=["zoo_rate", "lower_rate"])
def test_vgg16_steps_match_jax(tmp_path, lr):
    jnet, tnet = _pair(tmp_path, lr)
    upd = tnet.layers[0].resolve("updater")
    assert (upd.kind, upd.learning_rate, upd.momentum) == \
        ("nesterovs", lr, 0.9)
    data = _batches(3)
    js, ts = [], []
    for step in range(9 if lr == 0.01 else 12):
        x, y = data[step % 2]
        js.append(float(jnet.fit_batch(JDS(x, y))))
        ts.append(float(tnet.fit_batch(TDS(x, y))))
        if step == 0:
            for ln, lp in tnet.params.items():
                for k, t in lp.items():
                    _max_close(t, jnet.params[ln][k], f"param {ln}.{k}")
    for step in range(3):
        assert abs(ts[step] - js[step]) <= 1e-4 * abs(js[step]), \
            (step, ts, js)
    if lr == 0.01:
        first_over = [next(i for i, s in enumerate(sc) if not s <= 100)
                      for sc in (js, ts)]
        assert first_over[0] == first_over[1], (js, ts)
        assert np.isnan(js[-1]) and np.isnan(ts[-1]), (js, ts)
    else:
        for sc in (js, ts):
            assert all(np.isfinite(sc)), sc
            assert np.mean(sc[-5:]) < sc[0], sc
