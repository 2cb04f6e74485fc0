"""The char-RNN slice end to end on the CPU: a model built and written by
the JAX package, restored in the port (deeplearning4j_tpu_torch), gives the
same ``output``, ``feed_forward`` and ``rnn_time_step``; configurations
round-trip to the same JSON; a zip the port writes restores in the JAX
package with the same outputs.

Tolerances: f32 1e-5 abs and rel (same arithmetic, other summation
order). BF16 policy: both packages compute in bf16 and may round a bf16
intermediate (the input projection, h before each product, the logits)
the other way. On the bf16 hidden activations (|y| <= 1) that is 1.6e-2
abs and rel, two bf16 ulps (2 * 2**-7). On the f32 softmax outputs it is
2e-3 abs: two ulps on a logit of magnitude < 4 (2 * 2**-5) move a
probability p by at most p/16, and p < 0.03 for these random-weight
models over an 80-letter vocabulary.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers_recurrent import (
    GravesBidirectionalLSTM as JBiLSTM, GravesLSTM as JLSTM,
    LastTimeStep as JLast, RnnOutput as JRnnOutput)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf.core import (
    MultiLayerConfiguration as TMLC)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.utils import serialization as tser

V, H, T = 80, 128, 8
F32_TOL = 1e-5
BF16_ACT_TOL = 1.6e-2
BF16_PROB_TOL = 2e-3


def _one_hot(b, t, seed, v=V):
    rng = np.random.default_rng(seed)
    return np.eye(v, dtype=np.float32)[rng.integers(0, v, (b, t))]


def _mask(b, t, seed):
    rng = np.random.default_rng(seed)
    m = np.ones((b, t), np.float32)
    lengths = rng.integers(1, t + 1, b)
    for i, L in enumerate(lengths):
        m[i, L:] = 0.0
    return m


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _transplant(jnet, tmp_path):
    path = tmp_path / "model.zip"
    jser.write_model(jnet, str(path))
    return tser.restore_multi_layer_network(str(path), device="cpu")


@pytest.fixture(params=["F32", "BF16"])
def policy(request, monkeypatch):
    """F32, and BF16 with the Pallas kernel in interpret mode, so the JAX
    side runs the numerics the port follows (b = 16 passes its gate)."""
    if request.param == "BF16":
        monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    if request.param == "F32":
        return jzoo.models.F32, F32_TOL, F32_TOL
    return jzoo.models.BF16, BF16_PROB_TOL, BF16_ACT_TOL


@pytest.mark.parametrize("masked", [False, True])
def test_output_matches_jax(policy, masked, tmp_path):
    pol, tol, _ = policy
    jnet = jzoo.char_rnn(vocab_size=V, hidden=H, n_layers=2, dtype=pol)
    tnet = _transplant(jnet, tmp_path)
    x = _one_hot(16, T, seed=1)
    m = _mask(16, T, seed=2) if masked else None
    want = _np(jnet.output(x, mask=m))
    got = tnet.output(x, mask=m)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)


def test_feed_forward_matches_jax(policy, tmp_path):
    pol, out_tol, act_tol = policy
    jnet = jzoo.char_rnn(vocab_size=V, hidden=H, n_layers=2, dtype=pol)
    tnet = _transplant(jnet, tmp_path)
    x = _one_hot(16, T, seed=3)
    want = jnet.feed_forward(x)
    got = tnet.feed_forward(x)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        tol = out_tol if i == 2 else act_tol
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol)


def test_rnn_time_step_matches_one_shot_and_jax(policy, tmp_path):
    """Step by step equals one shot (bf16 rounds the carry between calls,
    hence the bf16 tolerance), and equals the JAX package's streaming."""
    pol, tol, _ = policy
    jnet = jzoo.char_rnn(vocab_size=V, hidden=H, n_layers=2, dtype=pol)
    tnet = _transplant(jnet, tmp_path)
    x = _one_hot(16, T, seed=4)
    one_shot = _np(tnet.output(x))
    steps = [_np(tnet.rnn_time_step(x[:, t, :])) for t in range(T)]
    np.testing.assert_allclose(np.stack(steps, 1), one_shot, atol=tol,
                               rtol=tol)
    jsteps = [_np(jnet.rnn_time_step(x[:, t, :])) for t in range(T)]
    np.testing.assert_allclose(np.stack(steps, 1), np.stack(jsteps, 1),
                               atol=tol, rtol=tol)
    tnet.rnn_clear_previous_state()
    np.testing.assert_allclose(_np(tnet.rnn_time_step(x[:, :3])),
                               one_shot[:, :3], atol=tol, rtol=tol)


def test_port_written_zip_restores_in_jax(policy, tmp_path):
    pol, tol, _ = policy
    tnet = tzoo.char_rnn(vocab_size=V, hidden=H, n_layers=2, seed=7,
                         dtype=getattr(tzoo, "F32" if pol.compute_dtype ==
                                       "float32" else "BF16"),
                         device="cpu")
    path = tmp_path / "port.zip"
    tser.write_model(tnet, str(path))
    jnet = jser.restore_multi_layer_network(str(path))
    assert jnet.conf.to_json() == tnet.conf.to_json()
    x = _one_hot(16, T, seed=5)
    np.testing.assert_allclose(_np(tnet.output(x)), _np(jnet.output(x)),
                               atol=tol, rtol=tol)
    back = tser.restore_multi_layer_network(str(path), device="cpu")
    for name, layer in tnet.params.items():
        for k, v in layer.items():
            assert torch.equal(back.params[name][k], v)


def _recurrent_confs():
    base = JNNC.builder().seed(3).dtype(jzoo.models.F32)
    return {
        "char_rnn_bf16": (JNNC.builder().seed(42)
                          .updater(JAdam(2e-3)).dtype(jzoo.models.BF16)
                          .list()
                          .layer(JLSTM(n_out=32, activation="tanh"))
                          .layer(JLSTM(n_out=32, activation="tanh"))
                          .layer(JRnnOutput(n_out=V, activation="softmax"))
                          .set_input_type(JInputType.recurrent(V))
                          .build()),
        "bidirectional": (base.list()
                          .layer(JBiLSTM(n_out=24, activation="tanh"))
                          .layer(JRnnOutput(n_out=7, activation="softmax"))
                          .set_input_type(JInputType.recurrent(11))
                          .build()),
        "last_time_step": (JNNC.builder().seed(5).activation("softsign")
                           .weight_init("xavier_uniform").list()
                           .layer(JLSTM(n_out=16, gate_activation="hardsigmoid",
                                        forget_gate_bias_init=0.5))
                           .layer(JLast())
                           .set_input_type(JInputType.recurrent(9, 6))
                           .build()),
    }


@pytest.mark.parametrize("name", ["bidirectional", "char_rnn_bf16",
                                  "last_time_step"])
def test_configuration_json_round_trip(name):
    conf = _recurrent_confs()[name]
    s = conf.to_json()
    tconf = TMLC.from_json(s)
    assert tconf.to_json() == s
    assert JMLC.from_json(tconf.to_json()) == conf


@pytest.mark.parametrize("name", ["bidirectional", "last_time_step"])
def test_other_recurrent_layers_match_jax(name, tmp_path):
    """The bidirectional LSTM (kernel reused on the flipped input) and the
    mask-aware last-time-step layer, F32, masked."""
    conf = _recurrent_confs()[name]
    jnet = JMLN(conf).init()
    tnet = _transplant(jnet, tmp_path)
    n_in = conf.input_type.size
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (5, 6, n_in)).astype(np.float32)
    m = _mask(5, 6, seed=7)
    np.testing.assert_allclose(_np(tnet.output(x, mask=m)),
                               _np(jnet.output(x, mask=m)),
                               atol=F32_TOL, rtol=F32_TOL)


def test_unported_layer_type_is_refused_by_name():
    conf = jzoo.mnist_mlp().conf
    with pytest.raises(NotImplementedError, match="'dense'"):
        TMLC.from_json(conf.to_json())


def test_params_from_numpy_keeps_jax_layouts(tmp_path):
    jnet = jzoo.char_rnn(vocab_size=V, hidden=32, n_layers=1,
                         dtype=jzoo.models.F32)
    tree = {k: {n: np.asarray(a) for n, a in v.items()}
            for k, v in jnet.params.items()}
    params = tser.params_from_numpy(tree)
    assert tuple(params["layer_0"]["Wx"].shape) == (V, 128)
    assert tuple(params["layer_0"]["Wh"].shape) == (32, 128)
    assert tuple(params["layer_0"]["p"].shape) == (3, 32)
    assert tuple(params["layer_1"]["W"].shape) == (32, V)
    tnet = TMLN(tzoo.char_rnn(vocab_size=V, hidden=32, n_layers=1,
                              dtype=tzoo.F32, device="cpu").conf,
                device="cpu").init()
    tnet.params = params
    x = _one_hot(3, 4, seed=8)
    np.testing.assert_allclose(_np(tnet.output(x)), _np(jnet.output(x)),
                               atol=F32_TOL, rtol=F32_TOL)


def test_zoo_char_rnn_matches_jax_configuration():
    for pol in ("F32", "BF16"):
        j = jzoo.char_rnn(dtype=getattr(jzoo.models, pol)).conf
        t = tzoo.char_rnn(dtype=getattr(tzoo, pol), device="cpu")
        assert t.conf.to_json() == j.to_json()
        assert t.num_params() == JMLN(j).init(
            structure_only=True).num_params()


def test_init_draws_match_jax_moments():
    """Only the distributions match (jax.random bits are not reproduced):
    xavier std, forget-gate bias, zero peepholes."""
    t = tzoo.char_rnn(device="cpu", seed=11)
    p0 = t.params["layer_0"]
    std = float(p0["Wh"].std())
    assert abs(std - np.sqrt(2.0 / (512 + 512))) < 2e-3
    n = 512
    assert torch.all(p0["b"][n:2 * n] == 1.0)
    assert torch.all(p0["b"][:n] == 0.0) and torch.all(p0["p"] == 0.0)
    again = tzoo.char_rnn(device="cpu", seed=11)
    assert torch.equal(again.params["layer_0"]["Wx"], p0["Wx"])
    assert dataclasses.asdict(t.conf.global_conf.dtype)[
        "compute_dtype"] == "bfloat16"
