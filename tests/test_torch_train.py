"""Training the char-RNN in the port (deeplearning4j_tpu_torch) against the JAX
package, on the CPU: a model built by the JAX package and transplanted
through the zip gives the same score and gradients, the same parameters
after a few steps, the same truncated-BPTT batch, and its updater state
crosses the zip both ways. Small: vocab 80, hidden 128, 2 layers, b = 16,
T = 8.

Tolerances, each with its reason:

- Scores: f32 1e-6 relative (the same f32 log-softmax, summed in another
  order). BF16 1e-4 relative: the logits are bf16, and one logit rounding
  that lands the other way moves that row's loss by about 2**-8 * |z|
  (~1e-2) and the mean over 128 rows by ~1e-4.
- F32 gradients: 1e-5 of each gradient's largest element (the same f32
  arithmetic in another order; small elements are sums that cancel).
- BF16 gradients of weights (Wx, Wh, p, W): two bf16 ulps at the
  gradient's largest element. Both packages accumulate their products in
  f32 and round once; a bf16 rounding upstream (dz in the LSTM backward,
  the head's cotangent) can land the other way.
- BF16 gradients of biases: the JAX package's CPU lowering adds the N =
  b*T bf16 cotangent rows with bf16 partial sums, each add rounding by up
  to half an ulp of its result, while the port accumulates in f32 and
  rounds once. The bound is (N - 1) * 2**-9 * S per element, S the sum of
  the rows' magnitudes (captured from the port's own cotangents), plus
  two ulps.
- Parameters after Sgd steps: 1e-6 abs and rel (f32 parameters moved by
  lr * g with g equal to ~1e-6 relative).
- Parameters after Adam steps: 1e-5 abs. Where a first-step gradient is
  tiny (|g| <= 1e-6 * max|g| of its tensor) its sign may differ between
  the packages, and Adam's update there is ~lr whatever |g| is, so those
  elements may differ by up to 2 * lr per step.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JArrayIt
from deeplearning4j_tpu.datasets import DataSet as JDS
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers_recurrent import (
    GravesLSTM as JLSTM, RnnOutput as JRnnOutput)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam, Sgd as JSgd
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.datasets import DataSet as TDS
from deeplearning4j_tpu_torch.nn import precision as tprec
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.updater import _leaves, _map
from deeplearning4j_tpu_torch.ops import lstm as tlstm
from deeplearning4j_tpu_torch.utils import serialization as tser

V, H, T, B = 80, 128, 8, 16
LR = 2e-3


def _conf(pol, updater, tbptt=None):
    b = JNNC.builder().seed(42).updater(updater).dtype(pol).list()
    for _ in range(2):
        b = b.layer(JLSTM(n_out=H, activation="tanh"))
    b = (b.layer(JRnnOutput(n_out=V, loss="mcxent", activation="softmax"))
         .set_input_type(JInputType.recurrent(V)))
    if tbptt:
        b = b.backprop_type("tbptt", tbptt, tbptt)
    return b.build()


def _data(seed, masked=False, t=T):
    """One-hot next-symbol sequences; the mask covers features and
    labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, t + 1))
    eye = np.eye(V, dtype=np.float32)
    m = None
    if masked:
        m = np.ones((B, t), np.float32)
        for i, L in enumerate(rng.integers(1, t + 1, B)):
            m[i, L:] = 0.0
    return eye[ids[:, :-1]], eye[ids[:, 1:]], m


def _transplant(jnet, tmp_path, name="model.zip"):
    path = tmp_path / name
    jser.write_model(jnet, str(path))
    return tser.restore_multi_layer_network(str(path), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_loss_and_grads(jnet, x, y, m):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    fn = jax.jit(jax.value_and_grad(lambda p: jnet._loss(
        p, jnet.state, j(x), j(y), j(m), j(m), None, train=True)[0]))
    return fn(jnet.params)


def _port_loss_and_grads(tnet, x, y, m):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    leaves = _map(lambda p: p.detach().requires_grad_(), tnet.params)
    loss, _ = tnet._loss(leaves, tnet.state, t(x), t(y), t(m), t(m))
    flat = list(_leaves(leaves))
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), tprec._fill(leaves, iter(grads))


def _bf16_ulps(top, k):
    return k * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


@pytest.fixture(params=["F32", "BF16"])
def policy(request, monkeypatch):
    """F32, and BF16 with the Pallas kernels in interpret mode, so the JAX
    side runs the forward and backward numerics the port follows."""
    if request.param == "BF16":
        monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    return request.param


@pytest.fixture
def bias_rows(monkeypatch):
    """Capture the port's bf16 cotangent rows of every bias: dxz of each
    LSTM (through LstmSequenceFn) and the head's pre-output."""
    rows = []
    apply = tlstm.LstmSequenceFn.apply

    def lstm_apply(xz_t, *args):
        if xz_t.requires_grad:
            xz_t.register_hook(
                lambda g: rows.append(g.reshape(-1, g.shape[-1])))
        return apply(xz_t, *args)

    preout = trec.RnnOutputLayerImpl.preout

    def head_preout(self, params, x):
        z = preout(self, params, x)
        if z.requires_grad:
            z.register_hook(lambda g: rows.append(g.reshape(-1, g.shape[-1])))
        return z

    monkeypatch.setattr(tlstm.LstmSequenceFn, "apply", lstm_apply)
    monkeypatch.setattr(trec.RnnOutputLayerImpl, "preout", head_preout)
    return rows


@pytest.mark.parametrize("masked", [False, True])
def test_fit_batch_score_and_grads_match_jax(policy, masked, bias_rows,
                                             tmp_path):
    pol = getattr(jzoo.models, policy)
    jnet = jzoo.char_rnn(vocab_size=V, hidden=H, n_layers=2, dtype=pol)
    tnet = _transplant(jnet, tmp_path)
    x, y, m = _data(seed=1, masked=masked)
    jloss, jgrads = _jax_loss_and_grads(jnet, x, y, m)
    tloss, tgrads = _port_loss_and_grads(tnet, x, y, m)
    score_tol = 1e-6 if policy == "F32" else 1e-4
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=score_tol)

    # the bias rows, in the order their cotangents arrived: head, then the
    # LSTMs from the top down
    S = {"layer_2": None, "layer_1": None, "layer_0": None}
    for name, r in zip(S, bias_rows):
        S[name] = r.float().abs().sum(0).numpy()
    n_rows = B * T
    for name, layer in tgrads.items():
        for k, g in layer.items():
            assert g.dtype == torch.float32, (name, k)
            w, gn = _np(jgrads[name][k]), _np(g)
            top = float(np.abs(w).max())
            if policy == "F32":
                tol = 1e-5 * top
            elif k == "b":
                tol = ((n_rows - 1) * 2.0 ** -9 * S[name]
                       + _bf16_ulps(top, 2))
            else:
                tol = _bf16_ulps(top, 2)
            assert np.all(np.abs(gn - w) <= tol), (name, k)

    # one fit_batch in each package: the step reports the same score
    js = jnet.fit_batch(JDS(x, y, m, m))
    ts = tnet.fit_batch(TDS(x, y, m, m))
    assert ts.dtype == torch.float32 and ts.dim() == 0
    np.testing.assert_allclose(float(ts), float(js), rtol=score_tol)
    np.testing.assert_allclose(float(ts), float(tloss), rtol=1e-7)
    assert tnet.iteration == 1 and tnet.score_value is ts


def _assert_adam_params_close(tnet, jnet, first_grads, steps):
    for name, layer in tnet.params.items():
        for k, p in layer.items():
            g1 = np.abs(_np(first_grads[name][k]))
            tiny = g1 <= 1e-6 * g1.max()
            d = np.abs(_np(p) - _np(jnet.params[name][k]))
            assert np.all(d[~tiny] <= 1e-5), (name, k)
            assert np.all(d[tiny] <= 2 * LR * steps + 1e-5), (name, k)


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_params_after_three_steps_match_jax(updater, tmp_path):
    upd = JSgd(0.5) if updater == "sgd" else JAdam(LR)
    jnet = JMLN(_conf(jzoo.models.F32, upd)).init()
    tnet = _transplant(jnet, tmp_path)
    batches = [_data(seed=10 + i, masked=(i == 1)) for i in range(3)]
    _, first_grads = _jax_loss_and_grads(jnet, *batches[0])
    for x, y, m in batches:
        js = jnet.fit_batch(JDS(x, y, m, m))
        ts = tnet.fit_batch(TDS(x, y, m, m))
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    if updater == "sgd":
        for name, layer in tnet.params.items():
            for k, p in layer.items():
                np.testing.assert_allclose(_np(p), _np(jnet.params[name][k]),
                                           atol=1e-6, rtol=1e-6)
    else:
        _assert_adam_params_close(tnet, jnet, first_grads, 3)
        assert int(tnet.opt_state["layer_0"]["t"]) == 3


def test_tbptt_batch_matches_jax(tmp_path):
    """T = 8 in chunks of 4: two steps, the carry crossing between them;
    the score is the chunks' mean weighted by length."""
    jnet = JMLN(_conf(jzoo.models.F32, JAdam(LR), tbptt=4)).init()
    tnet = _transplant(jnet, tmp_path)
    assert tnet.conf.backprop_type == "tbptt"
    x, y, m = _data(seed=20, masked=True)
    _, first_grads = _jax_loss_and_grads(jnet, x[:, :4], y[:, :4], m[:, :4])
    js = jnet.fit_batch(JDS(x, y, m, m))
    ts = tnet.fit_batch(TDS(x, y, m, m))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    _assert_adam_params_close(tnet, jnet, first_grads, 2)
    assert int(tnet.opt_state["layer_1"]["t"]) == 2 and tnet.iteration == 1
    assert tnet.state == {} and not jnet.state
    assert not any(getattr(layer, "streaming", False)
                   for layer in tnet.layers)


def test_tbptt_chunks_hand_the_carry_on(tmp_path, monkeypatch):
    """The second chunk starts from the first chunk's final (h, c)."""
    jnet = JMLN(_conf(jzoo.models.F32, JSgd(0.0), tbptt=4)).init()
    tnet = _transplant(jnet, tmp_path)
    seen = []
    apply = tlstm.LstmSequenceFn.apply

    def spy(xz_t, h0, c0, *args):
        seen.append(float(h0.abs().sum()))
        return apply(xz_t, h0, c0, *args)

    monkeypatch.setattr(tlstm.LstmSequenceFn, "apply", spy)
    x, y, _ = _data(seed=21)
    tnet.fit_batch(TDS(x, y))
    assert len(seen) == 4 and seen[:2] == [0.0, 0.0]
    assert seen[2] > 0 and seen[3] > 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_updater_state_crosses_the_zip(direction, tmp_path):
    """Two steps in one package, write, restore in the other, step 3 in
    both: the same parameters and Adam state."""
    jnet = jzoo.char_rnn(vocab_size=V, hidden=H, n_layers=2,
                         dtype=jzoo.models.F32)
    tnet = _transplant(jnet, tmp_path, "start.zip")
    batches = [_data(seed=30 + i) for i in range(3)]
    _, first_grads = _jax_loss_and_grads(jnet, *batches[0])
    path = str(tmp_path / "two_steps.zip")
    if direction == "jax_to_port":
        for x, y, _ in batches[:2]:
            jnet.fit_batch(JDS(x, y))
        jser.write_model(jnet, path)
        tnet = tser.restore_multi_layer_network(path, device="cpu")
        assert tnet.iteration == 2
    else:
        for x, y, _ in batches[:2]:
            tnet.fit_batch(TDS(x, y))
        tser.write_model(tnet, path)
        jnet = jser.restore_multi_layer_network(path)
        assert jnet.iteration == 2
    assert int(tnet.opt_state["layer_2"]["t"]) == 2
    for name in tnet.params:
        for slot in ("m", "v"):
            for k, v in tnet.opt_state[name][slot].items():
                np.testing.assert_allclose(
                    _np(v), _np(jnet.opt_state[name][slot][k]), atol=1e-7,
                    rtol=1e-5)
    x, y, _ = batches[2]
    jnet.fit_batch(JDS(x, y))
    tnet.fit_batch(TDS(x, y))
    _assert_adam_params_close(tnet, jnet, first_grads, 3)
    assert int(tnet.opt_state["layer_0"]["t"]) == int(
        jnet.opt_state["layer_0"]["t"]) == 3


def test_fit_replays_the_shuffled_order_after_reset(tmp_path):
    rng = np.random.default_rng(40)
    ids = rng.integers(0, V, (40, 5))
    x = np.eye(V, dtype=np.float32)[ids[:, :-1]]
    y = np.eye(V, dtype=np.float32)[ids[:, 1:]]
    it = ArrayDataSetIterator(x, y, batch_size=16, shuffle=True, seed=3,
                              drop_last=True)
    jit_ = JArrayIt(x, y, batch_size=16, shuffle=True, seed=3,
                    drop_last=True)
    first = [ds.features for ds in it]
    assert len(first) == len(it) == 2
    for a, b in zip(first, jit_):
        assert np.array_equal(a, b.features)
    second = [ds.features for ds in it]
    assert not np.array_equal(first[0], second[0])
    it.reset()
    assert all(np.array_equal(a, b.features) for a, b in zip(first, it))

    # fit over the iterator equals fit_batch over the same order, twice
    # (fit resets the iterator after each epoch)
    jnet = jzoo.char_rnn(vocab_size=V, hidden=32, n_layers=1,
                         dtype=jzoo.models.F32)
    a = _transplant(jnet, tmp_path, "a.zip")
    b = _transplant(jnet, tmp_path, "b.zip")
    it.reset()
    a.fit(it, epochs=2)
    it.reset()
    order = list(it)
    for _ in range(2):
        for ds in order:
            b.fit_batch(ds)
    assert a.iteration == b.iteration == 4 and a.epoch == 2
    for name, layer in a.params.items():
        for k, p in layer.items():
            assert torch.equal(p, b.params[name][k])


def test_fit_takes_arrays_and_a_dataset(tmp_path):
    jnet = jzoo.char_rnn(vocab_size=V, hidden=32, n_layers=1,
                         dtype=jzoo.models.F32)
    tnet = _transplant(jnet, tmp_path)
    x, y, m = _data(seed=50, masked=True)
    before = tnet.score(TDS(x, y, m, m))
    tnet.fit(x, y, epochs=2, batch_size=8)
    assert tnet.iteration == 4 and tnet.epoch == 2
    tnet.fit(TDS(x, y, m, m))
    assert tnet.iteration == 5
    assert tnet.score(TDS(x, y, m, m)) < before
    np.testing.assert_allclose(before, float(jnet.score(JDS(x, y, m, m))),
                               rtol=1e-6)


def _f16_net(tmp_path):
    from deeplearning4j_tpu_torch import zoo as tzoo
    pol = DtypePolicy(param_dtype="float32", compute_dtype="float16")
    return tzoo.char_rnn(vocab_size=V, hidden=32, n_layers=1, dtype=pol,
                         device="cpu", seed=3)


def test_f16_overflow_skips_the_step_bit_identically(tmp_path):
    """Dynamic loss scaling on the CPU (the kernels take f32/bf16 only): a
    scale of 2**24 overflows the f16 backward, so the step is skipped with
    params and Adam state untouched and the scale halved; the next step,
    at a scale that fits, updates."""
    net = _f16_net(tmp_path)
    ls = net.opt_state[tprec.LOSS_SCALE_KEY]
    assert float(ls["scale"]) == 2.0 ** 15 and int(ls["good_steps"]) == 0
    x, y, m = _data(seed=60, masked=True)
    ds = TDS(x, y, m, m)
    ls["scale"] = torch.tensor(2.0 ** 24)
    params = _map(torch.clone, net.params)
    slots = _map(torch.clone, {k: v for k, v in net.opt_state.items()
                               if k != tprec.LOSS_SCALE_KEY})
    score = net.fit_batch(ds)
    assert math.isfinite(float(score))
    np.testing.assert_allclose(float(score), net.score(ds), rtol=1e-6)
    for a, b in zip(_leaves(params), _leaves(net.params)):
        assert torch.equal(a, b)
    for name, sub in slots.items():
        for a, b in zip(_leaves(sub), _leaves(net.opt_state[name])):
            assert torch.equal(a, b)
    ls = net.opt_state[tprec.LOSS_SCALE_KEY]
    assert float(ls["scale"]) == 2.0 ** 23 and int(ls["good_steps"]) == 0
    assert tprec.current_loss_scale(net) == 2.0 ** 23

    net.opt_state[tprec.LOSS_SCALE_KEY]["scale"] = torch.tensor(2.0 ** 8)
    net.fit_batch(ds)
    assert not torch.equal(params["layer_0"]["Wh"], net.params["layer_0"]["Wh"])
    assert int(net.opt_state[tprec.LOSS_SCALE_KEY]["good_steps"]) == 1
    assert int(net.opt_state["layer_0"]["t"]) == 1


def test_f16_loss_scale_state_crosses_the_zip(tmp_path):
    net = _f16_net(tmp_path)
    x, y, _ = _data(seed=61)
    net.fit_batch(TDS(x, y))
    path = str(tmp_path / "f16.zip")
    tser.write_model(net, path)
    back = jser.restore_multi_layer_network(path)
    assert float(back.opt_state["_loss_scale"]["scale"]) == float(
        net.opt_state[tprec.LOSS_SCALE_KEY]["scale"])
    assert int(back.opt_state["_loss_scale"]["good_steps"]) == 1
    again = tser.restore_multi_layer_network(path, device="cpu")
    for a, b in zip(_leaves(again.opt_state), _leaves(net.opt_state)):
        assert torch.equal(a, b)


def test_zoo_char_rnn_trains_with_its_adam_and_mcxent():
    """zoo.char_rnn's Adam(2e-3) and mcxent head reach the update rule and
    the loss registry; a few steps on one batch lower its score."""
    from deeplearning4j_tpu_torch import zoo as tzoo
    from deeplearning4j_tpu_torch.nn import updater as tupd
    from deeplearning4j_tpu_torch.ops import losses as tlosses
    net = tzoo.char_rnn(vocab_size=V, hidden=32, n_layers=1, device="cpu",
                        dtype=tzoo.F32, seed=5)
    upd = net.layers[0].resolve("updater")
    assert upd == tupd.Adam(2e-3)
    assert isinstance(net.layers[-1].loss_fn, tlosses.MCXENT)
    assert sorted(net.opt_state["layer_0"]) == ["m", "t", "v"]
    x, y, _ = _data(seed=70)
    first = float(net.fit_batch(TDS(x, y)))
    for _ in range(4):
        last = float(net.fit_batch(TDS(x, y)))
    assert last < first and int(net.opt_state["layer_1"]["t"]) == 5


def test_regularized_loss_and_lr_scale_match_jax(tmp_path):
    """L1/L2 (weights) and L1/L2 on biases in the loss, and a halved
    learning rate (set_lr_scale), one Sgd step against the JAX package."""
    b = (JNNC.builder().seed(42).updater(JSgd(0.5)).dtype(jzoo.models.F32)
         .l1(1e-3).l2(2e-2).l1_bias(5e-4).l2_bias(1e-2).list()
         .layer(JLSTM(n_out=32, activation="tanh"))
         .layer(JRnnOutput(n_out=V, loss="mcxent", activation="softmax"))
         .set_input_type(JInputType.recurrent(V)))
    jnet = JMLN(b.build()).init().set_lr_scale(0.5)
    tnet = _transplant(jnet, tmp_path).set_lr_scale(0.5)
    with pytest.raises(ValueError):
        tnet.set_lr_scale(0.0)
    x, y, m = _data(seed=80, masked=True)
    np.testing.assert_allclose(tnet.score(TDS(x, y, m, m)),
                               float(jnet.score(JDS(x, y, m, m))), rtol=1e-6)
    js = jnet.fit_batch(JDS(x, y, m, m))
    ts = tnet.fit_batch(TDS(x, y, m, m))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    for name, layer in tnet.params.items():
        for k, p in layer.items():
            np.testing.assert_allclose(_np(p), _np(jnet.params[name][k]),
                                       atol=1e-6, rtol=1e-6)


def test_dropout_draws_from_the_nets_generator(tmp_path):
    """Inverted dropout on the layers' inputs while training: the same
    seed gives the same mask, kept inputs are scaled by 1/keep, and
    inference ignores it. (Its bits are torch's, not jax.random's.)"""
    from deeplearning4j_tpu_torch.nn.conf.core import (
        MultiLayerConfiguration as TMLC)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    b = (JNNC.builder().seed(4).dropout(0.5).dtype(jzoo.models.F32).list()
         .layer(JLSTM(n_out=16, activation="tanh"))
         .layer(JRnnOutput(n_out=V, loss="mcxent", activation="softmax"))
         .set_input_type(JInputType.recurrent(V)))
    conf = TMLC.from_json(b.build().to_json())
    x, y, _ = _data(seed=81)
    a = MultiLayerNetwork(conf, device="cpu").init()
    c = MultiLayerNetwork(conf, device="cpu").init()
    assert torch.equal(a.output(x, train=True), c.output(x, train=True))
    assert not torch.equal(a.output(x, train=True), a.output(x))
    assert torch.equal(a.output(x), c.output(x))
    layer = a.layers[0]
    xt = torch.ones(4, 3, 5)
    gen = torch.Generator().manual_seed(0)
    dropped = layer._input_dropout(xt, True, gen)
    assert set(torch.unique(dropped).tolist()) <= {0.0, 2.0}
    assert torch.equal(layer._input_dropout(xt, False, None), xt)
    with pytest.raises(ValueError, match="generator"):
        layer._input_dropout(xt, True, None)
    # the train step drops inputs (its score is not the eval score of the
    # same params), with the same bits from the same seed
    d = MultiLayerNetwork(conf, device="cpu").init()
    e = MultiLayerNetwork(conf, device="cpu").init()
    eval_score = d.score(TDS(x, y))
    step_score = float(d.fit_batch(TDS(x, y)))
    assert step_score == float(e.fit_batch(TDS(x, y)))
    assert step_score != eval_score


def test_tbptt_configuration_json_matches_jax():
    from deeplearning4j_tpu_torch.nn.conf.core import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import (
        GravesLSTM, RnnOutput)
    from deeplearning4j_tpu_torch.nn.updater import Adam
    want = _conf(jzoo.models.BF16, JAdam(LR), tbptt=16).to_json()
    from deeplearning4j_tpu_torch import zoo as tzoo
    b = (NeuralNetConfiguration.builder().seed(42).updater(Adam(LR))
         .dtype(tzoo.BF16).list())
    for _ in range(2):
        b = b.layer(GravesLSTM(n_out=H, activation="tanh"))
    got = (b.layer(RnnOutput(n_out=V, loss="mcxent", activation="softmax"))
           .set_input_type(InputType.recurrent(V))
           .backprop_type("tbptt", 16, 16).build())
    assert got.to_json() == want
    with pytest.raises(ValueError, match="tbptt_bwd_length"):
        b.backprop_type("tbptt", 16, 8).build()


def test_bidirectional_lstm_trains_like_jax(tmp_path):
    """The bidirectional LSTM (the same op on the time-flipped input,
    directions summed; nested fwd/bwd params): one Sgd step, masked,
    F32."""
    from deeplearning4j_tpu.nn.conf.layers_recurrent import (
        GravesBidirectionalLSTM as JBiLSTM)
    b = (JNNC.builder().seed(6).updater(JSgd(0.5)).dtype(jzoo.models.F32)
         .list()
         .layer(JBiLSTM(n_out=24, activation="tanh"))
         .layer(JRnnOutput(n_out=V, loss="mcxent", activation="softmax"))
         .set_input_type(JInputType.recurrent(V)))
    jnet = JMLN(b.build()).init()
    tnet = _transplant(jnet, tmp_path)
    x, y, m = _data(seed=90, masked=True)
    js = jnet.fit_batch(JDS(x, y, m, m))
    ts = tnet.fit_batch(TDS(x, y, m, m))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    for a, w in zip(_leaves(tnet.params), jax.tree_util.tree_leaves(
            jnet.params)):
        np.testing.assert_allclose(_np(a), _np(w), atol=1e-6, rtol=1e-6)
