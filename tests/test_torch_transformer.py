"""The gpt_mini transformer in the port (deeplearning4j_tpu_torch) against the
JAX package, on the CPU: a gpt_mini of width 32, 2 blocks, 2 heads and
max_len 16, built by the JAX package and transplanted through the zip,
gives the same ``output``, ``feed_forward``, score, gradients, parameters
after Adam steps, ``rnn_time_step`` stream and truncated-BPTT batch;
configurations and zips cross both ways; ``ModelServer`` serves it; and
``strip_carries`` drops the KV-cache carries as the JAX package's does.

Tolerances, each with its reason:

- F32: 1e-5 abs and rel on activations and probabilities, 1e-6 relative
  on scores, 1e-5 of each gradient's largest element (the same f32
  arithmetic summed in another order).
- BF16 activations: 4 bf16 ulps at the layer's largest magnitude. Each
  block rounds its bf16 stream at about ten places (LayerNorm out, q, k,
  v, attention out, projection, residual add, GELU, the MLP's products),
  and XLA's CPU fusion keeps some of those intermediates in f32, so a
  rounding can land the other way at each (measured: 2 ulps).
- BF16 probabilities: 5e-3 abs. Two bf16 ulps on a logit of magnitude < 4
  (2**-5) move a probability p by at most p * 2**-5, and p < 0.16 for
  these random-weight models (measured: 2.4e-3).
- BF16 score: 2e-4 relative (one bf16 rounding of a logit moves its
  row's loss by ~2**-8 * |z|; the mean over 64 rows, measured 7.6e-5).
- BF16 gradients: 8 bf16 ulps at each gradient's largest element: the
  forward's roundings above, the backward's own bf16 cotangent roundings,
  and the JAX CPU lowering's bf16 partial sums of bias cotangents
  (measured: 5 ulps).
- ``bk``: its true gradient is 0 (a key bias adds q.bk to every score of
  a row, which the softmax removes), so both packages give rounding noise
  there; it is held to 1e-5 (F32) or 2**-8 (BF16: the k cotangent rows
  are rounded to bf16 before they are summed) of the largest ``Wk``
  gradient instead.
- Parameters after Adam steps: 1e-5 abs; ``bk`` to 2 * lr per step, since
  Adam scales its noise gradient up to about lr whatever its sign.
- Streaming runs in f32 under either policy: 1e-5 abs.
"""

import dataclasses
import json
import math
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.datasets import DataSet as JDS
from deeplearning4j_tpu.nn.conf.core import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.datasets import DataSet as TDS
from deeplearning4j_tpu_torch.nn import precision as tprec
from deeplearning4j_tpu_torch.nn.conf.core import (
    MultiLayerConfiguration as TMLC)
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn import multilayer as tmln
from deeplearning4j_tpu_torch.nn.updater import _leaves, _map
from deeplearning4j_tpu_torch.serving import ModelServer
from deeplearning4j_tpu_torch.utils import serialization as tser

V, W, L, HEADS, MAX_LEN = 80, 32, 2, 2, 16
B, T = 4, 16
LR = 3e-4
F32_TOL = 1e-5
BF16_ACT_ULPS = 4
BF16_PROB_TOL = 5e-3
BF16_SCORE_RTOL = 2e-4
BF16_GRAD_ULPS = 8

SIZE = dict(vocab_size=V, width=W, n_layers=L, n_heads=HEADS,
            max_len=MAX_LEN)


def _jnet(policy, seed=42):
    return jzoo.gpt_mini(seed=seed, dtype=getattr(jzoo.models, policy),
                         **SIZE)


def _transplant(jnet, tmp_path, name="model.zip"):
    path = tmp_path / name
    jser.write_model(jnet, str(path))
    return tser.restore_multi_layer_network(str(path), device="cpu")


def _one_hot(b, t, seed):
    rng = np.random.default_rng(seed)
    return np.eye(V, dtype=np.float32)[rng.integers(0, V, (b, t))]


def _data(seed, t=T):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, t + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulp(top):
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


@pytest.fixture(params=["F32", "BF16"])
def policy(request):
    return request.param


def test_gpt_mini_configuration_matches_jax():
    for kw in ({}, SIZE):
        jconf = jzoo.gpt_mini(**kw).conf
        tconf = tzoo.gpt_mini(device="cpu", **kw).conf
        assert tconf.to_json() == jconf.to_json()
    assert (tzoo.gpt_mini_draft(device="cpu").conf.to_json()
            == jzoo.gpt_mini_draft().conf.to_json())


def test_configuration_json_crosses_both_ways(policy):
    jconf = _jnet(policy).conf
    tconf = TMLC.from_json(jconf.to_json())
    assert tconf.to_json() == jconf.to_json()
    assert JMLC.from_json(tconf.to_json()).to_json() == jconf.to_json()
    types = [lc.layer_type for lc in tconf.layers]
    assert types == ["gpt_embedding"] + ["transformer_block"] * L + [
        "gpt_output"]


def test_full_width_defaults():
    net = tzoo.gpt_mini(device="cpu")
    emb, *blocks, head = net.layers
    assert (emb.conf.n_in, emb.conf.n_out, emb.conf.max_len) == (80, 256, 256)
    assert len(blocks) == 4
    assert all((blk.n_heads, blk.head_dim, blk.cache_len) == (4, 64, 256)
               for blk in blocks)
    assert net.params[blocks[0].name]["W1"].shape == (256, 1024)
    pol = net.conf.global_conf.dtype
    assert (pol.param_dtype, pol.compute_dtype) == ("float32", "bfloat16")
    upd = blocks[0].resolve("updater")
    assert upd.kind == "adam" and upd.learning_rate == LR
    assert head.conf.n_out == 80


def test_output_and_feed_forward_match_jax(policy, tmp_path):
    jnet = _jnet(policy)
    tnet = _transplant(jnet, tmp_path)
    x = _one_hot(B, T, seed=1)
    want = np.asarray(jnet.output(x))
    got = tnet.output(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, V)
    acts_j = jnet.feed_forward(x)
    acts_t = tnet.feed_forward(x)
    assert len(acts_t) == len(acts_j) == L + 2
    if policy == "F32":
        np.testing.assert_allclose(_np(got), want, rtol=F32_TOL,
                                   atol=F32_TOL)
        for a_t, a_j in zip(acts_t, acts_j):
            np.testing.assert_allclose(_np(a_t), _np(a_j), rtol=F32_TOL,
                                       atol=F32_TOL)
        return
    assert np.abs(_np(got) - want).max() <= BF16_PROB_TOL
    for a_t, a_j in zip(acts_t[:-1], acts_j[:-1]):
        assert a_t.dtype == torch.bfloat16
        w = _np(a_j)
        assert (np.abs(_np(a_t) - w).max()
                <= BF16_ACT_ULPS * _ulp(float(np.abs(w).max())))


def test_output_ignores_the_features_mask(tmp_path):
    """The non-streaming path ignores the mask, as in the JAX package."""
    tnet = _transplant(_jnet("F32"), tmp_path)
    x = _one_hot(2, T, seed=2)
    m = np.ones((2, T), np.float32)
    m[0, 5:] = 0.0
    assert torch.equal(tnet.output(x, mask=m), tnet.output(x))


def _jax_loss_and_grads(jnet, x, y):
    fn = jax.jit(jax.value_and_grad(lambda p: jnet._loss(
        p, jnet.state, jnp.asarray(x), jnp.asarray(y), None, None, None,
        train=True)[0]))
    return fn(jnet.params)


def _port_loss_and_grads(tnet, x, y):
    leaves = _map(lambda p: p.detach().requires_grad_(), tnet.params)
    loss, _ = tnet._loss(leaves, tnet.state, torch.from_numpy(x),
                         torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(_leaves(leaves)))
    return loss.detach(), tprec._fill(leaves, iter(grads))


def test_score_and_gradients_match_jax(policy, tmp_path):
    jnet = _jnet(policy)
    tnet = _transplant(jnet, tmp_path)
    x, y = _data(seed=3)
    jloss, jgrads = _jax_loss_and_grads(jnet, x, y)
    tloss, tgrads = _port_loss_and_grads(tnet, x, y)
    rtol = 1e-6 if policy == "F32" else BF16_SCORE_RTOL
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol)
    np.testing.assert_allclose(
        tnet.score(TDS(x, y)), float(jnet.score(JDS(x, y))), rtol=rtol)
    n = 0
    for name, layer in tgrads.items():
        for k, g in layer.items():
            assert g.dtype == torch.float32, (name, k)
            w, gn = _np(jgrads[name][k]), _np(g)
            if k == "bk":
                rel = F32_TOL if policy == "F32" else 2.0 ** -8
                tol = rel * float(np.abs(_np(jgrads[name]["Wk"])).max())
                assert np.abs(gn).max() <= tol and np.abs(w).max() <= tol
                continue
            top = float(np.abs(w).max())
            tol = (F32_TOL * top if policy == "F32"
                   else BF16_GRAD_ULPS * _ulp(top))
            assert np.abs(gn - w).max() <= tol, (name, k)
            n += 1
    assert n == 2 + L * 15 + 2


def test_params_after_three_adam_steps_match_jax(tmp_path):
    jnet = _jnet("F32")
    tnet = _transplant(jnet, tmp_path)
    steps = 3
    for s in range(steps):
        x, y = _data(seed=10 + s)
        js = jnet.fit_batch(JDS(x, y))
        ts = tnet.fit_batch(TDS(x, y))
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    assert tnet.iteration == jnet.iteration == steps
    for name, layer in tnet.params.items():
        for k, p in layer.items():
            w = np.asarray(jnet.params[name][k])
            tol = 2 * LR * steps if k == "bk" else F32_TOL
            assert np.abs(_np(p) - w).max() <= tol, (name, k)


def test_rnn_time_step_matches_jax(policy, tmp_path):
    """Token by token, then the same sequence in chunks of 5, 1 and 10:
    each against the JAX package's stream and the one-shot output."""
    jnet = _jnet(policy)
    tnet = _transplant(jnet, tmp_path)
    x = _one_hot(3, T, seed=4)
    jnet.rnn_clear_previous_state()
    tnet.rnn_clear_previous_state()
    js = np.stack([np.asarray(jnet.rnn_time_step(x[:, t]))
                   for t in range(T)], axis=1)
    ts = torch.stack([tnet.rnn_time_step(x[:, t]) for t in range(T)], dim=1)
    np.testing.assert_allclose(_np(ts), js, atol=F32_TOL)
    assert {k: sorted(v) for k, v in tnet._rnn_state.items()} == {
        k: sorted(v) for k, v in jnet._rnn_state.items()}
    for name, st in tnet._rnn_state.items():
        np.testing.assert_array_equal(st["pos"].numpy(), np.full(3, T))
        for k in ("k", "v"):
            if k in st:
                assert st[k].dtype == torch.float32
                assert tuple(st[k].shape) == (3, MAX_LEN, HEADS, W // HEADS)
                np.testing.assert_allclose(
                    st[k].numpy(), np.asarray(jnet._rnn_state[name][k]),
                    atol=F32_TOL)
    tnet.rnn_clear_previous_state()
    chunks = [tnet.rnn_time_step(x[:, a:b]) for a, b in ((0, 5), (5, 6),
                                                        (6, 16))]
    np.testing.assert_allclose(_np(torch.cat(chunks, dim=1)), js,
                               atol=F32_TOL)
    one_shot = _np(tnet.output(x))
    tol = F32_TOL if policy == "F32" else BF16_PROB_TOL
    np.testing.assert_allclose(_np(ts), one_shot, atol=tol)


def test_masked_prefill_advances_each_row_by_its_length(tmp_path):
    jnet = _jnet("F32")
    tnet = _transplant(jnet, tmp_path)
    x = _one_hot(2, 6, seed=5)
    m = np.ones((2, 6), np.float32)
    m[1, 4:] = 0.0
    jnet.rnn_clear_previous_state()
    tnet.rnn_clear_previous_state()
    jo = np.asarray(jnet.rnn_time_step(x, mask=m))
    to = tnet.rnn_time_step(x, mask=m)
    np.testing.assert_allclose(_np(to), jo, atol=F32_TOL)
    np.testing.assert_array_equal(tnet._rnn_state["layer_1"]["pos"].numpy(),
                                  [6, 4])
    nxt = _one_hot(2, 1, seed=6)
    np.testing.assert_allclose(_np(tnet.rnn_time_step(nxt[:, 0])),
                               np.asarray(jnet.rnn_time_step(nxt[:, 0])),
                               atol=F32_TOL)


def test_tbptt_batch_matches_jax_and_strips_the_carries(tmp_path,
                                                        monkeypatch):
    """tBPTT at 4 over T = 16: four chunks hand the KV cache on; after
    the batch neither package keeps a carry in its state."""
    conf = dataclasses.replace(_jnet("F32").conf, backprop_type="tbptt",
                               tbptt_fwd_length=4, tbptt_bwd_length=4)
    jnet = JMLN(conf).init()
    tnet = _transplant(jnet, tmp_path)
    assert tnet.conf.backprop_type == "tbptt"
    seen = []

    def spy(state):
        seen.append({k: sorted(v) for k, v in state.items()})
        return trec.strip_carries(state)

    monkeypatch.setattr(tmln, "strip_carries", spy)
    x, y = _data(seed=7)
    js = float(jnet.fit_batch(JDS(x, y)))
    ts = float(tnet.fit_batch(TDS(x, y)))
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    assert seen == [{"layer_0": ["pos"], "layer_1": ["k", "pos", "v"],
                     "layer_2": ["k", "pos", "v"]}]
    assert tnet.state == {} and jnet.state == {}
    for name, layer in tnet.params.items():
        for k, p in layer.items():
            tol = 2 * LR if k == "bk" else F32_TOL
            assert np.abs(_np(p) - np.asarray(jnet.params[name][k])).max() \
                <= tol, (name, k)


def test_strip_carries_leaves_what_jax_leaves():
    """One layer's state holds the KV-cache carries beside entries that
    are not carries; another holds only carries, another an LSTM's."""
    def state(arr):
        return {
            "layer_0": {"pos": arr([3]), "running_mean": arr([1.0])},
            "layer_1": {"k": arr([[1.0]]), "v": arr([[2.0]]),
                        "pos": arr([3]), "count": arr([7])},
            "layer_2": {"k": arr([[1.0]]), "v": arr([[2.0]]),
                        "pos": arr([3])},
            "layer_3": {"h": arr([0.5]), "c": arr([0.5]),
                        "h_bwd": arr([0.1]), "c_bwd": arr([0.1])},
        }

    want = jrec.strip_carries(state(np.asarray))
    got = trec.strip_carries(state(torch.tensor))
    assert trec.CARRY_KEYS == jrec.CARRY_KEYS
    assert {k: sorted(v) for k, v in got.items()} == {
        k: sorted(v) for k, v in want.items()} == {
        "layer_0": ["running_mean"], "layer_1": ["count"]}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_zip_with_adam_state_crosses_both_ways(direction, tmp_path):
    jnet = _jnet("BF16")
    x, y = _data(seed=8)
    if direction == "jax_to_port":
        jnet.fit_batch(JDS(x, y))
        src, dst = jnet, _transplant(jnet, tmp_path)
    else:
        tnet = _transplant(jnet, tmp_path)
        tnet.fit_batch(TDS(x, y))
        path = tmp_path / "port.zip"
        tser.write_model(tnet, str(path))
        src, dst = tnet, jser.restore_multi_layer_network(str(path))
    assert dst.iteration == src.iteration == 1
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(_np(v))  # noqa: E731
                      for p, v in jax.tree_util.tree_flatten_with_path(
                          jax.tree_util.tree_map(_np, t))[0]}
    for a, b in ((src.params, dst.params), (src.opt_state, dst.opt_state)):
        fa, fb = flat(a), flat(b)
        assert set(fa) == set(fb)
        for key in fa:
            np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)
    assert "['layer_1']['m']['Wq']" in flat(src.opt_state)
    x2 = _one_hot(2, T, seed=9)
    assert np.abs(_np(dst.output(x2)) - _np(src.output(x2))).max() \
        <= BF16_PROB_TOL


def _post(url, rows):
    req = urllib.request.Request(
        url + "/predict", data=json.dumps({"features": rows.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_model_server_serves_gpt_mini(tmp_path):
    """The recurrent input has no fixed length, so the caller gives the
    warm-up its [T, vocab] rows; served rows equal ``output``'s."""
    net = tzoo.gpt_mini(device="cpu", dtype=tzoo.F32, seed=5, **SIZE)
    assert ModelServer(net, port=0)._infer_row_shapes() is None
    srv = ModelServer(net, port=0, max_batch=8,
                      input_shapes=[(T, V)]).start()
    try:
        assert srv.shapes_seen == {2, 4, 8}
        for k, seed in ((1, 10), (3, 11), (8, 12)):
            x = _one_hot(k, T, seed)
            status, body = _post(srv.url, x)
            assert status == 200
            got = np.asarray(body["predictions"], np.float32)
            assert got.shape == (k, T, V)
            # the same rows through torch's CPU matmul at another batch size
            np.testing.assert_allclose(got, _np(net.output(x)), atol=1e-6,
                                       rtol=1e-6)
    finally:
        srv.stop()


def test_gpt_mini_entry_point_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.gpt_mini(**SIZE)
    assert tzoo.gpt_mini(device="cpu", **SIZE).device.type == "cpu"


def test_fit_trains_gpt_mini_on_arrays():
    """``fit`` over arrays in minibatches lowers the score on a copy task
    (each next symbol is the current one)."""
    net = tzoo.gpt_mini(device="cpu", dtype=tzoo.F32, seed=3, **SIZE)
    rng = np.random.default_rng(12)
    ids = np.repeat(rng.integers(0, V, (16, 1)), T + 1, axis=1)
    eye = np.eye(V, dtype=np.float32)
    x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
    before = net.score(TDS(x, y))
    net.fit(x, y, epochs=3, batch_size=8)
    assert net.iteration == 6 and net.epoch == 3
    assert net.score(TDS(x, y)) < before
