"""MultiLayerNetwork's feed-forward and conv path in the port
(deeplearning4j_tpu_torch: nn/conf/preprocessors.py, the preprocessors in
MultiLayerConfiguration and MultiLayerNetwork, zoo.mnist_mlp, zoo.lenet,
zoo.vgg16) against the JAX package, on the CPU.

Each net is built by the JAX package and carried to the port through the
zip, F32 set explicitly (tests/conftest.py turns on JAX's x64). Sizes:
mnist_mlp (784-256-128-10) and LeNet (28 x 28 x 1, conv 20/50, dense 500)
at their published widths, b = 8; VGG-16 at 32 x 32 and 7 classes, b = 2.

Tolerances, each with its reason:

- Preprocessors, the JSON, the inserted adapters, the summary: exact
  (reshapes and strings).
- F32 outputs (softmax probabilities): 1e-5 absolute (the same f32
  arithmetic, convolutions and sums in another order).
- F32 scores: 1e-5 relative.
- F32 gradients: 1e-4 of each gradient's largest magnitude (sums in
  another order through up to four products).
- Parameters after 3 F32 steps: 1e-4 of each tensor's largest magnitude
  plus 1e-6 (each step moves a parameter by the updater's function of
  gradients held to 1e-4 above).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.datasets import DataSet as JDS
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.conf.core import (
    MultiLayerConfiguration as JMLC)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.conf.layers_conv import (
    Convolution2D as JConv, Subsampling as JSub)
from deeplearning4j_tpu.nn.conf.layers_recurrent import GravesLSTM as JLSTM
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Nesterovs as JNesterovs
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.datasets import DataSet as TDS
from deeplearning4j_tpu_torch.nn import precision as tprec
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpre
from deeplearning4j_tpu_torch.nn.conf.core import (
    MultiLayerConfiguration as TMLC)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.nn.conf.layers import Dense as TDense
from deeplearning4j_tpu_torch.nn.conf.layers import Output as TOutput
from deeplearning4j_tpu_torch.nn.conf.layers_conv import (
    Convolution2D as TConv, Subsampling as TSub)
from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import (
    GravesLSTM as TLSTM)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.nn.updater import Nesterovs as TNesterovs
from deeplearning4j_tpu_torch.nn.updater import _leaves, _map
from deeplearning4j_tpu_torch.utils import serialization as tser

B = 8

# (kind, constructor kwargs, input shape)
PREPROCESSORS = [
    ("CnnToFeedForward", dict(height=4, width=3, channels=5), (6, 4, 3, 5)),
    ("FeedForwardToCnn", dict(height=4, width=3, channels=5), (6, 60)),
    ("RnnToFeedForward", dict(), (3, 4, 7)),
    ("FeedForwardToRnn", dict(timesteps=4), (12, 7)),
    ("CnnToRnn", dict(timesteps=3), (6, 4, 3, 5)),
    ("RnnToCnn", dict(height=4, width=3, channels=5), (2, 3, 60)),
]

IN_TYPES = {
    "CnnToFeedForward": ("convolutional", (4, 3, 5)),
    "FeedForwardToCnn": ("feed_forward", (60,)),
    "RnnToFeedForward": ("recurrent", (7,)),
    "FeedForwardToRnn": ("feed_forward", (7,)),
    "CnnToRnn": ("convolutional", (4, 3, 5)),
    "RnnToCnn": ("recurrent", (60,)),
}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_max(got, want, rel, what, floor=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    tol = rel * float(np.abs(want).max()) + floor
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


def _transplant(jnet, tmp_path, name="m.zip"):
    path = tmp_path / name
    jser.write_model(jnet, str(path))
    return tser.restore_multi_layer_network(str(path), device="cpu")


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
    return float(loss.detach()), tprec._fill(leaves, iter(grads))


def _images(seed, b, size, channels, classes):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, size, size, channels)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, b)]
    return x, y


# ------------------------------------------------------------ preprocessors
@pytest.mark.parametrize("kind,kw,shape", PREPROCESSORS,
                         ids=[p[0] for p in PREPROCESSORS])
def test_preprocessor_matches_jax(kind, kw, shape):
    jp, tp = getattr(jpre, kind)(**kw), getattr(tpre, kind)(**kw)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jp(jnp.asarray(x)))
    got = tp(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tpre.preprocessor_to_dict(tp) == jpre.preprocessor_to_dict(jp)
    assert tpre.preprocessor_from_dict(jpre.preprocessor_to_dict(jp)) == tp
    in_kind, dims = IN_TYPES[kind]
    jt = getattr(JInputType, in_kind)(*dims)
    tt = getattr(TInputType, in_kind)(*dims)
    assert tp.output_type(tt).to_dict() == jp.output_type(jt).to_dict()


def test_cnn_flatten_keeps_nhwc_order_on_a_channels_last_tensor():
    """A convolution's output is an NCHW tensor in channels-last memory,
    seen as NHWC through a permute: not contiguous in NHWC order. The
    flatten must still give h, w, c order (the JAX package's), which a
    reshape does and a view would refuse."""
    nchw = torch.randn(2, 5, 4, 3).contiguous(
        memory_format=torch.channels_last)
    nhwc = nchw.permute(0, 2, 3, 1)
    got = tpre.CnnToFeedForward(4, 3, 5)(nhwc)
    want = np.asarray(nhwc.contiguous().numpy()).reshape(2, -1)
    np.testing.assert_array_equal(got.numpy(), want)
    nchw_plain = torch.randn(2, 5, 4, 3)
    odd = nchw_plain.permute(0, 2, 3, 1)
    assert not odd.is_contiguous()
    np.testing.assert_array_equal(
        tpre.CnnToFeedForward(4, 3, 5)(odd).numpy(),
        odd.contiguous().numpy().reshape(2, -1))


# ------------------------------------------------------------------- JSON
def _mixed_conf(pkg, explicit):
    """conv -> pool -> dense -> output on 8 x 8 x 2 images: the CnnToFF
    before the dense layer comes from set_input_type, or (``explicit``)
    from input_preprocessor, plus an explicit (no-op) one at layer 0."""
    if pkg == "jax":
        nnc, conv, sub, dense, out, it, pre = (JNNC, JConv, JSub, JDense,
                                               JOutput, JInputType, jpre)
        from deeplearning4j_tpu.nn.conf.core import DtypePolicy
    else:
        nnc, conv, sub, dense, out, it, pre = (TNNC, TConv, TSub, TDense,
                                               TOutput, TInputType, tpre)
        from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
    b = (nnc.builder().seed(3).activation("relu")
         .dtype(DtypePolicy(param_dtype="float32", compute_dtype="float32"))
         .list()
         .layer(conv(n_out=4, kernel=(3, 3)))
         .layer(sub(kernel=(2, 2), stride=(2, 2)))
         .layer(dense(n_out=6))
         .layer(out(n_out=3, loss="mcxent", activation="softmax"))
         .set_input_type(it.convolutional(8, 8, 2)))
    if explicit:
        b = (b.input_preprocessor(2, pre.CnnToFeedForward(3, 3, 4))
             .input_preprocessor(0, pre.FeedForwardToCnn(8, 8, 2)))
    return b.build()


@pytest.mark.parametrize("explicit", [False, True],
                         ids=["inserted", "explicit"])
def test_json_round_trips_both_ways(explicit):
    jconf, tconf = _mixed_conf("jax", explicit), _mixed_conf("torch",
                                                              explicit)
    assert tconf.to_json() == jconf.to_json()
    assert TMLC.from_json(jconf.to_json()).to_json() == jconf.to_json()
    assert JMLC.from_json(tconf.to_json()).to_json() == tconf.to_json()
    assert TMLC.from_json(jconf.to_json()).preprocessors == \
        tconf.preprocessors
    assert bool(tconf.preprocessors) == explicit


@pytest.mark.parametrize("explicit", [False, True],
                         ids=["inserted", "explicit"])
def test_network_preprocessors_match_jax(explicit):
    jnet = JMLN(_mixed_conf("jax", explicit)).init()
    tnet = TMLN(_mixed_conf("torch", explicit), device="cpu").init()
    dicts = lambda ps, to: [None if p is None else to(p)  # noqa: E731
                            for p in ps]
    assert dicts(tnet.preprocessors, tpre.preprocessor_to_dict) == \
        dicts(jnet.preprocessors, jpre.preprocessor_to_dict)
    assert tnet.preprocessors[2] == tpre.CnnToFeedForward(3, 3, 4)
    assert (tnet.preprocessors[0] is not None) == explicit
    assert tnet.summary() == jnet.summary()


def test_inserted_preprocessors_of_every_family_match_jax():
    """rnn -> dense (RnnToFeedForward), flat -> conv (FeedForwardToCnn),
    conv -> dense (CnnToFeedForward): the same adapters at the same
    places, and the explicit one at a layer wins over the inserted."""
    def build(pkg, explicit):
        if pkg == "jax":
            nnc, lstm, dense, conv, out, it, pre = (
                JNNC, JLSTM, JDense, JConv, JOutput, JInputType, jpre)
        else:
            nnc, lstm, dense, conv, out, it, pre = (
                TNNC, TLSTM, TDense, TConv, TOutput, TInputType, tpre)
        rnn = (nnc.builder().list().layer(lstm(n_out=4))
               .layer(dense(n_out=3)).layer(out(n_out=2))
               .set_input_type(it.recurrent(5)))
        flat = (nnc.builder().list().layer(conv(n_out=2, kernel=(3, 3)))
                .layer(out(n_out=2)).set_input_type(
                    it.convolutional_flat(6, 6, 1)))
        if explicit:
            flat = flat.input_preprocessor(1, pre.CnnToFeedForward(4, 4, 2))
        return rnn.build(), flat.build()
    for explicit in (False, True):
        for jc, tc in zip(build("jax", explicit), build("torch", explicit)):
            assert tc.to_json() == jc.to_json()
            jn, tn = JMLN(jc).init(), TMLN(tc, device="cpu").init()
            got = [None if p is None else tpre.preprocessor_to_dict(p)
                   for p in tn.preprocessors]
            want = [None if p is None else jpre.preprocessor_to_dict(p)
                    for p in jn.preprocessors]
            assert got == want and any(p is not None for p in got)


# ---------------------------------------------------------------- parity
def _conv_output_conf(pkg):
    """conv 3x3x4 -> Output(5) on 6 x 6 x 2 images: the Output layer's
    CnnToFeedForward runs in _loss after the walk stops before it."""
    if pkg == "jax":
        nnc, conv, out, it, upd = JNNC, JConv, JOutput, JInputType, \
            JNesterovs
        from deeplearning4j_tpu.nn.conf.core import DtypePolicy
    else:
        nnc, conv, out, it, upd = TNNC, TConv, TOutput, TInputType, \
            TNesterovs
        from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
    return (nnc.builder().seed(11).updater(upd(0.01, 0.9))
            .dtype(DtypePolicy(param_dtype="float32", compute_dtype="float32"))
            .list()
            .layer(conv(n_out=4, kernel=(3, 3), activation="tanh"))
            .layer(out(n_out=5, loss="mcxent", activation="softmax"))
            .set_input_type(it.convolutional(6, 6, 2)).build())


def _nets(name, tmp_path):
    """(JAX net, its transplant, input maker) for each net held here."""
    if name == "conv_output":
        jnet = JMLN(_conv_output_conf("jax")).init()
        data = lambda s, b: _images(s, b, 6, 2, 5)  # noqa: E731
    elif name == "mnist_mlp":
        jnet = jzoo.mnist_mlp(dtype=jzoo.F32)

        def data(s, b):
            rng = np.random.default_rng(s)
            x = rng.normal(size=(b, 784)).astype(np.float32)
            return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]
    elif name == "lenet":
        jnet = jzoo.lenet(dtype=jzoo.F32)
        data = lambda s, b: _images(s, b, 28, 1, 10)  # noqa: E731
    else:
        raise ValueError(name)
    return jnet, _transplant(jnet, tmp_path), data


NETS = ["conv_output", "mnist_mlp", "lenet"]


@pytest.mark.parametrize("name", NETS)
def test_output_score_and_gradients_match_jax(tmp_path, name):
    jnet, tnet, data = _nets(name, tmp_path)
    assert tnet.conf.to_json() == jnet.conf.to_json()
    x, y = data(1, B)
    np.testing.assert_allclose(_np(tnet.output(x)), _np(jnet.output(x)),
                               atol=1e-5, rtol=0)
    js = jnet.score(JDS(x, y))
    assert abs(tnet.score(TDS(x, y)) - js) <= 1e-5 * abs(js)
    jl, jg = _jax_loss_and_grads(jnet, x, y)
    tl, tg = _port_loss_and_grads(tnet, x, y)
    assert abs(tl - float(jl)) <= 1e-5 * abs(float(jl))
    for ln, lp in tg.items():
        for k, g in lp.items():
            _close_max(g, jg[ln][k], 1e-4, f"grad {ln}.{k}")


@pytest.mark.parametrize("name", NETS)
def test_three_f32_steps_match_jax(tmp_path, name):
    jnet, tnet, data = _nets(name, tmp_path)
    for step in range(3):
        x, y = data(10 + step, B)
        js = float(jnet.fit_batch(JDS(x, y)))
        ts = float(tnet.fit_batch(TDS(x, y)))
        assert abs(ts - js) <= 1e-5 * abs(js), (step, ts, js)
    assert tnet.iteration == jnet.iteration == 3
    for ln, lp in tnet.params.items():
        for k, t in lp.items():
            _close_max(t, jnet.params[ln][k], 1e-4, f"param {ln}.{k}",
                       floor=1e-6)


def test_vgg16_small_output_matches_jax(tmp_path):
    jnet = jzoo.vgg16(image_size=32, n_classes=7, dtype=jzoo.F32)
    tnet = _transplant(jnet, tmp_path)
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert tnet.num_params() == jnet.num_params() == 33625927
    assert tnet.preprocessors[18] == tpre.CnnToFeedForward(1, 1, 512)
    raw, _ = _images(2, 2, 32, 3, 7)
    raw = raw * 40 + 128
    x = tzoo.vgg16_preprocess(raw)
    np.testing.assert_array_equal(x, jzoo.vgg16_preprocess(raw))
    np.testing.assert_allclose(_np(tnet.output(x)), _np(jnet.output(x)),
                               atol=1e-5, rtol=0)


def test_zoo_defaults_match_jax():
    """Same configuration JSON as the JAX package's builders at their
    defaults (LeNet and VGG-16 BF16 with Nesterovs(0.01, 0.9), mnist_mlp
    F32 with Adam), and vgg16_preprocess keeps a tensor on its device."""
    for jn, tn in ((jzoo.lenet(), tzoo.lenet(device="cpu")),
                   (jzoo.mnist_mlp(), tzoo.mnist_mlp(device="cpu"))):
        assert tn.conf.to_json() == jn.conf.to_json()
        assert tn.num_params() == jn.num_params()
    lenet = tzoo.lenet(device="cpu")
    assert lenet.conf.global_conf.dtype == tzoo.BF16
    upd = lenet.layers[0].resolve("updater")
    assert (upd.kind, upd.learning_rate, upd.momentum) == \
        ("nesterovs", 0.01, 0.9)
    vgg = tzoo.vgg16(image_size=32, n_classes=7, device="cpu")
    assert vgg.conf.to_json() == jzoo.vgg16(image_size=32,
                                            n_classes=7).conf.to_json()
    t = torch.full((1, 2, 2, 3), 200, dtype=torch.uint8)
    out = tzoo.vgg16_preprocess(t)
    assert out.dtype == torch.float32 and out.device == t.device
    np.testing.assert_allclose(out[0, 0, 0].numpy(),
                               200 - np.asarray(tzoo.VGG16_MEAN_RGB),
                               rtol=1e-6)
    assert tzoo.VGG16_MEAN_RGB == jzoo.VGG16_MEAN_RGB


# ----------------------------------------------------------------- the zip
def test_zip_with_preprocessors_crosses_both_ways(tmp_path):
    jnet = JMLN(_mixed_conf("jax", True)).init()
    x, y = _images(3, 4, 8, 2, 3)
    jnet.fit_batch(JDS(x, y))
    tnet = _transplant(jnet, tmp_path, "j.zip")
    assert tnet.conf.preprocessors == {
        2: tpre.CnnToFeedForward(3, 3, 4), 0: tpre.FeedForwardToCnn(8, 8, 2)}
    np.testing.assert_allclose(_np(tnet.output(x)), _np(jnet.output(x)),
                               atol=1e-5, rtol=0)
    tnet.fit_batch(TDS(x, y))
    path = tmp_path / "t.zip"
    tser.write_model(tnet, str(path))
    back = jser.restore_multi_layer_network(str(path))
    assert back.conf.to_json() == tnet.conf.to_json()
    assert back.iteration == 2
    np.testing.assert_allclose(_np(back.output(x)), _np(tnet.output(x)),
                               atol=1e-5, rtol=0)
    again = tser.restore_model(str(path), device="cpu")
    assert isinstance(again, TMLN)
    assert torch.equal(again.output(x), tnet.output(x))


# ------------------------------------------------------ evaluate and clone
def test_evaluate_matches_jax(tmp_path):
    jnet, tnet, data = _nets("lenet", tmp_path)
    x, y = data(5, 32)
    jev, tev = jnet.evaluate(JDS(x, y)), tnet.evaluate(TDS(x, y))
    np.testing.assert_array_equal(tev.confusion.matrix, jev.confusion.matrix)
    assert tev.accuracy() == jev.accuracy() and tev.stats() == jev.stats()
    yr = np.random.default_rng(6).uniform(size=(32, 10)).astype(np.float32)
    jr, tr = (jnet.evaluate_regression(JDS(x, yr)),
              tnet.evaluate_regression(TDS(x, yr)))
    for c in range(10):
        assert abs(tr.mean_squared_error(c) - jr.mean_squared_error(c)) \
            <= 1e-6 * jr.mean_squared_error(c)


def test_clone_shares_no_storage_and_trains_alike():
    net = tzoo.lenet(device="cpu", dtype=tzoo.F32)
    x, y = _images(7, 4, 28, 1, 10)
    net.fit_batch(TDS(x, y))
    twin = net.clone()
    assert twin.iteration == net.iteration == 1 and twin is not net
    before = _map(lambda t: t.clone(), twin.params)
    for a, b in zip(_leaves(net.params), _leaves(twin.params)):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    for a, b in zip(_leaves(net.opt_state), _leaves(twin.opt_state)):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    s1 = float(net.fit_batch(TDS(x, y)))
    for a, b in zip(_leaves(twin.params), _leaves(before)):
        assert torch.equal(a, b)
    s2 = float(twin.fit_batch(TDS(x, y)))
    assert s1 == s2
    for a, b in zip(_leaves(net.params), _leaves(twin.params)):
        assert torch.equal(a, b)
    assert twin.preprocessors == net.preprocessors
