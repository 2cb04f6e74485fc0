"""Every vertex type and the layer types of the port's slice 14
(deeplearning4j_tpu_torch/nn/conf/{vertices,layers,layers_conv,
layers_recurrent}.py and their runtime layers) against the JAX package, on
the CPU, on nets transplanted through the zip.

The vertex-rich graph (``_layers_graph``) holds every vertex type
(merge on features, time series and channels, element-wise, scale,
L2-normalize, L2, stack, unstack, subset, last-time-step with a named
mask input, duplicate-to-time-series with a named sequence input,
preprocessor) and each new layer type (Convolution1D, Subsampling1D with
p-norm, ZeroPadding, LRN, p-norm Subsampling, masked GlobalPooling,
Embedding, Dropout, TimeDistributedDense, LossLayer as a second output),
with its stem conv (5x5/s2 on 3 channels) and a 1x1/s2 projection meeting
the gates of the two exact conv rewrites.

Tolerances, each with its reason:

- F64 (activations, masks, scores, gradients): 1e-9 of each tensor's
  largest magnitude. The same f64 arithmetic with sums in another order
  is ~1e-15 off; 1e-9 leaves room for the few places where the packages
  take different but equal formulas (LRN's window sum by unfold against
  reduce_window, p-norm's sum by a unit-divisor average pool).
- F32 (the conv1d op): 1e-5 of the output's largest magnitude, as
  tests/test_torch_conv.py.
- Remat: exact (bit-equal gradients), as the JAX package holds its own
  (tests/test_graph.py::test_selective_remat_exact_in_f32).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import layers_conv as jconv_conf
from deeplearning4j_tpu.nn.conf import layers_recurrent as jrec
from deeplearning4j_tpu.nn.conf import preprocessors as jprep
from deeplearning4j_tpu.nn.conf import vertices as jvert
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JPolicy
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import _remat_match
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.ops import convolution as jops
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets import DataSet as TDS
from deeplearning4j_tpu_torch.datasets import MultiDataSet as TMDS
from deeplearning4j_tpu_torch.nn import remat
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import layers_conv as tconv_conf
from deeplearning4j_tpu_torch.nn.conf import layers_recurrent as trec
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tprep
from deeplearning4j_tpu_torch.nn.conf import vertices as tvert
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy as TPolicy
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration as TGraphConf)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT
from deeplearning4j_tpu_torch.nn.conf.layers import layer_from_dict
from deeplearning4j_tpu_torch.nn.conf.vertices import vertex_from_dict
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.ops import convolution as tops
from deeplearning4j_tpu_torch.utils import serialization as tser

F64_TOL = 1e-9
F32_TOL = 1e-5
B, T, IMG = 3, 6, 16


class _Pkg:
    """One package's config modules under common names."""

    def __init__(self, jax_side):
        if jax_side:
            (self.nnc, self.L, self.C, self.R, self.P, self.V, self.pol,
             self.it, self.adam) = (JNNC, jlayers, jconv_conf, jrec, jprep,
                                    jvert, JPolicy, JIT, JAdam)
        else:
            (self.nnc, self.L, self.C, self.R, self.P, self.V, self.pol,
             self.it, self.adam) = (TNNC, tlayers, tconv_conf, trec, tprep,
                                    tvert, TPolicy, TIT, None)
            from deeplearning4j_tpu_torch.nn.updater import Adam
            self.adam = Adam


JAXP, TORCHP = _Pkg(True), _Pkg(False)


def _layers_graph(p, dtype="float64", drop=None):
    """The vertex-rich graph of the module docstring in package ``p``."""
    L, C, R, V, it = p.L, p.C, p.R, p.V, p.it
    pol = p.pol(param_dtype=dtype, compute_dtype=dtype)
    g = (p.nnc.builder().seed(11).updater(p.adam(1e-2)).dtype(pol)
         .graph_builder().add_inputs("seq", "img", "static", "ids"))
    # the sequence side
    g.add_layer("c1", C.Convolution1D(n_out=6, kernel=3, mode="same",
                                      activation="tanh"), "seq")
    g.add_layer("sub1", C.Subsampling1D(kernel=2, stride=1, mode="same",
                                        pooling="pnorm", pnorm=2), "c1")
    g.add_layer("tdd", R.TimeDistributedDense(n_out=5, activation="tanh"),
                "sub1")
    g.add_vertex("lts", V.LastTimeStepVertex(mask_input="seq"), "tdd")
    g.add_vertex("dup", V.DuplicateToTimeSeriesVertex(seq_input="seq"),
                 "static")
    g.add_vertex("merge_t", V.MergeVertex(), "tdd", "dup")
    g.add_layer("gp", C.GlobalPooling(pooling="avg"), "merge_t")
    g.add_vertex("subset", V.SubsetVertex(from_index=2, to_index=6), "gp")
    g.add_vertex("stack", V.StackVertex(), "lts", "subset")
    g.add_vertex("un0", V.UnstackVertex(index=0, stack_size=2), "stack")
    g.add_vertex("un1", V.UnstackVertex(index=1, stack_size=2), "stack")
    g.add_vertex("l2", V.L2Vertex(), "un0", "un1")
    # the image side: the stem meets the space-to-depth gate, proj the
    # strided-1x1 one
    g.add_layer("zp", C.ZeroPadding(pad=(1, 1, 1, 1)), "img")
    g.add_layer("stem", C.Convolution2D(n_out=4, kernel=(5, 5),
                                        stride=(2, 2), mode="same",
                                        activation="relu"), "zp")
    g.add_layer("conv", C.Convolution2D(n_out=4, kernel=(3, 3),
                                        mode="same", activation="tanh"),
                "stem")
    g.add_layer("lrn", C.LocalResponseNormalization(n=3, alpha=0.1), "conv")
    g.add_vertex("merge_c", V.MergeVertex(), "lrn", "stem")
    g.add_layer("pool", C.Subsampling(kernel=(3, 3), stride=(2, 2),
                                      pooling="pnorm", pnorm=3), "merge_c")
    g.add_vertex("pv", V.PreprocessorVertex(
        preprocessor=p.P.CnnToFeedForward(4, 4, 8)), "pool")
    g.add_layer("proj", C.Convolution2D(n_out=4, kernel=(1, 1),
                                        stride=(2, 2), has_bias=False,
                                        activation="identity"), "merge_c")
    g.add_layer("gpi", C.GlobalPooling(pooling="sum"), "proj")
    # the index side
    g.add_layer("emb", L.Embedding(n_in=7, n_out=3, activation="identity"),
                "ids")
    g.add_vertex("merge_f", V.MergeVertex(), "l2", "pv", "emb", "un0",
                 "gpi")
    g.add_layer("drop", L.Dropout(dropout=drop), "merge_f")
    g.add_vertex("scale", V.ScaleVertex(factor=0.5), "drop")
    g.add_vertex("l2n", V.L2NormalizeVertex(), "scale")
    g.add_vertex("ew", V.ElementWiseVertex(op="add"), "l2n", "scale")
    g.add_layer("dense", L.Dense(n_out=2, activation="tanh"), "ew")
    g.add_layer("out", L.Output(n_out=3, activation="softmax",
                                loss="mcxent"), "ew")
    g.add_layer("loss", L.LossLayer(loss="mse", activation="identity"),
                "dense")
    return (g.set_outputs("out", "loss")
            .set_input_types(it.recurrent(4, T), it.convolutional(IMG, IMG, 3),
                             it.feed_forward(4), it.feed_forward(1))
            .build())


def _layers_data(seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    seq = rng.normal(size=(B, T, 4)).astype(dtype)
    img = rng.normal(size=(B, IMG, IMG, 3)).astype(dtype)
    static = rng.normal(size=(B, 4)).astype(dtype)
    ids = rng.integers(0, 7, (B, 1)).astype(np.int32)
    mask = np.ones((B, T), dtype)
    mask[1, 4:] = 0.0
    mask[2, 2:] = 0.0
    y1 = np.eye(3, dtype=dtype)[rng.integers(0, 3, B)]
    y2 = rng.normal(size=(B, 2)).astype(dtype)
    return [seq, img, static, ids], [mask, None, None, None], [y1, y2]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a, np.float64)


def _close(got, want, rel, what):
    """Within ``rel`` of want's largest magnitude; NaN where want is NaN
    (an all-masked row's p-norm gradient, in both packages)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    got, want = got[~nan], want[~nan]
    top = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * top, f"{what}: {err:.3e} > {rel * top:.3e}"


def _transplant(jnet, tmp_path, name="g.zip"):
    path = tmp_path / name
    jser.write_computation_graph(jnet, str(path))
    return tser.restore_computation_graph(str(path), device="cpu")


@pytest.fixture
def layers_pair(tmp_path, monkeypatch):
    monkeypatch.delenv("DL4J_TPU_FUSE_BLOCKS", raising=False)
    jnet = JGraph(_layers_graph(JAXP)).init()
    return jnet, _transplant(jnet, tmp_path)


def _jwalk(jnet, feats, fmasks, train=False):
    inputs = {n: jnp.asarray(f) for n, f in zip(jnet.conf.network_inputs,
                                                feats)}
    md = {n: jnp.asarray(m) for n, m in zip(jnet.conf.network_inputs,
                                            fmasks) if m is not None}
    acts, _, masks, _ = jnet._walk(jnet.params, jnet.state, inputs,
                                   train=train, rng=None, fmasks=md)
    return acts, masks


def _twalk(tnet, feats, fmasks, train=False):
    inputs, md = tnet._prepare_inputs(feats, fmasks)
    with torch.no_grad():
        acts, _, masks, _ = tnet._walk(tnet.params, tnet.state, inputs,
                                       train=train, gen=tnet._gen,
                                       fmasks=md)
    return acts, masks


def _jgrads(jnet, feats, fmasks, labels):
    inputs = {n: jnp.asarray(f) for n, f in zip(jnet.conf.network_inputs,
                                                feats)}
    md = {n: jnp.asarray(m) for n, m in zip(jnet.conf.network_inputs,
                                            fmasks) if m is not None}

    def loss(p):
        return jnet._loss(p, jnet.state, inputs,
                          [jnp.asarray(l) for l in labels], md, None,
                          rng=None, train=True)[0]
    val, g = jax.value_and_grad(loss)(jnet.params)
    return float(val), g


def _tgrads(tnet, feats, fmasks, labels):
    leaves = {ln: {k: t.detach().clone().requires_grad_()
                   for k, t in lp.items()}
              for ln, lp in tnet.params.items()}
    loss, _ = tnet._loss(leaves, tnet.state,
                         *tnet._batch(TMDS(feats, labels, fmasks)),
                         gen=tnet._gen)
    keys = [(ln, k) for ln in leaves for k in leaves[ln]]
    gs = torch.autograd.grad(loss, [leaves[ln][k] for ln, k in keys])
    return float(loss.detach()), dict(zip(keys, gs))


# ------------------------------------------------------------ registries
def test_registries_hold_every_jax_type():
    assert set(tvert.VERTEX_REGISTRY) == set(jvert.VERTEX_REGISTRY)
    assert set(tlayers.LAYER_REGISTRY) == set(jlayers.LAYER_REGISTRY)


@pytest.mark.parametrize("vtype", sorted(jvert.VERTEX_REGISTRY))
def test_each_vertex_type_round_trips_key_for_key(vtype):
    cls = jvert.VERTEX_REGISTRY[vtype]
    kw = {"preprocessor": jprep.CnnToFeedForward(4, 4, 8)} \
        if vtype == "preprocessor" else {}
    jv = cls(**kw)
    d = json.loads(json.dumps(jvert.vertex_to_dict(jv)))
    tv = vertex_from_dict(d)
    assert type(tv).__name__ == cls.__name__
    assert tvert.vertex_to_dict(tv) == jvert.vertex_to_dict(jv)
    assert jvert.vertex_from_dict(tvert.vertex_to_dict(tv)) == jv


def test_unknown_vertex_and_layer_types_are_refused_by_name():
    with pytest.raises(ValueError, match="'no_such_vertex'"):
        vertex_from_dict({"vertex_type": "no_such_vertex"})
    with pytest.raises(ValueError, match="'no_such_layer'"):
        layer_from_dict({"layer_type": "no_such_layer"})


def test_layers_graph_json_matches_jax_key_for_key():
    jc, tc = _layers_graph(JAXP), _layers_graph(TORCHP)
    assert tc.to_json() == jc.to_json()
    assert TGraphConf.from_json(jc.to_json()).to_json() == jc.to_json()
    pv = json.loads(tc.to_json())["vertices"]["pv"]["conf"]
    assert pv["vertex_type"] == "preprocessor"
    assert pv["preprocessor"] == {"kind": "cnn_to_ff", "height": 4,
                                  "width": 4, "channels": 8}


# ------------------------------------------------------------ the graph
def test_layers_graph_activations_and_masks_match_jax(layers_pair):
    jnet, tnet = layers_pair
    feats, fmasks, _ = _layers_data()
    jacts, jmasks = _jwalk(jnet, feats, fmasks)
    tacts, tmasks = _twalk(tnet, feats, fmasks)
    assert set(tacts) == set(jacts)
    for name in tnet.topo:
        _close(tacts[name], jacts[name], F64_TOL, f"act {name}")
        jm, tm = jmasks.get(name), tmasks.get(name)
        assert (jm is None) == (tm is None), name
        if jm is not None:
            np.testing.assert_array_equal(_np(tm), _np(jm), err_msg=name)
    for o, j in zip(tnet.output(*feats, masks=fmasks),
                    jnet.output(*feats, masks=fmasks)):
        _close(o, j, F64_TOL, "output")


def test_layers_graph_score_and_gradients_match_jax(layers_pair):
    jnet, tnet = layers_pair
    feats, fmasks, labels = _layers_data(1)
    jl, jg = _jgrads(jnet, feats, fmasks, labels)
    tl, tg = _tgrads(tnet, feats, fmasks, labels)
    assert abs(tl - jl) <= F64_TOL * abs(jl)
    assert set(tg) == {(ln, k) for ln in jg for k in jg[ln]}
    for (ln, k), g in tg.items():
        _close(g, jg[ln][k], F64_TOL, f"grad {ln}.{k}")


def test_layers_graph_steps_match_jax(layers_pair):
    """Two Adam steps: parameters and updater state."""
    jnet, tnet = layers_pair
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
    for seed in (2, 3):
        feats, fmasks, labels = _layers_data(seed)
        js = float(jnet.fit_batch(JMDS(feats, labels, fmasks)))
        ts = float(tnet.fit_batch(TMDS(feats, labels, fmasks)))
        assert abs(ts - js) <= F64_TOL * abs(js)
    for ln, lp in tnet.params.items():
        for k, t in lp.items():
            _close(t, jnet.params[ln][k], F64_TOL, f"param {ln}.{k}")


def test_layers_graph_zip_crosses_both_ways(layers_pair, tmp_path):
    jnet, tnet = layers_pair
    feats, fmasks, _ = _layers_data(4)
    path = tmp_path / "back.zip"
    tser.write_computation_graph(tnet, str(path))
    back = jser.restore_computation_graph(str(path))
    assert back.conf.to_json() == jnet.conf.to_json()
    for o, j in zip(back.output(*feats, masks=fmasks),
                    tnet.output(*feats, masks=fmasks)):
        _close(j, o, F64_TOL, "output after the reverse zip")


@pytest.mark.parametrize("env", ["DL4J_TPU_S2D_STEM", "DL4J_TPU_SLICE_1X1"])
def test_conv_rewrites_take_their_gate_and_match_flags_off(layers_pair,
                                                           monkeypatch, env):
    """Each flag reroutes the conv it gates (seen by a spy) and leaves the
    graph's output and gradients as they were, F64."""
    _, tnet = layers_pair
    feats, fmasks, labels = _layers_data(5)
    monkeypatch.delenv("DL4J_TPU_S2D_STEM", raising=False)
    monkeypatch.delenv("DL4J_TPU_SLICE_1X1", raising=False)
    base_out = tnet.output(*feats, masks=fmasks)
    base_l, base_g = _tgrads(tnet, feats, fmasks, labels)
    fn = {"DL4J_TPU_S2D_STEM": "conv2d_space_to_depth",
          "DL4J_TPU_SLICE_1X1": "conv2d_strided_1x1_as_slice"}[env]
    calls = []
    real = getattr(tops, fn)
    monkeypatch.setattr(tops, fn,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv(env, "1")
    out = tnet.output(*feats, masks=fmasks)
    l, g = _tgrads(tnet, feats, fmasks, labels)
    assert len(calls) == 2      # one eval walk, one training walk
    for a, b in zip(out, base_out):
        _close(a, b, F64_TOL, f"output under {env}")
    assert abs(l - base_l) <= F64_TOL * abs(base_l)
    for key in g:
        _close(g[key], base_g[key], F64_TOL, f"grad {key} under {env}")


# ------------------------------------------------------------ single ops
@pytest.mark.parametrize("case", ["stem_5x5", "stem_7x7_odd", "stem_224"])
def test_space_to_depth_equals_plain_conv_and_jax(case):
    size, k, pads = {"stem_5x5": (13, 5, [(2, 2), (2, 2)]),
                     "stem_7x7_odd": (15, 7, [(3, 3), (2, 4)]),
                     "stem_224": (32, 7, [(2, 3), (2, 3)])}[case]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, size, size + 2, 3))
    w = rng.normal(size=(k, k, 3, 5))
    want = jops.conv2d_space_to_depth(jnp.asarray(x), jnp.asarray(w),
                                      padding=pads)
    tx, tw = torch.tensor(x), torch.tensor(w)
    got = tops.conv2d_space_to_depth(tx, tw, padding=pads)
    plain = tops.conv2d(tx, tw, strides=(2, 2), padding=pads)
    _close(got, want, F64_TOL, "s2d vs JAX")
    _close(got, plain, F64_TOL, "s2d vs plain conv")


@pytest.mark.parametrize("strides", [(2, 2), (2, 1), (3, 3)])
def test_strided_1x1_as_slice_equals_plain_conv_and_jax(strides):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 8, 6))
    w = rng.normal(size=(1, 1, 6, 4))
    want = jops.conv2d_strided_1x1_as_slice(jnp.asarray(x), jnp.asarray(w),
                                            strides=strides)
    tx, tw = torch.tensor(x), torch.tensor(w)
    got = tops.conv2d_strided_1x1_as_slice(tx, tw, strides=strides)
    plain = tops.conv2d(tx, tw, strides=strides, padding=[(0, 0), (0, 0)])
    _close(got, want, F64_TOL, "slice vs JAX")
    _close(got, plain, F64_TOL, "slice vs plain conv")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k,stride,dil,pads", [
    (3, 1, 1, [(1, 1)]), (3, 2, 1, [(0, 0)]), (4, 1, 1, [(1, 2)]),
    (3, 1, 2, [(2, 2)])])
def test_conv1d_forward_and_gradients(dtype, k, stride, dil, pads):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, 5)).astype(dtype)
    w = rng.normal(size=(k, 5, 3)).astype(dtype)

    def jf(x, w):
        return jops.conv1d_xla(x, w, stride=stride, padding=pads,
                               dilation=dil)
    jy = jf(jnp.asarray(x), jnp.asarray(w))
    wts = np.cos(np.arange(jy.size).reshape(jy.shape)).astype(dtype)
    jdx, jdw = jax.grad(lambda x, w: jnp.sum(jf(x, w) * wts),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ty = tops.conv1d(tx, tw, stride=stride, padding=pads, dilation=dil)
    (ty * torch.from_numpy(wts)).sum().backward()
    tol = F32_TOL if dtype == "float32" else F64_TOL
    for name, t, j in (("y", ty, jy), ("dx", tx.grad, jdx),
                       ("dw", tw.grad, jdw)):
        _close(t, j, tol, name)


@pytest.mark.parametrize("n", [5, 4])
def test_lrn_matches_lrn_xla(n):
    """n = 4 is the asymmetric window (n//2 = 2 below, 1 above)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 4, 9)) * 3.0
    g = rng.normal(size=x.shape)
    kw = dict(k=2.0, n=n, alpha=0.1, beta=0.75)
    jy, jvjp = jax.vjp(lambda a: jops.lrn_xla(a, **kw), jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = tops.lrn(tx, **kw)
    ty.backward(torch.tensor(g))
    _close(ty, jy, F64_TOL, "lrn")
    _close(tx.grad, jvjp(jnp.asarray(g))[0], F64_TOL, "lrn dx")


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("geom", ["2x2s2", "3x3s2same"])
def test_pnorm_pool_matches_jax(p, geom):
    kernel, strides, mode = {"2x2s2": ((2, 2), (2, 2), "truncate"),
                             "3x3s2same": ((3, 3), (2, 2), "same")}[geom]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 8, 3))
    g = rng.normal(size=x.shape)
    pads = jops.spatial_padding((7, 8), kernel, strides, (0, 0), mode)
    kw = dict(kernel=kernel, strides=strides, padding=pads, p=p)
    jy, jvjp = jax.vjp(lambda a: jops.pnorm_pool2d_xla(a, **kw),
                       jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = tops.pnorm_pool2d(tx, **kw)
    gy = rng.normal(size=ty.shape)
    ty.backward(torch.tensor(gy))
    _close(ty, jy, F64_TOL, "pnorm pool")
    _close(tx.grad, jvjp(jnp.asarray(gy))[0], F64_TOL, "pnorm pool dx")
    del g


def _layer_pair(jconf, tconf, it_j, it_t):
    pol = dict(param_dtype="float64", compute_dtype="float64")
    jgc = JNNC.builder().dtype(JPolicy(**pol)).build()
    tgc = TNNC.builder().dtype(TPolicy(**pol)).build()
    jl = jconf.replace(name="l").with_n_in(it_j).make_layer(it_j, jgc,
                                                            jgc.dtype)
    tl = tconf.replace(name="l").with_n_in(it_t).make_layer(it_t, tgc,
                                                            tgc.dtype)
    assert tl.output_type.to_dict() == jl.output_type.to_dict()
    return jl, tl


@pytest.mark.parametrize("pooling", ["max", "avg", "pnorm"])
@pytest.mark.parametrize("kind", ["subsampling", "subsampling1d"])
def test_subsampling_layers_match_jax_with_masks(kind, pooling):
    rng = np.random.default_rng(5)
    if kind == "subsampling":
        args = dict(kernel=(2, 2), stride=(2, 2), pooling=pooling, pnorm=3)
        jc, tc = jconv_conf.Subsampling(**args), tconv_conf.Subsampling(**args)
        its = JIT.convolutional(6, 5, 2), TIT.convolutional(6, 5, 2)
        x, mask = rng.normal(size=(2, 6, 5, 2)), None
    else:
        args = dict(kernel=3, stride=2, pooling=pooling, pnorm=3)
        jc, tc = (jconv_conf.Subsampling1D(**args),
                  tconv_conf.Subsampling1D(**args))
        its = JIT.recurrent(4, 9), TIT.recurrent(4, 9)
        x = rng.normal(size=(2, 9, 4))
        mask = np.ones((2, 9))
        mask[1, 5:] = 0.0
    jl, tl = _layer_pair(jc, tc, *its)
    gy = None
    jy, jvjp = jax.vjp(lambda a: jl.apply({}, {}, a)[0], jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty, _ = tl.apply({}, {}, tx)
    gy = rng.normal(size=ty.shape)
    ty.backward(torch.tensor(gy))
    _close(ty, jy, F64_TOL, "y")
    _close(tx.grad, jvjp(jnp.asarray(gy))[0], F64_TOL, "dx")
    if mask is not None:
        np.testing.assert_array_equal(
            _np(tl.feed_forward_mask(torch.tensor(mask))),
            _np(jl.feed_forward_mask(jnp.asarray(mask))))


@pytest.mark.parametrize("mode,stride", [("same", 1), ("truncate", 2)])
def test_convolution1d_layer_matches_jax_with_masks(mode, stride):
    rng = np.random.default_rng(6)
    args = dict(n_out=3, kernel=3, stride=stride, mode=mode, dilation=1,
                activation="tanh")
    jl, tl = _layer_pair(jconv_conf.Convolution1D(**args),
                         tconv_conf.Convolution1D(**args),
                         JIT.recurrent(4, 10), TIT.recurrent(4, 10))
    params = {"W": rng.normal(size=(3, 4, 3)), "b": rng.normal(size=3)}
    x = rng.normal(size=(2, 10, 4))
    mask = np.ones((2, 10))
    mask[0, 6:] = 0.0
    jy, _ = jl.apply({k: jnp.asarray(v) for k, v in params.items()}, {},
                     jnp.asarray(x))
    ty, _ = tl.apply({k: torch.tensor(v) for k, v in params.items()}, {},
                     torch.tensor(x))
    _close(ty, jy, F64_TOL, "conv1d layer")
    np.testing.assert_array_equal(
        _np(tl.feed_forward_mask(torch.tensor(mask))),
        _np(jl.feed_forward_mask(jnp.asarray(mask))))
    assert {k: tuple(v.shape) for k, v in tl.init_params(
        torch.Generator().manual_seed(0), "cpu").items()} == \
        {"W": (3, 4, 3), "b": (3,)}


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_masked_global_pooling_matches_jax(pooling):
    """MaskedReductionUtil semantics, an all-masked row included."""
    rng = np.random.default_rng(7)
    jl, tl = _layer_pair(jconv_conf.GlobalPooling(pooling=pooling, pnorm=3),
                         tconv_conf.GlobalPooling(pooling=pooling, pnorm=3),
                         JIT.recurrent(5, 6), TIT.recurrent(5, 6))
    x = rng.normal(size=(3, 6, 5))
    mask = np.ones((3, 6))
    mask[1, 3:] = 0.0
    mask[2, :] = 0.0
    jy, jvjp = jax.vjp(lambda a: jl.apply({}, {}, a,
                                          mask=jnp.asarray(mask))[0],
                       jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty, _ = tl.apply({}, {}, tx, mask=torch.tensor(mask))
    gy = rng.normal(size=ty.shape)
    ty.backward(torch.tensor(gy))
    _close(ty, jy, F64_TOL, f"{pooling} y")
    _close(tx.grad, jvjp(jnp.asarray(gy))[0], F64_TOL, f"{pooling} dx")


# ------------------------------------------------------------ Embedding
def _embedding_mln(p, n_in, dtype):
    pol = p.pol(param_dtype="float32", compute_dtype=dtype)
    return (p.nnc.builder().seed(2).dtype(pol).list()
            .layer(p.L.Embedding(n_in=n_in, n_out=4, activation="identity"))
            .layer(p.L.Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())


@pytest.mark.parametrize("form", ["int_vector", "int_column",
                                  "float_column", "one_hot"])
def test_embedding_inputs_match_jax(form, tmp_path):
    jnet = JMLN(_embedding_mln(JAXP, 9, "float32")).init()
    path = tmp_path / "e.zip"
    jser.write_model(jnet, str(path))
    tnet = tser.restore_multi_layer_network(str(path), device="cpu")
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 9, 5)
    x = {"int_vector": idx.astype(np.int64),
         "int_column": idx[:, None].astype(np.int32),
         "float_column": idx[:, None].astype(np.float32),
         "one_hot": np.eye(9, dtype=np.float32)[idx]}[form]
    _close(tnet.output(x), jnet.output(x), F32_TOL, form)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    if form != "int_vector":
        js = float(jnet.fit_batch(JDS(x, y)))
        ts = float(tnet.fit_batch(TDS(x, y)))
        assert abs(ts - js) <= F32_TOL * abs(js)
        _close(tnet.params["layer_0"]["W"], jnet.params["layer_0"]["W"],
               F32_TOL, "W after a step")


def test_embedding_indices_stay_integers_under_bf16(tmp_path):
    """Under BF16 an index above 256 would round if it were cast to the
    compute dtype first (513 -> 512); it is not, in either package."""
    jnet = JMLN(_embedding_mln(JAXP, 600, "bfloat16")).init()
    path = tmp_path / "e16.zip"
    jser.write_model(jnet, str(path))
    tnet = tser.restore_multi_layer_network(str(path), device="cpu")
    x = np.array([[513], [511], [257], [599]], np.int32)
    tl, jl = tnet.layers[0], jnet.layers[0]
    got, _ = tl.apply(tnet.params["layer_0"], {}, torch.tensor(x))
    want, _ = jl.apply(jnet.params["layer_0"], {}, jnp.asarray(x))
    W = _np(tnet.params["layer_0"]["W"])
    np.testing.assert_array_equal(_np(got), W[x[:, 0]])
    _close(got, want, 0.0, "bf16 embedding rows")
    assert tl.indices(torch.tensor(x)).dtype == torch.int32
    # through the network: the batch reaches the layer as integers
    np.testing.assert_array_equal(_np(tnet.feed_forward(x)[0]), W[x[:, 0]])
    _close(tnet.feed_forward(x)[0], jnet.feed_forward(x)[0], 0.0,
           "bf16 embedding rows through the net")


def test_embedding_backward_sums_repeated_indices():
    """Rows of a repeated index sum their cotangents (F.embedding's
    backward), as jnp.take's does."""
    jl, tl = _layer_pair(jlayers.Embedding(n_in=5, n_out=3),
                         tlayers.Embedding(n_in=5, n_out=3),
                         JIT.feed_forward(1), TIT.feed_forward(1))
    rng = np.random.default_rng(9)
    W, b = rng.normal(size=(5, 3)), rng.normal(size=3)
    x = np.array([1, 3, 1, 1, 4])
    gy = rng.normal(size=(5, 3))
    jy, jvjp = jax.vjp(lambda W: jl.apply({"W": W, "b": jnp.asarray(b)}, {},
                                          jnp.asarray(x))[0], jnp.asarray(W))
    tW = torch.tensor(W, requires_grad=True)
    ty, _ = tl.apply({"W": tW, "b": torch.tensor(b)}, {}, torch.tensor(x))
    ty.backward(torch.tensor(gy))
    _close(ty, jy, F64_TOL, "y")
    _close(tW.grad, jvjp(jnp.asarray(gy))[0], F64_TOL, "dW")


# ------------------------------------------------------------ Dropout
def test_dropout_layer_draws_from_the_generator_and_scales():
    _, tl = _layer_pair(jlayers.Dropout(dropout=0.25),
                        tlayers.Dropout(dropout=0.25),
                        JIT.feed_forward(8), TIT.feed_forward(8))
    x = torch.ones(4000, 8, dtype=torch.float64)
    assert torch.equal(tl.apply({}, {}, x)[0], x)     # eval: identity
    g1 = torch.Generator().manual_seed(3)
    y, _ = tl.apply({}, {}, x, train=True, gen=g1)
    kept = y != 0
    assert abs(float(kept.double().mean()) - 0.75) < 0.01
    assert torch.all(y[kept] == 1.0 / 0.75)
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(tl.apply({}, {}, x, train=True, gen=g2)[0], y)


# ------------------------------------------------------------ remat
def _remat_graph(p, drop=0.3):
    """in -> d0 (dense, dropout) -> d1 (dense, dropout) -> dbn (batch norm)
    -> out, F32; DL4J_TPU_REMAT=d names d0, d1 and dbn (one span, the
    batch norm's running statistics returned from it)."""
    pol = p.pol(param_dtype="float32", compute_dtype="float32")
    return (p.nnc.builder().seed(5).updater(p.adam(1e-2)).dtype(pol)
            .graph_builder().add_inputs("in")
            .add_layer("d0", p.L.Dense(n_out=16, activation="tanh",
                                       dropout=drop), "in")
            .add_layer("d1", p.L.Dense(n_out=16, activation="relu",
                                       dropout=drop), "d0")
            .add_layer("dbn", p.C.BatchNorm(), "d1")
            .add_layer("out", p.L.Output(n_out=3, activation="softmax",
                                         loss="mcxent"), "dbn")
            .set_outputs("out").set_input_types(p.it.feed_forward(6))
            .build())


def _grads_and_state(net, batch):
    gen_state = net._gen.get_state()
    leaves = {ln: {k: t.detach().clone().requires_grad_()
                   for k, t in lp.items()}
              for ln, lp in net.params.items()}
    loss, new_state = net._loss(leaves, net.state, *batch, gen=net._gen)
    keys = [(ln, k) for ln in leaves for k in leaves[ln]]
    gs = torch.autograd.grad(loss, [leaves[ln][k] for ln, k in keys])
    net._gen.set_state(gen_state)
    return loss.detach(), dict(zip(keys, gs)), new_state


@pytest.mark.parametrize("kind", ["graph", "mln"])
def test_remat_gradients_are_bit_equal_with_dropout_in_the_span(
        kind, monkeypatch):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(12, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
    if kind == "graph":
        net = TGraph(_remat_graph(TORCHP), device="cpu").init()
        batch = net._batch(TMDS([x], [y]))
        prefixes, span = "d", ["d0", "d1", "dbn"]
    else:
        conf = (TNNC.builder().seed(5).updater(TORCHP.adam(1e-2))
                .dtype(TPolicy(param_dtype="float32",
                               compute_dtype="float32")).list()
                .layer(tlayers.Dense(n_out=16, activation="tanh",
                                     dropout=0.3))
                .layer(tlayers.Dense(n_out=16, activation="relu",
                                     dropout=0.3))
                .layer(tconv_conf.BatchNorm())
                .layer(tlayers.Output(n_out=3, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(TIT.feed_forward(6)).build())
        net = TMLN(conf, device="cpu").init()
        batch = net._batch(TDS(x, y))
        prefixes, span = "layer_", None
    monkeypatch.delenv("DL4J_TPU_REMAT", raising=False)
    base_loss, base_g, base_state = _grads_and_state(net, batch)
    spans_seen = []
    real = remat.run_span
    monkeypatch.setattr(remat, "run_span",
                        lambda fn, *a: spans_seen.append(1) or real(fn, *a))
    monkeypatch.setenv("DL4J_TPU_REMAT", prefixes)
    loss, g, state = _grads_and_state(net, batch)
    assert spans_seen == [1]
    if span is not None:
        assert net._remat_spans(remat.active(net), {"out"}) == {"d0": span}
    else:
        assert net._remat_spans(3) == {0: 3}
    assert torch.equal(loss, base_loss)
    for key in base_g:
        assert torch.equal(g[key], base_g[key]), key
    for ln in base_state:
        for k in base_state[ln]:
            assert torch.equal(state[ln][k], base_state[ln][k]), (ln, k)


def test_remat_steps_match_unremat_steps_bit_for_bit(monkeypatch):
    """Three fit_batch steps of the dropout graph with and without remat,
    from one parameter set and one generator state."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(12, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
    nets = []
    for env in ("", "d"):
        monkeypatch.setenv("DL4J_TPU_REMAT", env)
        net = TGraph(_remat_graph(TORCHP), device="cpu").init()
        for _ in range(3):
            net.fit_batch(TMDS([x], [y]))
        assert net.remat_prefixes == ((env,) if env else ())
        nets.append(net)
    for ln, lp in nets[0].params.items():
        for k, t in lp.items():
            assert torch.equal(t, nets[1].params[ln][k]), (ln, k)
    for ln, s in nets[0].state.items():
        for k, t in s.items():
            assert torch.equal(t, nets[1].state[ln][k]), (ln, k)


def _train_remat_graph(remat_prefixes, seed, steps=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(12, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
    net = TGraph(_remat_graph(TORCHP), device="cpu").init()
    net.remat_prefixes = remat_prefixes
    for _ in range(steps):
        net.fit_batch(TMDS([x], [y]))
    return net


def _assert_same_params(a, b):
    for ln, lp in a.params.items():
        for k, t in lp.items():
            assert torch.equal(t, b.params[ln][k]), (ln, k)


def test_remat_nets_in_two_threads_match_their_single_threaded_runs():
    """Two dropout graphs train at once in two threads, one with a remat
    span: each ends bit-equal to its run alone."""
    import threading
    want = [_train_remat_graph(("d",), 12), _train_remat_graph((), 13)]
    got = [None, None]

    def train(i, prefixes, seed):
        got[i] = _train_remat_graph(prefixes, seed, steps=3)

    threads = [threading.Thread(target=train, args=(0, ("d",), 12), daemon=True),
               threading.Thread(target=train, args=(1, (), 13), daemon=True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a training thread hung"
    for g, w in zip(got, want):
        _assert_same_params(g, w)


def test_a_span_open_in_one_thread_leaves_another_threads_dropout_alone():
    """A span pauses mid-forward and mid-recompute while another thread
    trains a dropout graph: the graph ends bit-equal to its run alone
    (its masks neither go onto the span's tape nor come from it), and the
    span's gradient equals the same function's without remat."""
    import threading
    want = _train_remat_graph((), 14, steps=2)
    paused = [threading.Event(), threading.Event()]
    resume = [threading.Event(), threading.Event()]
    calls = []
    x = torch.from_numpy(np.random.default_rng(15).normal(size=(5, 7))
                         .astype(np.float32))

    def body(gen, pause):
        def fn(v):
            m1 = remat.keep_mask(v.shape, 0.7, gen, v.device)
            if pause:
                k = len(calls)
                calls.append(k)
                paused[k].set()
                assert resume[k].wait(60)
            m2 = remat.keep_mask(v.shape, 0.7, gen, v.device)
            return (torch.tanh(v * m1) * m2).sum()
        return fn

    def grad(span, pause):
        gen = torch.Generator().manual_seed(16)
        v = x.clone().requires_grad_()
        fn = body(gen, pause)
        out = remat.run_span(fn, v) if span else fn(v)
        return torch.autograd.grad(out, v)[0]

    got = {}

    def other():
        net = TGraph(_remat_graph(TORCHP), device="cpu").init()
        net.remat_prefixes = ()
        rng = np.random.default_rng(14)
        xb = rng.normal(size=(12, 6)).astype(np.float32)
        yb = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
        for k in range(2):     # one step in the forward, one in the recompute
            assert paused[k].wait(60)
            net.fit_batch(TMDS([xb], [yb]))
            resume[k].set()
        got["net"] = net

    t = threading.Thread(target=other, daemon=True)
    t.start()
    span_grad = grad(True, True)
    t.join(timeout=300)
    assert not t.is_alive(), "the other training thread hung"
    assert calls == [0, 1]
    assert torch.equal(span_grad, grad(False, False))
    _assert_same_params(got["net"], want)


@pytest.mark.parametrize("name,prefixes", [
    ("layer_1", ("layer_1$",)), ("layer_10", ("layer_1$",)),
    ("layer_10", ("layer_1",)), ("s0b0_conv", ("s0b",)),
    ("s1b0_conv", ("s0b",)), ("x", ()), ("d0", ("a", "d0$"))])
def test_remat_prefix_matching_matches_jax(name, prefixes):
    assert remat.match(name, prefixes) == _remat_match(name, prefixes)


def test_remat_is_read_once_and_warns_on_change(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_REMAT", "d0$, d1 ,")
    net = TGraph(_remat_graph(TORCHP, drop=None), device="cpu").init()
    assert net.remat_prefixes is None
    net.fit_batch(TMDS([np.zeros((4, 6), np.float32)],
                       [np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]]))
    assert net.remat_prefixes == ("d0$", "d1")
    monkeypatch.setenv("DL4J_TPU_REMAT", "other")
    with pytest.warns(RuntimeWarning, match="DL4J_TPU_REMAT changed"):
        net.fit_batch(TMDS([np.zeros((4, 6), np.float32)],
                           [np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]]))
    assert net.remat_prefixes == ("d0$", "d1")


def test_remat_spans_are_empty_where_fusion_plans_exist(monkeypatch):
    """As in the JAX package: a graph with fused tails takes no span."""
    from deeplearning4j_tpu_torch import zoo
    monkeypatch.setenv("DL4J_TPU_FUSE_BLOCKS", "1")
    monkeypatch.setenv("DL4J_TPU_REMAT", "s0b,s1b,s2b,s3b")
    net = zoo.resnet50(image_size=32, n_classes=10, device="cpu",
                       dtype=zoo.F32)
    assert len(net._fusion_plans) == 13
    seen = []
    monkeypatch.setattr(net, "_remat_spans",
                        lambda *a: seen.append(a) or {})
    x = torch.zeros(2, 32, 32, 3)
    with torch.no_grad():
        net._walk(net.params, net.state, {"img": x}, train=True,
                  gen=net._gen)
    assert seen == []
    monkeypatch.setenv("DL4J_TPU_FUSE_BLOCKS", "0")
    plain = zoo.resnet50(image_size=32, n_classes=10, device="cpu",
                         dtype=zoo.F32)
    spans = plain._remat_spans(remat.active(plain), {"fc"})
    blocks = [n for n in plain.topo if n.startswith(("s0b", "s1b", "s2b",
                                                     "s3b"))]
    assert list(spans.values()) == [blocks]   # one span: all 16 blocks


# ------------------------------------------------------------ MLN heads
def _mln(p, case):
    """F64 stacks ending in the new layer types: an embedding into a
    LossLayer head, and Convolution1D -> Subsampling1D ->
    TimeDistributedDense -> RnnOutput over a masked time series."""
    pol = p.pol(param_dtype="float64", compute_dtype="float64")
    b = p.nnc.builder().seed(4).updater(p.adam(1e-2)).dtype(pol).list()
    if case == "embedding_loss":
        b = (b.layer(p.L.Embedding(n_in=9, n_out=5, activation="tanh"))
             .layer(p.L.Dense(n_out=3, activation="identity"))
             .layer(p.L.LossLayer(loss="mse", activation="identity"))
             .set_input_type(p.it.feed_forward(1)))
    else:
        b = (b.layer(p.C.Convolution1D(n_out=5, kernel=3, mode="same",
                                       activation="tanh"))
             .layer(p.C.Subsampling1D(kernel=2, stride=1, mode="same",
                                      pooling="avg"))
             .layer(p.R.TimeDistributedDense(n_out=4, activation="relu"))
             .layer(p.R.RnnOutput(n_out=3, activation="softmax",
                                  loss="mcxent"))
             .set_input_type(p.it.recurrent(4, 7)))
    return b.build()


@pytest.mark.parametrize("case", ["embedding_loss", "conv1d_tdd_masked"])
def test_mln_with_the_new_layer_types_matches_jax(case, tmp_path):
    """Score, every gradient and two Adam steps, F64."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    jnet = JMLN(_mln(JAXP, case)).init()
    path = tmp_path / "mln.zip"
    jser.write_model(jnet, str(path))
    tnet = tser.restore_multi_layer_network(str(path), device="cpu")
    assert tnet.conf.to_json() == jnet.conf.to_json()
    rng = np.random.default_rng(12)
    if case == "embedding_loss":
        x = rng.integers(0, 9, (6, 1)).astype(np.int32)
        y, m = rng.normal(size=(6, 3)), None
    else:
        x = rng.normal(size=(6, 7, 4))
        y = np.eye(3)[rng.integers(0, 3, (6, 7))]
        m = np.ones((6, 7))
        m[2, 4:] = 0.0

    def jloss(params):
        return jnet._loss(params, jnet.state, jnp.asarray(x), jnp.asarray(y),
                          None if m is None else jnp.asarray(m),
                          None if m is None else jnp.asarray(m), rng=None)[0]
    jl, jg = jax.value_and_grad(jloss)(jnet.params)
    leaves = {ln: {k: t.detach().clone().requires_grad_()
                   for k, t in lp.items()} for ln, lp in tnet.params.items()}
    tl, _ = tnet._loss(leaves, tnet.state, *tnet._batch(TDS(x, y, m, m)),
                       gen=tnet._gen)
    assert abs(float(tl.detach()) - float(jl)) <= F64_TOL * abs(float(jl))
    keys = [(ln, k) for ln in leaves for k in leaves[ln]]
    tg = torch.autograd.grad(tl, [leaves[ln][k] for ln, k in keys])
    for (ln, k), g in zip(keys, tg):
        _close(g, jg[ln][k], F64_TOL, f"grad {ln}.{k}")
    for _ in range(2):
        jnet.fit_batch(JDS(x, y, m, m))
        tnet.fit_batch(TDS(x, y, m, m))
    for ln, lp in tnet.params.items():
        for k, t in lp.items():
            _close(t, jnet.params[ln][k], F64_TOL, f"param {ln}.{k}")
