"""The port's transfer learning and frozen layers (deeplearning4j_tpu_torch/
nn/transferlearning.py, nn/conf/layers_pretrain.py's ``Frozen``,
nn/layers/pretrain.py's ``FrozenLayerWrapper``) on the CPU, F32.

Against the JAX package on a zip-transplanted base net (6 -> 8 relu "feat"
-> 8 relu "mid" -> 3 softmax "out", trained 8 steps in the JAX package):

- for each builder recipe (freeze and fine-tune, replace the output,
  ``n_out_replace``, ``remove_layers_from`` + ``add_layer``), the new
  configuration's JSON is the JAX package's; retained weights are the
  base's bit for bit; with the re-initialized layers carried over from
  the JAX package's new net, the outputs agree to 1e-6;
- five SGD steps of the frozen net: frozen parameters bit-unchanged in
  both, the trained ones equal to 1e-6 (the same f32 steps in another
  order; the port computes no gradient for the frozen layers, the JAX
  package computes and discards it); batch-norm running statistics of a
  frozen layer move as the JAX package's do;
- the zip carries a frozen net both ways;
- ``TransferLearningHelper``: features to 1e-6, the tail's configuration
  JSON exactly, ``copy_back``.

On the port alone: a frozen layer's leaves reach autograd without
``requires_grad`` (and a frozen step counts fewer FLOPs), the
multi-tensor update leaves a ``NoOp`` group untouched eagerly, through
``fit_batch_repeated`` and under loss scaling, and on a graph.
"""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.conf.layers_conv import BatchNorm as JBatchNorm
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import transferlearning as jtl
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.nn.updater import Sgd as JSgd
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import multistep
from deeplearning4j_tpu_torch.nn import transferlearning as ttl
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.core import (DtypePolicy,
                                                   MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.conf.layers_pretrain import Frozen
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.pretrain import FrozenLayerWrapper
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, NoOp, Sgd
from deeplearning4j_tpu_torch.utils import serialization as tser

F32J = JDtypePolicy(param_dtype="float32", compute_dtype="float32")
F32 = DtypePolicy(param_dtype="float32", compute_dtype="float32")


def blobs(n=256, seed=0, classes=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 2, (classes, 6))
    idx = rng.integers(0, classes, n)
    x = (centers[idx] + rng.normal(0, 0.5, (n, 6))).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[idx]


def jax_base(bn=False):
    b = (JNNC.builder().seed(7).updater(JAdam(1e-2)).dtype(F32J).list()
         .layer(JDense(n_in=6, n_out=8, activation="relu", name="feat")))
    if bn:
        b = b.layer(JBatchNorm(activation="identity", name="bn"))
    conf = (b.layer(JDense(n_out=8, activation="relu", name="mid"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent",
                           name="out"))
            .build())
    net = JMLN(conf).init()
    x, y = blobs()
    for i in range(8):
        net.fit_batch(JDataSet(x[32 * i:32 * (i + 1)], y[32 * i:32 * (i + 1)]))
    return net


def transplant_mln(tmp_path, jnet, name="net.zip"):
    path = str(tmp_path / name)
    jser.write_model(jnet, path)
    return tser.restore_multi_layer_network(path, device="cpu")


def recipe(mod, name, builder):
    """The same builder calls on either package's builder."""
    if name == "freeze_and_fine_tune":
        return (builder.fine_tune_configuration(
            mod.FineTuneConfiguration(updater=(JSgd if mod is jtl
                                               else Sgd)(0.5)))
            .set_feature_extractor("mid"))
    if name == "replace_output":
        out = JOutput if mod is jtl else Output
        return (builder.set_feature_extractor("feat").remove_output_layer()
                .add_layer(out(n_in=8, n_out=5, activation="softmax",
                               loss="mcxent", name="new_out")))
    if name == "n_out_replace":
        return builder.n_out_replace("mid", 12)
    if name == "remove_layers_from":
        dense, out = (JDense, JOutput) if mod is jtl else (Dense, Output)
        return (builder.set_feature_extractor(0).remove_layers_from("mid")
                .add_layer(dense(n_in=8, n_out=4, activation="tanh",
                                 name="mid2"))
                .add_layer(out(n_in=4, n_out=3, activation="softmax",
                               loss="mcxent", name="out2")))
    raise ValueError(name)


RECIPES = ["freeze_and_fine_tune", "replace_output", "n_out_replace",
           "remove_layers_from"]
KEPT = {"freeze_and_fine_tune": ("feat", "mid", "out"),
        "replace_output": ("feat", "mid"),
        "n_out_replace": ("feat",),
        "remove_layers_from": ("feat",)}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.mark.parametrize("name", RECIPES)
def test_builder_matches_the_jax_package(tmp_path, name):
    jnet = jax_base()
    tnet = transplant_mln(tmp_path, jnet)
    jnew = recipe(jtl, name, jtl.TransferLearning.Builder(jnet)).build()
    tnew = recipe(ttl, name, ttl.TransferLearning.Builder(tnet)).build()
    assert json.loads(tnew.conf.to_json()) == json.loads(jnew.conf.to_json())
    assert tnew.device == tnet.device
    for layer in KEPT[name]:
        for k, v in tnet.params[layer].items():
            assert torch.equal(tnew.params[layer][k], v), (layer, k)
            assert tnew.params[layer][k] is not v
            np.testing.assert_array_equal(_np(tnew.params[layer][k]),
                                          _np(jnew.params[layer][k]))
    # the layers initialized afresh, carried over from the JAX package's
    # new net: the two nets compute the same function
    jnew_t = transplant_mln(tmp_path, jnew, "new.zip")
    for layer, sub in jnew_t.params.items():
        if layer not in KEPT[name]:
            tnew.params[layer] = sub
    x, _ = blobs(16, seed=3)
    np.testing.assert_allclose(_np(tnew.output(x)), _np(jnew.output(x)),
                               atol=1e-6)


def test_frozen_steps_match_the_jax_package(tmp_path):
    jnet = jax_base()
    tnet = transplant_mln(tmp_path, jnet)
    name = "freeze_and_fine_tune"
    jnew = recipe(jtl, name, jtl.TransferLearning.Builder(jnet)).build()
    tnew = recipe(ttl, name, ttl.TransferLearning.Builder(tnet)).build()
    assert [type(l).__name__ for l in tnew.layers] == [
        "FrozenLayerWrapper", "FrozenLayerWrapper", "OutputLayer"]
    assert tnew.opt_state["feat"] == {} and tnew.opt_state["mid"] == {}
    frozen = {n: {k: v.clone() for k, v in tnew.params[n].items()}
              for n in ("feat", "mid")}
    out0 = tnew.params["out"]["W"].clone()
    x, y = blobs(64, seed=4)
    for _ in range(5):
        jnew.fit_batch(JDataSet(x, y))
        tnew.fit_batch(DataSet(x, y))
    for n, sub in frozen.items():
        for k, v in sub.items():
            assert torch.equal(tnew.params[n][k], v), (n, k)
            np.testing.assert_array_equal(_np(jnew.params[n][k]), _np(v))
    assert not torch.equal(tnew.params["out"]["W"], out0)
    for k, v in jnew.params["out"].items():
        np.testing.assert_allclose(_np(tnew.params["out"][k]), _np(v),
                                   atol=1e-6)


def test_frozen_batch_norm_statistics_still_move(tmp_path):
    jnet = jax_base(bn=True)
    tnet = transplant_mln(tmp_path, jnet)
    jnew = jtl.TransferLearning.Builder(jnet).set_feature_extractor(
        "bn").build()
    tnew = ttl.TransferLearning.Builder(tnet).set_feature_extractor(
        "bn").build()
    bn0 = {k: v.clone() for k, v in tnew.params["bn"].items()}
    st0 = {k: v.clone() for k, v in tnew.state["bn"].items()}
    x, y = blobs(64, seed=5)
    for _ in range(3):
        jnew.fit_batch(JDataSet(x, y))
        tnew.fit_batch(DataSet(x, y))
    for k, v in bn0.items():
        assert torch.equal(tnew.params["bn"][k], v), k
    assert any(not torch.equal(tnew.state["bn"][k], v)
               for k, v in st0.items())
    for k, v in jnew.state["bn"].items():
        np.testing.assert_allclose(_np(tnew.state["bn"][k]), _np(v),
                                   atol=1e-6)


def test_zip_carries_a_frozen_net_both_ways(tmp_path):
    jnet = jax_base()
    tnet = transplant_mln(tmp_path, jnet)
    tnew = ttl.TransferLearning.Builder(tnet).set_feature_extractor(
        "mid").build()
    path = str(tmp_path / "frozen_port.zip")
    tser.write_model(tnew, path)
    jback = jser.restore_multi_layer_network(path)
    assert [l.conf.layer_type for l in jback.layers[:2]] == ["frozen"] * 2
    x, _ = blobs(8, seed=6)
    np.testing.assert_allclose(_np(jback.output(x)), _np(tnew.output(x)),
                               atol=1e-6)
    jnew = jtl.TransferLearning.Builder(jnet).set_feature_extractor(
        "feat").build()
    tback = transplant_mln(tmp_path, jnew, "frozen_jax.zip")
    assert isinstance(tback.layers[0], FrozenLayerWrapper)
    assert not isinstance(tback.layers[1], FrozenLayerWrapper)
    np.testing.assert_allclose(_np(tback.output(x)), _np(jnew.output(x)),
                               atol=1e-6)


def test_frozen_json_round_trip():
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(0.1))
            .dtype(F32).list()
            .layer(Frozen(inner=Dense(n_in=4, n_out=3, activation="tanh"),
                          name="f0"))
            .layer(Output(n_in=3, n_out=2, activation="softmax",
                          loss="mcxent"))
            .build())
    restored = MultiLayerConfiguration.from_json(conf.to_json())
    assert restored.layers[0].layer_type == "frozen"
    assert restored.layers[0].inner.n_out == 3
    net = MultiLayerNetwork(restored, device="cpu").init()
    assert tuple(net.output(np.zeros((2, 4), np.float32)).shape) == (2, 2)
    renamed = restored.layers[0].replace(name="g")
    assert renamed.inner.name == "g"


def test_helper_matches_the_jax_package(tmp_path):
    jnet = jax_base()
    tnet = transplant_mln(tmp_path, jnet)
    jh = jtl.TransferLearningHelper(jnet, "mid")
    th = ttl.TransferLearningHelper(tnet, "mid")
    x, y = blobs(64, seed=7)
    jf, tf = jh.featurize(JDataSet(x, y)), th.featurize(DataSet(x, y))
    np.testing.assert_allclose(_np(tf.features), _np(jf.features),
                               atol=1e-6)
    jtail, ttail = jh.unfrozen_net(), th.unfrozen_net()
    assert json.loads(ttail.conf.to_json()) == \
        json.loads(jtail.conf.to_json())
    np.testing.assert_allclose(_np(ttail.output(tf.features[:8])),
                               _np(tnet.output(x[:8])), rtol=1e-6)
    s0 = tnet.score(DataSet(x, y))
    feats = DataSet(_np(tf.features), y)
    for _ in range(10):
        ttail.fit_batch(feats)
    th.copy_back(ttail)
    assert torch.equal(tnet.params["out"]["W"], ttail.params["out"]["W"])
    assert tnet.score(DataSet(x, y)) <= s0 + 1e-6


# ----------------------------------------------------------- the port alone
def port_net(updater=None, policy=F32):
    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater(updater or Adam(1e-2)).dtype(policy).list()
            .layer(Dense(n_in=6, n_out=8, activation="relu", name="feat"))
            .layer(Dense(n_out=8, activation="relu", name="mid"))
            .layer(Output(n_out=3, activation="softmax", loss="mcxent",
                          name="out"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_frozen_leaves_get_no_gradient_and_fewer_flops():
    base = port_net()
    new = ttl.TransferLearning.Builder(base).set_feature_extractor(
        "mid").build()
    assert multistep.frozen_layers(new) == {"feat", "mid"}
    leaves = multistep.step_leaves(new)
    assert not any(t.requires_grad for t in leaves["feat"].values())
    assert not any(t.requires_grad for t in leaves["mid"].values())
    assert all(t.requires_grad for t in leaves["out"].values())
    assert leaves["feat"]["W"].data_ptr() == new.params["feat"]["W"].data_ptr()
    x, y = blobs(32, seed=8)
    ds = DataSet(x, y)
    assert new.step_cost_analysis(ds)["flops"] < \
        base.step_cost_analysis(ds)["flops"]


@pytest.mark.parametrize("how", ["fit_batch", "fit_batch_repeated",
                                 "loss_scaled"])
def test_update_leaves_the_frozen_group_untouched(how):
    policy = (DtypePolicy(param_dtype="float32", compute_dtype="float32",
                          loss_scale="dynamic")
              if how == "loss_scaled" else F32)
    new = ttl.TransferLearning.Builder(port_net(policy=policy)
                                       ).set_feature_extractor(0).build()
    before = {n: {k: v.clone() for k, v in sub.items()}
              for n, sub in new.params.items()}
    x, y = blobs(32, seed=9)
    ds = DataSet(x, y)
    if how == "fit_batch_repeated":
        new.fit_batch_repeated(ds, 4)
    else:
        for _ in range(4):
            new.fit_batch(ds)
    for k, v in before["feat"].items():
        assert torch.equal(new.params["feat"][k], v), k
    for n in ("mid", "out"):
        assert not torch.equal(new.params[n]["W"], before[n]["W"]), n
    assert int(new.opt_state["mid"]["t"]) == 4


def test_a_noop_layer_on_a_graph_is_left_alone():
    g = (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2))
         .dtype(F32).graph_builder().add_inputs("in")
         .add_layer("d", Dense(n_in=6, n_out=8, activation="tanh",
                               updater=NoOp()), "in")
         .add_layer("out", Output(n_out=3, activation="softmax",
                                  loss="mcxent"), "d")
         .set_outputs("out").build())
    net = ComputationGraph(g, device="cpu").init()
    d0 = {k: v.clone() for k, v in net.params["d"].items()}
    o0 = net.params["out"]["W"].clone()
    x, y = blobs(32, seed=10)
    for _ in range(3):
        net.fit_batch(MultiDataSet([x], [y]))
    for k, v in d0.items():
        assert torch.equal(net.params["d"][k], v)
    assert not torch.equal(net.params["out"]["W"], o0)
