"""The port's numeric gradient checks (deeplearning4j_tpu_torch/utils/
gradient_check.py) on the CPU, in F64.

Against the JAX package (deeplearning4j_tpu/utils/gradient_check.py) on
zip-transplanted F64 nets and the same seed: the same ``GradCheckResult``
counts (entries checked, failures), the same sampled entries (a loss
whose analytic gradient is planted wrong in both packages fails on every
checked entry, so the two failure lists name the same (parameter, index)
pairs in the same order), and the largest relative error within 1e-6 of
each other's (each side's central differences in its own f64 order).

On the port alone, the counterparts of tests/test_gradient_check.py (each
activation, loss and regularization passes; the checker catches a wrong
gradient), and a conv/BN/dense net (the net ``[gradcheck]`` runs on the
card) and a ComputationGraph pass.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.conf.layers_conv import BatchNorm as JBatchNorm
from deeplearning4j_tpu.nn.conf.layers_conv import (
    Convolution2D as JConvolution2D)
from deeplearning4j_tpu.nn.conf.layers_conv import Subsampling as JSubsampling
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Sgd as JSgd
from deeplearning4j_tpu.utils import gradient_check as jgc
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Sgd
from deeplearning4j_tpu_torch.utils import gradient_check as tgc
from deeplearning4j_tpu_torch.utils import serialization as tser

F64 = DtypePolicy(param_dtype="float64", compute_dtype="float64")
F64J = JDtypePolicy(param_dtype="float64", compute_dtype="float64")


def small_ds(out_dim=3, n=8, dim=5, onehot=True, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim))
    if onehot:
        y = np.eye(out_dim)[rng.integers(0, out_dim, n)]
    else:
        y = rng.normal(size=(n, out_dim))
    return DataSet(x, y)


def mlp(activation, loss, out_activation, out_dim=3, dim=5, l1=0.0, l2=0.0):
    conf = (NeuralNetConfiguration.builder()
            .seed(42).updater(Sgd(0.1)).dtype(F64).l1(l1).l2(l2).list()
            .layer(Dense(n_in=dim, n_out=6, activation=activation))
            .layer(Output(n_out=out_dim, activation=out_activation,
                          loss=loss))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.mark.parametrize("activation", [
    "tanh", "sigmoid", "relu", "elu", "softplus", "hardtanh", "cube",
    "softsign", "leakyrelu", "selu", "gelu", "rationaltanh",
])
def test_dense_gradients_by_activation(activation):
    res = tgc.check_network_gradients(mlp(activation, "mcxent", "softmax"),
                                      small_ds())
    assert res.passed, res.failures[:5]


@pytest.mark.parametrize("loss,out_act,onehot", [
    ("mcxent", "softmax", True),
    ("negativeloglikelihood", "softmax", True),
    ("mse", "identity", False),
    ("l2", "identity", False),
    ("l1", "tanh", False),
    ("mae", "identity", False),
    ("xent", "sigmoid", True),
    ("kldivergence", "softmax", True),
    ("poisson", "softplus", True),
    ("squaredhinge", "identity", True),
])
def test_output_gradients_by_loss(loss, out_act, onehot):
    res = tgc.check_network_gradients(mlp("tanh", loss, out_act),
                                      small_ds(onehot=onehot))
    assert res.passed, res.failures[:5]


@pytest.mark.parametrize("l1,l2", [(0.0, 0.3), (0.2, 0.0), (0.1, 0.2)])
def test_gradients_with_regularization(l1, l2):
    res = tgc.check_network_gradients(
        mlp("tanh", "mcxent", "softmax", l1=l1, l2=l2), small_ds())
    assert res.passed, res.failures[:5]


def test_gradient_check_catches_wrong_gradient():
    params = {"w": torch.arange(1.0, 4.0, dtype=torch.float64)}

    def loss(p):
        return (p["w"] * p["w"]).sum()

    assert tgc.gradient_check_fn(loss, params).passed
    res = tgc.gradient_check_fn(loss, params,
                                grad_fn=lambda p: {"w": 3.0 * p["w"]})
    assert not res.passed and res.total_failed == 3


# ------------------------------------------------------- against the JAX one
def jax_mlp():
    conf = (JNNC.builder().seed(42).updater(JSgd(0.1)).dtype(F64J).list()
            .layer(JDense(n_in=5, n_out=40, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return JMLN(conf).init()


def jax_conv_net():
    """conv 3x3 (4 maps) -> BN relu -> max-pool -> dense -> softmax on
    6 x 6 x 2 inputs: every layer kind with an F64 route on the card."""
    conf = (JNNC.builder().seed(11).updater(JSgd(0.1)).dtype(F64J).list()
            .layer(JConvolution2D(n_out=4, kernel=(3, 3),
                                  activation="identity"))
            .layer(JBatchNorm(activation="relu"))
            .layer(JSubsampling(pooling="max", kernel=(2, 2),
                                stride=(2, 2)))
            .layer(JDense(n_out=5, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.convolutional(6, 6, 2)).build())
    return JMLN(conf).init()


def conv_ds(n=6, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 6, 6, 2)),
            np.eye(3)[rng.integers(0, 3, n)])


def transplant(tmp_path, jnet):
    path = str(tmp_path / "net.zip")
    jser.write_model(jnet, path)
    return tser.restore_multi_layer_network(path, device="cpu")


@pytest.mark.parametrize("which", ["mlp", "conv_bn"])
def test_counts_and_errors_match_the_jax_package(tmp_path, which):
    jnet = jax_mlp() if which == "mlp" else jax_conv_net()
    tnet = transplant(tmp_path, jnet)
    if which == "mlp":
        ds = small_ds()
        x, y = ds.features, ds.labels
    else:
        x, y = conv_ds()
    jr = jgc.check_network_gradients(jnet, JDataSet(x, y),
                                     sample_per_leaf=24, seed=5)
    tr = tgc.check_network_gradients(tnet, DataSet(x, y),
                                     sample_per_leaf=24, seed=5)
    assert (tr.total_checked, tr.total_failed) == (jr.total_checked,
                                                   jr.total_failed)
    assert tr.passed and jr.passed
    assert abs(tr.max_rel_error - jr.max_rel_error) < 1e-6


def test_the_same_seed_checks_the_same_entries(tmp_path):
    """A wrong analytic gradient, planted alike in both packages (the
    true loss plus |p|^2 whose gradient is kept and value cancelled),
    fails every checked entry away from 0 (the zero-initialized biases
    pass): both failure lists name the same entries in the same
    order."""
    jnet = jax_mlp()
    tnet = transplant(tmp_path, jnet)
    ds = small_ds()

    def jloss(p):
        loss, _ = jnet._loss(p, jnet.state, jnp.asarray(ds.features),
                             jnp.asarray(ds.labels), None, None, rng=None,
                             train=True)
        sq = sum(jnp.sum(l * l) for l in jax.tree_util.tree_leaves(p))
        return loss + sq - jax.lax.stop_gradient(sq)

    batch = tnet._step_batch(ds)

    def tloss(p):
        loss, _ = tnet._loss(p, tnet.state, *batch, gen=None, train=True)
        sq = sum((l * l).sum() for l in (p[n][k] for n in sorted(p)
                                         for k in sorted(p[n])))
        return loss + sq - sq.detach()

    jr = jgc.gradient_check_fn(jloss, jnet.params, sample_per_leaf=16,
                               seed=9)
    tr = tgc.gradient_check_fn(tloss, tnet.params, sample_per_leaf=16,
                               seed=9)
    assert tr.total_checked == jr.total_checked
    assert tr.total_failed == jr.total_failed > 0
    assert [(f["param"], f["index"]) for f in tr.failures] == \
        [(f["param"], f["index"]) for f in jr.failures]
    for a, b in zip(tr.failures, jr.failures):
        assert a["analytic"] == pytest.approx(b["analytic"], rel=1e-9)


def test_a_computation_graph_passes():
    g = (NeuralNetConfiguration.builder().seed(5).updater(Sgd(0.1))
         .dtype(F64).graph_builder().add_inputs("in")
         .add_layer("d", Dense(n_in=5, n_out=6, activation="tanh"), "in")
         .add_layer("out", Output(n_out=3, activation="softmax",
                                  loss="mcxent"), "d")
         .set_outputs("out").build())
    net = ComputationGraph(g, device="cpu").init()
    ds = small_ds()
    res = tgc.check_network_gradients(net, MultiDataSet([ds.features],
                                                        [ds.labels]))
    assert res.passed and res.total_checked == 5 * 6 + 6 + 6 * 3 + 3
