"""The port's pretrain-family layers (deeplearning4j_tpu_torch/nn/conf/
layers_pretrain.py, nn/layers/{pretrain,variational}.py), ``pretrain`` and
``pretrain_layer`` on both network kinds, and
``ReconstructionDataSetIterator``, on the CPU.

The random draws cannot be reproduced across the packages (the AE's
corruption mask, the RBM's Gibbs samples, the VAE's epsilon), so the
deterministic parts are held against the JAX package on zip-transplanted
F64 nets, to 1e-10 (the same f64 arithmetic in another order):

- every config's JSON (each reconstruction distribution, AutoEncoder,
  RBM, CenterLossOutput, a frozen AutoEncoder);
- the VAE for each distribution: ``encode``, ``decode``, the KL term,
  ``reconstruction_error``, ``generate_at_mean_given_z``, the -ELBO at a
  given epsilon (the ``eps=`` seam) and its gradient, the forward;
- the AutoEncoder at ``corruption_level = 0``: the loss, its gradient, and
  the parameters after ``pretrain`` (Adam, 2 epochs of 4 batches);
- the RBM's ``_propup``, ``_propdown``, free energy and forward;
- the center-loss output: the score and, after 3 steps, params and
  centers; frozen, the centers stay and the loss keeps its term.

The sampled parts are held by statistics: the AE's kept fraction, the
RBM's CD loss (its mean over 4000 draws within 5 standard errors of the
exact expectation over the 2^4 hidden states, from the JAX package's
functions), and the VAE's -ELBO (the port's mean over 2000 draws against
the JAX package's over 2000, within 5 standard errors). And on the port
alone: pretraining lowers each objective, on a graph too.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JIterator
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers_pretrain as jlp
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.layers import variational as jvar
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.nn.updater import Sgd as JSgd
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator, DataSet,
                                               MultiDataSet,
                                               ReconstructionDataSetIterator)
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers_pretrain as tlp
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, Sgd
from deeplearning4j_tpu_torch.utils import serialization as tser

F64J = JDtypePolicy(param_dtype="float64", compute_dtype="float64")
F64 = DtypePolicy(param_dtype="float64", compute_dtype="float64")
TOL = 1e-10


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def dists(mod):
    """The same reconstruction distributions from either package."""
    return {
        "bernoulli": mod.BernoulliReconstruction(),
        "gaussian": mod.GaussianReconstruction(activation="tanh"),
        "exponential": mod.ExponentialReconstruction(),
        "loss_wrapper": mod.LossWrapperReconstruction(loss="mse"),
        "composite": mod.CompositeReconstruction(distributions=(
            (3, mod.BernoulliReconstruction()),
            (3, mod.GaussianReconstruction()))),
    }


def data_for(name, n=8, seed=0):
    rng = np.random.default_rng(seed)
    if name in ("bernoulli", "composite"):
        x = (rng.random((n, 6)) > 0.5).astype(float)
        if name == "composite":
            x[:, 3:] = rng.normal(size=(n, 3))
        return x
    if name == "exponential":
        return rng.exponential(size=(n, 6))
    return rng.normal(size=(n, 6))


def jax_vae_net(dist, num_samples=2):
    conf = (JNNC.builder().seed(42).updater(JAdam(1e-2)).dtype(F64J).list()
            .layer(jlp.VariationalAutoencoder(
                n_in=6, n_out=2, encoder_layer_sizes=(5, 4),
                decoder_layer_sizes=(4, 5), reconstruction=dist,
                num_samples=num_samples, activation="tanh"))
            .layer(JOutput(n_in=2, n_out=2, activation="softmax",
                           loss="mcxent"))
            .build())
    return JMLN(conf).init()


def transplant(tmp_path, jnet, name="net.zip"):
    path = str(tmp_path / name)
    jser.write_model(jnet, path)
    return tser.restore_multi_layer_network(path, device="cpu")


def _layer_confs(mod, dense):
    return [
        *[mod.VariationalAutoencoder(n_in=6, n_out=2,
                                     encoder_layer_sizes=(5, 4),
                                     decoder_layer_sizes=(4,),
                                     reconstruction=d, num_samples=3)
          for d in dists(mod).values()],
        mod.AutoEncoder(n_in=6, n_out=3, corruption_level=0.2, loss="xent"),
        mod.RBM(n_in=6, n_out=4, k=2),
        mod.Frozen(inner=mod.AutoEncoder(n_in=6, n_out=3), name="fz"),
    ]


@pytest.mark.parametrize("i", range(8))
def test_config_json_matches_the_jax_package(i):
    jl, tl = _layer_confs(jlp, JDense)[i], _layer_confs(tlp, Dense)[i]
    jconf = (JNNC.builder().seed(1).updater(JSgd(0.1)).list().layer(jl)
             .layer(jlp.CenterLossOutput(n_out=3, lmbda=0.1, alpha=0.3,
                                         activation="softmax")).build())
    tconf = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(0.1))
             .list().layer(tl)
             .layer(tlp.CenterLossOutput(n_out=3, lmbda=0.1, alpha=0.3,
                                         activation="softmax")).build())
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    back = type(tconf).from_json(jconf.to_json())
    assert back == tconf


@pytest.mark.parametrize("name", sorted(dists(jlp)))
def test_vae_deterministic_parts_match_the_jax_package(tmp_path, name):
    jnet = jax_vae_net(dists(jlp)[name])
    tnet = transplant(tmp_path, jnet)
    jl, tl = jnet.layers[0], tnet.layers[0]
    jp, tp = jnet.params[jl.name], tnet.params[tl.name]
    x = data_for(name)
    xt = torch.from_numpy(x)
    jm, jlv = jl.encode(jp, jnp.asarray(x))
    tm, tlv = tl.encode(tp, xt)
    _close(tm, jm, what="mean")
    _close(tlv, jlv, what="logvar")
    z = np.random.default_rng(1).normal(size=(8, 2))
    _close(tl.decode(tp, torch.from_numpy(z)), jl.decode(jp, jnp.asarray(z)),
           what="decode")
    jkl = -0.5 * jnp.sum(1 + jlv - jm ** 2 - jnp.exp(jlv), axis=-1)
    _close(tl.kl(tm, tlv), jkl, what="kl")
    _close(tl.reconstruction_error(tp, xt),
           jl.reconstruction_error(jp, jnp.asarray(x)), what="recon error")
    _close(tl.generate_at_mean_given_z(tp, torch.from_numpy(z)),
           jl.generate_at_mean_given_z(jp, jnp.asarray(z)), what="generate")
    _close(tnet.output(x), jnet.output(x), what="forward")

    # -ELBO at a given epsilon and its gradient
    eps = np.random.default_rng(2).normal(size=(2, 8, 2))

    def jelbo(p):
        m, lv = jl.encode(p, jnp.asarray(x))
        kl = -0.5 * jnp.sum(1 + lv - m ** 2 - jnp.exp(lv), axis=-1)
        rec = 0.0
        for s in range(2):
            zz = m + jnp.exp(0.5 * lv) * eps[s]
            rec = rec + jvar._neg_log_prob(jl.conf.reconstruction,
                                           jnp.asarray(x), jl.decode(p, zz))
        return rec / 2 + jnp.mean(kl)

    jval, jgrad = jax.value_and_grad(jelbo)(jp)
    leaves = {k: {kk: v.detach().clone().requires_grad_()
                  for kk, v in sub.items()} for k, sub in tp.items()}
    tval = tl.pretrain_loss(leaves, xt, None, eps=torch.from_numpy(eps))
    tval.backward()
    _close(tval, jval, what="-elbo")
    for k, sub in jgrad.items():
        for kk, g in sub.items():
            _close(leaves[k][kk].grad, g, what=f"grad {k}.{kk}")


def test_vae_sampled_elbo_agrees_with_the_jax_package(tmp_path):
    jnet = jax_vae_net(dists(jlp)["gaussian"], num_samples=1)
    tnet = transplant(tmp_path, jnet)
    jl, tl = jnet.layers[0], tnet.layers[0]
    x = data_for("gaussian", n=4)
    n = 2000
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    jv = np.asarray(jax.jit(jax.vmap(
        lambda k: jl.pretrain_loss(jnet.params[jl.name], jnp.asarray(x),
                                   k)))(keys))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        tv = np.array([float(tl.pretrain_loss(tnet.params[tl.name],
                                              torch.from_numpy(x), gen))
                       for _ in range(n)])
    se = np.sqrt(jv.var() / n + tv.var() / n)
    assert abs(jv.mean() - tv.mean()) < 5 * se, (jv.mean(), tv.mean(), se)
    # and the draws differ from one call to the next
    assert tv.std() > 0


def jax_ae_net(corruption=0.0, n_hidden=3):
    conf = (JNNC.builder().seed(3).updater(JAdam(1e-2)).dtype(F64J).list()
            .layer(jlp.AutoEncoder(n_in=12, n_out=n_hidden,
                                   activation="tanh",
                                   corruption_level=corruption, loss="mse"))
            .layer(JOutput(n_in=n_hidden, n_out=2, activation="softmax",
                           loss="mcxent"))
            .build())
    return JMLN(conf).init()


def ae_data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(3, 12))
    return rng.normal(size=(n, 3)) @ basis + 0.05 * rng.normal(size=(n, 12))


def test_autoencoder_without_corruption_matches_the_jax_package(tmp_path):
    jnet = jax_ae_net()
    tnet = transplant(tmp_path, jnet)
    jl, tl = jnet.layers[0], tnet.layers[0]
    x = ae_data()
    jval, jgrad = jax.value_and_grad(
        lambda p: jl.pretrain_loss(p, jnp.asarray(x), None))(
            jnet.params[jl.name])
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in tnet.params[tl.name].items()}
    tval = tl.pretrain_loss(leaves, torch.from_numpy(x), None)
    tval.backward()
    _close(tval, jval, what="loss")
    for k, g in jgrad.items():
        _close(leaves[k].grad, g, what=f"grad {k}")
    jnet.pretrain(JIterator(x, None, batch_size=16), epochs=2)
    tnet.pretrain(ArrayDataSetIterator(x, None, batch_size=16), epochs=2)
    assert tnet.iteration == jnet.iteration == 8
    for k, v in jnet.params[jl.name].items():
        _close(tnet.params[tl.name][k], v, tol=1e-9, what=f"param {k}")
    _close(tnet.opt_state[tl.name]["t"], jnet.opt_state[jl.name]["t"])
    _close(float(tnet.score_value), float(jnet.score_value), tol=1e-9)


def test_autoencoder_corruption_keeps_the_stated_fraction():
    conf = (NeuralNetConfiguration.builder().seed(3).dtype(F64).list()
            .layer(tlp.AutoEncoder(n_in=2000, n_out=1,
                                   activation="identity",
                                   corruption_level=0.3))
            .layer(Output(n_in=1, n_out=2, activation="softmax",
                          loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    ae = net.layers[0]
    seen = []
    real = ae.preout
    ae.preout = lambda p, x: (seen.append(x), real(p, x))[1]
    ae.pretrain_loss(net.params[ae.name], torch.ones(10, 2000),
                     torch.Generator().manual_seed(0))
    kept = float((seen[0] != 0).double().mean())
    se = np.sqrt(0.7 * 0.3 / 20000)
    assert abs(kept - 0.7) < 5 * se, kept


def jax_rbm_net(k=1):
    conf = (JNNC.builder().seed(5).updater(JSgd(0.1)).dtype(F64J).list()
            .layer(jlp.RBM(n_in=8, n_out=4, k=k))
            .layer(JOutput(n_in=4, n_out=2, activation="softmax",
                           loss="mcxent"))
            .build())
    return JMLN(conf).init()


def test_rbm_deterministic_parts_match_the_jax_package(tmp_path):
    jnet = jax_rbm_net()
    tnet = transplant(tmp_path, jnet)
    jl, tl = jnet.layers[0], tnet.layers[0]
    jp, tp = jnet.params[jl.name], tnet.params[tl.name]
    rng = np.random.default_rng(0)
    v = (rng.random((16, 8)) > 0.5).astype(float)
    h = (rng.random((16, 4)) > 0.5).astype(float)
    _close(tl._propup(tp, torch.from_numpy(v)), jl._propup(jp, jnp.asarray(v)))
    _close(tl._propdown(tp, torch.from_numpy(h)),
           jl._propdown(jp, jnp.asarray(h)))
    _close(tl._free_energy(tp, torch.from_numpy(v)),
           jl._free_energy(jp, jnp.asarray(v)))
    _close(tnet.output(v), jnet.output(v))


def test_rbm_cd_loss_is_unbiased_around_the_exact_expectation(tmp_path):
    """CD-1's loss averaged over the port's Gibbs draws against its exact
    expectation over the 2^4 hidden states (the JAX package's functions
    on the same weights)."""
    jnet = jax_rbm_net(k=1)
    tnet = transplant(tmp_path, jnet)
    jl, tl = jnet.layers[0], tnet.layers[0]
    jp = jnet.params[jl.name]
    rng = np.random.default_rng(1)
    v0 = (rng.random((6, 8)) > 0.5).astype(float)
    ph = np.asarray(jl._propup(jp, jnp.asarray(v0)))           # [6, 4]
    f0 = np.asarray(jl._free_energy(jp, jnp.asarray(v0)))      # [6]
    states = np.array([[(s >> i) & 1 for i in range(4)]
                       for s in range(16)], float)             # [16, 4]
    prob = np.prod(np.where(states[None] == 1, ph[:, None], 1 - ph[:, None]),
                   axis=-1)                                     # [6, 16]
    f_model = np.asarray(jl._free_energy(
        jp, jl._propdown(jp, jnp.asarray(states))))            # [16]
    exact = float(np.mean(f0 - prob @ f_model))
    n = 4000
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        draws = np.array([float(tl.pretrain_loss(tnet.params[tl.name],
                                                 torch.from_numpy(v0), gen))
                          for _ in range(n)])
    se = draws.std() / np.sqrt(n)
    assert abs(draws.mean() - exact) < 5 * se, (draws.mean(), exact, se)


def jax_center_net(frozen=False):
    out = jlp.CenterLossOutput(n_out=3, activation="softmax", lmbda=0.1,
                               alpha=0.2)
    if frozen:
        out = jlp.Frozen(inner=out, name="out")
    conf = (JNNC.builder().seed(42).updater(JSgd(0.1)).dtype(F64J).list()
            .layer(JDense(n_in=5, n_out=4, activation="tanh"))
            .layer(out)
            .build())
    return JMLN(conf).init()


@pytest.mark.parametrize("frozen", [False, True], ids=["trained", "frozen"])
def test_center_loss_matches_the_jax_package(tmp_path, frozen):
    jnet = jax_center_net(frozen)
    tnet = transplant(tmp_path, jnet)
    name = tnet.layers[1].name
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(8, 5)), np.eye(3)[rng.integers(0, 3, 8)]
    # move the centers off zero so the center term is seen
    for _ in range(2):
        jnet.fit_batch(JDataSet(x, y))
    tnet = transplant(tmp_path, jnet, "moved.zip")
    c0 = tnet.state[name]["centers"].clone()
    _close(tnet.score(DataSet(x, y)), jnet.score(JDataSet(x, y)))
    for _ in range(3):
        jnet.fit_batch(JDataSet(x, y))
        tnet.fit_batch(DataSet(x, y))
    for n, sub in jnet.params.items():
        for k, v in sub.items():
            _close(tnet.params[n][k], v, tol=1e-9, what=f"{n}.{k}")
    _close(tnet.state[name]["centers"], jnet.state[name]["centers"],
           tol=1e-9)
    moved = not torch.equal(tnet.state[name]["centers"], c0)
    assert moved != frozen
    if not frozen:
        assert float(c0.abs().sum()) > 0


def test_pretraining_lowers_each_objective():
    rng = np.random.default_rng(0)
    protos = (rng.random((2, 10)) > 0.5).astype(float)
    xb = protos[rng.integers(0, 2, 128)]
    flip = rng.random(xb.shape) < 0.05
    xb[flip] = 1 - xb[flip]
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-2))
            .dtype(F64).list()
            .layer(tlp.VariationalAutoencoder(
                n_in=10, n_out=2, encoder_layer_sizes=(16,),
                decoder_layer_sizes=(16,), activation="tanh"))
            .layer(tlp.AutoEncoder(n_out=2, activation="tanh",
                                   corruption_level=0.1))
            .layer(tlp.RBM(n_out=3))
            .layer(Output(n_out=2, activation="softmax", loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    vae, ae = net.layers[0], net.layers[1]
    x = torch.from_numpy(xb)
    err0 = float(vae.reconstruction_error(net.params[vae.name], x))
    net.pretrain_layer(0, ArrayDataSetIterator(xb, None, batch_size=32),
                       epochs=30)
    err1 = float(vae.reconstruction_error(net.params[vae.name], x))
    assert err1 < 0.7 * err0, (err0, err1)
    assert net.iteration == 120
    h = net.feed_forward(xb)[0]
    l0 = float(ae.pretrain_loss(net.params[ae.name], h, None))
    net.pretrain(ArrayDataSetIterator(xb, None, batch_size=32), epochs=10)
    assert net.iteration == 120 + 3 * 40
    h = net.feed_forward(xb)[0]
    assert float(ae.pretrain_loss(net.params[ae.name], h, None)) < l0
    with pytest.raises(ValueError, match="not pretrainable"):
        net.pretrain_layer(3, ArrayDataSetIterator(xb, None, batch_size=32))


def test_a_frozen_layer_is_not_pretrained():
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-2))
            .dtype(F64).list()
            .layer(tlp.Frozen(inner=tlp.AutoEncoder(n_in=6, n_out=3),
                              name="fz"))
            .layer(Output(n_in=3, n_out=2, activation="softmax",
                          loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert not net.layers[0].is_pretrainable
    before = {k: v.clone() for k, v in net.params["fz"].items()}
    net.pretrain(np.random.default_rng(0).normal(size=(16, 6)))
    assert net.iteration == 0
    for k, v in before.items():
        assert torch.equal(net.params["fz"][k], v)


def test_graph_pretrain():
    g = (NeuralNetConfiguration.builder().seed(2).updater(Adam(1e-2))
         .dtype(F64).graph_builder().add_inputs("in")
         .add_layer("d", Dense(n_in=8, n_out=8, activation="tanh"), "in")
         .add_layer("vae", tlp.VariationalAutoencoder(
             n_out=2, encoder_layer_sizes=(8,), decoder_layer_sizes=(8,),
             reconstruction=tlp.GaussianReconstruction()), "d")
         .add_layer("out", Output(n_out=2, activation="softmax",
                                  loss="mcxent"), "vae")
         .set_outputs("out").build())
    net = ComputationGraph(g, device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 2)) @ rng.normal(size=(2, 8))
    vae = net._layer_by_name["vae"]
    feats = net.feed_forward(x)["d"]
    err0 = float(vae.reconstruction_error(net.params["vae"], feats))
    net.pretrain(MultiDataSet([x], [np.zeros((64, 2))]), epochs=60)
    assert net.iteration == 60
    err1 = float(vae.reconstruction_error(net.params["vae"], feats))
    assert err1 < err0, (err0, err1)
    with pytest.raises(ValueError, match="not a pretrainable"):
        net.pretrain_layer("d", MultiDataSet([x], [np.zeros((64, 2))]))


def test_reconstruction_iterator_makes_features_the_labels():
    x = np.arange(24.0).reshape(6, 4)
    it = ReconstructionDataSetIterator(
        ArrayDataSetIterator(x, None, batch_size=4))
    batches = list(it)
    assert [b.features.shape[0] for b in batches] == [4, 2]
    for b in batches:
        assert b.labels is b.features
    it.reset()
    assert it.batch_size == 4 and len(list(it)) == 2
