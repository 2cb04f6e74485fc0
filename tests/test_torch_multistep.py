"""The training runtime (deeplearning4j_tpu_torch/nn/multistep.py, the
nets' ``fit(multi_step=)`` and ``fit_batch_repeated``) on the CPU, where
nothing is captured and the captured step's body runs eagerly; and the
public methods' parameter order against the JAX package.

- ``fit(multi_step=k)`` and ``fit_batch_repeated`` against the per-batch
  loop, bit for bit (parameters, updater state, layer state, the
  listeners' (iteration, score) stream), on both network kinds;
- against the JAX package's ``fit(multi_step=k)`` and
  ``fit_batch_repeated`` on a zip-transplanted F32 net: 1e-5 relative /
  1e-6 absolute on parameters and scores after 6 steps (the same f32
  operations, where XLA and PyTorch sum and round a transcendental in
  another order);
- the step's body reads nothing from the device on the host (what a CUDA
  graph needs), with ``Tensor.item``, ``tolist``, ``__bool__``,
  ``__float__`` and ``__int__`` made to raise;
- a non-finite loss-scaled step leaves params and updater state bit for
  bit as they were, as the JAX package's step does.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JIterator
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.optimize import listeners as jlst
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator, DataSet,
                                               ListDataSetIterator)
from deeplearning4j_tpu_torch.nn import multistep, precision
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.conf.layers_conv import BatchNorm
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, Nesterovs, _leaves
from deeplearning4j_tpu_torch.ops import registry
from deeplearning4j_tpu_torch.optimize import listeners as tlst
from deeplearning4j_tpu_torch.utils import serialization as tser

F32 = DtypePolicy(param_dtype="float32", compute_dtype="float32")
JAX_TOL = dict(rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ Part 0
def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                          p.VAR_POSITIONAL)]


def _public_methods(port_cls, jax_cls):
    return [(port_cls, jax_cls, n) for n in sorted(vars(port_cls))
            if not n.startswith("_") and callable(getattr(port_cls, n))
            and hasattr(jax_cls, n)]


METHODS = (_public_methods(MultiLayerNetwork, JMLN)
           + _public_methods(ComputationGraph, JCG))


@pytest.mark.parametrize("port_cls,jax_cls,name", METHODS,
                         ids=[f"{p.__name__}.{n}" for p, _, n in METHODS])
def test_public_methods_take_the_references_positional_parameters(
        port_cls, jax_cls, name):
    """Names and order of the positional parameters equal the JAX
    package's (keyword-only additions are allowed)."""
    assert (_positional(getattr(port_cls, name))
            == _positional(getattr(jax_cls, name)))


def _dropout_net():
    conf = (NeuralNetConfiguration.builder().seed(3).dtype(F32).list()
            .layer(Dense(n_in=6, n_out=64, activation="relu", dropout=0.5))
            .layer(Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_output_takes_train_as_its_second_positional_argument():
    """``output(x, True)`` runs train mode (dropout) as ``train=True``
    does, from the same generator state; inference mode differs."""
    x = np.random.default_rng(0).normal(size=(8, 6)).astype(np.float32)
    net = _dropout_net()
    state = net._gen.get_state()
    positional = net.output(x, True)
    net._gen.set_state(state)
    keyword = net.output(x, train=True)
    assert torch.equal(positional, keyword)
    assert not torch.equal(positional, net.output(x))
    net._gen.set_state(state)
    acts = net.feed_forward(x, True)
    net._gen.set_state(state)
    assert all(torch.equal(a, b)
               for a, b in zip(acts, net.feed_forward(x, train=True)))


# ------------------------------------------------------------ nets
def _mln(seed=7, updater=None):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(updater or Adam(1e-2)).dtype(F32).list()
            .layer(Dense(n_in=5, n_out=16, activation="tanh"))
            .layer(Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _graph(seed=7):
    """Dense -> batch norm (state the step writes back) -> output."""
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Nesterovs(0.05, 0.9)).dtype(F32).graph_builder()
            .add_inputs("in")
            .add_layer("h", Dense(n_out=16, activation="identity"), "in")
            .add_layer("bn", BatchNorm(activation="tanh"), "h")
            .add_layer("out", Output(n_out=3, activation="softmax",
                                     loss="mcxent"), "bn")
            .set_outputs("out").set_input_types(InputType.feed_forward(5))
            .build())
    return ComputationGraph(conf, device="cpu").init()


def _data(n=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _batches(n=48, bs=8, seed=0):
    x, y = _data(n, seed)
    return [DataSet(x[i:i + bs], y[i:i + bs]) for i in range(0, n, bs)]


def _equal_nets(a, b):
    for tree in ("params", "state", "opt_state"):
        la, lb = list(_leaves(getattr(a, tree))), list(_leaves(getattr(b,
                                                                     tree)))
        assert len(la) == len(lb)
        for p, q in zip(la, lb):
            assert p.dtype == q.dtype and torch.equal(p, q), tree
    assert a.iteration == b.iteration


MAKERS = {"mln": _mln, "graph": _graph}


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_fit_multi_step_is_the_per_batch_loop_bit_for_bit(kind, k):
    """Two epochs of 6 batches (the last chunk shorter than k when k does
    not divide 6; a 4-example batch at the end of each epoch makes a
    signature of its own)."""
    base = MAKERS[kind]()
    batches = _batches() + [_batches(4, 4, seed=9)[0]]
    a, b = base.clone(), base.clone()
    la, lb = (tlst.CollectScoresIterationListener(1),
              tlst.CollectScoresIterationListener(1))
    a.set_listeners(la)
    b.set_listeners(lb)
    a.fit(ListDataSetIterator(batches), epochs=2, multi_step=1)
    b.fit(ListDataSetIterator(batches), epochs=2, multi_step=k)
    assert la.scores == lb.scores and len(la.scores) == 14
    _equal_nets(a, b)
    assert a.epoch == b.epoch == 2
    assert torch.equal(a.score_value, b.score_value)


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_fit_batch_repeated_is_n_fit_batch_calls(kind):
    base = MAKERS[kind]()
    ds = _batches()[0]
    a, b = base.clone(), base.clone()
    for _ in range(5):
        want = a.fit_batch(ds)
    got = b.fit_batch_repeated(ds, 5)
    _equal_nets(a, b)
    assert torch.equal(got, want) and b.last_batch_examples == 8
    with pytest.raises(ValueError, match="n_steps"):
        b.fit_batch_repeated(ds, 0)


def test_fit_async_and_device_prefetch_are_the_plain_loop():
    """``async_prefetch`` and an explicit ``device_prefetch`` (a copy to
    the net's device, here the CPU) leave the steps as they were."""
    base = _mln()
    x, y = _data()
    a, b = base.clone(), base.clone()
    a.fit(ArrayDataSetIterator(x, y, 8, shuffle=True, seed=2), epochs=2,
          async_prefetch=False, device_prefetch=False)
    b.fit(ArrayDataSetIterator(x, y, 8, shuffle=True, seed=2), epochs=2,
          async_prefetch=True, device_prefetch=True, multi_step=4)
    _equal_nets(a, b)


def _jax_net():
    conf = (JNNC.builder().seed(7).updater(JAdam(1e-2))
            .dtype(JDtypePolicy(param_dtype="float32",
                                compute_dtype="float32")).list()
            .layer(JDense(n_in=5, n_out=16, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return JMLN(conf).init()


def _transplant(jnet, tmp_path):
    path = str(tmp_path / "net.zip")
    jser.write_model(jnet, path)
    return tser.restore_multi_layer_network(path, device="cpu")


def _close_params(tnet, jnet):
    for name, sub in tnet.params.items():
        for k, t in sub.items():
            np.testing.assert_allclose(t.numpy(),
                                       np.asarray(jnet.params[name][k]),
                                       **JAX_TOL)


def test_fit_multi_step_matches_jax(tmp_path):
    jnet = _jax_net()
    tnet = _transplant(jnet, tmp_path)
    jl, tl = (jlst.CollectScoresIterationListener(1),
              tlst.CollectScoresIterationListener(1))
    jnet.set_listeners(jl)
    tnet.set_listeners(tl)
    x, y = _data()
    jnet.fit(JIterator(x, y, 8), epochs=1, multi_step=3,
             async_prefetch=False, device_prefetch=False)
    tnet.fit(ArrayDataSetIterator(x, y, 8), epochs=1, multi_step=3)
    assert [i for i, _ in tl.scores] == [i for i, _ in jl.scores]
    np.testing.assert_allclose([s for _, s in tl.scores],
                               [s for _, s in jl.scores], **JAX_TOL)
    _close_params(tnet, jnet)


def test_fit_batch_repeated_matches_jax(tmp_path):
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    jnet = _jax_net()
    tnet = _transplant(jnet, tmp_path)
    x, y = _data(8)
    js = jnet.fit_batch_repeated(JDataSet(x, y), 6)
    ts = tnet.fit_batch_repeated(DataSet(x, y), 6)
    assert tnet.iteration == jnet.iteration == 6
    np.testing.assert_allclose(float(ts), float(js), **JAX_TOL)
    _close_params(tnet, jnet)


def test_fit_batch_repeated_matches_jax_on_a_graph(tmp_path):
    """A ComputationGraph with batch norm (the state the step writes
    back), transplanted both ways through the zip."""
    tnet = _graph()
    path = str(tmp_path / "g.zip")
    tser.write_computation_graph(tnet, path)
    jnet = jser.restore_computation_graph(path)
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    x, y = _data(8, seed=3)
    js = jnet.fit_batch_repeated(JDataSet(x, y), 4)
    ts = tnet.fit_batch_repeated(DataSet(x, y), 4)
    np.testing.assert_allclose(float(ts), float(js), **JAX_TOL)
    for tree in ("params", "state"):
        for name, sub in getattr(tnet, tree).items():
            for k, t in sub.items():
                np.testing.assert_allclose(
                    t.numpy(), np.asarray(getattr(jnet, tree)[name][k]),
                    **JAX_TOL)


# ------------------------------------------------------- host reads
def _refusing(monkeypatch):
    def refuse(name):
        def read(self, *a, **k):
            raise AssertionError(f"host read: Tensor.{name}")
        return read
    for name in ("item", "tolist", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name), raising=False)


def _char_rnn():
    return tzoo.char_rnn(vocab_size=10, hidden=16, n_layers=1, device="cpu",
                         dtype=tzoo.F32, seed=1)


def _gpt():
    return tzoo.gpt_mini(device="cpu", vocab_size=10, width=32, n_layers=1,
                         n_heads=2, max_len=8, dtype=tzoo.F32)


def _seq_batch(net, b=4, t=8, seed=0):
    rng = np.random.default_rng(seed)
    x = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (b, t))]
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (b, t))]
    return DataSet(x, y)


def _f16_net():
    pol = DtypePolicy(param_dtype="float32", compute_dtype="float16")
    return tzoo.char_rnn(vocab_size=10, hidden=16, n_layers=1, dtype=pol,
                         device="cpu", seed=3)


STEP_NETS = {"char_rnn": _char_rnn, "gpt_mini": _gpt, "graph_bn": _graph,
             "f16_scaled": _f16_net}


@pytest.mark.parametrize("kind", sorted(STEP_NETS))
def test_the_captured_step_reads_nothing_on_the_host(kind, monkeypatch):
    net = STEP_NETS[kind]()
    ds = (_batches()[0] if kind == "graph_bn" else _seq_batch(net))
    batch = net._step_batch(ds)
    before = [t.clone() for t in _leaves(net.params)]
    _refusing(monkeypatch)
    score = multistep.train_step(net, batch)
    monkeypatch.undo()
    assert np.isfinite(float(score))
    assert any(not torch.equal(a, b)
               for a, b in zip(before, _leaves(net.params)))
    assert int(net._it_twin.tensor) == net.iteration + 1


def test_non_finite_scaled_step_leaves_params_bit_identical_as_jax(tmp_path):
    """A loss scale of 2**24 overflows the f16 backward in both packages:
    neither touches params nor updater slots, both halve the scale."""
    from deeplearning4j_tpu import zoo as jzoo
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    jpol = JDtypePolicy(param_dtype="float32", compute_dtype="float16")
    jnet = jzoo.char_rnn(vocab_size=10, hidden=16, n_layers=1, dtype=jpol)
    jnet.opt_state["_loss_scale"]["scale"] = jnp.asarray(2.0 ** 24,
                                                         jnp.float32)
    tnet = _transplant(jnet, tmp_path)
    ds = _seq_batch(tnet)
    jbefore = [np.asarray(a) for a in _jleaves(jnet.params)]
    tbefore = [t.clone() for t in _leaves(tnet.params)]
    tslots = [t.clone() for k, s in tnet.opt_state.items()
              if k != precision.LOSS_SCALE_KEY for t in _leaves(s)]
    jnet.fit_batch(JDataSet(ds.features, ds.labels))
    tnet.fit_batch(ds)
    for a, b in zip(jbefore, _jleaves(jnet.params)):
        assert np.array_equal(a, np.asarray(b))
    for a, b in zip(tbefore, _leaves(tnet.params)):
        assert torch.equal(a, b)
    after = [t for k, s in tnet.opt_state.items()
             if k != precision.LOSS_SCALE_KEY for t in _leaves(s)]
    assert all(torch.equal(a, b) for a, b in zip(tslots, after))
    assert (float(tnet.opt_state["_loss_scale"]["scale"])
            == float(jnet.opt_state["_loss_scale"]["scale"]) == 2.0 ** 23)


def _jleaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jleaves(tree[k])
    else:
        yield tree


# ------------------------------------------------------- the runtime
def test_multi_step_resolution_follows_the_reference():
    net = _mln()
    assert multistep.resolve_multi_step(net, "auto") == 1          # the CPU
    assert multistep.resolve_multi_step(net, 5) == 5
    assert multistep.resolve_multi_step(net, None) == 1
    assert multistep.resolve_device_prefetch(net, "auto") is False
    net.set_listeners(tlst.ScoreIterationListener(5))
    assert multistep.resolve_multi_step(net, 4) == 4
    net.set_listeners(tlst.PerformanceListener(5))
    assert multistep.resolve_multi_step(net, 4) == 1
    both = tlst.ComposableIterationListener(
        tlst.ScoreIterationListener(5), tlst.PerformanceListener(5))
    assert both.needs_per_iteration is True
    net.set_listeners(both)
    assert multistep.resolve_multi_step(net, 4) == 1
    net.set_listeners(tlst.ComposableIterationListener(
        tlst.CollectScoresIterationListener(1)))
    assert multistep.resolve_multi_step(net, 4) == 4
    for name in ("ScoreIterationListener", "CollectScoresIterationListener",
                 "PerformanceListener", "TrainingListener",
                 "ParamAndGradientIterationListener", "ProfilerListener"):
        assert (getattr(tlst, name).needs_per_iteration
                == getattr(jlst, name).needs_per_iteration), name


def test_graphs_are_dropped_where_the_reference_drops_its_steps():
    net = _mln()
    ds = _batches()[0]
    net.fit_batch_repeated(ds, 2)
    assert len(net._multi_steps) == 1
    assert net.clone()._multi_steps == {}
    for drop in (lambda: net.set_lr_scale(0.5),
                 lambda: net.set_listeners(),
                 lambda: net.add_listener(tlst.TrainingListener()),
                 lambda: net.init()):
        net.fit_batch_repeated(ds, 1)
        assert net._multi_steps
        drop()
        assert net._multi_steps == {}


def test_the_device_iteration_follows_an_iteration_set_from_outside():
    net = _mln()
    ds = _batches()[0]
    net.fit_batch(ds)
    assert int(net._it_twin.tensor) == net.iteration == 1
    net.iteration = 40
    net.fit_batch_repeated(ds, 2)
    assert int(net._it_twin.tensor) == net.iteration == 42


def test_rebind_copies_in_a_replaced_leaf_and_points_the_net_back():
    """What a replay does when the net's trees hold other tensors than
    the graph was captured over (eager steps replaced a leaf, or a user
    assigned one)."""
    net = _graph()
    sg = multistep.StepGraph(net, net._step_batch(_batches()[0]))
    sg._bound = multistep._tree_paths(net)
    captured = net.state["bn"]["mean"]
    net.state["bn"]["mean"] = torch.full_like(captured, 0.25)
    assert sg._rebind()
    assert net.state["bn"]["mean"] is captured
    assert torch.equal(captured, torch.full_like(captured, 0.25))
    net.state["extra"] = {"x": torch.zeros(2)}
    assert not sg._rebind()   # the trees changed shape: capture anew


def test_launches_recorded_apart_and_added_per_replay():
    registry.reset_launches()
    with registry.recording() as rec:
        registry.count_launch("k", 2)
        registry.count_launch("k_sm90")
    assert registry.launches() == {}
    assert rec == {"k": 2, "k_sm90": 1}
    registry.add_launches(rec, times=3)
    assert registry.launches() == {"k": 6, "k_sm90": 3}
    registry.reset_launches()


def test_static_inputs_refuse_another_signature():
    net = _mln()
    sg = multistep.step_graph(net, net._step_batch(_batches()[0]))
    with pytest.raises(ValueError, match="signature"):
        sg.load(net._step_batch(_batches(4, 4)[0]))
    assert multistep.step_graph(net, net._step_batch(_batches()[1])) is sg
