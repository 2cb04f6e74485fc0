"""The port's public names (ROADMAP.md A.1) and its structure-only init,
held against the JAX package on the CPU.

- ``activations.names()`` and ``initializers.names()`` equal the JAX
  package's; the top-level ``activations``, ``initializers`` and
  ``losses``, ``nn.conf.ListBuilder``, ``nn.layers.Layer`` and the
  ``Convolution`` alias resolve as they do there.
- ``init(structure_only=True)`` on both network kinds gives ``meta``
  tensors with the paths, shapes and dtypes ``init()`` gives, and draws
  nothing: the process's generator is untouched and a later ``init()``
  from the same seed gives the same weights as without it.
- ``materialize_state()`` equals ``init()``'s state;
  ``materialize_opt_state()`` a fresh updater state over the params.
- A checkpoint restored through the structure-only path
  (utils/checkpoint.py) is bit-equal to the net saved, as the full
  ``init()`` path gave it.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch as port
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.utils.checkpoint import (
    restore_computation_graph, restore_multi_layer_network,
    save_checkpoint)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _meta(tree):
    return [(p, tuple(t.shape), t.dtype) for p, t in _leaves(tree)]


# ----------------------------------------------------------- public names
@pytest.mark.parametrize("module", ["activations", "initializers"])
def test_names_equal_the_jax_packages(module):
    import deeplearning4j_tpu as jpkg
    assert getattr(port, module).names() == getattr(jpkg, module).names()
    assert getattr(port, module).names() == sorted(
        getattr(port, module).names())


def test_top_level_modules_and_aliases_resolve():
    from deeplearning4j_tpu_torch.nn.conf import ListBuilder
    from deeplearning4j_tpu_torch.nn.conf.core import (
        ListBuilder as CoreListBuilder)
    from deeplearning4j_tpu_torch.nn.conf.layers_conv import (Convolution,
                                                            Convolution2D)
    from deeplearning4j_tpu_torch.nn.layers import Layer
    from deeplearning4j_tpu_torch.nn.layers.base import Layer as BaseLayer
    for name in ("activations", "initializers", "losses"):
        assert name in port.__all__
        assert getattr(port, name).__name__ == \
            f"deeplearning4j_tpu_torch.ops.{name}"
    assert ListBuilder is CoreListBuilder
    assert Layer is BaseLayer
    assert Convolution is Convolution2D
    assert port.losses.get("mcxent") is not None
    builder = port.NeuralNetConfiguration.builder().list()
    assert isinstance(builder, ListBuilder)


# ---------------------------------------------------- structure-only init
def _mln():
    return zoo.char_rnn(hidden=16, n_layers=1, device="cpu")


def _graph():
    return zoo.resnet50(image_size=32, n_classes=10, device="cpu")


@pytest.mark.parametrize("make", [_mln, _graph], ids=["mln", "graph"])
def test_structure_only_init_has_inits_structure_and_draws_nothing(make):
    net = make()
    want = {k: _meta(getattr(net, k)) for k in ("params", "state",
                                                "opt_state")}
    before = {k: [t.clone() for _, t in _leaves(getattr(net, k))]
              for k in ("params", "state")}
    gen_state = torch.random.get_rng_state()
    shell = type(net)(net.conf, device="cpu").init(structure_only=True)
    assert torch.equal(torch.random.get_rng_state(), gen_state)
    for k in ("params", "state", "opt_state"):
        assert _meta(getattr(shell, k)) == want[k], k
        assert all(t.device.type == "meta"
                   for _, t in _leaves(getattr(shell, k))), k
    # a later init() from the same seed is the init() it was
    again = type(net)(net.conf, device="cpu").init()
    for k in ("params", "state"):
        got = [t for _, t in _leaves(getattr(again, k))]
        assert all(torch.equal(a, b) for a, b in zip(got, before[k])), k
    # init() over the shell gives the same weights too
    shell.init()
    assert all(torch.equal(a, b) for (_, a), b in
               zip(_leaves(shell.params), before["params"]))


@pytest.mark.parametrize("make", [_mln, _graph], ids=["mln", "graph"])
def test_materialize_state_and_opt_state(make):
    net = make()
    shell = type(net)(net.conf, device="cpu").init(structure_only=True)
    shell.materialize_state()
    for (p, a), (q, b) in zip(_leaves(shell.state), _leaves(net.state)):
        assert p == q and a.device.type == "cpu" and torch.equal(a, b)
    shell.params = net.params
    shell.materialize_opt_state()
    assert _meta(shell.opt_state) == _meta(net.opt_state)
    for (_, a), (_, b) in zip(_leaves(shell.opt_state),
                              _leaves(net.opt_state)):
        assert a.device.type == "cpu" and torch.equal(a, b)


def test_restore_through_the_structure_only_path_is_bit_equal(tmp_path):
    net = _mln()
    x = torch.from_numpy(np.eye(80, dtype=np.float32)[
        np.random.default_rng(0).integers(0, 80, (2, 5))])
    net.fit_batch(port.DataSet(x, x))
    save_checkpoint(net, str(tmp_path / "m"))
    back = restore_multi_layer_network(str(tmp_path / "m"), device="cpu")
    for k in ("params", "state", "opt_state"):
        got, want = list(_leaves(getattr(back, k))), \
            list(_leaves(getattr(net, k)))
        assert [p for p, _ in got] == [p for p, _ in want]
        assert all(a.device.type == "cpu" and a.dtype == b.dtype
                   and torch.equal(a, b) for (_, a), (_, b) in
                   zip(got, want)), k
    assert back.iteration == net.iteration
    assert torch.equal(back.output(x), net.output(x))

    graph = zoo.resnet50(image_size=32, n_classes=10, device="cpu")
    save_checkpoint(graph, str(tmp_path / "g"))
    gback = restore_computation_graph(str(tmp_path / "g"), device="cpu")
    for k in ("params", "state", "opt_state"):
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(_leaves(getattr(gback, k)),
                       _leaves(getattr(graph, k)))), k
