"""The port's model guesser (deeplearning4j_tpu_torch/utils/
model_guesser.py) held against the JAX package's on the CPU: the cases
of tests/test_serialization.py's guesser tests.

Both packages name the same format for each file: this framework's zip,
the DL4J zip, a Keras HDF5 file and a checkpoint directory (either
package's), and refuse the same junk. ``load_model`` restores what the
direct entry point restores: bit-equal parameters, F64 outputs within
1e-12 of the JAX net's, F32 within 1e-6.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport.dl4j import write_dl4j_zip as j_write_dl4j
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.utils import checkpoint as jck
from deeplearning4j_tpu.utils import model_guesser as jguess
from deeplearning4j_tpu.utils.serialization import write_model as j_write
from deeplearning4j_tpu_torch.modelimport.dl4j import (
    restore_multi_layer_network_from_dl4j)
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.utils import model_guesser as guess
from deeplearning4j_tpu_torch.utils.checkpoint import save_checkpoint
from deeplearning4j_tpu_torch.utils.serialization import restore_model

F64 = DtypePolicy(param_dtype="float64", compute_dtype="float64")
JF64 = JDtypePolicy(param_dtype="float64", compute_dtype="float64")


def _jax_net():
    conf = (JNNC.builder().seed(9).dtype(JF64).list()
            .layer(JDense(n_in=4, n_out=6, activation="tanh"))
            .layer(JOutput(n_out=2, activation="softmax", loss="mcxent"))
            .build())
    return JMLN(conf).init()


def _x(seed=0):
    return np.random.default_rng(seed).normal(size=(3, 4))


def _params_bit_equal(jnet, pnet):
    for layer in jnet.layers:
        for k, v in jnet.params[layer.name].items():
            np.testing.assert_array_equal(
                pnet.params[layer.name][k].numpy(), np.asarray(v))


def _write_h5(path, config, weights):
    import h5py
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(config).encode()
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array([n.encode() for n in weights],
                                           dtype="S8")
        for name, arrays in weights.items():
            g = mw.create_group(name)
            names = [f"{name}/{i}".encode() for i in range(len(arrays))]
            g.attrs["weight_names"] = np.array(names, dtype="S8")
            for n, a in zip(names, arrays):
                g.create_dataset(n.decode(), data=np.asarray(a, np.float32))


def test_tpu_zip(tmp_path):
    jnet = _jax_net()
    p = str(tmp_path / "m.zip")
    j_write(jnet, p)
    assert guess.guess_format(p) == jguess.guess_format(p) == "tpu_zip"
    net = guess.load_model(p, device="cpu")
    _params_bit_equal(jnet, net)
    assert torch.equal(net.output(_x()), restore_model(
        p, device="cpu").output(_x()))
    np.testing.assert_allclose(net.output(_x()).numpy(),
                               np.asarray(jnet.output(_x())), rtol=1e-12,
                               atol=1e-12)


def test_dl4j_zip(tmp_path):
    jnet = _jax_net()
    p = str(tmp_path / "ref.zip")
    j_write_dl4j(jnet, p, dtype="DOUBLE")
    assert guess.guess_format(p) == jguess.guess_format(p) == "dl4j_zip"
    net = guess.load_model(p, dtype=F64, device="cpu")
    direct = restore_multi_layer_network_from_dl4j(p, dtype=F64,
                                                   device="cpu")
    assert net.num_params() == jnet.num_params()
    _params_bit_equal(jnet, net)
    assert torch.equal(net.output(_x()), direct.output(_x()))
    np.testing.assert_allclose(net.output(_x()).numpy(),
                               np.asarray(jnet.output(_x())), rtol=1e-12,
                               atol=1e-12)


def test_checkpoint_directories_of_both_packages(tmp_path):
    """Either package's checkpoint directory is "orbax" to both; the
    port's loads through ``load_model`` bit-equal to its net."""
    jnet = _jax_net()
    zp = str(tmp_path / "m.zip")
    j_write(jnet, zp)
    net = restore_model(zp, device="cpu")
    ours = save_checkpoint(net, str(tmp_path / "port_ck"))
    theirs = jck.save_checkpoint(jnet, str(tmp_path / "jax_ck"))
    for p in (ours, theirs):
        assert guess.guess_format(p) == jguess.guess_format(p) == "orbax"
    back = guess.load_model(ours, device="cpu")
    _params_bit_equal(jnet, back)
    assert torch.equal(back.output(_x(1)), net.output(_x(1)))


@pytest.mark.parametrize("functional", [False, True],
                         ids=["sequential", "functional"])
def test_keras_h5(tmp_path, functional):
    rng = np.random.default_rng(2)
    W, b = rng.normal(size=(4, 2)), rng.normal(size=(2,))
    dense = {"name": "d", "units": 2, "activation": "softmax"}
    if functional:
        config = {"class_name": "Model", "config": {
            "layers": [
                {"class_name": "InputLayer", "name": "in",
                 "config": {"name": "in", "batch_input_shape": [None, 4]},
                 "inbound_nodes": []},
                {"class_name": "Dense", "name": "d", "config": dense,
                 "inbound_nodes": [[["in", 0, 0, {}]]]}],
            "input_layers": [["in", 0, 0]], "output_layers": [["d", 0, 0]]}}
    else:
        config = {"class_name": "Sequential", "config": {"layers": [
            {"class_name": "Dense",
             "config": dict(dense, batch_input_shape=[None, 4])}]}}
    p = str(tmp_path / "k.h5")
    _write_h5(p, config, {"d": [W, b]})
    assert guess.guess_format(p) == jguess.guess_format(p) == "keras_h5"
    net = guess.load_model(p, device="cpu")
    jnet = jguess.load_model(p)
    assert isinstance(net, ComputationGraph) == functional
    _params_bit_equal(jnet, net)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    got = net.output(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.output(x)), rtol=1e-6,
                               atol=1e-6)
    z = x @ W + b
    e = np.exp(z - z.max(axis=1, keepdims=True))
    np.testing.assert_allclose(got, e / e.sum(axis=1, keepdims=True),
                               rtol=1e-4, atol=1e-5)


def _junk(kind, tmp_path):
    if kind == "bytes":
        p = str(tmp_path / "junk.bin")
        with open(p, "wb") as f:
            f.write(b"not a model")
    elif kind == "dir":
        p = str(tmp_path / "empty_dir")
        os.makedirs(p)
    elif kind == "zip":
        p = str(tmp_path / "other.zip")
        with zipfile.ZipFile(p, "w") as zf:
            zf.writestr("readme.txt", "nothing")
    else:
        import h5py
        p = str(tmp_path / "weights_only.h5")
        with h5py.File(p, "w") as f:
            f.create_group("d")
    return p


@pytest.mark.parametrize("kind", ["bytes", "dir", "zip", "weights_only_h5"])
def test_unknown_rejected(tmp_path, kind):
    p = _junk(kind, tmp_path)
    with pytest.raises(ValueError):
        guess.guess_format(p)
    with pytest.raises(ValueError):
        jguess.guess_format(p)


def test_the_card_is_the_default(tmp_path):
    p = str(tmp_path / "m.zip")
    j_write(_jax_net(), p)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            guess.load_model(p)
