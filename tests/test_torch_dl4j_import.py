"""The port's DL4J zip reader and writer (deeplearning4j_tpu_torch/
modelimport/dl4j.py) held against the JAX package's on the CPU: the
cases of tests/test_dl4j_import.py and tests/test_dl4j_golden.py.

- The ND4J binary: both writers give the same bytes, each reader reads
  the other's, the headerless variant parses.
- A JAX net's zip restores in the port with bit-equal parameters and
  batch-norm state, F64 outputs within 1e-12 of the JAX net's (1e-10
  after a batch-norm step), and the port writes it back byte for byte.
- The hand-packed golden fixture: every parameter placed as the JAX
  package places it, the forward against numpy within 1e-12 (F64) and
  against the JAX package within 1e-6 (F32), and the writer reproduces
  its coefficients.bin byte for byte.
- The refusals: a parameter count that does not match, malformed layer
  JSON, and the card as the default device.
"""

import io
import json
import os
import struct
import sys
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.modelimport import dl4j as jdl4j
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.conf.layers_conv import BatchNorm as JBatchNorm
from deeplearning4j_tpu.nn.conf.layers_conv import (
    Convolution2D as JConvolution2D)
from deeplearning4j_tpu.nn.conf.layers_conv import Subsampling as JSubsampling
from deeplearning4j_tpu.nn.conf.layers_recurrent import (
    GravesLSTM as JGravesLSTM)
from deeplearning4j_tpu.nn.conf.layers_recurrent import RnnOutput as JRnnOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.modelimport import dl4j
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
GOLDEN = os.path.join(FIXTURES, "dl4j_mlp_golden.zip")
F64 = DtypePolicy(param_dtype="float64", compute_dtype="float64")
F32 = DtypePolicy(param_dtype="float32", compute_dtype="float32")
JF64 = JDtypePolicy(param_dtype="float64", compute_dtype="float64")
JF32 = JDtypePolicy(param_dtype="float32", compute_dtype="float32")

sys.path.insert(0, FIXTURES)
import build_dl4j_golden as golden_builder  # noqa: E402


def assert_trees_bit_equal(jtree, ptree, names):
    for name in names:
        for k, v in (jtree.get(name) or {}).items():
            want = np.asarray(v)
            got = ptree[name][k].numpy()
            assert got.dtype == want.dtype, (name, k)
            np.testing.assert_array_equal(got, want, err_msg=f"{name}/{k}")


def members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


# ------------------------------------------------------------ nd4j binary
@pytest.mark.parametrize("arr,dtype", [
    (np.arange(12, dtype=np.float32).reshape(3, 4), "FLOAT"),
    (np.random.default_rng(0).normal(size=(1, 7)), "DOUBLE"),
], ids=["float_2d", "double_row"])
def test_nd4j_binary_equals_the_jax_packages(arr, dtype):
    ours, theirs = io.BytesIO(), io.BytesIO()
    dl4j.write_nd4j_array(ours, arr, dtype=dtype)
    jdl4j.write_nd4j_array(theirs, arr, dtype=dtype)
    assert ours.getvalue() == theirs.getvalue()
    theirs.seek(0)
    got = dl4j.read_nd4j_array(theirs)
    np.testing.assert_array_equal(got, arr)
    ours.seek(0)
    np.testing.assert_array_equal(jdl4j.read_nd4j_array(ours), arr)


def test_headerless_buffer_variant():
    # some point releases omit the allocation-mode UTF; the reader must
    # accept both
    buf = io.BytesIO()
    si = np.asarray([2, 2, 3, 3, 1, 0, 1, ord("c")], np.int64)

    def utf(s):
        b = s.encode()
        return struct.pack(">H", len(b)) + b

    for payload, tn in ((si, "INT"),
                        (np.arange(6, dtype=np.float32), "FLOAT")):
        buf.write(struct.pack(">i", payload.size))
        buf.write(utf(tn))
        dt = ">i4" if tn == "INT" else ">f4"
        buf.write(payload.astype(dt).tobytes())
    buf.seek(0)
    out = dl4j.read_nd4j_array(buf)
    np.testing.assert_array_equal(
        out, np.arange(6, dtype=np.float32).reshape(2, 3))


# --------------------------------------------- round trips from the JAX side
def _jax_mlp():
    conf = (JNNC.builder().seed(1).dtype(JF64).list()
            .layer(JDense(n_in=6, n_out=5, activation="tanh"))
            .layer(JOutput(n_in=5, n_out=3, activation="softmax",
                           loss="mcxent"))
            .build())
    net = JMLN(conf).init()
    return net, np.random.default_rng(0).normal(size=(4, 6)), None, 1e-12


def _jax_cnn_with_bn():
    conf = (JNNC.builder().seed(2).dtype(JF64).list()
            .layer(JConvolution2D(n_out=4, kernel=(3, 3),
                                  activation="identity"))
            .layer(JBatchNorm(activation="relu"))
            .layer(JSubsampling(kernel=(2, 2), stride=(2, 2),
                                pooling="max"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.convolutional(8, 8, 2))
            .build())
    net = JMLN(conf).init()
    # make BN state non-trivial before export
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 8, 8, 2))
    y = np.eye(3)[rng.integers(0, 3, 8)]
    net.fit_batch(JDataSet(x, y))
    return net, x, InputType.convolutional(8, 8, 2), 1e-10


def _jax_lstm_with_peepholes():
    import jax.numpy as jnp
    conf = (JNNC.builder().seed(3).dtype(JF64).list()
            .layer(JGravesLSTM(n_in=4, n_out=6, activation="tanh"))
            .layer(JRnnOutput(n_in=6, n_out=3, activation="softmax",
                              loss="mcxent"))
            .build())
    net = JMLN(conf).init()
    # non-zero peepholes so the peephole column mapping is exercised
    p0 = dict(net.params["layer_0"])
    p0["p"] = jnp.asarray(np.random.default_rng(2).normal(size=(3, 6)))
    net.params = {**net.params, "layer_0": p0}
    return net, np.random.default_rng(0).normal(size=(2, 5, 4)), None, 1e-12


@pytest.mark.parametrize("make", [_jax_mlp, _jax_cnn_with_bn,
                                  _jax_lstm_with_peepholes],
                         ids=["mlp", "cnn_with_bn", "lstm_gate_permutation"])
def test_jax_zip_restores_in_the_port_and_writes_back(make, tmp_path):
    jnet, x, input_type, tol = make()
    src = str(tmp_path / "jax.zip")
    jdl4j.write_dl4j_zip(jnet, src, dtype="DOUBLE")
    pnet = dl4j.restore_multi_layer_network_from_dl4j(
        src, input_type=input_type, dtype=F64, device="cpu")
    names = [layer.name for layer in jnet.layers]
    assert [layer.name for layer in pnet.layers] == names
    assert_trees_bit_equal(jnet.params, pnet.params, names)
    assert_trees_bit_equal(jnet.state, pnet.state, names)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=tol, atol=tol)
    back = str(tmp_path / "port.zip")
    dl4j.write_dl4j_zip(pnet, back, dtype="DOUBLE")
    assert members(back) == members(src)


def test_era_variant_field_names(tmp_path):
    # 0.7/0.8-era @class activation objects + nIn/nOut casing must parse
    rng = np.random.default_rng(5)
    W = rng.normal(size=(4, 2))
    b = rng.normal(size=(2,))
    flat = np.concatenate([W.reshape(-1, order="F"), b]).reshape(1, -1)
    confs = {"confs": [{"layer": {"output": {
        "nIn": 4, "nOut": 2,
        "activationFn": {
            "@class": "org.nd4j.linalg.activations.impl.ActivationSoftmax"},
        "lossFn": {"@class": "org.nd4j.linalg.lossfunctions.impl."
                             "LossMCXENT"},
    }}}]}
    p = str(tmp_path / "era.zip")
    buf = io.BytesIO()
    dl4j.write_nd4j_array(buf, flat, dtype="DOUBLE")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("configuration.json", json.dumps(confs))
        zf.writestr("coefficients.bin", buf.getvalue())
    net = dl4j.restore_multi_layer_network_from_dl4j(p, dtype=F64,
                                                     device="cpu")
    jnet = jdl4j.restore_multi_layer_network_from_dl4j(p, dtype=JF64)
    assert net.conf.layers[0].loss == jnet.conf.layers[0].loss == "mcxent"
    x = rng.normal(size=(3, 4))
    z = x @ W + b
    e = np.exp(z - z.max(axis=1, keepdims=True))
    want = e / e.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(net.output(x).numpy(), want, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_param_count_mismatch_rejected(package, tmp_path):
    flat = np.zeros((1, 5), np.float32)
    confs = {"confs": [{"layer": {"dense": {"nin": 4, "nout": 2,
                                            "activation": "tanh"}}}]}
    p = str(tmp_path / "bad.zip")
    buf = io.BytesIO()
    dl4j.write_nd4j_array(buf, flat)
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("configuration.json", json.dumps(confs))
        zf.writestr("coefficients.bin", buf.getvalue())
    with pytest.raises(ValueError, match="holds 5 params"):
        if package == "jax":
            jdl4j.restore_multi_layer_network_from_dl4j(p)
        else:
            dl4j.restore_multi_layer_network_from_dl4j(p, device="cpu")


def test_inherited_global_activation_round_trips(tmp_path):
    """Layers inheriting the network-wide activation export the resolved
    activation; the JAX package restores the port's zip to the same
    outputs."""
    conf = (NeuralNetConfiguration.builder().seed(11).dtype(F64)
            .activation("relu")
            .list()
            .layer(Dense(n_in=5, n_out=8))
            .layer(Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    p = str(tmp_path / "glob.zip")
    dl4j.write_dl4j_zip(net, p, dtype="DOUBLE")
    with zipfile.ZipFile(p) as zf:
        confs = json.loads(zf.read("configuration.json"))["confs"]
    assert confs[0]["layer"]["dense"]["activation"] == "relu"
    net2 = dl4j.restore_multi_layer_network_from_dl4j(p, dtype=F64,
                                                      device="cpu")
    jnet = jdl4j.restore_multi_layer_network_from_dl4j(p, dtype=JF64)
    x = np.random.default_rng(3).normal(size=(4, 5))
    np.testing.assert_allclose(net2.output(x).numpy(), net.output(x).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(net2.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=1e-12,
                               atol=1e-12)


def test_updater_state_member_warns(tmp_path):
    net = dl4j.restore_multi_layer_network_from_dl4j(GOLDEN, dtype=F64,
                                                     device="cpu")
    p = str(tmp_path / "upd.zip")
    dl4j.write_dl4j_zip(net, p)
    with zipfile.ZipFile(p, "a") as zf:
        zf.writestr("updaterState.bin", b"")
    with pytest.warns(UserWarning, match="updaterState.bin"):
        dl4j.restore_multi_layer_network_from_dl4j(p, device="cpu")


# ---------------------------------------------------------- golden fixture
def test_builder_matches_committed_fixture():
    with open(GOLDEN, "rb") as f:
        assert f.read() == golden_builder.build()


def test_golden_coefficients_binary_layout():
    with zipfile.ZipFile(GOLDEN) as zf:
        arr = dl4j.read_nd4j_array(io.BytesIO(zf.read("coefficients.bin")))
    assert arr.shape == (1, 26)
    np.testing.assert_array_equal(arr.astype(np.float32).ravel(),
                                  golden_builder.FLAT)


def test_import_places_every_parameter():
    net = dl4j.restore_multi_layer_network_from_dl4j(GOLDEN, dtype=F64,
                                                     device="cpu")
    jnet = jdl4j.restore_multi_layer_network_from_dl4j(GOLDEN, dtype=JF64)
    names = [layer.name for layer in jnet.layers]
    assert_trees_bit_equal(jnet.params, net.params, names)
    flat = golden_builder.FLAT.astype(np.float64)
    p0 = net.params[net.layers[0].name]
    p1 = net.params[net.layers[1].name]
    np.testing.assert_array_equal(p0["W"].numpy(),
                                  flat[:12].reshape(3, 4, order="F"))
    np.testing.assert_array_equal(p0["b"].numpy(), flat[12:16])
    np.testing.assert_array_equal(p1["W"].numpy(),
                                  flat[16:24].reshape(4, 2, order="F"))
    np.testing.assert_array_equal(p1["b"].numpy(), flat[24:26])
    assert p0["W"].numpy()[1, 2] == np.float64(np.float32(-0.80))
    assert p1["W"].numpy()[3, 1] == np.float64(np.float32(-0.95))


def _golden_numpy_forward(x):
    flat = golden_builder.FLAT.astype(np.float64)
    h = np.tanh(x @ flat[:12].reshape(3, 4, order="F") + flat[12:16])
    logits = h @ flat[16:24].reshape(4, 2, order="F") + flat[24:26]
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def test_golden_forward_matches_numpy_and_the_jax_package():
    x = np.asarray([[0.3, -0.1, 0.8], [1.0, 0.5, -0.25]], np.float64)
    net = dl4j.restore_multi_layer_network_from_dl4j(GOLDEN, dtype=F64,
                                                     device="cpu")
    np.testing.assert_allclose(net.output(x).numpy(),
                               _golden_numpy_forward(x), rtol=1e-12,
                               atol=1e-12)
    # F32, as the chip phase runs it: the port against the JAX package
    n32 = dl4j.restore_multi_layer_network_from_dl4j(GOLDEN, dtype=F32,
                                                     device="cpu")
    j32 = jdl4j.restore_multi_layer_network_from_dl4j(GOLDEN, dtype=JF32)
    x32 = x.astype(np.float32)
    got = n32.output(x32).numpy()
    np.testing.assert_allclose(got, np.asarray(j32.output(x32)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got, _golden_numpy_forward(x), rtol=1e-6,
                               atol=1e-6)


def test_writer_reproduces_golden_bytes(tmp_path):
    net = dl4j.restore_multi_layer_network_from_dl4j(GOLDEN, dtype=F64,
                                                     device="cpu")
    out = str(tmp_path / "roundtrip.zip")
    dl4j.write_dl4j_zip(net, out)
    with zipfile.ZipFile(GOLDEN) as zf:
        golden_coeff = zf.read("coefficients.bin")
    ours = members(out)
    assert ours["coefficients.bin"] == golden_coeff
    assert len(json.loads(ours["configuration.json"])["confs"]) == 2
    jout = str(tmp_path / "jax.zip")
    jdl4j.write_dl4j_zip(
        jdl4j.restore_multi_layer_network_from_dl4j(GOLDEN, dtype=JF64),
        jout)
    assert members(jout) == ours
    net2 = dl4j.restore_multi_layer_network_from_dl4j(out, dtype=F64,
                                                      device="cpu")
    for l1, l2 in zip(net.layers, net2.layers):
        for k in net.params[l1.name]:
            assert torch.equal(net.params[l1.name][k],
                               net2.params[l2.name][k]), k


@pytest.mark.parametrize("kind,ld,match", [
    ("batchNormalization", {"eps": 1e-5}, "neither nIn nor nOut"),
    ("dense", {"nin": 3, "activationFunction": "tanh"}, "missing required"),
    ("gravesLSTM", {"nout": 8}, "missing required"),
    ("lambda", {}, "unsupported layer type"),
])
def test_malformed_layer_json_raises(kind, ld, match):
    with pytest.raises(ValueError, match=match):
        dl4j.translate_layer(kind, ld)
    with pytest.raises(ValueError, match=match):
        jdl4j.translate_layer(kind, ld)


def test_the_card_is_the_default():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dl4j.restore_multi_layer_network_from_dl4j(GOLDEN)
