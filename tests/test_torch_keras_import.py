"""The port's Keras import (deeplearning4j_tpu_torch/modelimport/keras.py
and hdf5.py) held against the JAX package's on the CPU.

Every case of tests/test_keras_import.py runs through both packages on
the same file or the same JSON + weights: the imported parameters and
batch-norm state are bit-equal, the F32 outputs lie within 1e-6 of the
JAX package's, and within the JAX test's tolerance of its independent
numpy forward of Keras's semantics. Also: the refusals, the in-place
weight copy, training after an import, the hard-sigmoid gate Keras 2
defaults to, the package importing without h5py, and the card as the
default device.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.modelimport import (
    import_keras_model_and_weights as j_model_and_weights)
from deeplearning4j_tpu.modelimport import (
    import_keras_sequential_model as j_sequential)
from deeplearning4j_tpu.modelimport import (
    import_keras_sequential_model_and_weights as j_sequential_and_weights)
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.modelimport import (
    KerasImportError, import_keras_model, import_keras_model_and_weights,
    import_keras_sequential_model,
    import_keras_sequential_model_and_weights)
from deeplearning4j_tpu_torch.modelimport import keras as pkeras

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_TOL = 1e-6          # port vs JAX package, F32 outputs
REF_RTOL, REF_ATOL = 1e-4, 1e-5   # vs the numpy forward (the JAX test's)


# ------------------------------------------------------- fixture writing
def write_keras_h5(path, model_config, layer_weights, keras_version="2.2.4",
                   training_config=None):
    """Write a Keras-layout .h5: model_config attr + model_weights group."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config).encode()
        f.attrs["keras_version"] = keras_version.encode()
        f.attrs["backend"] = b"tensorflow"
        if training_config is not None:
            f.attrs["training_config"] = json.dumps(training_config).encode()
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array(
            [n.encode() for n in layer_weights], dtype="S64")
        for lname, weights in layer_weights.items():
            g = mw.create_group(lname)
            names = [f"{lname}/w_{i}".encode() for i in range(len(weights))]
            g.attrs["weight_names"] = np.array(names, dtype="S64")
            for n, w in zip(names, weights):
                g.create_dataset(n.decode(), data=np.asarray(w, np.float32))


def seq_config(layers):
    return {"class_name": "Sequential", "config": {"layers": layers}}


# ------------------------------------------------- numpy keras reference
def np_relu(z):
    return np.maximum(z, 0.0)


def np_softmax(z):
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def np_conv2d_valid(x, K, b):
    """Naive channels_last 'valid' conv: x [b,h,w,cin], K [kh,kw,cin,cout]."""
    bs, h, w, cin = x.shape
    kh, kw, _, cout = K.shape
    oh, ow = h - kh + 1, w - kw + 1
    out = np.zeros((bs, oh, ow, cout))
    for i in range(oh):
        for j in range(ow):
            patch = x[:, i:i + kh, j:j + kw, :]
            out[:, i, j, :] = np.tensordot(patch, K, axes=([1, 2, 3],
                                                           [0, 1, 2]))
    return out + b


def np_maxpool2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))


def np_lstm(x, kernel, recurrent, bias, units, gate=None):
    """Keras-semantics LSTM (gates i,f,c,o; tanh cell), return_sequences."""
    gate = gate or (lambda z: 1.0 / (1.0 + np.exp(-z)))
    b, t, _ = x.shape
    h = np.zeros((b, units))
    c = np.zeros((b, units))
    ys = []
    for step in range(t):
        z = x[:, step, :] @ kernel + h @ recurrent + bias
        zi, zf, zc, zo = np.split(z, 4, axis=1)
        c = gate(zf) * c + gate(zi) * np.tanh(zc)
        h = gate(zo) * np.tanh(c)
        ys.append(h)
    return np.stack(ys, axis=1)


def lstm_weights(rng, feats, units):
    return (rng.normal(size=(feats, 4 * units)),
            rng.normal(size=(units, 4 * units)),
            rng.normal(size=(4 * units,)))


def lstm_config(name, units, t, feats, return_sequences=True):
    return {"class_name": "LSTM",
            "config": {"name": name, "units": units, "activation": "tanh",
                       "recurrent_activation": "sigmoid",
                       "return_sequences": return_sequences,
                       "batch_input_shape": [None, t, feats]}}


# ------------------------------------------------------------- the cases
def case_sequential_mlp(rng):
    W1, b1 = rng.normal(size=(5, 8)), rng.normal(size=(8,))
    W2, b2 = rng.normal(size=(8, 3)), rng.normal(size=(3,))
    config = seq_config([
        {"class_name": "Dense",
         "config": {"name": "d1", "units": 8, "activation": "relu",
                    "batch_input_shape": [None, 5]}},
        {"class_name": "Dense",
         "config": {"name": "d2", "units": 3, "activation": "softmax"}},
    ])
    x = rng.normal(size=(4, 5)).astype(np.float32)
    ref = np_softmax(np_relu(x @ W1 + b1) @ W2 + b2)
    return dict(config=config, weights={"d1": [W1, b1], "d2": [W2, b2]},
                x=(x,), ref=ref,
                training_config={"loss": "categorical_crossentropy"})


def case_sequential_cnn(rng):
    K1, b1 = rng.normal(size=(3, 3, 2, 4)), rng.normal(size=(4,))
    Wd = rng.normal(size=(3 * 3 * 4, 5))
    config = seq_config([
        {"class_name": "Conv2D",
         "config": {"name": "c1", "filters": 4, "kernel_size": [3, 3],
                    "strides": [1, 1], "padding": "valid",
                    "activation": "relu", "data_format": "channels_last",
                    "batch_input_shape": [None, 8, 8, 2]}},
        {"class_name": "MaxPooling2D",
         "config": {"name": "p1", "pool_size": [2, 2], "strides": [2, 2],
                    "padding": "valid"}},
        {"class_name": "Flatten", "config": {"name": "f1"}},
        {"class_name": "Dense",
         "config": {"name": "d1", "units": 5, "activation": "softmax"}},
    ])
    bd = rng.normal(size=(5,))
    x = rng.normal(size=(2, 8, 8, 2)).astype(np.float32)
    pooled = np_maxpool2(np_relu(np_conv2d_valid(x, K1, b1)))
    ref = np_softmax(pooled.reshape(2, -1) @ Wd + bd)
    return dict(config=config, weights={"c1": [K1, b1], "d1": [Wd, bd]},
                x=(x,), ref=ref)


def _cnn_ground_truth(rng, size, pool):
    K = rng.normal(size=(3, 3, 2, 4))              # HWIO ground truth
    b = rng.normal(size=(4,))
    side = (size - 2) // 2 if pool else size - 2
    Wd = rng.normal(size=(side * side * 4, 5))     # rows in (h, w, c) order
    bd = rng.normal(size=(5,))
    x = rng.normal(size=(2, size, size, 2)).astype(np.float32)
    conv = np_relu(np_conv2d_valid(x, K, b))
    feat = np_maxpool2(conv) if pool else conv
    ref = np_softmax(feat.reshape(2, -1) @ Wd + bd)
    perm = (np.arange(side * side * 4).reshape(side, side, 4)
            .transpose(2, 0, 1).reshape(-1))
    return K, b, Wd, bd, Wd[perm], x, ref


def case_channels_first_conv_and_dense_permutation(rng):
    """Keras 2 channels_first: the kernel stays HWIO, the post-Flatten
    Dense rows are (c, h, w)-ordered."""
    K, b, _, bd, Wd_cf, x, ref = _cnn_ground_truth(rng, 8, pool=True)
    config = seq_config([
        {"class_name": "Conv2D",
         "config": {"name": "c1", "filters": 4, "kernel_size": [3, 3],
                    "padding": "valid", "activation": "relu",
                    "data_format": "channels_first",
                    "batch_input_shape": [None, 2, 8, 8]}},
        {"class_name": "MaxPooling2D",
         "config": {"name": "p1", "pool_size": [2, 2],
                    "data_format": "channels_first"}},
        {"class_name": "Flatten",
         "config": {"name": "f1", "data_format": "channels_first"}},
        {"class_name": "Dense",
         "config": {"name": "d1", "units": 5, "activation": "softmax"}},
    ])
    return dict(config=config, weights={"c1": [K, b], "d1": [Wd_cf, bd]},
                x=(x,), ref=ref)


def case_keras1_theano_kernel_flip(rng):
    """Keras 1 'th': kernels (O, I, kh, kw) with Theano's 180-degree
    rotation; the post-Flatten Dense rows (c, h, w)-ordered."""
    K, b, _, bd, Wd_cf, x, ref = _cnn_ground_truth(rng, 5, pool=False)
    K_th = K.transpose(3, 2, 0, 1)[:, :, ::-1, ::-1]
    config = seq_config([
        {"class_name": "Convolution2D",
         "config": {"name": "c1", "nb_filter": 4, "nb_row": 3, "nb_col": 3,
                    "border_mode": "valid", "activation": "relu",
                    "dim_ordering": "th",
                    "batch_input_shape": [None, 2, 5, 5]}},
        {"class_name": "Flatten",
         "config": {"name": "f1", "dim_ordering": "th"}},
        {"class_name": "Dense",
         "config": {"name": "d1", "output_dim": 5, "activation": "softmax"}},
    ])
    return dict(config=config, weights={"c1": [K_th, b], "d1": [Wd_cf, bd]},
                x=(x,), ref=ref, keras_version="1.2.2")


def case_lstm_keras2(rng):
    units, feats = 6, 4
    kernel, recurrent, bias = lstm_weights(rng, feats, units)
    Wd, bd = rng.normal(size=(units, 3)), rng.normal(size=(3,))
    config = seq_config([
        lstm_config("l1", units, 5, feats, return_sequences=False),
        {"class_name": "Dense",
         "config": {"name": "d1", "units": 3, "activation": "softmax"}},
    ])
    x = rng.normal(size=(2, 5, feats)).astype(np.float32)
    seq = np_lstm(x, kernel, recurrent, bias, units)
    return dict(config=config,
                weights={"l1": [kernel, recurrent, bias], "d1": [Wd, bd]},
                x=(x,), ref=np_softmax(seq[:, -1, :] @ Wd + bd))


def case_lstm_keras1_split_weights(rng):
    units, feats = 5, 3
    kernel, recurrent, bias = lstm_weights(rng, feats, units)
    Wi, Wf, Wc, Wo = np.split(kernel, 4, axis=1)
    Ui, Uf, Uc, Uo = np.split(recurrent, 4, axis=1)
    bi, bf, bc, bo = np.split(bias, 4)
    config = seq_config([
        {"class_name": "LSTM",
         "config": {"name": "l1", "output_dim": units, "activation": "tanh",
                    "inner_activation": "sigmoid", "return_sequences": True,
                    "batch_input_shape": [None, 4, feats]}},
    ])
    x = rng.normal(size=(2, 4, feats)).astype(np.float32)
    return dict(config=config,
                weights={"l1": [Wi, Ui, bi, Wc, Uc, bc, Wf, Uf, bf, Wo, Uo,
                                bo]},
                x=(x,), ref=np_lstm(x, kernel, recurrent, bias, units),
                keras_version="1.2.2")


def case_batchnorm_inference_uses_moving_stats(rng):
    gamma = rng.normal(size=(6,)) + 1.0
    beta = rng.normal(size=(6,))
    mean = rng.normal(size=(6,))
    var = rng.uniform(0.5, 2.0, size=(6,))
    W, b = rng.normal(size=(6, 2)), rng.normal(size=(2,))
    config = seq_config([
        {"class_name": "BatchNormalization",
         "config": {"name": "bn", "epsilon": 1e-3, "momentum": 0.99,
                    "batch_input_shape": [None, 6]}},
        {"class_name": "Dense",
         "config": {"name": "d", "units": 2, "activation": "linear"}},
    ])
    x = rng.normal(size=(3, 6)).astype(np.float32)
    ref = (gamma * (x - mean) / np.sqrt(var + 1e-3) + beta) @ W + b
    return dict(config=config,
                weights={"bn": [gamma, beta, mean, var], "d": [W, b]},
                x=(x,), ref=ref)


def _functional(layers, inputs, outputs):
    return {"class_name": "Model",
            "config": {"layers": layers, "input_layers": inputs,
                       "output_layers": outputs}}


def _node(name):
    return [name, 0, 0, {}]


def case_functional_two_branch_model(rng):
    Wa, ba = rng.normal(size=(3, 4)), rng.normal(size=(4,))
    Wb, bb = rng.normal(size=(2, 4)), rng.normal(size=(4,))
    Wo, bo = rng.normal(size=(8, 2)), rng.normal(size=(2,))
    config = _functional([
        {"class_name": "InputLayer", "name": "in_a",
         "config": {"name": "in_a", "batch_input_shape": [None, 3]},
         "inbound_nodes": []},
        {"class_name": "InputLayer", "name": "in_b",
         "config": {"name": "in_b", "batch_input_shape": [None, 2]},
         "inbound_nodes": []},
        {"class_name": "Dense", "name": "da",
         "config": {"name": "da", "units": 4, "activation": "relu"},
         "inbound_nodes": [[_node("in_a")]]},
        {"class_name": "Dense", "name": "db",
         "config": {"name": "db", "units": 4, "activation": "relu"},
         "inbound_nodes": [[_node("in_b")]]},
        {"class_name": "Concatenate", "name": "cat",
         "config": {"name": "cat"},
         "inbound_nodes": [[_node("da"), _node("db")]]},
        {"class_name": "Dense", "name": "out",
         "config": {"name": "out", "units": 2, "activation": "softmax"},
         "inbound_nodes": [[_node("cat")]]},
    ], [["in_a", 0, 0], ["in_b", 0, 0]], [["out", 0, 0]])
    xa = rng.normal(size=(4, 3)).astype(np.float32)
    xb = rng.normal(size=(4, 2)).astype(np.float32)
    ref = np_softmax(np.concatenate([np_relu(xa @ Wa + ba),
                                     np_relu(xb @ Wb + bb)], axis=1)
                     @ Wo + bo)
    return dict(config=config,
                weights={"da": [Wa, ba], "db": [Wb, bb], "out": [Wo, bo]},
                x=(xa, xb), ref=ref, h5=False)


def case_time_distributed_dense_keras2_wrapper(rng):
    units, feats, t = 5, 4, 6
    kernel, recurrent, bias = lstm_weights(rng, feats, units)
    Wt, bt = rng.normal(size=(units, 7)), rng.normal(size=(7,))
    Wo, bo = rng.normal(size=(7, 3)), rng.normal(size=(3,))
    config = seq_config([
        lstm_config("l1", units, t, feats),
        {"class_name": "TimeDistributed",
         "config": {"name": "td", "layer": {
             "class_name": "Dense",
             "config": {"name": "td_inner", "units": 7,
                        "activation": "relu"}}}},
        {"class_name": "TimeDistributed",
         "config": {"name": "td_out", "layer": {
             "class_name": "Dense",
             "config": {"name": "td_out_inner", "units": 3,
                        "activation": "softmax"}}}},
    ])
    x = rng.normal(size=(2, t, feats)).astype(np.float32)
    seq = np_lstm(x, kernel, recurrent, bias, units)
    ref = np_softmax(np_relu(seq @ Wt + bt) @ Wo + bo)
    return dict(config=config, weights={"l1": [kernel, recurrent, bias],
                                        "td": [Wt, bt], "td_out": [Wo, bo]},
                x=(x,), ref=ref)


def case_time_distributed_dense_keras1(rng):
    units, feats, t = 4, 3, 5
    kernel, recurrent, bias = lstm_weights(rng, feats, units)
    Wt, bt = rng.normal(size=(units, 2)), rng.normal(size=(2,))
    config = seq_config([
        lstm_config("l1", units, t, feats),
        {"class_name": "TimeDistributedDense",
         "config": {"name": "tdd", "output_dim": 2,
                    "activation": "softmax"}},
    ])
    x = rng.normal(size=(2, t, feats)).astype(np.float32)
    seq = np_lstm(x, kernel, recurrent, bias, units)
    return dict(config=config, weights={"l1": [kernel, recurrent, bias],
                                        "tdd": [Wt, bt]},
                x=(x,), ref=np_softmax(seq @ Wt + bt))


def _global_pooling_1d(cls, npfn):
    def case(rng):
        units, feats, t = 4, 3, 5
        kernel, recurrent, bias = lstm_weights(rng, feats, units)
        Wd, bd = rng.normal(size=(units, 2)), rng.normal(size=(2,))
        config = seq_config([
            lstm_config("l1", units, t, feats),
            {"class_name": cls, "config": {"name": "gp"}},
            {"class_name": "Dense",
             "config": {"name": "d", "units": 2, "activation": "softmax"}},
        ])
        x = rng.normal(size=(2, t, feats)).astype(np.float32)
        seq = np_lstm(x, kernel, recurrent, bias, units)
        return dict(config=config, weights={"l1": [kernel, recurrent, bias],
                                            "d": [Wd, bd]},
                    x=(x,), ref=np_softmax(npfn(seq) @ Wd + bd))
    return case


def case_keras_loss_terminal_layer_for_vertex_output(rng):
    Wa, ba = rng.normal(size=(3, 4)), rng.normal(size=(4,))
    Wb, bb = rng.normal(size=(3, 4)), rng.normal(size=(4,))
    config = _functional([
        {"class_name": "InputLayer", "name": "in",
         "config": {"name": "in", "batch_input_shape": [None, 3]},
         "inbound_nodes": []},
        {"class_name": "Dense", "name": "da",
         "config": {"name": "da", "units": 4, "activation": "relu"},
         "inbound_nodes": [[_node("in")]]},
        {"class_name": "Dense", "name": "db",
         "config": {"name": "db", "units": 4, "activation": "relu"},
         "inbound_nodes": [[_node("in")]]},
        {"class_name": "Add", "name": "sum", "config": {"name": "sum"},
         "inbound_nodes": [[_node("da"), _node("db")]]},
    ], [["in", 0, 0]], [["sum", 0, 0]])
    x = rng.normal(size=(4, 3)).astype(np.float32)
    ref = np_relu(x @ Wa + ba) + np_relu(x @ Wb + bb)
    return dict(config=config, weights={"da": [Wa, ba], "db": [Wb, bb]},
                x=(x,), ref=ref, h5=False, training_loss="mse")


CASES = {
    "sequential_mlp": (0, case_sequential_mlp),
    "sequential_cnn": (1, case_sequential_cnn),
    "channels_first_conv_and_dense_permutation":
        (2, case_channels_first_conv_and_dense_permutation),
    "keras1_theano_kernel_flip": (7, case_keras1_theano_kernel_flip),
    "lstm_keras2": (3, case_lstm_keras2),
    "lstm_keras1_split_weights": (4, case_lstm_keras1_split_weights),
    "batchnorm_inference_uses_moving_stats":
        (5, case_batchnorm_inference_uses_moving_stats),
    "functional_two_branch_model": (6, case_functional_two_branch_model),
    "time_distributed_dense_keras2_wrapper":
        (11, case_time_distributed_dense_keras2_wrapper),
    "time_distributed_dense_keras1": (12, case_time_distributed_dense_keras1),
    "global_max_pooling_1d":
        (13, _global_pooling_1d("GlobalMaxPooling1D",
                                lambda s: s.max(axis=1))),
    "global_average_pooling_1d":
        (13, _global_pooling_1d("GlobalAveragePooling1D",
                                lambda s: s.mean(axis=1))),
    "keras_loss_terminal_layer_for_vertex_output":
        (14, case_keras_loss_terminal_layer_for_vertex_output),
}


def _import_both(case, tmp_path):
    """(JAX net, port net) of one case: through an .h5 file where the JAX
    test writes one, else through JSON + weights."""
    if case.get("h5", True):
        path = os.path.join(tmp_path, "model.h5")
        write_keras_h5(path, case["config"], case["weights"],
                       keras_version=case.get("keras_version", "2.2.4"),
                       training_config=case.get("training_config"))
        return j_sequential(path), import_keras_sequential_model(
            path, device="cpu")
    loss = case.get("training_loss")
    return (j_model_and_weights(case["config"], case["weights"],
                                training_loss=loss),
            import_keras_model_and_weights(case["config"], case["weights"],
                                           training_loss=loss,
                                           device="cpu"))


def assert_trees_bit_equal(jtree, ptree):
    """Every non-empty entry of the JAX package's tree is in the port's,
    with the same dtype and bits."""
    for name, leaves in jtree.items():
        for k, v in (leaves or {}).items():
            got = ptree[name][k]
            want = np.asarray(v)
            assert got.numpy().dtype == want.dtype, (name, k)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{name}/{k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_import_matches_the_jax_package(name, tmp_path):
    seed, make = CASES[name]
    case = make(np.random.default_rng(seed))
    jnet, pnet = _import_both(case, tmp_path)
    assert_trees_bit_equal(jnet.params, pnet.params)
    assert_trees_bit_equal(jnet.state, pnet.state)
    want = np.asarray(jnet.output(*case["x"]))
    got = pnet.output(*case["x"]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(got, case["ref"], rtol=REF_RTOL,
                               atol=REF_ATOL)


def test_sequential_mlp_takes_the_training_loss(tmp_path):
    case = case_sequential_mlp(np.random.default_rng(0))
    jnet, pnet = _import_both(case, tmp_path)
    assert pnet.conf.layers[-1].loss == jnet.conf.layers[-1].loss == "mcxent"
    assert json.loads(pnet.conf.to_json()) == json.loads(jnet.conf.to_json())


def test_imported_model_is_trainable(tmp_path):
    """20 SGD steps after the import, in both packages: the first score
    within 1e-6 relative, the last within 1e-4, and it falls."""
    rng = np.random.default_rng(7)
    config = seq_config([
        {"class_name": "Dense",
         "config": {"name": "d1", "units": 16, "activation": "relu",
                    "batch_input_shape": [None, 4]}},
        {"class_name": "Dense",
         "config": {"name": "d2", "units": 3, "activation": "softmax"}},
    ])
    path = os.path.join(tmp_path, "train.h5")
    write_keras_h5(path, config,
                   {"d1": [rng.normal(size=(4, 16)), np.zeros(16)],
                    "d2": [rng.normal(size=(16, 3)), np.zeros(3)]})
    jnet = j_sequential(path)
    pnet = import_keras_sequential_model(path, device="cpu")
    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    js = [float(jnet.fit_batch(JDataSet(x, y))) for _ in range(21)]
    ps = [float(pnet.fit_batch(DataSet(x, y))) for _ in range(21)]
    assert ps[0] == pytest.approx(js[0], rel=1e-6)
    assert ps[-1] == pytest.approx(js[-1], rel=1e-4)
    assert ps[-1] < ps[0]


def test_vertex_output_graph_trains_with_its_loss_layer():
    case = case_keras_loss_terminal_layer_for_vertex_output(
        np.random.default_rng(14))
    jnet = j_model_and_weights(case["config"], case["weights"],
                               training_loss="mse")
    pnet = import_keras_model_and_weights(case["config"], case["weights"],
                                          training_loss="mse", device="cpu")
    assert tuple(pnet.conf.network_outputs) == ("sum_loss",)
    x = case["x"][0]
    y = np.random.default_rng(15).normal(size=(4, 4)).astype(np.float32)
    js = float(jnet.fit_batch(JMultiDataSet([x], [y])))
    ps = float(pnet.fit_batch(MultiDataSet([x], [y])))
    assert np.isfinite(ps) and ps == pytest.approx(js, rel=1e-6)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_unsupported_layer_raises(package):
    config = seq_config([{"class_name": "Lambda", "config": {"name": "lam"}}])
    if package == "jax":
        from deeplearning4j_tpu.modelimport import KerasImportError as JErr
        with pytest.raises(JErr, match="Lambda"):
            j_sequential_and_weights(config, {})
    else:
        with pytest.raises(KerasImportError, match="Lambda"):
            import_keras_sequential_model_and_weights(config, {},
                                                      device="cpu")


def test_wrong_shape_raises():
    rng = np.random.default_rng(8)
    config = seq_config([
        {"class_name": "Dense",
         "config": {"name": "d1", "units": 8, "activation": "relu",
                    "batch_input_shape": [None, 5]}},
    ])
    with pytest.raises(KerasImportError, match="shape"):
        import_keras_sequential_model_and_weights(
            config, {"d1": [rng.normal(size=(4, 8)), np.zeros(8)]},
            device="cpu")


def test_weights_are_copied_into_the_nets_tensors():
    """The loaders write into the tensors init made (the ones the
    updater state and a captured step reference), in the master dtype."""
    case = case_lstm_keras2(np.random.default_rng(3))
    net = import_keras_sequential_model_and_weights(
        case["config"], {}, device="cpu")
    before = {k: v for k, v in net.params["l1"].items()}
    pkeras._lstm_loader()(net, "l1", case["weights"]["l1"])
    for k, t in net.params["l1"].items():
        assert t is before[k] and t.dtype == torch.float32
    kernel = np.asarray(case["weights"]["l1"][0])
    n = 6
    want = np.concatenate([kernel[:, :2 * n], kernel[:, 3 * n:],
                           kernel[:, 2 * n:3 * n]], axis=1)
    np.testing.assert_array_equal(net.params["l1"]["Wx"].numpy(),
                                  want.astype(np.float32))
    assert not net.params["l1"]["p"].any()


def test_keras2_default_gate_is_hard_sigmoid_in_both_packages():
    """An LSTM without ``recurrent_activation`` gets Keras 2's
    hard_sigmoid gate, as the JAX package gives it, and the same
    outputs."""
    rng = np.random.default_rng(21)
    units, feats, t = 4, 3, 5
    kernel, recurrent, bias = lstm_weights(rng, feats, units)
    cfg = lstm_config("l1", units, t, feats)
    del cfg["config"]["recurrent_activation"]
    config = seq_config([cfg])
    weights = {"l1": [kernel, recurrent, bias]}
    jnet = j_sequential_and_weights(config, weights)
    pnet = import_keras_sequential_model_and_weights(config, weights,
                                                     device="cpu")
    assert pnet.conf.layers[0].gate_activation == "hardsigmoid"
    assert jnet.conf.layers[0].gate_activation == "hardsigmoid"
    x = rng.normal(size=(2, t, feats)).astype(np.float32)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=OUT_TOL,
                               atol=OUT_TOL)
    hard = lambda z: np.clip(0.2 * z + 0.5, 0.0, 1.0)  # noqa: E731
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np_lstm(x, kernel, recurrent, bias, units,
                                       gate=hard), rtol=REF_RTOL,
                               atol=REF_ATOL)


def test_functional_h5_entry_point(tmp_path):
    """import_keras_model reads a functional model's .h5 as the JAX
    package's JSON entry point builds it."""
    case = case_functional_two_branch_model(np.random.default_rng(6))
    path = os.path.join(tmp_path, "func.h5")
    write_keras_h5(path, case["config"], case["weights"])
    pnet = import_keras_model(path, device="cpu")
    jnet = j_model_and_weights(case["config"], case["weights"])
    assert_trees_bit_equal(jnet.params, pnet.params)
    np.testing.assert_allclose(pnet.output(*case["x"]).numpy(),
                               np.asarray(jnet.output(*case["x"])),
                               rtol=OUT_TOL, atol=OUT_TOL)


def test_the_package_imports_without_h5py_and_the_card_is_the_default():
    code = ("import sys\n"
            "sys.modules['h5py'] = None\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['deeplearning4j_tpu'] = None\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "import deeplearning4j_tpu_torch.modelimport as m\n"
            "import deeplearning4j_tpu_torch.modelimport.dl4j\n"
            "import deeplearning4j_tpu_torch.utils.model_guesser\n"
            "try:\n"
            "    m.import_keras_sequential_model('x.h5', device='cpu')\n"
            "except ImportError:\n"
            "    print('needs h5py')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "needs h5py"
    if not torch.cuda.is_available():
        case = case_sequential_mlp(np.random.default_rng(0))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            import_keras_sequential_model_and_weights(case["config"],
                                                      case["weights"])
