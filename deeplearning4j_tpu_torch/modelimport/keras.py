"""Keras (1.x and 2.x) JSON + weights and HDF5 -> the port's networks
(counterpart of deeplearning4j_tpu/modelimport/keras.py).

Parity: KerasModelImport.java:48-231 (Sequential -> MultiLayerNetwork,
functional Model -> ComputationGraph), KerasModel.java /
KerasSequentialModel.java (config translation), KerasLayer.java (layer
registry + Theano/TensorFlow weight-layout permutations). The same
translation as the JAX package's, layer for layer, into the port's
configurations.

Supported layers: InputLayer, Dense, Activation, Dropout, Flatten,
Conv2D/Convolution2D, MaxPooling2D, AveragePooling2D, ZeroPadding2D,
GlobalMax/AveragePooling2D, BatchNormalization, Embedding, LSTM, and (for
functional graphs) Merge/Concatenate/Add/Multiply/Subtract.

Weight-layout conversions (KerasLayer.java analogue):
- Dense: kernel (in, out) -> W directly; channels_first models get their
  first post-Flatten Dense's rows permuted from (c, h, w) to our NHWC
  (h, w, c) flatten order.
- Conv2D: channels_last kernels are HWIO (ours); Keras 1 Theano-ordered
  kernels (O, I, kh, kw) are un-rotated and transposed to HWIO.
- LSTM Keras 2: kernel/recurrent_kernel/bias are gate-ordered (i, f, c, o);
  ours is (i, f, o, g=c) — columns permuted. Keras 1 stores 12 per-gate
  arrays (W_i, U_i, b_i, W_c, ...) which are concatenated the same way.
  Peepholes (absent in Keras) are zero, which disables them exactly.
- BatchNormalization: (gamma, beta, moving_mean, moving_variance) ->
  params gamma/beta + state mean/var.

The net is built and initialized on ``device`` (default: the card; pass
``device="cpu"`` for the plain versions) and the weights are then copied
into its parameter tensors in place, in their master dtype, so the
tensors its updater state and captured step reference are the imported
ones. The HDF5 entry points need ``h5py`` (modelimport/hdf5.py); the
JSON + weights entry points do not.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers_conv import (
    BatchNorm,
    Convolution2D,
    GlobalPooling,
    Subsampling,
    ZeroPadding,
)
from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import (
    GravesLSTM, LastTimeStep, RnnOutput, TimeDistributedDense)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import CnnToFeedForward
from deeplearning4j_tpu_torch.nn.conf.vertices import (
    ElementWiseVertex,
    MergeVertex,
    PreprocessorVertex,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.convolution import out_size


class KerasImportError(Exception):
    pass


_ACTIVATIONS = {
    "linear": "identity",
    "relu": "relu",
    "tanh": "tanh",
    "sigmoid": "sigmoid",
    "softmax": "softmax",
    "hard_sigmoid": "hardsigmoid",
    "softplus": "softplus",
    "softsign": "softsign",
    "elu": "elu",
    "selu": "selu",
    "swish": "swish",
    "gelu": "gelu",
}

_LOSSES = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse",
    "mse": "mse",
    "mean_absolute_error": "mae",
    "mae": "mae",
    "mean_absolute_percentage_error": "mape",
    "mean_squared_logarithmic_error": "msle",
    "hinge": "hinge",
    "squared_hinge": "squaredhinge",
    "kullback_leibler_divergence": "kldivergence",
    "poisson": "poisson",
    "cosine_proximity": "cosineproximity",
}


def _act(name: Optional[str]) -> str:
    if name is None:
        return "identity"
    if name not in _ACTIVATIONS:
        raise KerasImportError(f"Unsupported Keras activation '{name}'")
    return _ACTIVATIONS[name]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _padding_mode(cfg) -> str:
    mode = cfg.get("padding", cfg.get("border_mode", "valid"))
    if mode == "valid":
        return "truncate"
    if mode == "same":
        return "same"
    raise KerasImportError(f"Unsupported Keras padding mode '{mode}'")


def _channels_first(cfg, default: bool) -> bool:
    fmt = cfg.get("data_format", cfg.get("dim_ordering"))
    if fmt in ("channels_first", "th"):
        return True
    if fmt in ("channels_last", "tf"):
        return False
    return default


@dataclass
class _Ctx:
    """Translation context threaded through the layer walk."""

    channels_first: bool = False          # model-wide default ordering
    shape: Optional[Tuple[int, int, int]] = None   # (h, w, c) if conv-land
    flatten_cf: Optional[Tuple[int, int, int]] = None  # pending row permute
    loss: Optional[str] = None            # from training_config


@dataclass
class _Translated:
    conf: object                          # our layer/vertex conf (or None)
    keras_name: str
    loader: Optional[Callable] = None     # loader(net, our_name, arrays)
    preprocessor: object = None           # for Sequential flatten handling


# --------------------------------------------------------------- loaders
_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def copy_into(t: torch.Tensor, v):
    """Write the array ``v`` into the tensor ``t`` in place (its device
    and dtype), rounded once to ``t``'s dtype (through native float64 for
    a dtype numpy lacks)."""
    a = np.asarray(v).astype(_NUMPY_DTYPES.get(t.dtype, np.float64),
                             copy=False)
    with torch.no_grad():
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)))


def _set_params(net, name, **arrays):
    target = net.params.get(name)
    if target is None:
        raise KerasImportError(f"Layer '{name}' has no parameters to set")
    for k, v in arrays.items():
        if k not in target:
            raise KerasImportError(f"Layer '{name}' has no parameter '{k}'")
        if tuple(target[k].shape) != tuple(np.shape(v)):
            raise KerasImportError(
                f"Layer '{name}' param '{k}': shape {np.shape(v)} does not "
                f"match expected {tuple(target[k].shape)}")
        copy_into(target[k], v)


def _set_state(net, name, **arrays):
    target = net.state.get(name)
    for k, v in arrays.items():
        copy_into(target[k], v)


def _dense_loader(ctx_flatten_cf):
    def load(net, name, arrays):
        if not arrays:
            return
        W = np.asarray(arrays[0])
        if ctx_flatten_cf is not None:
            h, w, c = ctx_flatten_cf
            if W.shape[0] == h * w * c:
                # rows stored in (c, h, w) flatten order -> our (h, w, c)
                perm = (np.arange(h * w * c)
                        .reshape(c, h, w).transpose(1, 2, 0).reshape(-1))
                W = W[perm]
        kw = {"W": W}
        if len(arrays) > 1:
            kw["b"] = np.asarray(arrays[1])
        _set_params(net, name, **kw)
    return load


def _conv_loader(theano_kernel):
    """Kernel layout conversion (KerasConvolution.java:108-137 parity).

    Keras 2 stores conv kernels HWIO regardless of data_format — ours is
    HWIO, so no transform. Keras 1 'tf' dim ordering is also HWIO. Keras 1
    'th' (Theano) kernels are (out, in, kh, kw) AND Theano rotates filters
    180 degrees before application (KerasConvolution.java:124-137), so the
    spatial window is flipped then transposed to HWIO."""
    def load(net, name, arrays):
        if not arrays:
            return
        K = np.asarray(arrays[0])
        if theano_kernel:
            # (out, in, kh, kw): rotate each filter 180deg, then -> HWIO
            K = K[:, :, ::-1, ::-1].transpose(2, 3, 1, 0)
        kw = {"W": K}
        if len(arrays) > 1:
            kw["b"] = np.asarray(arrays[1])
        _set_params(net, name, **kw)
    return load


def _lstm_permute_gates(a, n, axis):
    """Keras gate order (i, f, c, o) -> ours (i, f, o, g=c) along axis."""
    blocks = np.split(np.asarray(a), 4, axis=axis)
    i, f, c, o = blocks
    return np.concatenate([i, f, o, c], axis=axis)


def _lstm_loader():
    def load(net, name, arrays):
        if not arrays:
            return
        if len(arrays) == 3:        # Keras 2: kernel, recurrent, bias
            Wx, Wh, b = (np.asarray(a) for a in arrays)
        elif len(arrays) == 12:     # Keras 1: per-gate W/U/b in i,c,f,o
            Wi, Ui, bi, Wc, Uc, bc, Wf, Uf, bf, Wo, Uo, bo = (
                np.asarray(a) for a in arrays)
            Wx = np.concatenate([Wi, Wf, Wc, Wo], axis=1)
            Wh = np.concatenate([Ui, Uf, Uc, Uo], axis=1)
            b = np.concatenate([bi, bf, bc, bo])
        else:
            raise KerasImportError(
                f"LSTM layer '{name}': expected 3 (Keras 2) or 12 (Keras 1)"
                f" weight arrays, got {len(arrays)}")
        n = Wh.shape[0]
        _set_params(net, name,
                    Wx=_lstm_permute_gates(Wx, n, 1),
                    Wh=_lstm_permute_gates(Wh, n, 1),
                    b=_lstm_permute_gates(b, n, 0),
                    p=np.zeros((3, n), np.float32))
    return load


def _bn_loader():
    def load(net, name, arrays):
        arrays = [np.asarray(a) for a in arrays]
        if len(arrays) == 4:
            gamma, beta, mean, var = arrays
        elif len(arrays) == 2:      # scale=False/center=False variants
            gamma, beta = arrays
            mean = var = None
        else:
            raise KerasImportError(
                f"BatchNormalization '{name}': unsupported weight count "
                f"{len(arrays)}")
        _set_params(net, name, gamma=gamma, beta=beta)
        if mean is not None:
            _set_state(net, name, mean=mean, var=var)
    return load


def _embedding_loader():
    def load(net, name, arrays):
        if arrays:
            _set_params(net, name, W=np.asarray(arrays[0]))
    return load


# ----------------------------------------------------------- translation
def _input_type_from_shape(shape, channels_first) -> Optional[InputType]:
    """batch_input_shape (without batch dim) -> InputType."""
    dims = [d for d in shape if d is not None]
    if len(dims) == 3:
        if channels_first:
            c, h, w = dims
        else:
            h, w, c = dims
        return InputType.convolutional(h, w, c)
    if len(dims) == 2:
        t, f = dims
        return InputType.recurrent(f, t)
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    return None


def _update_shape_conv(ctx, kh, kw, sh, sw, mode, n_out=None, pad=(0, 0)):
    if ctx.shape is None:
        return
    h, w, c = ctx.shape
    ph, pw = pad
    ctx.shape = (out_size(h, kh, sh, ph, mode), out_size(w, kw, sw, pw, mode),
                 n_out if n_out is not None else c)


def _translate_layer(class_name: str, cfg: dict, ctx: _Ctx, *,
                     is_output: bool) -> List[_Translated]:
    """One Keras layer dict -> zero or more of our layer confs + loaders."""
    name = cfg.get("name", class_name.lower())
    out: List[_Translated] = []

    if class_name in ("InputLayer",):
        shape = cfg.get("batch_input_shape") or cfg.get("batch_shape")
        if shape is not None:
            cf = _channels_first(cfg, ctx.channels_first)
            it = _input_type_from_shape(shape[1:], cf)
            if it is not None and it.kind == "convolutional":
                ctx.shape = (it.height, it.width, it.channels)
        return out

    if class_name == "Dense":
        n_out = int(cfg.get("units", cfg.get("output_dim")))
        act = _act(cfg.get("activation", "linear"))
        flatten_cf = ctx.flatten_cf
        ctx.flatten_cf = None
        use_bias = bool(cfg.get("use_bias", cfg.get("bias", True)))
        if is_output:
            loss = ctx.loss or ("mcxent" if act == "softmax" else "mse")
            conf = L.Output(name=name, n_out=n_out, activation=act,
                            loss=loss, has_bias=use_bias)
        else:
            conf = L.Dense(name=name, n_out=n_out, activation=act,
                           has_bias=use_bias)
        out.append(_Translated(conf, name, _dense_loader(flatten_cf)))
        return out

    if class_name == "Activation":
        out.append(_Translated(
            L.ActivationLayer(name=name,
                              activation=_act(cfg.get("activation"))),
            name))
        return out

    if class_name == "Dropout":
        rate = float(cfg.get("rate", cfg.get("p", 0.5)))
        out.append(_Translated(L.Dropout(name=name, dropout=rate), name))
        return out

    if class_name == "Flatten":
        cf = _channels_first(cfg, ctx.channels_first)
        if cf and ctx.shape is not None:
            ctx.flatten_cf = ctx.shape
        # shape adapter inserted automatically (Sequential) or via
        # PreprocessorVertex (functional)
        if ctx.shape is not None:
            h, w, c = ctx.shape
            prep = CnnToFeedForward(h, w, c)
        else:
            prep = CnnToFeedForward()
        out.append(_Translated(None, name, preprocessor=prep))
        return out

    if class_name in ("Conv2D", "Convolution2D"):
        cf = _channels_first(cfg, ctx.channels_first)
        # Keras-1-only config keys identify a Keras 1 file; only Keras 1
        # Theano-ordered kernels need a layout transform (see _conv_loader)
        keras1 = "nb_filter" in cfg or "dim_ordering" in cfg
        theano_kernel = keras1 and cf
        n_out = int(cfg.get("filters", cfg.get("nb_filter")))
        if "kernel_size" in cfg:
            kh, kw = _pair(cfg["kernel_size"])
        else:
            kh, kw = int(cfg["nb_row"]), int(cfg["nb_col"])
        sh, sw = _pair(cfg.get("strides", cfg.get("subsample", (1, 1))))
        mode = _padding_mode(cfg)
        act = _act(cfg.get("activation", "linear"))
        use_bias = bool(cfg.get("use_bias", cfg.get("bias", True)))
        conf = Convolution2D(name=name, n_out=n_out, kernel=(kh, kw),
                             stride=(sh, sw), mode=mode, activation=act,
                             has_bias=use_bias)
        _update_shape_conv(ctx, kh, kw, sh, sw, mode, n_out)
        out.append(_Translated(conf, name, _conv_loader(theano_kernel)))
        return out

    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        kh, kw = _pair(cfg.get("pool_size", (2, 2)))
        strides = cfg.get("strides")
        sh, sw = _pair(strides) if strides else (kh, kw)
        mode = _padding_mode(cfg)
        pooling = "max" if class_name.startswith("Max") else "avg"
        conf = Subsampling(name=name, kernel=(kh, kw), stride=(sh, sw),
                           pooling=pooling, mode=mode)
        _update_shape_conv(ctx, kh, kw, sh, sw, mode)
        out.append(_Translated(conf, name))
        return out

    if class_name == "ZeroPadding2D":
        pad = cfg.get("padding", (1, 1))
        if isinstance(pad, (list, tuple)) and len(pad) == 2 \
                and all(isinstance(p, (list, tuple)) for p in pad):
            (pt, pb), (pl, pr) = pad
        else:
            ph, pw = _pair(pad)
            pt = pb = ph
            pl = pr = pw
        conf = ZeroPadding(name=name, pad=(int(pt), int(pb), int(pl),
                                           int(pr)))
        if ctx.shape is not None:
            h, w, c = ctx.shape
            ctx.shape = (h + pt + pb, w + pl + pr, c)
        out.append(_Translated(conf, name))
        return out

    if class_name in ("GlobalMaxPooling2D", "GlobalAveragePooling2D"):
        pooling = "max" if "Max" in class_name else "avg"
        conf = GlobalPooling(name=name, pooling=pooling)
        ctx.shape = None
        out.append(_Translated(conf, name))
        return out

    if class_name == "BatchNormalization":
        eps = float(cfg.get("epsilon", 1e-3))
        momentum = float(cfg.get("momentum", cfg.get("mode", 0.99))
                         if not isinstance(cfg.get("momentum"), dict)
                         else 0.99)
        conf = BatchNorm(name=name, eps=eps, decay=momentum,
                         activation="identity")
        out.append(_Translated(conf, name, _bn_loader()))
        return out

    if class_name == "Embedding":
        n_in = int(cfg.get("input_dim"))
        n_out = int(cfg.get("output_dim"))
        conf = L.Embedding(name=name, n_in=n_in, n_out=n_out)
        out.append(_Translated(conf, name, _embedding_loader()))
        return out

    if class_name in ("GlobalMaxPooling1D", "GlobalAveragePooling1D"):
        # [b, t, f] -> [b, f] over the time axis (KerasLayer.java:225-230
        # maps these to GlobalPoolingLayer)
        pooling = "max" if "Max" in class_name else "avg"
        out.append(_Translated(GlobalPooling(name=name, pooling=pooling),
                               name))
        return out

    if class_name in ("TimeDistributedDense", "TimeDistributed"):
        # Keras 1 TimeDistributedDense, or the Keras 2 TimeDistributed
        # wrapper around a Dense (KerasLayer.java:206-212 maps both to
        # DenseLayer; here a first-class per-timestep dense)
        inner = cfg.get("layer")
        if class_name == "TimeDistributed":
            if not inner or inner.get("class_name") != "Dense":
                raise KerasImportError(
                    "TimeDistributed is only supported around Dense "
                    f"(got {inner and inner.get('class_name')})")
            dcfg = inner.get("config", {})
        else:
            dcfg = cfg
        n_out = int(dcfg.get("units", dcfg.get("output_dim")))
        act = _act(dcfg.get("activation", "linear"))
        use_bias = bool(dcfg.get("use_bias", dcfg.get("bias", True)))
        if is_output:
            loss = ctx.loss or ("mcxent" if act == "softmax" else "mse")
            conf = RnnOutput(name=name, n_out=n_out, activation=act,
                             loss=loss, has_bias=use_bias)
        else:
            conf = TimeDistributedDense(name=name, n_out=n_out,
                                        activation=act, has_bias=use_bias)
        out.append(_Translated(conf, name, _dense_loader(None)))
        return out

    if class_name == "Masking":
        # masking flows via the DataSet feature mask in this framework —
        # the layer itself is shape-identity, but silently processing
        # padded steps as data would diverge from the source model
        warnings.warn(
            f"Keras Masking layer '{name}' imported as identity: supply "
            "the padding pattern as a DataSet feature mask (features_mask) "
            "or padded timesteps WILL be processed as real data",
            UserWarning)
        return out

    if class_name == "LSTM":
        n_out = int(cfg.get("units", cfg.get("output_dim")))
        act = _act(cfg.get("activation", "tanh"))
        # Keras 2's default gate is hard_sigmoid: such an LSTM takes the
        # counted composed route on the card (ops/lstm.py::lstm_route)
        gate = _act(cfg.get("recurrent_activation",
                            cfg.get("inner_activation", "hard_sigmoid")))
        conf = GravesLSTM(name=name, n_out=n_out, activation=act,
                          gate_activation=gate)
        out.append(_Translated(conf, name, _lstm_loader()))
        if not cfg.get("return_sequences", False):
            out.append(_Translated(LastTimeStep(name=f"{name}_last",
                                                n_out=n_out),
                                   f"{name}_last"))
        return out

    raise KerasImportError(f"Unsupported Keras layer type '{class_name}'")


def _parse_model_config(config) -> Tuple[str, list, dict]:
    """Returns (model_class, layer dicts, extras)."""
    if isinstance(config, str):
        config = json.loads(config)
    cls = config.get("class_name")
    cfg = config.get("config")
    if cls == "Sequential":
        layers = cfg if isinstance(cfg, list) else cfg.get("layers", [])
        return "Sequential", layers, {}
    if cls in ("Model", "Functional"):
        return "Model", cfg.get("layers", []), {
            "input_layers": cfg.get("input_layers", []),
            "output_layers": cfg.get("output_layers", []),
        }
    raise KerasImportError(f"Unsupported model class '{cls}'")


def _extract_loss(training_config: Optional[dict]) -> Optional[str]:
    if not training_config:
        return None
    loss = training_config.get("loss")
    if isinstance(loss, dict):
        loss = next(iter(loss.values()), None)
    if isinstance(loss, str):
        return _LOSSES.get(loss)
    return None


# ------------------------------------------------------------ sequential
def import_keras_sequential_model_and_weights(
        model_json, weights: Dict[str, List[np.ndarray]], *,
        training_loss: Optional[str] = None,
        device=None) -> MultiLayerNetwork:
    """Keras Sequential JSON + per-layer weight arrays -> a trained
    MultiLayerNetwork on ``device`` (default: the card)
    (KerasModelImport.importKerasSequentialModelAndWeights parity)."""
    cls, layer_dicts, _ = _parse_model_config(model_json)
    if cls != "Sequential":
        raise KerasImportError(
            "Not a Sequential model; use import_keras_model_and_weights")

    ctx = _Ctx(loss=training_loss)
    translated: List[_Translated] = []
    input_type = None
    for i, ld in enumerate(layer_dicts):
        class_name = ld["class_name"]
        cfg = dict(ld.get("config", {}))
        if i == 0 or input_type is None:
            shape = cfg.get("batch_input_shape") or cfg.get("batch_shape")
            if shape is not None:
                cf = _channels_first(cfg, ctx.channels_first)
                it = _input_type_from_shape(shape[1:], cf)
                if it is not None and input_type is None:
                    input_type = it
                    if it.kind == "convolutional":
                        ctx.shape = (it.height, it.width, it.channels)
        is_output = (i == len(layer_dicts) - 1)
        translated.extend(
            _translate_layer(class_name, cfg, ctx, is_output=is_output))

    builder = NeuralNetConfiguration.builder().list()
    prep_for_next = None
    layer_idx = 0
    loaders: List[Tuple[str, str, Callable]] = []  # (keras, ours, loader)
    for t in translated:
        if t.conf is None:
            prep_for_next = t.preprocessor
            continue
        builder = builder.layer(t.conf)
        if prep_for_next is not None:
            builder = builder.input_preprocessor(layer_idx, prep_for_next)
            prep_for_next = None
        if t.loader is not None:
            loaders.append((t.keras_name, t.conf.name, t.loader))
        layer_idx += 1
    if input_type is not None:
        builder = builder.set_input_type(input_type)
    net = MultiLayerNetwork(builder.build(), device=device).init()

    for keras_name, our_name, loader in loaders:
        loader(net, our_name, weights.get(keras_name, []))
    return net


def import_keras_sequential_model(path: str, *,
                                  device=None) -> MultiLayerNetwork:
    """Import a full-model Keras HDF5 file (architecture + weights) onto
    ``device`` (default: the card). Needs ``h5py``."""
    with Hdf5Archive(path) as ar:
        config = ar.model_config()
        if config is None:
            raise KerasImportError(
                f"{path} has no model_config attribute (weights-only file? "
                "use import_keras_sequential_model_and_weights with a JSON)")
        loss = _extract_loss(ar.training_config())
        return import_keras_sequential_model_and_weights(
            config, ar.all_weights(), training_loss=loss, device=device)


# ------------------------------------------------------------ functional
def _inbound_names(layer_dict) -> List[str]:
    """Normalize Keras 1/2 inbound_nodes to a list of input layer names."""
    nodes = layer_dict.get("inbound_nodes", [])
    if not nodes:
        return []
    node = nodes[0]
    names = []
    if isinstance(node, dict):    # very new Keras: {"args": [...]}
        raise KerasImportError("Unsupported inbound_nodes format (dict)")
    for entry in node:
        if isinstance(entry, (list, tuple)):
            names.append(entry[0])
        else:
            names.append(entry)
    return names


def import_keras_model_and_weights(
        model_json, weights: Dict[str, List[np.ndarray]], *,
        training_loss: Optional[str] = None,
        device=None) -> ComputationGraph:
    """Keras functional-Model JSON + weights -> a ComputationGraph on
    ``device`` (default: the card)
    (KerasModelImport.importKerasModelAndWeights parity)."""
    cls, layer_dicts, extras = _parse_model_config(model_json)
    if cls != "Model":
        raise KerasImportError(
            "Not a functional model; use "
            "import_keras_sequential_model_and_weights")

    out_names = {e[0] if isinstance(e, (list, tuple)) else e
                 for e in extras["output_layers"]}
    in_names = [e[0] if isinstance(e, (list, tuple)) else e
                for e in extras["input_layers"]]

    g = NeuralNetConfiguration.builder().graph_builder()
    g.add_inputs(*in_names)

    ctx = _Ctx(loss=training_loss)
    input_types = []
    loaders: List[Tuple[str, str, Callable]] = []
    # keras layer name -> final translated vertex name: when a layer's
    # translation ends in an extra vertex (e.g. LSTM with
    # return_sequences=False appends a LastTimeStep), later layers and
    # set_outputs must resolve the Keras name to that LAST vertex, not the
    # intermediate one (otherwise the full-sequence output leaks through)
    alias: Dict[str, str] = {}
    for ld in layer_dicts:
        class_name = ld["class_name"]
        cfg = dict(ld.get("config", {}))
        name = cfg.get("name", ld.get("name"))
        inputs = [alias.get(i, i) for i in _inbound_names(ld)]

        if class_name == "InputLayer":
            shape = cfg.get("batch_input_shape") or cfg.get("batch_shape")
            cf = _channels_first(cfg, ctx.channels_first)
            it = _input_type_from_shape(shape[1:], cf) if shape else None
            if it is None:
                raise KerasImportError(
                    f"InputLayer '{name}' has no batch_input_shape")
            input_types.append(it)
            if it.kind == "convolutional":
                ctx.shape = (it.height, it.width, it.channels)
            continue

        if class_name in ("Concatenate", "Merge"):
            mode = cfg.get("mode", "concat")
            if class_name == "Concatenate" or mode == "concat":
                g.add_vertex(name, MergeVertex(), *inputs)
            elif mode in ("sum", "add"):
                g.add_vertex(name, ElementWiseVertex(op="add"), *inputs)
            elif mode == "mul":
                g.add_vertex(name, ElementWiseVertex(op="product"), *inputs)
            else:
                raise KerasImportError(f"Unsupported Merge mode '{mode}'")
            continue
        if class_name == "Add":
            g.add_vertex(name, ElementWiseVertex(op="add"), *inputs)
            continue
        if class_name == "Multiply":
            g.add_vertex(name, ElementWiseVertex(op="product"), *inputs)
            continue
        if class_name == "Subtract":
            g.add_vertex(name, ElementWiseVertex(op="sub"), *inputs)
            continue

        translated = _translate_layer(class_name, cfg, ctx,
                                      is_output=name in out_names)
        prev = inputs
        for t in translated:
            if t.conf is None:
                g.add_vertex(t.keras_name,
                             PreprocessorVertex(
                                 preprocessor=t.preprocessor),
                             *prev)
                prev = [t.keras_name]
                continue
            g.add_layer(t.conf.name, t.conf, *prev)
            if t.loader is not None:
                loaders.append((t.keras_name, t.conf.name, t.loader))
            prev = [t.conf.name]
        if prev and prev[0] != name:
            alias[name] = prev[0]

    out_resolved = [alias.get(n, n) for n in
                    (e[0] if isinstance(e, (list, tuple)) else e
                     for e in extras["output_layers"])]
    # KerasLoss parity (modelimport KerasLoss.java): an output that is not
    # a loss-bearing layer (e.g. a merge vertex or bare activation) gets a
    # terminal LossLayer with the training loss appended — identity
    # activation, so inference outputs are unchanged but fit() works
    final_outputs = []
    for n in out_resolved:
        vconf = g.get_vertex(n)
        has_loss = hasattr(vconf, "loss") if vconf is not None else False
        if has_loss:
            final_outputs.append(n)
        else:
            loss_name = f"{n}_loss"
            g.add_layer(loss_name,
                        L.LossLayer(name=loss_name,
                                    loss=ctx.loss or "mse",
                                    activation="identity"), n)
            final_outputs.append(loss_name)
    g.set_outputs(*final_outputs)
    if input_types:
        g.set_input_types(*input_types)
    net = ComputationGraph(g.build(), device=device).init()

    for keras_name, our_name, loader in loaders:
        loader(net, our_name, weights.get(keras_name, []))
    return net


def import_keras_model(path: str, *, device=None) -> ComputationGraph:
    """Import a full functional-model Keras HDF5 file onto ``device``
    (default: the card). Needs ``h5py``."""
    with Hdf5Archive(path) as ar:
        config = ar.model_config()
        if config is None:
            raise KerasImportError(f"{path} has no model_config attribute")
        loss = _extract_loss(ar.training_config())
        return import_keras_model_and_weights(
            config, ar.all_weights(), training_loss=loss, device=device)
