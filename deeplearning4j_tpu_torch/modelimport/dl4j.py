"""DL4J checkpoint (.zip) importer and writer (counterpart of
deeplearning4j_tpu/modelimport/dl4j.py): the reference's ModelSerializer
format into and out of the port's MultiLayerNetwork.

Format (util/ModelSerializer.java:79-95): a ZIP containing
``configuration.json`` (the Jackson-serialized MultiLayerConfiguration),
``coefficients.bin`` (ONE flattened parameter row vector written with
``Nd4j.write`` :99) and optionally ``updaterState.bin`` (:118). The flat
vector concatenates every layer's parameters in layer order, each layer
using its ParamInitializer's view layout:

- Dense/Output (DefaultParamInitializer.java:60-88):
  [W (nIn*nOut, 'f'-order [nIn, nOut]), b (nOut)]
- Convolution (ConvolutionParamInitializer.java:62-85): [b (nOut),
  W ('c'-order [nOut, nIn, kH, kW])] -> transposed to our HWIO
- BatchNorm (BatchNormalizationParamInitializer.java:56-70):
  [gamma, beta, mean, var] (each nOut; mean/var -> layer STATE here)
- GravesLSTM (GravesLSTMParamInitializer.java:88-96): [W_in ('f'
  [nLast, 4nL]), RW ('f' [nL, 4nL+3]), b (4nL)]. DL4J's gate column
  order is [g(candidate), f, o, i] with peephole columns
  [wFF, wOO, wGG] = [forget, output, input-gate] peepholes
  (LSTMHelpers.java:59-61,174-231); ours is [i, f, o, g] with
  p = [input, forget, output], so columns are permuted on load.

ND4J binary array layout (BaseDataBuffer.write of the 0.5-0.8 era): two
DataBuffers back to back — the shapeInfo int buffer then the data buffer —
each as {writeUTF(allocation mode), writeInt(length), writeUTF(type name),
big-endian elements}. The reader tolerates the allocation-mode header
being present or absent (it changed across point releases).

configuration.json field names vary across the reference's releases
(plain strings in 0.5/0.6, @class-wrapped activation/loss objects in
0.7/0.8); the translator accepts both. The hand-packed golden fixture
(tests/fixtures/dl4j_mlp_golden.zip) pins the format: the importer reads
it and the writer reproduces its coefficients.bin byte for byte.

The restored net is built on ``device`` (default: the card) and the
zip's values are copied into its parameter and state tensors in place,
rounded once from the file's values to the master dtype.
"""

from __future__ import annotations

import io
import json
import struct
import warnings
import zipfile

import numpy as np
import torch

_ALLOC_MODES = {"HEAP", "JAVACPP", "DIRECT", "WORKSPACE", "MIXED_DATA_TYPES",
                "LONG_SHAPE"}


# ----------------------------------------------------------- nd4j binary
def _read_utf(f) -> str:
    n = struct.unpack(">H", f.read(2))[0]
    return f.read(n).decode("utf-8")


def _write_utf(f, s: str):
    b = s.encode("utf-8")
    f.write(struct.pack(">H", len(b)))
    f.write(b)


_DTYPES = {"INT": (">i4", 4), "FLOAT": (">f4", 4), "DOUBLE": (">f8", 8),
           "LONG": (">i8", 8)}


def _read_databuffer(f):
    pos = f.tell()
    try:
        first = _read_utf(f)
        headered = first in _ALLOC_MODES
    except (UnicodeDecodeError, KeyError):
        # headerless variant: the probe read raw int/float bytes (large
        # buffers make the fake "UTF length" huge and non-UTF8)
        headered = False
    if headered:
        length = struct.unpack(">i", f.read(4))[0]
        type_name = _read_utf(f)
    else:
        f.seek(pos)
        length = struct.unpack(">i", f.read(4))[0]
        type_name = _read_utf(f)
    dt, size = _DTYPES[type_name]
    return np.frombuffer(f.read(length * size), dtype=dt, count=length)


def _write_databuffer(f, arr: np.ndarray, type_name: str):
    _write_utf(f, "HEAP")
    f.write(struct.pack(">i", arr.size))
    _write_utf(f, type_name)
    f.write(arr.astype(_DTYPES[type_name][0]).tobytes())


def read_nd4j_array(f) -> np.ndarray:
    """Nd4j.read parity: shapeInfo buffer + data buffer."""
    shape_info = _read_databuffer(f).astype(np.int64)
    rank = int(shape_info[0])
    shape = tuple(int(s) for s in shape_info[1:1 + rank])
    order = chr(int(shape_info[-1]))
    data = _read_databuffer(f)
    return np.asarray(data).reshape(shape, order="F" if order == "f" else "C")


def write_nd4j_array(f, arr: np.ndarray, dtype: str = "FLOAT"):
    """Nd4j.write parity ('c'-order row vector, as ModelSerializer emits)."""
    arr = np.ascontiguousarray(arr)
    rank = arr.ndim
    shape = list(arr.shape)
    strides = []
    acc = 1
    for s in reversed(shape):
        strides.insert(0, acc)
        acc *= s
    shape_info = np.asarray([rank] + shape + strides + [0, 1, ord("c")],
                            dtype=np.int64)
    _write_databuffer(f, shape_info, "INT")
    _write_databuffer(f, arr.reshape(-1), dtype)


# ------------------------------------------------------- json translation
def _first(d: dict, *names, default=None):
    for n in names:
        if n in d:
            return d[n]
    return default


def _activation_name(layer: dict) -> str:
    a = _first(layer, "activationFn", "activationFunction", "activation")
    if a is None:
        return "identity"
    if isinstance(a, str):
        return a.lower()
    if isinstance(a, dict):
        cls = a.get("@class", "")
        if cls:
            name = cls.rsplit(".", 1)[-1]
            return name.replace("Activation", "").lower()
        # wrapper-object form {"Tanh": {}}
        if len(a) == 1:
            return next(iter(a)).lower()
    return "identity"


_LOSS_MAP = {
    "MCXENT": "mcxent", "LossMCXENT": "mcxent",
    "MSE": "mse", "LossMSE": "mse", "LossL2": "l2",
    "NEGATIVELOGLIKELIHOOD": "mcxent", "LossNegativeLogLikelihood": "mcxent",
    "XENT": "xent", "LossBinaryXENT": "xent",
    "L1": "l1", "LossL1": "l1", "MAE": "mae", "LossMAE": "mae",
}


def _loss_name(layer: dict) -> str:
    lf = _first(layer, "lossFn", "lossFunction", "loss")
    if lf is None:
        return "mcxent"
    if isinstance(lf, str):
        return _LOSS_MAP.get(lf, lf.lower())
    if isinstance(lf, dict):
        cls = lf.get("@class", "")
        if cls:
            return _LOSS_MAP.get(cls.rsplit(".", 1)[-1], "mcxent")
        if len(lf) == 1:
            return _LOSS_MAP.get(next(iter(lf)), "mcxent")
    return "mcxent"


def _unwrap_layer(conf: dict):
    """A NeuralNetConfiguration JSON holds its layer either wrapper-object
    typed ({"layer": {"dense": {...}}}) or @class typed."""
    layer = conf.get("layer", conf)
    if "@class" in layer:
        cls = layer["@class"].rsplit(".", 1)[-1]
        return cls[0].lower() + cls[1:], layer
    if len(layer) == 1:
        k = next(iter(layer))
        if isinstance(layer[k], dict):
            return k, layer[k]
    return None, layer


def _pair(v, default):
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def translate_layer(kind: str, ld: dict):
    """One DL4J layer JSON dict -> (our layer config, flat-vector loader,
    its parameter count).

    The loader takes (flat_segment, params_out, state_out) and fills
    param/state dicts of numpy arrays from the reference's view layout."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                         Dense, Output)
    from deeplearning4j_tpu_torch.nn.conf.layers_conv import (BatchNorm,
                                                              Convolution2D,
                                                              Subsampling)
    from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import (
        GravesLSTM, RnnOutput)

    act = _activation_name(ld)
    n_in = _first(ld, "nin", "nIn", "NIn")
    n_out = _first(ld, "nout", "nOut", "NOut")
    n_in = None if n_in is None else int(n_in)
    n_out = None if n_out is None else int(n_out)

    def _require(**named):
        # fail loudly on a malformed layer dict: slicing with a None
        # bound would silently produce wrong-length parameter views
        missing = [k for k, v in named.items() if v is None]
        if missing:
            raise ValueError(
                f"DL4J-zip import: layer '{kind}' is missing required "
                f"field(s) {missing} in configuration.json")

    def dense_load(seg, params, state):
        nw = n_in * n_out
        params["W"] = seg[:nw].reshape(n_in, n_out, order="F")
        params["b"] = seg[nw:nw + n_out]

    if kind in ("dense", "denseLayer"):
        _require(nIn=n_in, nOut=n_out)
        conf = Dense(n_in=n_in, n_out=n_out, activation=act)
        return conf, dense_load, n_in * n_out + n_out

    if kind in ("output", "outputLayer"):
        _require(nIn=n_in, nOut=n_out)
        conf = Output(n_in=n_in, n_out=n_out, activation=act,
                      loss=_loss_name(ld))
        return conf, dense_load, n_in * n_out + n_out

    if kind in ("rnnoutput", "rnnOutputLayer", "rnnOutput"):
        _require(nIn=n_in, nOut=n_out)
        conf = RnnOutput(n_in=n_in, n_out=n_out, activation=act,
                         loss=_loss_name(ld))
        return conf, dense_load, n_in * n_out + n_out

    if kind in ("convolution", "convolutionLayer", "convolution2D"):
        _require(nIn=n_in, nOut=n_out)
        kh, kw = _pair(_first(ld, "kernelSize", "kernel"), (5, 5))
        sh, sw = _pair(_first(ld, "stride"), (1, 1))
        ph, pw = _pair(_first(ld, "padding"), (0, 0))
        mode = str(_first(ld, "convolutionMode", default="truncate")).lower()
        conf = Convolution2D(n_in=n_in, n_out=n_out, kernel=(kh, kw),
                             stride=(sh, sw), padding=(ph, pw),
                             mode=mode if mode in ("same", "strict",
                                                   "truncate") else "truncate",
                             activation=act)
        nw = n_out * n_in * kh * kw

        def load(seg, params, state):
            params["b"] = seg[:n_out]
            W = seg[n_out:n_out + nw].reshape(n_out, n_in, kh, kw, order="C")
            params["W"] = W.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        return conf, load, n_out + nw

    if kind in ("subsampling", "subsamplingLayer"):
        kh, kw = _pair(_first(ld, "kernelSize", "kernel"), (2, 2))
        sh, sw = _pair(_first(ld, "stride"), (2, 2))
        pool = str(_first(ld, "poolingType", default="MAX")).lower()
        conf = Subsampling(kernel=(kh, kw), stride=(sh, sw),
                           pooling="avg" if pool.startswith("avg") else pool)
        return conf, None, 0

    if kind in ("batchNormalization", "batchNorm"):
        if n_out is None and n_in is None:
            raise ValueError(
                "DL4J-zip import: batchNormalization layer carries neither "
                "nIn nor nOut in configuration.json — cannot size "
                "gamma/beta/mean/var")
        f = n_out if n_out else n_in
        conf = BatchNorm(eps=float(_first(ld, "eps", default=1e-5)),
                         decay=float(_first(ld, "decay", default=0.9)),
                         activation=act)

        def load(seg, params, state):
            params["gamma"] = seg[:f]
            params["beta"] = seg[f:2 * f]
            state["mean"] = seg[2 * f:3 * f]
            state["var"] = seg[3 * f:4 * f]
        return conf, load, 4 * f

    if kind in ("gravesLSTM", "graveslstm", "gravesLstm"):
        _require(nIn=n_in, nOut=n_out)
        gate_act = _first(ld, "gateActivationFn", "gateActivationFunction")
        gate = "sigmoid"
        if gate_act is not None:
            gate = _activation_name({"activationFn": gate_act})
        conf = GravesLSTM(n_in=n_in, n_out=n_out, activation=act,
                          gate_activation=gate)
        nL = n_out
        n_wx = n_in * 4 * nL
        n_rw = nL * (4 * nL + 3)

        def load(seg, params, state):
            # DL4J gate columns [g, f, o, i] -> ours [i, f, o, g]
            def regate(W):
                g_, f_, o_, i_ = (W[:, :nL], W[:, nL:2 * nL],
                                  W[:, 2 * nL:3 * nL], W[:, 3 * nL:4 * nL])
                return np.concatenate([i_, f_, o_, g_], axis=1)
            Wx = seg[:n_wx].reshape(n_in, 4 * nL, order="F")
            RW = seg[n_wx:n_wx + n_rw].reshape(nL, 4 * nL + 3, order="F")
            b = seg[n_wx + n_rw:n_wx + n_rw + 4 * nL]
            params["Wx"] = regate(Wx)
            params["Wh"] = regate(RW[:, :4 * nL])
            # peephole columns [wFF, wOO, wGG] -> p = [input, forget, output]
            params["p"] = np.stack([RW[:, 4 * nL + 2], RW[:, 4 * nL],
                                    RW[:, 4 * nL + 1]])
            params["b"] = regate(b.reshape(1, 4 * nL))[0]
        return conf, load, n_wx + n_rw + 4 * nL

    if kind in ("activation", "activationLayer"):
        return ActivationLayer(activation=act), None, 0

    raise ValueError(
        f"DL4J-zip import: unsupported layer type '{kind}' (supported: "
        "dense, output, rnnoutput, convolution, subsampling, "
        "batchNormalization, gravesLSTM, activation)")


def restore_multi_layer_network_from_dl4j(path: str, input_type=None,
                                          dtype=None, *, device=None):
    """ModelSerializer.restoreMultiLayerNetwork parity: read a reference
    .zip checkpoint into a MultiLayerNetwork on ``device`` (default: the
    card) with identical parameters. ``dtype`` optionally sets the
    DtypePolicy of the restored net (the reference stores f32; default
    keeps the default policy)."""
    from deeplearning4j_tpu_torch.modelimport.keras import copy_into
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(path) as zf:
        conf_json = json.loads(zf.read("configuration.json").decode("utf-8"))
        flat = read_nd4j_array(io.BytesIO(zf.read("coefficients.bin")))
        if "updaterState.bin" in zf.namelist():
            warnings.warn(
                "DL4J-zip import: updaterState.bin present but NOT "
                "restored — optimizer moments restart from zero (the "
                "reference's flat updater-state view layout is not mapped "
                "yet); expect a transient loss bump if training is "
                "continued", UserWarning)
    # the file's own dtype: each value is rounded once, to the master
    # dtype, when it is copied into its tensor (as through float64)
    flat = np.asarray(flat).reshape(-1)

    confs = conf_json.get("confs")
    if confs is None:
        raise ValueError(
            "configuration.json has no 'confs' — ComputationGraph zips are "
            "not supported yet (MultiLayerConfiguration only)")

    b0 = NeuralNetConfiguration.builder()
    if dtype is not None:
        b0 = b0.dtype(dtype)
    builder = b0.list()
    loaders = []
    offset = 0
    for c in confs:
        kind, ld = _unwrap_layer(c)
        conf, loader, n_params = translate_layer(kind, ld)
        builder = builder.layer(conf)
        loaders.append((loader, offset, n_params))
        offset += n_params
    if offset != flat.size:
        raise ValueError(
            f"coefficients.bin holds {flat.size} params but the "
            f"configuration implies {offset}")
    if input_type is not None:
        builder = builder.set_input_type(input_type)
    net = MultiLayerNetwork(builder.build(), device=device).init()

    for layer, (loader, off, n) in zip(net.layers, loaders):
        if loader is None:
            continue
        params, state = {}, {}
        loader(flat[off:off + n], params, state)
        for tree, values in ((net.params, params), (net.state, state)):
            for k, v in values.items():
                copy_into(tree[layer.name][k], v)
    return net


def write_dl4j_zip(net, path: str, *, dtype: str = "FLOAT"):
    """Export a MultiLayerNetwork to the reference's zip layout
    (ModelSerializer.writeModel :79-95) — the symmetric writer used to pin
    the format in tests and to hand checkpoints BACK to a reference
    stack."""
    confs = []
    segs = []
    for layer in net.layers:
        kind, ld, seg = _export_layer(net, layer, layer.conf)
        confs.append({"layer": {kind: ld}})
        if seg is not None:
            segs.append(seg)
    flat = (np.concatenate([s.reshape(-1) for s in segs])
            if segs else np.zeros((0,), np.float32))
    buf = io.BytesIO()
    write_nd4j_array(buf, flat.reshape(1, -1), dtype)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps({"confs": confs}))
        zf.writestr("coefficients.bin", buf.getvalue())


def _host(tree: dict) -> dict:
    """The tree's tensors as host arrays in their own dtype (float32 or
    float64; anything else widened to float64): the writer rounds each
    once, to the file's dtype."""
    out = {}
    for k, v in tree.items():
        t = v.detach().cpu()
        if t.dtype not in (torch.float32, torch.float64):
            t = t.double()
        out[k] = t.numpy()
    return out


def _export_layer(net, layer, lc):
    p = _host(net.params.get(layer.name, {}))
    s = _host(net.state.get(layer.name, {}) if net.state else {})
    t = lc.layer_type
    # per-layer activation may be None (inherited from the global conf) —
    # the zip must carry the RESOLVED value or the restored net silently
    # runs identity activations
    act = layer.resolve("activation", "identity")

    if t in ("dense", "output", "rnn_output"):
        kind = {"dense": "dense", "output": "output",
                "rnn_output": "rnnoutput"}[t]
        ld = {"nin": int(lc.n_in), "nout": int(lc.n_out),
              "activation": act}
        if t != "dense":
            ld["lossFunction"] = (lc.loss or "mcxent").upper()
        seg = np.concatenate([p["W"].reshape(-1, order="F"),
                              p["b"].reshape(-1)])
        return kind, ld, seg

    if t == "conv2d":
        kh, kw = lc.kernel
        ld = {"nin": int(lc.n_in), "nout": int(lc.n_out),
              "kernelSize": [kh, kw], "stride": list(lc.stride),
              "padding": list(lc.padding),
              "convolutionMode": lc.mode.capitalize(),
              "activation": act}
        W = p["W"].transpose(3, 2, 0, 1)  # HWIO -> OIHW
        seg = np.concatenate([p["b"].reshape(-1), W.reshape(-1, order="C")])
        return "convolution", ld, seg

    if t == "subsampling":
        ld = {"kernelSize": list(lc.kernel), "stride": list(lc.stride),
              "poolingType": lc.pooling.upper()}
        return "subsampling", ld, None

    if t == "batch_norm":
        f = p["gamma"].shape[0]
        ld = {"nin": f, "nout": f, "eps": lc.eps, "decay": lc.decay,
              "activation": act}
        seg = np.concatenate([p["gamma"], p["beta"], s["mean"], s["var"]])
        return "batchNormalization", ld, seg

    if t == "graves_lstm":
        nL = int(lc.n_out)

        def degate(W):  # ours [i,f,o,g] -> DL4J [g,f,o,i]
            i_, f_, o_, g_ = (W[:, :nL], W[:, nL:2 * nL],
                              W[:, 2 * nL:3 * nL], W[:, 3 * nL:4 * nL])
            return np.concatenate([g_, f_, o_, i_], axis=1)
        Wx = degate(p["Wx"])
        RW4 = degate(p["Wh"])
        # p = [input, forget, output] -> columns [wFF, wOO, wGG]
        peep = np.stack([p["p"][1], p["p"][2], p["p"][0]], axis=1)
        RW = np.concatenate([RW4, peep], axis=1)
        b = degate(p["b"].reshape(1, -1))[0]
        ld = {"nin": int(lc.n_in), "nout": nL,
              "activation": layer.resolve("activation", "tanh"),
              "gateActivationFn": lc.gate_activation}
        seg = np.concatenate([Wx.reshape(-1, order="F"),
                              RW.reshape(-1, order="F"), b])
        return "gravesLSTM", ld, seg

    if t == "activation":
        return "activation", {"activation": act}, None

    raise ValueError(f"DL4J-zip export: unsupported layer type '{t}'")
