"""Model zip, read and written in the JAX package's format (counterpart of
deeplearning4j_tpu/utils/serialization.py).

The zip holds ``configuration.json`` (the MultiLayerConfiguration or
ComputationGraphConfiguration JSON),
``coefficients.npz`` (params, keyed by JAX tree paths such as
``['layer_0']['Wh']``), ``updaterState.npz`` (the optimizer state, keyed
the same way: ``['layer_0']['m']['Wh']``, ``['layer_0']['t']``,
``['_loss_scale']['scale']``), ``state.npz`` (layer state, when there is
any) and ``metadata.json``. A zip written by either package restores in
the other with the same params and the same optimizer state, so training
resumes across the packages.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

_FORMAT_VERSION = 1


def _keystr(path) -> str:
    """The JAX ``keystr`` of a path of dict keys: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, tree


def params_from_numpy(tree, device="cpu", dtype=None):
    """A nested dict of numpy arrays (the JAX package's parameter tree in
    its layouts: Wx [n_in,4n], Wh [n,4n], b [4n], p [3,n], W [n_in,n_out])
    to the same dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    t = torch.tensor(np.asarray(tree))
    return t.to(device=device, dtype=dtype or t.dtype)


def _tree_to_npz_bytes(tree) -> bytes:
    arrays = {_keystr(path): leaf.detach().cpu().numpy()
              for path, leaf in _flatten(tree)}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _npz_into(data: bytes, template, device):
    """Arrays of an npz, in the structure and dtypes of ``template``, on
    ``device``."""
    npz = np.load(io.BytesIO(data))

    def fill(tree, path=()):
        if isinstance(tree, dict):
            return {k: fill(v, path + (k,)) for k, v in tree.items()}
        key = _keystr(path)
        if key not in npz:
            raise KeyError(f"Checkpoint missing array for {key}")
        arr = npz[key]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"model shape {tuple(tree.shape)}")
        return params_from_numpy(arr, device, tree.dtype)

    return fill(template)


def _write(net, path, model_type):
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", net.conf.to_json())
        zf.writestr("coefficients.npz", _tree_to_npz_bytes(net.params))
        if net.state:
            zf.writestr("state.npz", _tree_to_npz_bytes(net.state))
        zf.writestr("updaterState.npz", _tree_to_npz_bytes(net.opt_state))
        zf.writestr("metadata.json", json.dumps({
            "format_version": _FORMAT_VERSION,
            "model_type": model_type,
            "iteration": int(net.iteration),
            "epoch": int(net.epoch),
        }))


def write_model(net, path):
    """Write ``net`` as a zip that the JAX package's
    ``restore_multi_layer_network`` reads."""
    _write(net, path, "multi_layer_network")


def write_computation_graph(net, path):
    """Write a ComputationGraph as a zip that the JAX package's
    ``restore_computation_graph`` reads (``state.npz`` carries the
    batch-norm running statistics, ``updaterState.npz`` the updater's
    state, e.g. Nesterov's velocity)."""
    _write(net, path, "computation_graph")


def _restore(path, build):
    """Restore a zip into the structure-only net ``build(conf_json)``
    makes: params, layer state and updater state where the zip holds them
    (else the fresh ones ``init`` would make), and the step counters.
    Nothing is drawn: every parameter comes from the zip."""
    with zipfile.ZipFile(path, "r") as zf:
        names = set(zf.namelist())
        net = build(zf.read("configuration.json").decode("utf-8"))
        dev = net.device
        net.params = _npz_into(zf.read("coefficients.npz"), net.params, dev)
        if "state.npz" in names and net.state:
            net.state = _npz_into(zf.read("state.npz"), net.state, dev)
        else:
            net.materialize_state()
        if "updaterState.npz" in names:
            net.opt_state = _npz_into(zf.read("updaterState.npz"),
                                      net.opt_state, dev)
        else:
            net.materialize_opt_state()
        if "metadata.json" in names:
            meta = json.loads(zf.read("metadata.json"))
            net.iteration = meta.get("iteration", 0)
            net.epoch = meta.get("epoch", 0)
    return net


def restore_multi_layer_network(path, device=None):
    """Restore a MultiLayerNetwork zip (written by either package) onto
    ``device`` (default: the card), with its updater state when the zip
    holds one (else the fresh state ``init`` made)."""
    from deeplearning4j_tpu_torch.nn.conf.core import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return _restore(path, lambda s: MultiLayerNetwork(
        MultiLayerConfiguration.from_json(s), device=device).init(
            structure_only=True))


def restore_computation_graph(path, device=None):
    """Restore a ComputationGraph zip (written by either package) onto
    ``device`` (default: the card), with its batch-norm running statistics
    and its updater state when the zip holds them."""
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    return _restore(path, lambda s: ComputationGraph(
        ComputationGraphConfiguration.from_json(s), device=device).init(
            structure_only=True))


def restore_model(path, device=None):
    """Restore either kind of model zip, by ``metadata.json``'s
    ``model_type`` (a zip without one is a MultiLayerNetwork), onto
    ``device`` (default: the card)."""
    with zipfile.ZipFile(path, "r") as zf:
        mtype = "multi_layer_network"
        if "metadata.json" in zf.namelist():
            mtype = json.loads(zf.read("metadata.json")).get(
                "model_type", mtype)
    if mtype == "computation_graph":
        return restore_computation_graph(path, device=device)
    return restore_multi_layer_network(path, device=device)
