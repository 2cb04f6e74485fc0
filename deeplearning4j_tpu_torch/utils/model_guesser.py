"""Load-anything model loader (counterpart of
deeplearning4j_tpu/utils/model_guesser.py; ModelGuesser.java parity).

The reference's ``ModelGuesser`` sniffs a file and dispatches to the
right restore path. Four formats: this framework's zip
(``coefficients.npz`` member, written by either package), reference DL4J
zips (``coefficients.bin`` member), Keras HDF5 (``model_config`` root
attribute; needs ``h5py``), and checkpoint directories (``meta.json`` +
``tree/``, utils/checkpoint.py). A checkpoint directory keeps the JAX
package's format name ``"orbax"``, though the port's checkpoint is not
orbax's. Every restore runs on ``device`` (default: the card)."""

from __future__ import annotations

import json
import os
import zipfile


def guess_format(path: str) -> str:
    """One of {"tpu_zip", "dl4j_zip", "keras_h5", "orbax"}."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "meta.json")):
            return "orbax"
        raise ValueError(f"{path}: directory without a checkpoint meta.json")
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
        if "coefficients.npz" in names:
            return "tpu_zip"
        if "coefficients.bin" in names:
            return "dl4j_zip"
        raise ValueError(
            f"{path}: zip holds neither coefficients.npz (this framework) "
            "nor coefficients.bin (reference DL4J)")
    # HDF5 with a Keras model_config (a weights-only .h5 is not a model)
    with open(path, "rb") as f:
        is_hdf5 = f.read(8) == b"\x89HDF\r\n\x1a\n"
    if is_hdf5:
        import h5py
        with h5py.File(path, "r") as f:
            if "model_config" in f.attrs:
                return "keras_h5"
        raise ValueError(
            f"{path}: HDF5 file without a model_config attribute "
            "(weights-only files need the architecture too)")
    raise ValueError(f"{path}: unrecognized model file format")


def load_model(path: str, *, device=None, **kwargs):
    """Restore a network from any supported format onto ``device``
    (default: the card) (ModelGuesser.java's ``loadModelGuess``). kwargs
    pass through to the specific restorer (e.g. ``input_type=``/``dtype=``
    for DL4J zips, ``mesh=`` for checkpoint directories)."""
    fmt = guess_format(path)
    if fmt == "tpu_zip":
        # restore_model dispatches on the zip's own metadata.json
        from deeplearning4j_tpu_torch.utils.serialization import \
            restore_model
        return restore_model(path, device=device, **kwargs)
    if fmt == "dl4j_zip":
        from deeplearning4j_tpu_torch.modelimport.dl4j import (
            restore_multi_layer_network_from_dl4j)
        return restore_multi_layer_network_from_dl4j(path, device=device,
                                                     **kwargs)
    if fmt == "keras_h5":
        from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
        from deeplearning4j_tpu_torch.modelimport.keras import (
            import_keras_model, import_keras_sequential_model)
        with Hdf5Archive(path) as archive:
            cls = (archive.model_config() or {}).get("class_name")
        load = (import_keras_sequential_model if cls == "Sequential"
                else import_keras_model)
        return load(path, device=device, **kwargs)
    from deeplearning4j_tpu_torch.utils.checkpoint import (
        restore_computation_graph, restore_multi_layer_network)
    with open(os.path.join(path, "meta.json")) as f:
        kind = json.load(f)["kind"]
    restore = (restore_computation_graph if kind == "graph"
               else restore_multi_layer_network)
    return restore(path, device=device, **kwargs)
