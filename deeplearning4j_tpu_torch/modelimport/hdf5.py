"""HDF5 archive reading for Keras model files (counterpart of
deeplearning4j_tpu/modelimport/hdf5.py).

Parity: deeplearning4j-modelimport Hdf5Archive.java (JavaCPP libhdf5),
here ``h5py``, imported when an archive is opened, so the package imports
without it. Understands both full-model files (``model_config`` root
attribute + ``model_weights`` group) and weights-only files (layer groups
at the root), Keras 1.x and 2.x. Host only: the arrays come back as
numpy.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np


def _decode(v):
    if isinstance(v, bytes):
        return v.decode("utf-8")
    if isinstance(v, np.ndarray):
        return [_decode(x) for x in v.tolist()]
    return v


class Hdf5Archive:
    """Read-only view of a Keras .h5 file."""

    def __init__(self, path: str):
        import h5py

        self._f = h5py.File(path, "r")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- config
    def read_attr(self, name: str) -> Optional[str]:
        if name not in self._f.attrs:
            return None
        return _decode(self._f.attrs[name])

    def model_config(self) -> Optional[dict]:
        raw = self.read_attr("model_config")
        return None if raw is None else json.loads(raw)

    def training_config(self) -> Optional[dict]:
        raw = self.read_attr("training_config")
        return None if raw is None else json.loads(raw)

    def keras_version(self) -> Optional[str]:
        v = self.read_attr("keras_version")
        if v is None and "model_weights" in self._f:
            v = _decode(self._f["model_weights"].attrs.get("keras_version",
                                                          b"")) or None
        return v

    # ------------------------------------------------------------ weights
    def _weight_root(self):
        return (self._f["model_weights"] if "model_weights" in self._f
                else self._f)

    def layer_names(self) -> List[str]:
        root = self._weight_root()
        if "layer_names" in root.attrs:
            return [_decode(n) for n in root.attrs["layer_names"]]
        return list(root.keys())

    def layer_weights(self, layer_name: str) -> List[np.ndarray]:
        """The layer's weight arrays in Keras's stored (build) order."""
        root = self._weight_root()
        if layer_name not in root:
            return []
        g = root[layer_name]
        if "weight_names" in g.attrs:
            names = [_decode(n) for n in g.attrs["weight_names"]]
        else:
            names = []
            g.visit(lambda n: names.append(n)
                    if hasattr(g[n], "shape") else None)
        return [np.asarray(g[n]) for n in names]

    def all_weights(self) -> Dict[str, List[np.ndarray]]:
        return {n: self.layer_weights(n) for n in self.layer_names()}
