"""The AOT precompile manifest: the schema'd receipt that rides next to
the kernel build cache (counterpart of
deeplearning4j_tpu/compilecache/manifest.py).

A cache dir of hashed libraries says nothing about WHAT was precompiled.
The manifest records it: the model fingerprint, the dtype policy, the
serving row shapes and bucket ladder, and what the libraries were built
with and for. Where the JAX manifest has ``jax_version`` and
``backend``, the port's has ``torch_version``, ``cuda_runtime``,
``nvcc_release``, ``device`` (name and capability, ``sm_90``) and
``libraries`` (the file names of the libraries the entries need; each
name carries the hash of its sources). Every other field keeps the JAX
name and meaning. At boot the server validates its own configuration
against it (:func:`validate_serving`); a mismatch means the cached
libraries were built for another program, so the server warns and builds
at first use. The manifest never gates correctness (a stale library has
another file name and simply misses); it gates expectations.

The fingerprint is a sha256, truncated to 16 hex digits, over the net's
class name and every parameter's path, shape and dtype, computed the
way the JAX package computes it, so a configuration has the same
fingerprint in both packages: the JAX tree path strings
(``['layer_0']['W']``, keys in sorted order as ``jax.tree_util``
flattens a dict), numpy's dtype names (``float32``, ``bfloat16``) and
the same JSON. It reads only metadata, so a structure-only net
(``init(structure_only=True)``, meta tensors) gives the same fingerprint
as an initialised one.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import List, Optional

SCHEMA_VERSION = 1
#: default manifest filename inside a cache dir: the server looks here
#: when ``aot_manifest`` is True
MANIFEST_NAME = "aot_manifest.json"


def _sorted_leaves(tree, path=()):
    """(path, leaf) of a nested dict in ``jax.tree_util``'s order: each
    dict's keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _dtype_name(leaf) -> str:
    """numpy's name of a leaf's dtype (``float32``, not
    ``torch.float32``)."""
    dtype = getattr(leaf, "dtype", None)
    return "?" if dtype is None else str(dtype).replace("torch.", "")


def model_fingerprint(net) -> str:
    """sha256 (16 hex digits) over the params tree's structure: every
    leaf's path, shape and dtype, plus the net's class. Two nets with the
    same fingerprint take each other's weights (a hot swap's
    precondition)."""
    items = [("".join(f"[{k!r}]" for k in path),
              list(getattr(leaf, "shape", ())), _dtype_name(leaf))
             for path, leaf in _sorted_leaves(net.params or {})]
    blob = json.dumps([type(net).__name__, items], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _mesh_axes(mesh) -> Optional[dict]:
    """{axis: size} of a DeviceMesh (parallel/mesh.py), or None."""
    if mesh is None:
        return None
    return {str(k): int(v) for k, v in zip(mesh.mesh_dim_names,
                                           mesh.mesh.shape)}


def toolchain(device) -> dict:
    """What a library of this process is built with and for: torch, the
    CUDA runtime, the ``nvcc`` release, and the card (name and
    capability, ``sm_90``; the CPU has none)."""
    import torch

    from deeplearning4j_tpu_torch.ops import _build
    dev = torch.device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        card = {"name": torch.cuda.get_device_name(dev),
                "capability": f"sm_{major}{minor}"}
    else:
        card = {"name": dev.type, "capability": None}
    return {"torch_version": torch.__version__,
            "cuda_runtime": torch.version.cuda,
            "nvcc_release": _build.nvcc_release(),
            "device": card}


def library_files(names) -> List[str]:
    """The file names (each carrying its hash) of libraries ``names``."""
    from deeplearning4j_tpu_torch.ops import _build
    return sorted(_build.library_path(n).name for n in names)


def build(net, *, serving: Optional[dict] = None,
          train: Optional[List[dict]] = None) -> dict:
    """Assemble a manifest for *net*. ``serving`` / ``train`` are the
    entry dicts :mod:`compilecache.precompile` returns; ``libraries`` is
    the union of theirs."""
    gc = net.conf.global_conf
    libs = set((serving or {}).get("libraries", ()))
    for entry in train or ():
        libs.update(entry.get("libraries", ()))
    man = {
        "schema_version": SCHEMA_VERSION,
        "created_unix": round(time.time(), 3),
        **toolchain(net.device),
        "libraries": sorted(libs),
        "model": {
            "class": type(net).__name__,
            "num_params": int(net.num_params()),
            "fingerprint": model_fingerprint(net),
            "param_dtype": gc.dtype.param_dtype,
            "compute_dtype": gc.dtype.compute_dtype,
        },
    }
    if serving is not None:
        man["serving"] = serving
    if train:
        man["train"] = train
    return man


def save(manifest: dict, path: str) -> str:
    """Atomic write (tmp + rename); ``path`` may be a cache DIR, in
    which case the manifest lands at ``<dir>/aot_manifest.json``."""
    from deeplearning4j_tpu_torch.compilecache.cache import atomic_publish
    if os.path.isdir(path):
        path = os.path.join(path, MANIFEST_NAME)
    return atomic_publish(os.path.dirname(os.path.abspath(path)),
                          os.path.basename(path), manifest)


def load(path: str) -> dict:
    if os.path.isdir(path):
        path = os.path.join(path, MANIFEST_NAME)
    with open(path) as f:
        return json.load(f)


def validate_serving(manifest: dict, net, *, row_shapes, ladder,
                     max_batch: int, min_batch: int,
                     compute_dtype: str, mesh=None) -> List[str]:
    """Compare a boot-time serving configuration against the manifest.
    Returns one readable mismatch string per field that differs; empty
    means the precompiled libraries cover exactly this boot: the same
    toolchain and card, model signature, dtypes, shapes, ladder, and the
    same library files (their sources unchanged)."""
    mm: List[str] = []

    def need(cond, msg):
        if not cond:
            mm.append(msg)

    need(manifest.get("schema_version") == SCHEMA_VERSION,
         f"schema_version {manifest.get('schema_version')!r} != "
         f"{SCHEMA_VERSION}")
    for key, have in toolchain(net.device).items():
        need(manifest.get(key) == have,
             f"{key} {manifest.get(key)!r} != {have!r}")
    model = manifest.get("model") or {}
    need(model.get("class") == type(net).__name__,
         f"model class {model.get('class')!r} != {type(net).__name__!r}")
    fp = model_fingerprint(net)
    need(model.get("fingerprint") == fp,
         f"model fingerprint {model.get('fingerprint')!r} != {fp!r}")
    serving = manifest.get("serving")
    if serving is None:
        mm.append("manifest has no 'serving' entry")
        return mm
    want_shapes = [list(s) for s in row_shapes]
    need(serving.get("row_shapes") == want_shapes,
         f"row_shapes {serving.get('row_shapes')!r} != {want_shapes!r}")
    need(serving.get("ladder") == list(ladder),
         f"ladder {serving.get('ladder')!r} != {list(ladder)!r}")
    need(serving.get("max_batch") == int(max_batch),
         f"max_batch {serving.get('max_batch')!r} != {int(max_batch)}")
    need(serving.get("min_batch") == int(min_batch),
         f"min_batch {serving.get('min_batch')!r} != {int(min_batch)}")
    need(serving.get("compute_dtype") == compute_dtype,
         f"serving compute_dtype {serving.get('compute_dtype')!r} != "
         f"{compute_dtype!r}")
    need(serving.get("mesh_axes") == _mesh_axes(mesh),
         f"mesh_axes {serving.get('mesh_axes')!r} != {_mesh_axes(mesh)!r}")
    libs = serving.get("libraries") or []
    # lib<name>_<hash>.so: the same names at the hash this process keys
    have = [n[3:].rsplit("_", 1)[0] for n in libs]
    need(libs == library_files(have),
         f"libraries {libs!r} != {library_files(have)!r}")
    return mm
