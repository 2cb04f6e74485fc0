"""The model fingerprint (counterpart of
deeplearning4j_tpu/compilecache/manifest.py::model_fingerprint).

A sha256, truncated to 16 hex digits, over the net's class name and
every parameter's path, shape and dtype. It is computed the way the JAX
package computes it, so a configuration has the same fingerprint in both
packages: the JAX tree path strings (``['layer_0']['W']``, keys in
sorted order as ``jax.tree_util`` flattens a dict), numpy's dtype names
(``float32``, ``bfloat16``) and the same JSON. It reads only metadata,
so a structure-only net (``init(structure_only=True)``, meta tensors)
gives the same fingerprint as an initialised one.
"""

from __future__ import annotations

import hashlib
import json


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
