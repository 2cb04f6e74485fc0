"""Build-time precompile: every kernel library a deploy will need, built
BEFORE the deploy into the build cache (counterpart of
deeplearning4j_tpu/compilecache/precompile.py).

Two surfaces:

- :func:`precompile_serving` builds the libraries the net's forward
  (and, with ``decode_engine``, its decode path) reaches, all ``nvcc``
  processes at once, then warms every bucket through the SAME seam the
  server warms lazily: a ``ModelServer`` built with ``warmup=False``,
  then ``ReplicaSet.warm``, and ``DecodeEngine.warm``. Identical
  forwards on identical shapes, so a later boot from the same dir loads
  exactly these libraries and builds nothing.
- :func:`precompile_fit` builds the libraries the net's train step
  reaches. It runs no step: params, updater state and BN state stay bit
  for bit as they were, as the JAX package's ``lower().compile()``
  executes nothing.

Both return manifest entry dicts for compilecache.manifest.build.
"""

from __future__ import annotations

from typing import List, Optional

from deeplearning4j_tpu_torch.compilecache import cache as _cache
from deeplearning4j_tpu_torch.compilecache import manifest as _manifest
from deeplearning4j_tpu_torch.ops import _build


def _build_on_card(net, names) -> None:
    """Build ``names`` where the net runs on the card (the CPU runs the
    plain versions and builds nothing)."""
    if net.device.type == "cuda" and names:
        _build.build(names)


def precompile_serving(net, *, cache_dir: str, max_batch: int = 1024,
                       min_batch: Optional[int] = None,
                       input_shapes=None, compute_dtype=None,
                       replicas: int = 1, mesh=None,
                       model_axis: str = "model", data_axis=None,
                       tp_rules=None, decode_engine=None) -> dict:
    """Build the serving libraries into *cache_dir*, warm the bucket
    ladder (and ``decode_engine``'s ladders) and return the manifest
    ``serving`` entry. Raises ValueError when the row shapes cannot be
    inferred and ``input_shapes`` was not given. With ``mesh`` every rank
    of the mesh calls it: each builds its libraries, the leader warms the
    meshed ladder while the followers run its buckets (serving/server.py),
    and the entry records ``mesh_axes``."""
    from deeplearning4j_tpu_torch.serving.batcher import bucket_ladder
    from deeplearning4j_tpu_torch.serving.server import ModelServer

    _cache.configure(cache_dir)
    libs = _build.libraries_for(net, decode=decode_engine is not None)
    _build_on_card(net, libs)
    server = ModelServer(net, port=0, max_batch=max_batch, warmup=False,
                         input_shapes=input_shapes,
                         compute_dtype=compute_dtype, replicas=replicas,
                         mesh=mesh, model_axis=model_axis,
                         data_axis=data_axis, tp_rules=tp_rules)
    try:
        shapes = server._infer_row_shapes()
        if shapes is None:
            raise ValueError(
                "cannot infer serving row shapes from the model "
                "configuration — pass input_shapes explicitly")
        mb = server._batcher
        if server.is_follower:
            server._group.follow()
        else:
            server._fleet.warm(shapes)
        if decode_engine is not None:
            decode_engine.warm()
        return {
            "row_shapes": [list(s) for s in shapes],
            "ladder": bucket_ladder(mb.min_batch, mb.max_batch),
            "max_batch": int(mb.max_batch),
            "min_batch": int(mb.min_batch),
            "compute_dtype": server.serving_compute_dtype,
            "mesh_axes": _manifest._mesh_axes(mesh),
            "decode": decode_engine is not None,
            "libraries": _manifest.library_files(libs),
        }
    finally:
        server._fleet.stop()
        if server._group is not None and not server.is_follower:
            server._group.stop()


def precompile_fit(net, *, cache_dir: str, batch: int = 32,
                   input_shapes=None) -> dict:
    """Build the libraries the net's train step reaches into *cache_dir*
    and return the manifest ``train`` entry. No step runs: every tensor
    of the net is left bit for bit as it was. ``input_shapes`` overrides
    the per-input row shapes where the configuration does not imply
    them."""
    _cache.configure(cache_dir)
    if net.params is None:
        net.init()
    row_shapes = input_shapes or _infer_row_shapes(net)
    if row_shapes is None:
        raise ValueError(
            "cannot infer training input shapes — pass input_shapes")
    libs = _build.libraries_for(net, train=True)
    _build_on_card(net, libs)
    return {
        "kind": "train_step",
        "net": type(net).__name__,
        "batch": int(batch),
        "row_shapes": [list(s) for s in row_shapes],
        "libraries": _manifest.library_files(libs),
    }


def _infer_row_shapes(net) -> Optional[List]:
    """Per-input row shapes via the server's inference (one code path
    for both precompile surfaces)."""
    from deeplearning4j_tpu_torch.serving.server import ModelServer
    probe = ModelServer.__new__(ModelServer)
    probe.input_shapes = None
    probe.net = net
    return probe._infer_row_shapes()
