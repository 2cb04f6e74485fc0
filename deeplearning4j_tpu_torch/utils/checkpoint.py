"""Checkpoint and resume in a step directory (counterpart of
deeplearning4j_tpu/utils/checkpoint.py).

The JAX package writes its trees with orbax; this package writes its own
directory under the same discipline, so a crash at any moment leaves
either a complete checkpoint or one that restore and discovery refuse:

- ``tree/``: one ``.npz`` per tree (``params``, ``state``, ``opt_state``),
  keyed by the JAX tree path (``['layer_0']['W']``), and ``dtypes.json``
  naming each leaf's dtype. The directory is written as ``.tree.tmp`` and
  renamed into place, so the tree commit is atomic.
- ``layout.json`` next (renamed in): format 2's manifest: the mesh of a
  meshed net (one device a rank) with its model axis, ``mesh_detail``
  (the model axis and the tensor-parallel rules), the process count and
  index, and every leaf's partition spec (null for an unmeshed or
  data-parallel net, whose leaves are whole on every rank).
- ``meta.json`` last (renamed in): ``kind``, ``config``, ``iteration``,
  ``epoch``, ``format_version`` and any ``extra_meta``. Its presence
  certifies the checkpoint (``is_valid_checkpoint``).

Every leaf goes back bit for bit in its own dtype: bfloat16 is stored as
its 16 bits (numpy has no bfloat16) and read back as bfloat16, the int32
counters (Adam's ``t``, the loss scale's ``good_steps``) as int32, 0-d
leaves as 0-d. A checkpoint restores onto the device the caller names
(``device=None``: the card), whichever device it was saved from.

The update writes parameters and updater slots in place
(nn/updater.py), so a background writer must not read the live trees:
``snapshot_for_checkpoint`` clones every leaf on the device and records
a CUDA event after the clones; the writer waits on that event before it
copies anything to the host, on a stream of its own.

Use::

    from deeplearning4j_tpu_torch.utils.checkpoint import (
        save_checkpoint, restore_multi_layer_network)

    save_checkpoint(net, "/ckpt/step_1000")
    net = restore_multi_layer_network("/ckpt/step_1000")

A multi-process group saves with every rank calling ``save_checkpoint``:
rank 0 writes, the others wait at the two barriers around the meta
commit (see ``save_checkpoint``). A tensor-parallel net's sharded leaves
are gathered whole first (every rank takes part), so its checkpoint
holds full arrays, as the JAX package's does, and restores unmeshed or
onto any model-axis size.

Restoring onto a mesh (``mesh=``, ``data_axis=``, ``model_axis=``,
``tp_rules=``) places each leaf directly: the whole arrays are read on
the host, each rank keeps its shard of every sharded leaf (the specs
recomputed for the mesh restored onto, never read from the save's
layout) and moves only that to its device; no replicate-then-
``use_mesh`` hop. Both network kinds restore so.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.updater import _map
from deeplearning4j_tpu_torch.utils.serialization import _flatten, _keystr

FORMAT_VERSION = 2
_TREES = ("params", "state", "opt_state")


class CheckpointError(RuntimeError):
    """Base error for checkpoint discovery and restore failures."""


class IncompleteCheckpointError(CheckpointError):
    """Restore hit a partial save (the tree committed, ``meta.json`` never
    renamed in): the footprint a crash between the two commits leaves.
    Names the directory; ``find_latest_checkpoint`` skips such
    directories."""


# Fault-injection seam: called between the tree commit and the meta.json
# rename, the window a real preemption can hit. resilience/faultinject.py
# installs a crasher here so the partial-save path is tested.
_POST_COMMIT_HOOK = None


def _net_kind(net) -> str:
    if isinstance(net, CheckpointSnapshot):
        return net.kind
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    return "graph" if isinstance(net, ComputationGraph) else "multilayer"


class CheckpointSnapshot:
    """A copy of everything ``save_checkpoint`` reads from a net, safe to
    write while the net keeps training: every leaf cloned on its device,
    and ``ready`` a CUDA event recorded after the clones (None on the
    CPU), which a reader on another thread or stream waits on first."""

    __slots__ = ("kind", "conf", "params", "state", "opt_state",
                 "iteration", "epoch", "ready", "_mesh", "_mesh_detail")

    def __init__(self, kind, conf, params, state, opt_state, iteration,
                 epoch, ready=None, mesh=None, mesh_detail=None):
        self.kind = kind
        self.conf = conf
        self.params = params
        self.state = state
        self.opt_state = opt_state
        self.iteration = iteration
        self.epoch = epoch
        self.ready = ready
        self._mesh = mesh                  # (mesh, data_axis) or None
        self._mesh_detail = mesh_detail    # {model_axis, tp_rules} or None


def snapshot_for_checkpoint(net) -> CheckpointSnapshot:
    """Device-side copy of the net's checkpointable trees (see
    :class:`CheckpointSnapshot`). ``save_checkpoint(snapshot, path)``
    writes what ``save_checkpoint(net, path)`` would have written at this
    moment."""
    def copy(tree):
        return _map(lambda t: t.detach().clone(), tree or {})

    params, opt = _whole_trees(net)
    params, state, opt = copy(params), copy(net.state), copy(opt)
    ready = None
    if net.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(net.device))
    return CheckpointSnapshot(
        kind=_net_kind(net), conf=net.conf, params=params, state=state,
        opt_state=opt, iteration=int(net.iteration), epoch=int(net.epoch),
        ready=ready, mesh=getattr(net, "_mesh", None),
        mesh_detail=getattr(net, "_mesh_detail", None))


def _whole_trees(net):
    """(params, opt_state) with every leaf whole: a tensor-parallel net's
    sharded leaves gathered over its model axis (a collective: every rank
    calls it), anything else as it is."""
    tp = getattr(net, "_tp", None)
    if tp is None or isinstance(net, CheckpointSnapshot):
        return net.params, net.opt_state
    return (tp.gathered(net.params, tp.specs),
            tp.gathered(net.opt_state or {}, tp.opt_specs(net.opt_state
                                                          or {})))


def _host_trees(net):
    """({tree name: {keystr: numpy array}}, their dtype names), read from
    ``net`` (a net or a snapshot). Device tensors are copied on a stream
    of their own after the snapshot's event, so a writer thread never
    waits behind, or reads under, the training stream."""
    trees = {name: getattr(net, name) or {} for name in _TREES}
    leaves = [t for tree in trees.values() for _, t in _flatten(tree)]
    cuda = [t for t in leaves if t.is_cuda]
    ready = getattr(net, "ready", None)  # a snapshot's event
    if cuda:
        device = cuda[0].device
        stream = torch.cuda.Stream(device)
        if ready is not None:
            ready.synchronize()
        else:
            stream.wait_stream(torch.cuda.current_stream(device))
        ctx = torch.cuda.stream(stream)
    else:
        ctx = contextlib.nullcontext()
    arrays, dtypes = {}, {}
    with ctx:
        for name, tree in trees.items():
            arrays[name], dtypes[name] = {}, {}
            for path, t in _flatten(tree):
                key = _keystr(path)
                t = t.detach().to("cpu")
                dtypes[name][key] = str(t.dtype).replace("torch.", "")
                if t.dtype == torch.bfloat16:
                    t = t.view(torch.int16)  # its bits; numpy has no bf16
                arrays[name][key] = t.numpy()
    return arrays, dtypes


def _datapipe_shard_positions(extra_meta) -> list:
    """Every ``shard`` stage's ``(n, i, k)`` cursor in a ``datapipe``
    pipeline state (nested ``upstream`` dicts), outermost first."""
    out = []

    def walk(node):
        if not isinstance(node, dict):
            return
        if node.get("kind") == "shard":
            out.append({key: int(node[key]) for key in ("n", "i", "k")
                        if key in node})
        walk(node.get("upstream"))

    if extra_meta and isinstance(extra_meta.get("datapipe"), dict):
        walk(extra_meta["datapipe"])
    return out


def _mesh_json(net):
    """The meshed net's mesh as the layout records it, or None."""
    meshed = getattr(net, "_mesh", None)
    if meshed is None:
        return None
    mesh, data_axis = meshed
    names = [str(a) for a in (mesh.mesh_dim_names or ())]
    detail = getattr(net, "_mesh_detail", None) or {}
    return {"axis_names": names,
            "shape": [int(d) for d in mesh.mesh.shape],
            "device_count": int(mesh.mesh.numel()),
            "data_axis": data_axis, "model_axis": detail.get("model_axis")}


def _spec_json(spec):
    return None if spec is None else [
        list(a) if isinstance(a, tuple) else a for a in spec]


def _detail_json(net):
    """``mesh_detail`` as JSON: the model axis and the rules (exact keys
    to specs, or [pattern, spec] pairs), or None."""
    detail = getattr(net, "_mesh_detail", None)
    if detail is None:
        return None
    rules = detail.get("tp_rules")
    if rules and hasattr(rules, "items"):
        rules = {k: _spec_json(v) for k, v in rules.items()}
    elif rules:
        rules = [[pat, _spec_json(spec)] for pat, spec in rules]
    return {"model_axis": detail.get("model_axis"), "tp_rules": rules}


def _layout_manifest(net, extra_meta) -> dict:
    """Format 2's manifest: the mesh a meshed net was saved on (one
    device a rank) and, for a meshed net, its ``mesh_detail`` (the model
    axis and the rules), the process count and index,
    and every leaf's partition spec as it was placed (null where the net
    places whole leaves: unmeshed or data-parallel)."""
    from deeplearning4j_tpu_torch.parallel import distributed
    from deeplearning4j_tpu_torch.parallel.tensor import opt_state_specs
    detail = getattr(net, "_mesh_detail", None) or {}
    p_specs = o_specs = None
    if detail.get("model_axis") is not None:
        from deeplearning4j_tpu_torch.parallel.tensor import param_specs
        mesh = net._mesh[0]
        p_specs = param_specs(net.params, mesh, detail["model_axis"],
                              detail.get("tp_rules"))
        o_specs = opt_state_specs(net.opt_state or {}, p_specs)

    def specs(tree, spec_tree):
        def at(path):
            node = spec_tree
            for k in path:
                node = node[k]
            return _spec_json(node)
        return {_keystr(path): (None if spec_tree is None else at(path))
                for path, _ in sorted(_flatten(tree or {}),
                                      key=lambda kv: kv[0])}

    info = distributed.process_info()
    out = {
        "format_version": FORMAT_VERSION,
        "mesh": _mesh_json(net),
        "process_count": int(info["process_count"]),
        "process_index": int(info["process_index"]),
        "param_specs": specs(net.params, p_specs),
        "opt_specs": specs(net.opt_state, o_specs),
        "datapipe_shards": _datapipe_shard_positions(extra_meta),
    }
    if out["mesh"] is not None:   # an unmeshed layout is the JAX one
        out["mesh_detail"] = _detail_json(net)
    return out


def _write_json(path, name, obj, **kw):
    tmp = os.path.join(path, f".{name}.tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f, **kw)
    os.replace(tmp, os.path.join(path, name))


def save_checkpoint(net, path: str, stats=None, extra_meta=None) -> str:
    """Write {config, params, state, opt_state, iteration, epoch} under the
    directory ``path`` (a net, or a snapshot from
    ``snapshot_for_checkpoint``). The tree commit is a rename and
    ``meta.json`` lands by rename after it, so a save cut short leaves a
    complete checkpoint or one without ``meta.json``. Write each periodic
    save to a fresh step directory (``.../step_1000``).

    In a multi-process group every process calls this. Every leaf is
    replicated, so rank 0 writes the trees; a barrier
    (parallel/distributed.py, with the collective deadline) follows the
    tree commit, ``meta.json`` lands by rename after it, and a second
    barrier ends the save, so ``save_checkpoint`` returns once the
    checkpoint is complete for every rank, and a peer that dies mid-save
    raises ``PeerLostError`` before ``meta.json`` exists: the newest
    restorable checkpoint is always the last one complete on every rank.

    ``extra_meta``: a JSON-serializable dict merged into ``meta.json``; it
    may not override the reserved keys (rank 0's is written). ``stats``:
    a ``parallel.stats.TrainingStatsCollector``, which records the whole
    save, barriers included, as a ``checkpoint_barrier`` phase."""
    if stats is not None:
        with stats.time_phase("checkpoint_barrier"):
            return _save_checkpoint_inner(net, path, extra_meta)
    return _save_checkpoint_inner(net, path, extra_meta)


def _save_checkpoint_inner(net, path: str, extra_meta=None) -> str:
    from deeplearning4j_tpu_torch.parallel import distributed
    if getattr(net, "_tp", None) is not None:
        # the sharded leaves gathered whole on every rank; rank 0 writes
        net = snapshot_for_checkpoint(net)
    path = os.path.abspath(path)
    multi = distributed.is_multiprocess()
    writer = distributed.process_info()["process_index"] == 0
    if writer:
        os.makedirs(path, exist_ok=True)
        arrays, dtypes = _host_trees(net)
        tmp = os.path.join(path, ".tree.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name in _TREES:
            with open(os.path.join(tmp, f"{name}.npz"), "wb") as f:
                np.savez(f, **arrays[name])
        _write_json(tmp, "dtypes.json", dtypes)
        tree = os.path.join(path, "tree")
        if os.path.exists(tree):
            shutil.rmtree(tree)
        os.replace(tmp, tree)
    if _POST_COMMIT_HOOK is not None:
        _POST_COMMIT_HOOK(path)
    if multi:
        # meta.json is the validity commit: it may land only once the
        # tree is durable, and a peer dying here leaves no meta
        distributed.barrier("dl4j_ckpt_tree_committed")
    if writer:
        # layout.json lands before the meta.json rename, so meta's
        # presence still certifies the whole checkpoint
        _write_json(path, "layout.json", _layout_manifest(net, extra_meta),
                    indent=1)
        meta = {
            "kind": _net_kind(net),
            "config": net.conf.to_json(),
            "iteration": int(net.iteration),
            "epoch": int(net.epoch),
            "format_version": FORMAT_VERSION,
        }
        if extra_meta:
            clash = set(extra_meta) & set(meta)
            if clash:
                raise ValueError(f"extra_meta may not override reserved "
                                 f"meta.json keys: {sorted(clash)}")
            meta.update(extra_meta)
        _write_json(path, "meta.json", meta)
    if multi:
        # no rank returns (nor resumes, nor lets rank 0 collect) before
        # the rename landed: the save is complete everywhere
        distributed.barrier("dl4j_ckpt_save_done")
    return path


_STEP_DIR = re.compile(r"^step_(\d+)$")


def read_checkpoint_meta(path: str) -> dict:
    """The checkpoint's ``meta.json`` (counters, config, and any
    ``extra_meta`` the save recorded)."""
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def read_checkpoint_layout(path: str):
    """The ``layout.json`` manifest, or None for a checkpoint without one
    (format 1)."""
    try:
        with open(os.path.join(path, "layout.json")) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def is_valid_checkpoint(path: str) -> bool:
    """A complete save: the ``tree`` directory AND ``meta.json``, which
    lands by rename after the tree commit."""
    return (os.path.isdir(os.path.join(path, "tree"))
            and os.path.isfile(os.path.join(path, "meta.json")))


def find_latest_checkpoint(directory: str):
    """The newest *valid* ``step_<n>`` checkpoint under ``directory``, or
    None. Ordered by step number, not mtime (a rolled-back run may rewrite
    an older step later); partial saves are skipped; a step directory
    that vanishes under a concurrent retention GC before its meta is read
    is skipped too, and the scan goes on to the next newest."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = _STEP_DIR.match(name)
        if m is not None:
            steps.append((int(m.group(1)), os.path.join(directory, name)))
    for _, path in sorted(steps, reverse=True):
        if not is_valid_checkpoint(path):
            continue
        try:
            read_checkpoint_meta(path)     # provably still readable
        except (OSError, ValueError):
            continue                        # GC won the race: next step
        return path
    return None


def _checked_meta(path: str, expect_kind: str) -> dict:
    if not os.path.isfile(os.path.join(path, "meta.json")):
        raise IncompleteCheckpointError(
            f"partial checkpoint at {path}: meta.json is missing (a save "
            "was interrupted between the tree commit and the meta rename)."
            " Resume from the previous step directory; "
            "find_latest_checkpoint() skips partial saves")
    meta = read_checkpoint_meta(path)
    if meta["kind"] != expect_kind:
        raise ValueError(
            f"checkpoint at {path} holds a {meta['kind']} net, not a "
            f"{expect_kind}")
    return meta


def read_checkpoint_trees(path: str, template, device) -> dict:
    """{"params", "state", "opt_state"} of the checkpoint at ``path`` as
    tensors on ``device``, in the structure of ``template``'s trees (a net
    of the same configuration). Each leaf keeps the dtype it was saved in,
    bit for bit; a missing leaf or another shape or dtype than the
    template's raises."""
    tree_dir = os.path.join(path, "tree")
    with open(os.path.join(tree_dir, "dtypes.json")) as f:
        dtypes = json.load(f)
    out = {}
    for name in _TREES:
        with open(os.path.join(tree_dir, f"{name}.npz"), "rb") as f:
            npz = np.load(io.BytesIO(f.read()))

        def fill(node, key_path=(), name=name, npz=npz):
            if isinstance(node, dict):
                return {k: fill(v, key_path + (k,)) for k, v in node.items()}
            key = _keystr(key_path)
            if key not in npz:
                raise CheckpointError(
                    f"checkpoint at {path}: {name} has no leaf {key}")
            arr = npz[key]
            dtype = getattr(torch, dtypes[name][key])
            t = torch.from_numpy(np.array(arr))
            if dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            if tuple(t.shape) != tuple(node.shape) or t.dtype != node.dtype:
                raise CheckpointError(
                    f"checkpoint at {path}: {name}{key} is {t.dtype} "
                    f"{tuple(t.shape)}, the net's is {node.dtype} "
                    f"{tuple(node.shape)}")
            return t.to(device)

        out[name] = fill(getattr(template, name) or {})
    return out


def _restore(path, expect_kind, device, mesh, data_axis, model_axis,
             tp_rules):
    if model_axis is not None and mesh is None:
        raise ValueError("model_axis= places leaves on a mesh: pass mesh=")
    path = os.path.abspath(path)
    meta = _checked_meta(path, expect_kind)
    if expect_kind == "graph":
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
            ComputationGraphConfiguration)
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            meta["config"]), device=device).init(structure_only=True)
    else:
        from deeplearning4j_tpu_torch.nn.conf.core import (
            MultiLayerConfiguration)
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            meta["config"]), device=device).init(structure_only=True)
    if tp_rules:
        from deeplearning4j_tpu_torch.parallel.tensor import check_rules
        check_rules(tp_rules, net.params, f" (checkpoint at {path})")
    # every leaf of the structure-only net is overwritten here, so the
    # restore draws nothing: its cost is reading the trees. Onto a model
    # axis the whole arrays stay on the host until each rank has cut its
    # shards.
    sharded = mesh is not None and model_axis is not None
    trees = read_checkpoint_trees(path, net,
                                  torch.device("cpu") if sharded
                                  else net.device)
    net.params, net.state, net.opt_state = (
        trees["params"], trees["state"], trees["opt_state"])
    net.iteration = int(meta["iteration"])
    net.epoch = int(meta["epoch"])
    if mesh is not None:
        from deeplearning4j_tpu_torch.parallel.data_parallel import \
            apply_mesh
        net._multi_steps = {}
        apply_mesh(net, mesh, data_axis, model_axis, tp_rules,
                   replicate_first=False)
    if sharded:
        for name in ("params", "state", "opt_state"):
            setattr(net, name, _map(lambda t: t.to(net.device),
                                    getattr(net, name) or {}))
    return net


def restore_multi_layer_network(path: str, mesh=None, data_axis="data",
                                model_axis=None, tp_rules=None, *,
                                device=None):
    """A MultiLayerNetwork from the checkpoint at ``path`` on ``device``
    (default: the card). Refuses a partial save
    (``IncompleteCheckpointError``) and a graph's checkpoint."""
    return _restore(path, "multilayer", device, mesh, data_axis,
                    model_axis, tp_rules)


def restore_computation_graph(path: str, mesh=None, data_axis="data",
                              model_axis=None, tp_rules=None, *,
                              device=None):
    """A ComputationGraph from the checkpoint at ``path`` on ``device``
    (default: the card). Refuses a partial save and a sequential net's
    checkpoint."""
    return _restore(path, "graph", device, mesh, data_axis, model_axis,
                    tp_rules)
