"""Versioned weight publication: the train-to-serve live-reload seam
(counterpart of deeplearning4j_tpu/serving/publish.py).

The supervisor (resilience/supervisor.py) writes ``step_<n>`` checkpoints
for resume; this module promotes such a checkpoint into a publication
store for serving: a training run publishes, a server hot-swaps onto the
newest publication (``ModelServer.hot_swap``), and a version that fails
its gates is rolled back by repointing, never by rewriting weights.

Store layout (``root/``)::

    v_000001/            one published version = one complete checkpoint
      tree/              the checkpoint's trees (utils/checkpoint.py),
      layout.json        meta.json and layout.json, copied verbatim
      meta.json
      publication.json   {version, fingerprint, source, status, ...}
    v_000002/
    LATEST               the version serving should run

- **Atomic landing.** A publication is staged under a dot-temp directory
  and ``os.replace``d into its ``v_%06d`` name, so a reader never sees a
  half-copied version; ``LATEST`` lands the same way (temp + rename).
- **Monotonic versions.** Version numbers only grow; a rollback moves
  ``LATEST`` back across versions and never renumbers.
- **Fingerprint stamping.** Every publication records the model
  fingerprint (compilecache/manifest.py) of a structure-only net built
  from the checkpoint's own configuration: the key ``hot_swap`` checks
  before it binds the weights to the served forward.
- **Rollback as a verb.** ``rollback()`` marks the current version
  ``rejected`` (``publication.json`` rewritten atomically, with the
  reason) and repoints ``LATEST`` at the newest good predecessor. A
  rejected version never becomes ``LATEST`` again; its bits stay until
  retention removes them.
- **Retention.** The ``keep`` newest versions survive; the ``LATEST``
  target is never deleted.

``load_net`` restores a publication on the card unless a ``device`` is
given; its cost is reading the trees (a structure-only net, no random
draws, no kernel build). With ``mesh=`` (mesh serving) every rank of the
mesh restores the whole net on its own device: the serving placement,
whose shards ``ModelServer(mesh=)`` cuts from it (parallel/inference.py).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import List, Optional

from deeplearning4j_tpu_torch.utils.checkpoint import (find_latest_checkpoint,
                                                       is_valid_checkpoint,
                                                       read_checkpoint_meta)

__all__ = ["WeightStore", "Publication", "load_net"]

_VER_DIR = re.compile(r"^v_(\d{6})$")
_LATEST = "LATEST"
PUBLICATION_META = "publication.json"

class Publication:
    """One published version: a complete checkpoint directory and its
    ``publication.json``. ``path`` is a checkpoint path that ``load_net``
    and the ``restore_*`` functions take."""

    __slots__ = ("version", "path", "meta")

    def __init__(self, version: int, path: str, meta: dict):
        self.version = int(version)
        self.path = path
        self.meta = meta

    @property
    def fingerprint(self) -> Optional[str]:
        return self.meta.get("fingerprint")

    @property
    def status(self) -> str:
        return self.meta.get("status", "published")

    @property
    def rejected(self) -> bool:
        return self.status == "rejected"

    def describe(self) -> dict:
        return {"version": self.version, "path": self.path, **self.meta}

    def __repr__(self):
        return (f"Publication(v{self.version}, {self.status}, "
                f"fp={self.fingerprint})")


def _net_class(kind):
    """(network class, configuration class) of a checkpoint's kind."""
    if kind == "graph":
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
            ComputationGraphConfiguration)
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        return ComputationGraph, ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.conf.core import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork, MultiLayerConfiguration


def load_net(path: str, mesh=None, *, device=None):
    """The net a publication (or any checkpoint directory) holds, by the
    checkpoint's own ``kind``, on ``device`` (default: the card). With
    ``mesh`` (every rank of a serving mesh calls it) on this rank's
    device (parallel/distributed.py ``initialize``) unless ``device`` is
    given, whole: ``ModelServer(mesh=)`` cuts its shards."""
    from deeplearning4j_tpu_torch.utils.checkpoint import (
        restore_computation_graph, restore_multi_layer_network)
    if mesh is not None and device is None:
        from deeplearning4j_tpu_torch.parallel import distributed
        device = distributed.device()
    kind = read_checkpoint_meta(path)["kind"]
    fn = (restore_computation_graph if kind == "graph"
          else restore_multi_layer_network)
    return fn(path, device=device)


def _fingerprint_of_checkpoint(path: str) -> str:
    """The model fingerprint of the checkpoint's configuration, from a
    structure-only net: publishing reads no weights."""
    from deeplearning4j_tpu_torch.compilecache.manifest import (
        model_fingerprint)
    meta = read_checkpoint_meta(path)
    net_cls, conf_cls = _net_class(meta["kind"])
    net = net_cls(conf_cls.from_json(meta["config"]), device="cpu")
    return model_fingerprint(net.init(structure_only=True))


class WeightStore:
    """The versioned publication store (the module docstring has the
    layout and its rules). Safe for one publisher process; readers may
    poll concurrently, since every change lands by rename."""

    def __init__(self, root: str, *, keep: int = 3):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.root = os.path.abspath(root)
        self.keep = int(keep)
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------- reading
    def versions(self, include_rejected: bool = True) -> List[Publication]:
        """Every publication, oldest first. Staged temp directories, and
        versions removed by retention during the scan, are skipped."""
        out = []
        for name in sorted(os.listdir(self.root)):
            m = _VER_DIR.match(name)
            if m is None:
                continue
            path = os.path.join(self.root, name)
            try:
                with open(os.path.join(path, PUBLICATION_META)) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                continue    # mid-publish or mid-removal: not a version
            pub = Publication(int(m.group(1)), path, meta)
            if include_rejected or not pub.rejected:
                out.append(pub)
        return out

    def get(self, version: int) -> Publication:
        path = os.path.join(self.root, f"v_{int(version):06d}")
        with open(os.path.join(path, PUBLICATION_META)) as f:
            return Publication(version, path, json.load(f))

    def latest(self) -> Optional[Publication]:
        """The publication ``LATEST`` names, or None for an empty
        store."""
        try:
            with open(os.path.join(self.root, _LATEST)) as f:
                name = f.read().strip()
        except FileNotFoundError:
            return None
        m = _VER_DIR.match(name)
        if m is None:
            return None
        try:
            return self.get(int(m.group(1)))
        except (OSError, ValueError):
            return None

    # ----------------------------------------------------------- publishing
    def _write_latest(self, version: int) -> None:
        tmp = os.path.join(self.root, "." + _LATEST + ".tmp")
        with open(tmp, "w") as f:
            f.write(f"v_{int(version):06d}")
        os.replace(tmp, os.path.join(self.root, _LATEST))

    def _write_publication_meta(self, path: str, meta: dict) -> None:
        tmp = os.path.join(path, "." + PUBLICATION_META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(path, PUBLICATION_META))

    def publish(self, checkpoint_path: str, *, source: Optional[str] = None,
                extra: Optional[dict] = None) -> Publication:
        """Promote one complete checkpoint into the next version: copy,
        stamp, land atomically, repoint ``LATEST``, apply retention.
        Returns the new publication (now ``latest()``)."""
        checkpoint_path = os.path.abspath(checkpoint_path)
        if not is_valid_checkpoint(checkpoint_path):
            raise ValueError(
                f"not a complete checkpoint: {checkpoint_path} (needs the "
                "tree directory AND meta.json; a partial save is not "
                "publishable)")
        fingerprint = _fingerprint_of_checkpoint(checkpoint_path)
        ckpt_meta = read_checkpoint_meta(checkpoint_path)
        prev = self.versions()
        version = (prev[-1].version + 1) if prev else 1
        name = f"v_{version:06d}"
        final = os.path.join(self.root, name)
        staged = os.path.join(self.root, f".{name}.tmp-{os.getpid()}")
        if os.path.isdir(staged):
            shutil.rmtree(staged)
        shutil.copytree(checkpoint_path, staged)
        meta = {
            "schema": 1,
            "version": version,
            "fingerprint": fingerprint,
            "source": source if source is not None else checkpoint_path,
            "published_unix": time.time(),
            "status": "published",
            "iteration": ckpt_meta.get("iteration"),
            "epoch": ckpt_meta.get("epoch"),
            "kind": ckpt_meta.get("kind"),
        }
        if extra:
            for k in extra:
                if k in meta:
                    raise ValueError(f"extra key {k!r} shadows a "
                                     "publication field")
            meta.update(extra)
        self._write_publication_meta(staged, meta)
        os.replace(staged, final)          # the version exists, atomically
        self._write_latest(version)
        self._gc()
        return Publication(version, final, meta)

    def publish_latest(self, checkpoint_dir: str, **kw) -> Publication:
        """Promote the newest valid ``step_<n>`` checkpoint under a
        supervisor's checkpoint directory."""
        ckpt = find_latest_checkpoint(checkpoint_dir)
        if ckpt is None:
            raise FileNotFoundError(
                f"no complete checkpoint under {checkpoint_dir}")
        return self.publish(ckpt, **kw)

    # ------------------------------------------------------------- rollback
    def rollback(self, reason: str = "") -> Publication:
        """Mark the current ``LATEST`` version ``rejected`` (with the
        reason) and repoint ``LATEST`` at the newest good predecessor,
        which it returns. Raises RuntimeError when there is none: a
        server must not go on serving a version its gates rejected."""
        cur = self.latest()
        if cur is None:
            raise RuntimeError("empty store: nothing to roll back")
        meta = dict(cur.meta)
        meta["status"] = "rejected"
        meta["rejected_unix"] = time.time()
        meta["rejected_reason"] = reason
        self._write_publication_meta(cur.path, meta)
        good = [p for p in self.versions(include_rejected=False)
                if p.version < cur.version]
        if not good:
            raise RuntimeError(
                f"v{cur.version} rejected but no earlier good version "
                "exists to roll back to")
        self._write_latest(good[-1].version)
        return good[-1]

    # ------------------------------------------------------------ retention
    def _gc(self) -> None:
        """Keep the newest ``keep`` versions and whatever ``LATEST``
        names."""
        pubs = self.versions()
        if len(pubs) <= self.keep:
            return
        latest = self.latest()
        protect = {p.version for p in pubs[-self.keep:]}
        if latest is not None:
            protect.add(latest.version)
        for p in pubs:
            if p.version not in protect:
                shutil.rmtree(p.path, ignore_errors=True)

    def describe(self) -> dict:
        latest = self.latest()
        return {
            "root": self.root,
            "latest_version": latest.version if latest else None,
            "versions": [p.describe() for p in self.versions()],
        }
