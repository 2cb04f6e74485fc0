"""Mesh-parallel inference: the serving side of parallel/tensor.py
(counterpart of deeplearning4j_tpu/parallel/inference.py).

A coalesced f32 serving forward must return rows bit-identical to the
unmeshed ``net.output`` (serving/server.py). So the serving walk uses
only arithmetic-free collectives, as the JAX package's ``shard_map``
walk does:

- weights shard column-parallel over the model axis (training's
  placement and ``rules``), the 1-D leaves of a sharded layer's output
  width with them (bias co-sharding), and a layer whose activation mixes
  its features (softmax) stays replicated unless a rule claims it
  (``serving_param_specs``);
- each rank computes its full-contraction local product (no partial
  sums anywhere), then the feature axis is gathered: a concatenation;
- the rows may also split over a data axis, with a final row gather.

The one remaining condition is that the local product's reduction order
does not depend on the output width: a GEMM or convolution library picks
its algorithm by shape, so a column shard can come out of another kernel
than the full product's columns (``chip_smoke.py --mesh-serving`` probes
each served shape on the card).

The port runs one process a device where JAX has one controller, so the
walk runs on every rank of the mesh at once. ``ServingGroup`` is the
protocol that keeps them in lockstep: the leader (the mesh's first rank,
which serves HTTP) broadcasts a header (op, rows, row shape) and the
bucket for each forward; the followers wait in ``follow`` and run the
same forward; a stop header ends them. Every follower wait is bounded by
the group's collective timeout (parallel/distributed.py), and the leader
sends an idle header when it has sent nothing for a quarter of it, so a
quiet server does not time its followers out. A leader that dies
surfaces on a follower as ``CollectiveTimeoutError`` (``PeerLostError``
when the consensus round names it), never as a hang.

The port keeps the whole params on the net (a rank's ``net.output``
stays its unmeshed forward); ``shard_params_for_serving`` returns this
rank's shards beside the specs, and the forward reads those, cut once
when it is built.
"""

from __future__ import annotations

import copy
import datetime
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.ops.activations import mixes_features
from deeplearning4j_tpu_torch.parallel.tensor import (P, ModelGroup,
                                                      local_shard,
                                                      param_specs,
                                                      sharded_dim)

__all__ = ["serving_param_specs", "shard_params_for_serving",
           "build_tp_output_fn", "ServingGroup"]


def serving_param_specs(params, mesh, model_axis: str = "model",
                        rules=None, layers=None):
    """Training's ``param_specs`` plus the serving walk's two corrections:
    layers whose activation mixes features (softmax, logsoftmax) stay
    replicated unless an exact-key rule claims a leaf, and a 1-D leaf of
    a column-sharded layer's output width shards with it (the local
    activation arrives as this rank's columns)."""
    specs = param_specs(params, mesh, model_axis, rules)
    exact = rules if hasattr(rules, "items") else {}
    for layer in layers or ():
        lname = getattr(layer, "name", None)
        if not mixes_features(layer) or lname not in specs:
            continue
        lspecs = specs[lname]
        for k in lspecs:
            if f"['{lname}']['{k}']" not in exact:
                lspecs[k] = P()
    for lname, lspecs in specs.items():
        widths = {params[lname][k].shape[-1] for k, s in lspecs.items()
                  if isinstance(s, tuple) and len(s) >= 2
                  and s[-1] == model_axis}
        if not widths:
            continue
        for k, s in lspecs.items():
            leaf = params[lname][k]
            if (f"['{lname}']['{k}']" not in exact and isinstance(s, tuple)
                    and len(s) == 0 and getattr(leaf, "ndim", 0) == 1
                    and leaf.shape[0] in widths):
                lspecs[k] = P(model_axis)
    return specs


def shard_params_for_serving(net, mesh, model_axis: str = "model",
                             rules=None):
    """(specs, this rank's shards of ``net.params``) under the serving
    placement; ``net.params`` stays whole."""
    from deeplearning4j_tpu_torch.parallel.mesh import axis_group
    specs = serving_param_specs(net.params, mesh, model_axis, rules,
                                layers=net.layers)
    group = axis_group(mesh, model_axis)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    shards = {ln: {k: local_shard(t, specs[ln][k], model_axis, rank, size)
                   for k, t in sub.items()}
              for ln, sub in net.params.items()}
    return specs, shards


def _rendered_types():
    from deeplearning4j_tpu_torch.nn.layers import convolution as conv_l
    from deeplearning4j_tpu_torch.nn.layers import feedforward as ff_l
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        RnnOutputLayerImpl)
    return (ff_l.DenseLayer, ff_l.OutputLayer, ff_l.EmbeddingLayerImpl,
            RnnOutputLayerImpl, conv_l.ConvolutionLayer,
            conv_l.Convolution1DLayerImpl)


def _output_sharded(layer, lspecs, model_axis) -> bool:
    """Whether ``layer`` computes on column shards (its output is then
    this rank's features). Raises ValueError where the layer's output
    cannot be rendered from its weights' columns."""
    sharded = {k: sharded_dim(s, model_axis) for k, s in lspecs.items()}
    if not any(d is not None for d in sharded.values()):
        return False
    if type(layer) not in _rendered_types():
        raise ValueError(
            f"mesh-parallel serving cannot render a "
            f"{layer.conf.layer_type} layer ({layer.name}) from its "
            f"weights' columns (a transformer block's, an LSTM's and an "
            f"attention layer's output mix their columns); replicate its "
            f"params with tp_rules or serve the net replicated")
    for k, d in sharded.items():
        if d is not None and d != len(lspecs[k]) - 1:
            raise ValueError(
                f"mesh-parallel serving shards columns only: "
                f"['{layer.name}']['{k}'] is placed {lspecs[k]!r}")
    return True


def build_tp_output_fn(net, mesh, model_axis: str = "model",
                       data_axis: Optional[str] = None,
                       rules=None) -> Callable:
    """This rank's ``forward(feats) -> out`` of the tensor-parallel
    serving walk (module docstring): ``feats`` is the batcher's padded
    bucket list (one array or tensor), ``out`` the whole rows on this
    rank's device. Every rank of the mesh calls it with the same bucket,
    in lockstep (``ServingGroup``).

    A MultiLayerNetwork with stateless inference: a graph raises
    TypeError, a net with layer state (batch norm's running statistics)
    ValueError, a mesh without ``model_axis`` (or ``data_axis``)
    ValueError."""
    from deeplearning4j_tpu_torch.parallel import distributed
    from deeplearning4j_tpu_torch.parallel.mesh import axis_group
    if getattr(net, "layers", None) is None or not hasattr(
            net, "preprocessors"):
        raise TypeError(
            "mesh-parallel serving supports MultiLayerNetwork layer "
            f"stacks; got {type(net).__name__} (serve ComputationGraph "
            "replicated, or per-replica placed)")
    if net.state:
        raise ValueError(
            "mesh-parallel serving requires stateless inference layers; "
            f"this net carries state for {sorted(net.state)} (running "
            "stats would need the same per-channel sharding as their "
            "params); serve it replicated instead")
    axes = tuple(mesh.mesh_dim_names or ())
    for axis in (model_axis, data_axis):
        if axis is not None and axis not in axes:
            raise ValueError(f"mesh has no {axis!r} axis: {axes}")
    specs, shards = shard_params_for_serving(net, mesh, model_axis, rules)
    walk = copy.copy(net)       # layers of its own: no tensor-parallel
    walk._build_layers()        # rendering, whatever the net trains on
    gather_after = [_output_sharded(ly, specs.get(ly.name, {}), model_axis)
                    for ly in walk.layers]
    mg = ModelGroup(axis_group(mesh, model_axis))
    dg = ModelGroup(axis_group(mesh, data_axis)) if data_axis else None
    device = distributed.device()

    def forward(feats):
        x = torch.as_tensor(np.asarray(feats[0]) if not isinstance(
            feats[0], torch.Tensor) else feats[0]).to(device)
        if dg is not None:
            if x.shape[0] % dg.size:
                raise ValueError(
                    f"a bucket of {x.shape[0]} rows does not split over "
                    f"the data axis's {dg.size} ranks")
            x = dg.slice(x, 0)
        with torch.inference_mode():
            for layer, prep, gather in zip(walk.layers, walk.preprocessors,
                                           gather_after):
                if prep is not None:
                    x = prep(x)
                x, _ = layer.apply(shards.get(layer.name, {}), {}, x,
                                   train=False)
                if gather:
                    x = mg.all_gather(x, x.dim() - 1)
            if dg is not None:
                x = dg.all_gather(x, 0)
        return x

    forward.model_group = mg
    forward.data_group = dg
    forward.specs = specs
    return forward


# ------------------------------------------------------ the rank protocol
_STOP, _BUCKET, _IDLE = 0, 1, 2
_HEADER = 8      # op, rows, ndim, up to five row dims


class ServingGroup:
    """The mesh's ranks serving in lockstep: ``lead(feats)`` on the
    leader (the mesh's first rank) broadcasts the bucket and runs the
    forward; ``follow()`` on every other rank runs each broadcast bucket
    through the same forward until the leader's ``stop()``. Collectives
    on the leader are serialized by a lock (the batcher's device thread,
    a warm-up and the idle heartbeat share the group)."""

    def __init__(self, forward, mesh):
        from deeplearning4j_tpu_torch.parallel import distributed
        self.forward = forward
        ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        self.leader = ranks[0]
        self.rank = dist.get_rank()
        self.is_leader = self.rank == self.leader
        self.timeout_s = distributed.collective_timeout_s()
        self.group = dist.new_group(
            ranks, timeout=datetime.timedelta(seconds=self.timeout_s))
        self.comm = distributed._comm_device()
        self._lock = threading.Lock()
        self._last_sent = time.monotonic()
        self._stopped = threading.Event()
        self._heart = None
        #: forwards this rank ran, and the seconds in them
        self.forwards = 0
        self.seconds = 0.0

    # -- both sides
    def _run(self, x):
        t0 = time.perf_counter()
        out = self.forward([x])
        self.forwards += 1
        self.seconds += time.perf_counter() - t0
        return out

    def _bcast(self, t):
        dist.broadcast(t, self.leader, group=self.group)
        return t

    # -- the leader
    def _send(self, op, x=None):
        hdr = torch.zeros(_HEADER, dtype=torch.int64)
        hdr[0] = op
        if x is not None:
            hdr[1] = x.shape[0]
            hdr[2] = x.dim() - 1
            hdr[3:3 + x.dim() - 1] = torch.tensor(x.shape[1:])
        self._bcast(hdr.to(self.comm))
        if x is not None:
            self._bcast(x.to(self.comm))
        self._last_sent = time.monotonic()

    def lead(self, feats):
        """The leader's forward (the batcher's): broadcast the bucket,
        run it, return the rows as a host f32 array."""
        x = torch.as_tensor(np.ascontiguousarray(feats[0],
                                                 dtype=np.float32))
        if x.dim() - 1 > _HEADER - 3:
            raise ValueError(f"a row of {x.dim() - 1} dims does not fit "
                             "the serving header")
        with self._lock:
            if self._stopped.is_set():
                raise RuntimeError("the serving group has stopped")
            self._send(_BUCKET, x)
            out = self._run(x)
        return out.float().cpu().numpy()

    def start_heartbeat(self):
        """The leader's idle header, sent when nothing went out for a
        quarter of the collective timeout (a daemon thread)."""
        every = self.timeout_s / 4

        def beat():
            while not self._stopped.wait(every / 4):
                if time.monotonic() - self._last_sent < every:
                    continue
                with self._lock:
                    if not self._stopped.is_set():
                        self._send(_IDLE)
        self._heart = threading.Thread(target=beat, daemon=True,
                                       name="mesh-serving-heartbeat")
        self._heart.start()

    def stop(self):
        """The leader: the stop header, once; the heartbeat ends."""
        with self._lock:
            if self._stopped.is_set():
                return
            self._stopped.set()
            self._send(_STOP)
        if self._heart is not None:
            self._heart.join(timeout=self.timeout_s)
            self._heart = None

    # -- a follower
    def follow(self):
        """Run the leader's buckets until its stop header. A collective
        that fails (the leader gone, or silent past the timeout) raises
        ``PeerLostError`` naming the lost ranks, else
        ``CollectiveTimeoutError`` naming the leader."""
        from deeplearning4j_tpu_torch.parallel import distributed
        try:
            while True:
                hdr = self._bcast(torch.zeros(_HEADER, dtype=torch.int64,
                                              device=self.comm)).cpu()
                op = int(hdr[0])
                if op == _STOP:
                    return
                if op == _IDLE:
                    continue
                shape = [int(hdr[1])] + hdr[3:3 + int(hdr[2])].tolist()
                x = self._bcast(torch.empty(shape, dtype=torch.float32,
                                            device=self.comm))
                self._run(x)
        except distributed.CollectiveTimeoutError:
            raise
        except Exception as e:   # gloo and NCCL raise RuntimeError kinds
            distributed.check_peers(e, name="mesh_serving",
                                    timeout_s=self.timeout_s)
            raise distributed.CollectiveTimeoutError(
                f"mesh serving follower rank {self.rank}: a collective "
                f"with the leader, rank {self.leader}, failed or timed "
                f"out ({self.timeout_s:g} s): {type(e).__name__}: {e}"
            ) from e
        finally:
            self._stopped.set()
