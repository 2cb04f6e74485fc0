"""Data-parallel training over a device mesh (counterpart of
deeplearning4j_tpu/parallel/data_parallel.py).

Replaces the reference's data-parallel strategies (ParallelWrapper's
averageAndPropagate, Spark's ParameterAveragingTrainingMaster, the Aeron
parameter server) with one process per rank of the mesh's 'data' axis:
parameters are replicated (``apply_mesh`` broadcasts them from the
axis's first rank), each rank runs the net's own train step on its
LOCAL slice of the batch, and the step averages the gradients with ONE
all-reduce over the axis before the update (``GradAllReduce``, the
counterpart of the all-reduce XLA inserts into the sharded step). A
meshed step reads nothing back to the host, so on NCCL the whole step,
collective included, is captured as a CUDA graph (nn/multistep.py) like
an unmeshed one.

The average is weighted so the result is the global batch's mean loss:
each rank's gradient and score are scaled by its share of the loss's
denominator (the count of unmasked label entries, or of label rows)
before the sum. With one rank the share is exactly 1.0, so a meshed step
on a group of one is bit for bit the unmeshed step.

Batch norm takes the GLOBAL batch's statistics, as the JAX package's
sharded step does over the whole sharded batch: over a data axis of
more than one rank the step all-reduces BN's f32 column sums and row
count, forward and backward, in one collective a site
(ops/normalization.py, ops/fused_block.py), so the running statistics,
and with them every rank's layer ``state``, stay equal. Zero rows that
``_pad_batch`` adds enter those statistics (BN takes no mask), as in the
JAX package. A group of one takes none of these collectives.

``ParallelWrapper`` reproduces the reference's *semantics* (k local
steps between parameter averages) on one process, for the fixed-seed
equivalence tests; ``averaging_frequency=1`` is the same mathematics as
the sharded step.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.nn.updater import _fill, _leaves, _map
from deeplearning4j_tpu_torch.ops.normalization import synced_batch_stats
from deeplearning4j_tpu_torch.parallel.mesh import axis_group, axis_size

__all__ = ["apply_mesh", "shard_batch", "shard_step", "shard_step_multi",
           "use_mesh", "BatchSharding", "GradAllReduce", "ParallelWrapper"]


def replicate(mesh, tree, data_axis: str = "data"):
    """Every leaf of ``tree``, in place, set to the axis's first rank's
    value (one broadcast a leaf)."""
    group = axis_group(mesh, data_axis)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for leaf in _leaves(tree):
            if isinstance(leaf, torch.Tensor):
                dist.broadcast(leaf, src, group=group)
    return tree


def apply_mesh(net, mesh, data_axis: str = "data", model_axis=None,
               tp_rules=None, replicate_first: bool = True):
    """Replicate the net's params, state (the shift batch norm takes is
    the running mean, so it must agree) and optimizer state over the
    mesh's axes from their first rank, and give its train step the
    meshed collectives: ``GradAllReduce`` over the data axis, or
    ``NoDataAxis`` on a mesh without one. With ``model_axis`` the params
    are then placed over that axis (parallel/tensor.py
    ``apply_tensor_parallel``). A restore that read the same checkpoint
    on every rank passes ``replicate_first=False``."""
    if model_axis is not None:
        from deeplearning4j_tpu_torch.parallel.tensor import check_rules
        check_rules(tp_rules, net.params)
    axes = mesh.mesh_dim_names or ()
    if model_axis is None and data_axis not in axes:
        raise ValueError(f"the mesh has no data axis {data_axis!r} "
                         f"(its axes: {axes}) and no model axis was given")
    if replicate_first:
        for axis in (data_axis, model_axis):
            if axis in axes:
                for tree in (net.params, net.state, net.opt_state):
                    if tree:
                        replicate(mesh, tree, axis)
    net._grad_reduce = (GradAllReduce(axis_group(mesh, data_axis))
                        if data_axis in axes else NoDataAxis())
    net._mesh = (mesh, data_axis)   # what a checkpoint's layout records
    net._mesh_detail = {"model_axis": model_axis, "tp_rules": tp_rules}
    if model_axis is not None:
        from deeplearning4j_tpu_torch.parallel.tensor import (
            apply_tensor_parallel)
        apply_tensor_parallel(net, mesh, data_axis, model_axis, tp_rules)
    return net


class NoDataAxis:
    """The step's collectives on a mesh without a data axis (e.g.
    ``{"model": 2}``): every rank steps on the whole batch, so the
    gradient and the score are its own and no collective runs."""

    def share(self, labels, lmask):
        return None

    def batch_stats(self, share):
        return contextlib.nullcontext()

    def __call__(self, grads, loss, share):
        return grads, loss


def shard_batch(mesh, data_axis: str, x):
    """This rank's part of a batch sharded over the data axis: each
    process passes its LOCAL slice of the global batch (the
    Spark-partition analogue), placed on this rank's device."""
    from deeplearning4j_tpu_torch.parallel import distributed
    if x is None:
        return None
    return torch.as_tensor(x).to(distributed.device())


class BatchSharding:
    """Where a meshed net's batches go, for ``DevicePrefetchIterator(
    sharding=)`` (the counterpart of the JAX package's data
    ``NamedSharding``): this rank's share of a global batch's rows on the
    data axis (rows [i k, (i + 1) k) for data index i of d, k = rows / d;
    every rank of one model group takes the same rows), on this rank's
    device."""

    def __init__(self, mesh, data_axis: str = "data"):
        from deeplearning4j_tpu_torch.parallel import distributed
        self.device = distributed.device()
        if data_axis in (mesh.mesh_dim_names or ()):
            group = axis_group(mesh, data_axis)
            self.parts, self.index = (dist.get_world_size(group),
                                      dist.get_rank(group))
        else:
            self.parts, self.index = 1, 0

    def rows(self, t):
        """This rank's rows of the batch leaf ``t``."""
        if self.parts == 1:
            return t
        if t.shape[0] % self.parts:
            raise ValueError(
                f"a global batch of {t.shape[0]} rows does not split over "
                f"the data axis's {self.parts} ranks")
        k = t.shape[0] // self.parts
        return t[self.index * k:(self.index + 1) * k]


def _pad0(a, pad):
    if a is None:
        return None
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])


def _mask_lead_shape(label):
    """Label-mask leading shape: [b] for [b, c] labels, [b, t] for
    [b, t, c] sequence labels."""
    return label.shape[:-1] if label.dim() > 1 else label.shape


def _pad_batch(x, labels, fmask, lmask, multiple: int):
    """Pad a partial batch up to a multiple of ``multiple`` rows. Padded
    examples are masked out via the label mask, so the loss mean (and
    thus the gradients) equal the unpadded batch's."""
    n = x.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, labels, fmask, lmask
    pad = target - n
    if lmask is None:
        lmask = torch.ones(_mask_lead_shape(labels), dtype=torch.float32,
                           device=labels.device)
    return _pad0(x, pad), _pad0(labels, pad), _pad0(fmask, pad), \
        _pad0(lmask, pad)


def _loss_denominator(labels, lmask) -> torch.Tensor:
    """The count the loss averages over on this rank (losses.py: the sum
    of the label mask, else the label entries but the class axis); a
    graph's first output stands for all."""
    if isinstance(labels, (list, tuple)):
        labels = labels[0]
        lmask = None if lmask is None else lmask[0]
    if lmask is not None:
        return torch.clamp(lmask.to(torch.float32).sum(), min=1.0)
    # a fill, not a copy from the host: a captured step may hold it
    return torch.full((), float(_mask_lead_shape(labels).numel()),
                      dtype=torch.float32, device=labels.device)


class GradAllReduce:
    """The meshed step's collectives (nn/precision.py ``build_step_fn(
    reduce=)``): ``share`` before the forward, one small all-reduce of
    the loss denominators giving this rank's share of the loss;
    ``batch_stats(share)`` around the forward and backward, global batch
    statistics for batch norm over a group of more than one rank
    (ops/normalization.py ``synced_batch_stats``); and the call, between
    the backward and the update, ONE all-reduce of every gradient and
    the score, each scaled by this rank's share."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)

    def share(self, labels, lmask):
        mine = _loss_denominator(labels, lmask)
        total = mine.clone()
        dist.all_reduce(total, group=self.group)
        return mine / total

    def batch_stats(self, share):
        """Global batch statistics while open; a group of one takes no
        collective and keeps the unmeshed arithmetic."""
        if self.size == 1:
            return contextlib.nullcontext()
        return synced_batch_stats(self.group, share)

    def __call__(self, grads, loss, share):
        leaves = list(_leaves(grads))
        live = [g for g in leaves if g is not None]
        by_dtype: dict = {}
        for g in live:
            by_dtype.setdefault(g.dtype, []).append(g)
        by_dtype.setdefault(torch.float32, [])
        out = {}
        for dt, gs in by_dtype.items():
            parts = [g.reshape(-1) * share.to(dt) for g in gs]
            if dt == torch.float32:
                parts.append(loss.detach().to(dt).reshape(1) * share)
            buf = torch.cat(parts)
            dist.all_reduce(buf, group=self.group)
            sizes = [g.numel() for g in gs]
            rest = buf.split(sizes + ([1] if dt == torch.float32 else []))
            for g, r in zip(gs, rest):
                out[id(g)] = r.view_as(g)
            if dt == torch.float32:
                loss = rest[-1].reshape(()).to(loss.dtype)
        return _fill(grads, iter([None if g is None else out[id(g)]
                                  for g in leaves])), loss


def _with_reduce(net, mesh, data_axis, step_fn):
    reduce = GradAllReduce(axis_group(mesh, data_axis))

    def run(batch):
        prev = getattr(net, "_grad_reduce", None)
        net._grad_reduce = reduce
        try:
            return step_fn(net, batch)
        finally:
            net._grad_reduce = prev
    return run


def shard_step(net, step_fn, mesh, data_axis: str = "data"):
    """The train step ``step_fn(net, batch)`` (nn/multistep.py
    ``train_step``) for mesh execution: ``wrapped(x, labels, fmask,
    lmask)`` takes this rank's LOCAL slice, pads it to the rank's share
    of the data axis (padded rows masked out), and runs the step with
    the gradient all-reduce over the axis."""
    n_shards = axis_size(mesh, data_axis)
    pad_multiple = max(n_shards // dist.get_world_size(), 1)
    run = _with_reduce(net, mesh, data_axis, step_fn)

    def wrapped(x, labels, fmask=None, lmask=None):
        x, labels, fmask, lmask = _pad_batch(x, labels, fmask, lmask,
                                             pad_multiple)
        return run(tuple(shard_batch(mesh, data_axis, a)
                         for a in (x, labels, fmask, lmask)))

    return wrapped


def shard_step_multi(net, step_fn, mesh, data_axis: str = "data"):
    """ComputationGraph variant of shard_step: inputs a dict, labels and
    label masks lists; partial batches are zero-padded with padded rows
    excluded via the per-output label masks."""
    n_shards = axis_size(mesh, data_axis)
    pad_multiple = max(n_shards // dist.get_world_size(), 1)
    run = _with_reduce(net, mesh, data_axis, step_fn)

    def wrapped(inputs, labels, fmasks=None, lmasks=None):
        fmasks = fmasks or {}
        n = next(iter(inputs.values())).shape[0]
        target = -(-n // pad_multiple) * pad_multiple
        if target != n:
            pad = target - n
            inputs = {k: _pad0(v, pad) for k, v in inputs.items()}
            lmasks = [torch.ones(_mask_lead_shape(l), dtype=torch.float32,
                                 device=l.device) if m is None else m
                      for l, m in zip(labels, lmasks or [None] * len(labels))]
            labels = [_pad0(l, pad) for l in labels]
            lmasks = [_pad0(m, pad) for m in lmasks]
            fmasks = {k: _pad0(v, pad) for k, v in fmasks.items()}
        put = lambda a: shard_batch(mesh, data_axis, a)  # noqa: E731
        return run(({k: put(v) for k, v in inputs.items()},
                    [put(l) for l in labels],
                    {k: put(v) for k, v in fmasks.items()},
                    None if lmasks is None else [put(m) for m in lmasks]))

    return wrapped


class ParallelWrapper:
    """Reference-semantics data-parallel trainer on one process: each of
    N logical workers runs ``averaging_frequency`` local steps from a copy
    of the net's trees, then parameters and (optionally) updater state
    are averaged over the workers that stepped (ParallelWrapper.java
    averageAndPropagate). Every worker step of a round runs at the
    round's iteration; the net's iteration advances once a round. This
    exists for capability and equivalence parity; the sharded step is
    the performance path."""

    def __init__(self, net, workers: int = 2, averaging_frequency: int = 1,
                 average_updaters: bool = True):
        self.net = net
        self.workers = workers
        self.averaging_frequency = averaging_frequency
        self.average_updaters = average_updaters

    def _worker_step(self, replica, ds):
        """One train step of ``replica`` (its params, state, opt_state)
        on ``ds``, through the net's own step; -> (replica, score)."""
        from deeplearning4j_tpu_torch.nn import multistep
        net = self.net
        own = (net.params, net.state, net.opt_state)
        net.params, net.state, net.opt_state = replica
        try:
            score = multistep.train_step(net, net._step_batch(ds),
                                         advance=False)
            return (net.params, net.state, net.opt_state), score
        finally:
            net.params, net.state, net.opt_state = own

    def fit(self, iterator, epochs: int = 1):
        net = self.net
        net._require_init()
        copy = lambda tree: _map(lambda t: t.detach().clone(), tree)  # noqa
        for _ in range(epochs):
            batch_iter = iter(iterator)
            done = False
            while not done:
                # workers x averaging_frequency batches, round-robin like
                # the reference's per-worker queues
                replicas = [(copy(net.params), copy(net.state),
                             copy(net.opt_state))
                            for _ in range(self.workers)]
                scores = []
                stepped = [False] * self.workers
                for _ in range(self.averaging_frequency):
                    for w in range(self.workers):
                        try:
                            ds = next(batch_iter)
                        except StopIteration:
                            done = True
                            break
                        stepped[w] = True
                        replicas[w], score = self._worker_step(replicas[w],
                                                               ds)
                        scores.append(score)
                    if done:
                        break
                if not any(stepped):
                    break
                # average over the workers that stepped (idle tail workers
                # would dilute the last partial round toward stale params)
                active = [replicas[w] for w in range(self.workers)
                          if stepped[w]]
                _average_into(net.params, [r[0] for r in active])
                net.state = active[0][1]
                if self.average_updaters:
                    _average_into(net.opt_state, [r[2] for r in active])
                else:
                    net.opt_state = active[0][2]
                net.iteration += 1
                if scores:
                    net.score_value = scores[-1]
                for l in net.listeners:
                    l.iteration_done(net, net.iteration, net.epoch)
            iterator.reset()
            net.epoch += 1
        return net


def mean_leaf(*xs):
    """The workers' average of one leaf: ``sum(xs) / len(xs)`` in the
    leaf's dtype; an integer leaf (Adam's step count) takes the max, the
    furthest worker's count, exact when workers step evenly."""
    if not xs[0].dtype.is_floating_point:
        return torch.max(torch.stack(xs), dim=0).values
    return sum(xs) / len(xs)


def _average_into(tree, trees):
    """Each leaf of ``tree``, in place, set to ``mean_leaf`` of the
    matching leaves of ``trees`` (the net keeps its tensors, so a
    captured step replays over them)."""
    with torch.no_grad():
        for dst, *srcs in zip(_leaves(tree), *(_leaves(t) for t in trees)):
            dst.copy_(mean_leaf(*srcs))


def use_mesh(net, mesh, data_axis: str = "data", model_axis=None,
             tp_rules=None):
    """Both network kinds' ``use_mesh``: record the mesh, drop the
    captured steps (a meshed step is another graph) and apply it: over a
    data axis (``apply_mesh``), or with ``model_axis`` over the model axis
    too (parallel/tensor.py ``apply_tensor_parallel``; a
    MultiLayerNetwork's, the graph refuses it). ``tp_rules`` without a
    model axis place nothing, as in the JAX package."""
    net._require_init()
    net._multi_steps = {}
    return apply_mesh(net, mesh, data_axis, model_axis, tp_rules)
