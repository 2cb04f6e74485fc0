"""Pipeline (stage) parallelism over a ``pipe`` mesh axis (counterpart of
deeplearning4j_tpu/parallel/pipeline.py).

Each rank holds ONE stage's parameters (the stage dimension of a stacked
param tree, ``stack_stage_params``, cut by ``shard_stages``), and
microbatches stream through the ranks in a GPipe wavefront: M + S - 1
ticks for M microbatches over S stages, each stage's activation handed
to the next stage by ``parallel/mesh.py::ring_shift`` (the JAX package's
``lax.ppermute``) at the end of every tick. A rank computes only on the
ticks where it holds a real microbatch, and a hop moves only a real
activation: where the JAX package computes garbage on the other ticks
and never collects it, the port skips the work, and the outputs are the
same. The last stage's outputs reach every rank (``broadcast_from``).
The backward pipeline is autograd through the hops (cotangents ride the
ranks in reverse), so one ``backward()`` of a loss on the output trains
every stage; every rank computes that loss from the same output.

Scope: homogeneous repeated stages whose output has its input's shape
and dtype (the transformer-block regime); stems and heads run outside
the pipelined trunk. The bubble is the GPipe (S - 1) / (M + S - 1)
share of the ticks.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.parallel.mesh import (axis_group, axis_rank,
                                                    axis_size,
                                                    broadcast_from,
                                                    new_token, ring_shift,
                                                    tie)

__all__ = ["stack_stage_params", "shard_stages", "split_microbatches",
           "pipeline_forward", "pipeline_train_step", "StageShard"]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def stack_stage_params(per_stage_params):
    """[{param: tensor}, ...] (one per stage, identical structure) ->
    the stacked tree with a leading stage dimension."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack([torch.as_tensor(p) for p in per_stage_params])


class StageShard(dict):
    """This rank's slice of a stacked stage tree (leading dimension 1),
    with the number of stages it was cut from."""

    def __init__(self, tree, n_stages: int):
        super().__init__(tree)
        self.n_stages = int(n_stages)


def shard_stages(mesh, pipe_axis: str, stacked_params):
    """This rank's stage of a stacked tree: every leaf's slice [1, ...]
    at the rank's index on ``pipe_axis``, on this rank's device (each
    rank holds exactly its stage's slice)."""
    from deeplearning4j_tpu_torch.parallel import distributed
    dims = {leaf.shape[0] for leaf in _leaves(stacked_params)}
    s = axis_rank(mesh, pipe_axis)
    return StageShard(_map(lambda a: a[s:s + 1].contiguous().to(
        distributed.device()), stacked_params), max(dims))


def split_microbatches(x, n_micro: int):
    """[B, ...] -> [n_micro, B / n_micro, ...] (the GPipe microbatch
    dimension)."""
    b = x.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    return x.reshape(n_micro, b // n_micro, *x.shape[1:])


def _local_stage(stage_params, n_stages, s, pipe_axis):
    """This rank's stage params (the leading dimension dropped), after the
    JAX package's check that the stage dimension equals the axis."""
    if isinstance(stage_params, StageShard):
        dims = {stage_params.n_stages}
        local = stage_params
    else:
        dims = {leaf.shape[0] for leaf in _leaves(stage_params)}
        local = None
    if dims != {n_stages}:
        # a multiple would put 2+ stages on a rank, and applying only the
        # first would be silently wrong: a hard error instead
        raise ValueError(
            f"stacked stage dim(s) {sorted(dims)} must equal the "
            f"'{pipe_axis}' mesh axis size ({n_stages}): one stage per "
            f"device")
    if local is not None:
        return _map(lambda a: a[0], local)
    return _map(lambda a: a[s], stage_params)


def pipeline_forward(mesh, pipe_axis: str, stage_params, x_micro, stage_fn):
    """GPipe forward: ``stage_params`` this rank's ``StageShard`` (or the
    whole stacked tree, of which the rank takes its stage);
    ``x_micro`` [M, mb, ...] microbatched input (the same on every rank;
    only the first stage reads it); ``stage_fn(params, x) -> y`` one
    stage's computation, y of x's shape and dtype. Every rank of the axis
    calls it. Returns [M, mb, ...] outputs, the same on every rank.
    Differentiable."""
    group = axis_group(mesh, pipe_axis)
    n_stages, s = axis_size(mesh, pipe_axis), axis_rank(mesh, pipe_axis)
    p = _local_stage(stage_params, n_stages, s, pipe_axis)
    m = x_micro.shape[0]
    like = x_micro[0]
    token = new_token(x_micro, *_leaves(p), device=x_micro.device)
    outs, recv = [None] * m, None
    for t in range(m + n_stages - 1):
        y = None
        if 0 <= t - s < m:            # this stage holds microbatch t - s
            y = stage_fn(p, x_micro[t] if s == 0 else recv)
            if y.shape != like.shape or y.dtype != like.dtype:
                raise ValueError(
                    f"a pipeline stage must keep its input's shape and "
                    f"dtype: {tuple(like.shape)} {like.dtype} in, "
                    f"{tuple(y.shape)} {y.dtype} out")
            if s == n_stages - 1:
                outs[t - s] = y
        send = y is not None and s < n_stages - 1
        gets = s > 0 and 0 <= t + 1 - s < m
        recv = None
        if send or gets:
            recv, token = ring_shift(
                y, group, send_to=s + 1 if send else None,
                recv_from=s - 1 if gets else None, like=like, token=token,
                tag=t)
    if n_stages == 1:
        return torch.stack(outs)
    buf = torch.stack(outs) if s == n_stages - 1 else torch.zeros_like(
        x_micro)
    return tie(broadcast_from(buf, group, n_stages - 1), token)


def pipeline_train_step(mesh, pipe_axis: str, stage_fn, loss_fn,
                        lr: float = 0.1):
    """An SGD step over a pipelined trunk: ``loss_fn(y, labels)`` applied
    to the pipeline output (the caller's loss folds the mean over
    microbatches in). Returns ``step(stage_params, x_micro,
    labels_micro) -> (new_params, loss)``: this rank's stage updated (a
    ``StageShard``) and the loss. The backward pipeline is autograd
    through the forward schedule's hops."""

    def step(stage_params, x_micro, labels_micro):
        if not isinstance(stage_params, StageShard):
            stage_params = shard_stages(mesh, pipe_axis, stage_params)
        leaves = StageShard(_map(lambda a: a.detach().requires_grad_(),
                                 stage_params), stage_params.n_stages)
        with torch.enable_grad():
            y = pipeline_forward(mesh, pipe_axis, leaves, x_micro,
                                 stage_fn)
            loss = loss_fn(y, labels_micro)
            loss.backward()
        with torch.no_grad():
            new = _map(lambda a: a - lr * a.grad.to(a.dtype), leaves)
        return StageShard(new, stage_params.n_stages), loss.detach()

    return step
