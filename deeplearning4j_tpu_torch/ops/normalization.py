"""Batch-norm training op with a hand-written, dtype-controlled backward
(counterpart of deeplearning4j_tpu/ops/normalization.py, whose custom VJP
this ``torch.autograd.Function`` copies operation for operation).

Forward, single pass: per-channel mean and variance over all but the last
axis, accumulated in at least f32, in the shifted form
var = E[(x-K)^2] - E[x-K]^2 with K the caller's ``shift`` (the layer passes
its RUNNING mean, which is data-independent and receives no gradient).
``y = x * scale + sh`` in the compute dtype with scale = gamma * inv and
sh = beta - mean * scale formed in f32.

Backward, in the compute dtype with f32 sums: a = sum(g), b = sum(g * xhat)
with xhat = (x - mean) * inv, then dx = scale * (g - a/n - xhat * b/n),
dgamma = b, dbeta = a. The batch statistics ``mean``/``var`` are outputs
for the running-average update only and get no cotangent.

Meshed over a data axis of more than one rank (``synced_batch_stats``,
opened by the meshed train step), the statistics are the GLOBAL batch's,
as the JAX package's sharded step takes them over the whole sharded x:
the forward all-reduces its f32 column sums of (x-K) and (x-K)^2 with
the row count in one buffer, the backward its sums a and b with the
count the same way (``all_reduce_sums``). A rank's gradient is later
scaled by its share of the loss (parallel/data_parallel.py), so the
backward weights its sums by the share before the all-reduce and
divides the global ones by it after. Unmeshed, and in a group of one,
no collective is taken and the arithmetic above is unchanged.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

# (process group, this rank's loss share) while a meshed step of more
# than one rank runs its forward and backward; process-wide, since the
# autograd engine runs a backward (and a remat recompute) on its own
# thread, and a process is one rank
_SYNC = None


@contextlib.contextmanager
def synced_batch_stats(group, share):
    """While open, batch norm in training (``BatchNormTrainFn`` and the
    fused tail) reduces its statistics over ``group``; ``share`` is this
    rank's 0-d f32 share of the loss's denominator."""
    global _SYNC
    prev, _SYNC = _SYNC, (group, share)
    try:
        yield
    finally:
        _SYNC = prev


def batch_sync():
    """The open ``synced_batch_stats``' (group, share), or None."""
    return _SYNC


def all_reduce_sums(sync, *sums, rows: int):
    """Sums ``sums`` (1-d, one dtype) and the row count ``rows`` over the
    sync's group with ONE all-reduce; returns (the global sums, the
    global count as a 0-d tensor of their dtype)."""
    group = sync[0]
    s0 = sums[0]
    buf = torch.cat([*sums, s0.new_full((1,), float(rows))])
    dist.all_reduce(buf, group=group)
    n = s0.numel()
    return [buf[i * n:(i + 1) * n] for i in range(len(sums))], buf[-1]


def weighted_sums(sync, a, b, rows: int):
    """The backward's column sums over the group: each rank's (a, b)
    weighted by its loss share, summed, and divided by that share again,
    so ``share * result`` is this rank's part of the global cotangent's
    sums. Returns (A, B, global row count)."""
    share = sync[1].to(a.dtype)
    (A, B), m = all_reduce_sums(sync, a * share, b * share, rows=rows)
    inv = torch.where(share > 0, 1.0 / share, torch.zeros_like(share))
    return A * inv, B * inv, m


def _acc_dtype(x):
    """At least f32, wider if x already is."""
    return torch.promote_types(x.dtype, torch.float32)


def _stats(x, axes, shift):
    ad = _acc_dtype(x)
    k = shift.detach().to(ad)
    xs = x.to(ad) - k
    m1s = torch.mean(xs, dim=axes)
    m2s = torch.mean(xs * xs, dim=axes)
    var = torch.clamp(m2s - m1s * m1s, min=0.0)
    return m1s + k, var


def _global_stats(x, axes, shift, sync):
    """``_stats`` over the sync's group: sums of the shifted values and
    their squares, and the row count, all-reduced at once."""
    ad = _acc_dtype(x)
    k = shift.detach().to(ad)
    xs = x.to(ad) - k
    (s1, s2), m = all_reduce_sums(sync, torch.sum(xs, dim=axes),
                                  torch.sum(xs * xs, dim=axes),
                                  rows=x.numel() // x.shape[-1])
    m1s = s1 / m
    var = torch.clamp(s2 / m - m1s * m1s, min=0.0)
    return m1s + k, var


class BatchNormTrainFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, shift, eps):
        axes = tuple(range(x.dim() - 1))
        sync = batch_sync()
        ctx.sync = sync
        if sync is None:
            mean, var = _stats(x, axes, shift)
        else:
            mean, var = _global_stats(x, axes, shift, sync)
        inv = torch.rsqrt(var + eps)
        ad = _acc_dtype(x)
        scale = gamma.to(ad) * inv
        sh = beta.to(ad) - mean * scale
        y = x * scale.to(x.dtype) + sh.to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        cd = x.dtype
        axes = tuple(range(x.dim() - 1))
        n = x.numel() // x.shape[-1]
        ad = _acc_dtype(x)
        g = g.to(cd)
        xhat = (x - mean.to(cd)) * inv.to(cd)
        a = torch.sum(g.to(ad), dim=axes)
        b = torch.sum((g * xhat).to(ad), dim=axes)
        ca, cb = a, b
        if ctx.sync is not None:
            # dgamma and dbeta stay this rank's sums: the gradient
            # all-reduce weights them by the share and adds them up
            ca, cb, n = weighted_sums(ctx.sync, a, b, n)
        scale = gamma.to(ad) * inv
        dx = scale.to(cd) * (g - (ca / n).to(cd) - xhat * (cb / n).to(cd))
        return dx, b.to(gamma.dtype), a.to(gamma.dtype), None, None


def batch_norm_train(x, gamma, beta, shift, eps):
    """Normalize ``x`` over all-but-last axes with batch statistics.
    Returns ``(y, mean, var)``; mean/var are the f32 batch statistics the
    caller folds into its running averages."""
    return BatchNormTrainFn.apply(x, gamma, beta, shift, float(eps))
