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
"""

from __future__ import annotations

import torch


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


class BatchNormTrainFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, shift, eps):
        axes = tuple(range(x.dim() - 1))
        mean, var = _stats(x, axes, shift)
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
        scale = gamma.to(ad) * inv
        dx = scale.to(cd) * (g - (a / n).to(cd) - xhat * (b / n).to(cd))
        return dx, b.to(gamma.dtype), a.to(gamma.dtype), None, None


def batch_norm_train(x, gamma, beta, shift, eps):
    """Normalize ``x`` over all-but-last axes with batch statistics.
    Returns ``(y, mean, var)``; mean/var are the f32 batch statistics the
    caller folds into its running averages."""
    return BatchNormTrainFn.apply(x, gamma, beta, shift, float(eps))
