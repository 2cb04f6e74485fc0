"""Numeric gradient checks (counterpart of
deeplearning4j_tpu/utils/gradient_check.py).

Each checked entry of each parameter is moved by +-epsilon, the central
difference is compared with the analytic gradient (autograd of the same
loss a train step differentiates), and a relative error above
``max_rel_error`` (with an absolute error above ``min_abs_error``) is a
failure. Run under float64 (a float64 DtypePolicy) with epsilon ~1e-6 and
max_rel_error 1e-5, the reference's settings.

Which entries are checked is drawn from ``np.random.default_rng(seed)``
in the JAX package's order (leaves in sorted-key order, ``rng.choice``
per leaf larger than ``sample_per_leaf``), so one seed checks the same
entries in both packages. On the card, float64 runs where the layer has
a float64 route (dense, convolution and pooling through cuDNN, batch
norm); the CUDA LSTM and attention kernels take float32 and bfloat16
only and refuse float64 by name, so those layers are checked on the
CPU's plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.precision import tree_grads
from deeplearning4j_tpu_torch.nn.updater import _leaves, _map
from deeplearning4j_tpu_torch.utils.serialization import _flatten, _keystr


@dataclass
class GradCheckResult:
    total_checked: int = 0
    total_failed: int = 0
    max_rel_error: float = 0.0
    failures: list = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return self.total_failed == 0 and self.total_checked > 0


def _sorted_paths(tree):
    return [_keystr(p) for p, _ in sorted(_flatten(tree),
                                          key=lambda kv: kv[0])]


def gradient_check_fn(loss_fn, params, *, epsilon: float = 1e-6,
                      max_rel_error: float = 1e-5,
                      min_abs_error: float = 1e-10,
                      sample_per_leaf: int | None = None,
                      seed: int = 0, grad_fn=None) -> GradCheckResult:
    """Check d loss_fn / d params at ``params`` (a nested dict of
    tensors).

    ``loss_fn(params) -> 0-d tensor`` must be deterministic.
    ``sample_per_leaf`` caps how many entries of each parameter are
    moved (a random subset). ``grad_fn(params) -> gradient tree`` replaces
    autograd of ``loss_fn`` as the analytic gradient (the seam a test
    plants a wrong gradient through)."""
    if grad_fn is None:
        def grad_fn(p):
            leaves = _map(lambda t: t.detach().clone().requires_grad_(), p)
            return tree_grads(loss_fn(leaves), leaves)
    grads = grad_fn(params)
    work = _map(lambda t: t.detach().clone(), params)
    leaves = list(_leaves(work))
    grad_leaves = list(_leaves(grads))
    paths = _sorted_paths(work)
    rng = np.random.default_rng(seed)
    res = GradCheckResult()

    def probe():
        with torch.no_grad():
            return float(loss_fn(work))

    for leaf, gleaf, path in zip(leaves, grad_leaves, paths):
        flat = leaf.view(-1)
        host = flat.cpu().numpy().copy()
        gflat = gleaf.detach().reshape(-1).cpu().numpy()
        n = host.size
        idxs = np.arange(n)
        if sample_per_leaf is not None and n > sample_per_leaf:
            idxs = rng.choice(n, size=sample_per_leaf, replace=False)
        for i in idxs:
            orig = host[i]
            flat[i] = float(orig + epsilon)
            plus = probe()
            flat[i] = float(orig - epsilon)
            minus = probe()
            flat[i] = float(orig)
            numeric = (plus - minus) / (2.0 * epsilon)
            analytic = float(gflat[i])
            denom = abs(numeric) + abs(analytic)
            rel = 0.0 if denom == 0 else abs(numeric - analytic) / denom
            res.total_checked += 1
            res.max_rel_error = max(res.max_rel_error, rel)
            if rel > max_rel_error and abs(numeric - analytic) > min_abs_error:
                res.total_failed += 1
                res.failures.append(
                    {"param": path, "index": int(i), "numeric": numeric,
                     "analytic": analytic, "rel_error": rel})
    return res


def check_network_gradients(net, ds, *, epsilon: float = 1e-6,
                            max_rel_error: float = 1e-5,
                            min_abs_error: float = 1e-9,
                            sample_per_leaf: int | None = 128,
                            seed: int = 0, grad_fn=None) -> GradCheckResult:
    """The gradient check of a MultiLayerNetwork or ComputationGraph on
    one batch: its training loss (``train=True``) with no generator, so
    dropout must be 0 in the checked config (the reference's
    precondition)."""
    net._require_init()
    batch = net._step_batch(ds)

    def loss_fn(params):
        loss, _ = net._loss(params, net.state, *batch, gen=None, train=True)
        return loss

    return gradient_check_fn(
        loss_fn, net.params, epsilon=epsilon, max_rel_error=max_rel_error,
        min_abs_error=min_abs_error, sample_per_leaf=sample_per_leaf,
        seed=seed, grad_fn=grad_fn)
