"""t-SNE on the card (counterpart of deeplearning4j_tpu/plot/tsne.py).

Parity: deeplearning4j-core plot/Tsne.java. The exact O(N^2) algorithm:
the pairwise squared distances are one [N, N] ``torch.matmul``, the
per-point perplexity binary search runs as batched tensor ops over all
rows at once (the JAX package's 50 iterations), and the gradient loop
follows the JAX package's step for step (the same formulation, the same
early exaggeration and momentum schedule, the numpy-seeded init), in
float32. ``device=None`` is the card, as for every entry point; the CPU
runs the same ops. The loop reads nothing back to the host until it
ends.

``BarnesHutTsne`` needs clustering/sptree.py, which waits for
ROADMAP.md A.6; it is refused by name.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    s = torch.sum(x * x, dim=1)
    return s[:, None] - 2.0 * torch.matmul(x, x.T) + s[None, :]


def _off_diagonal(n: int, device) -> torch.Tensor:
    return 1.0 - torch.eye(n, dtype=torch.float32, device=device)


def _cond_probs_for_perplexity(d2: torch.Tensor, perplexity: float,
                               iters: int = 50) -> torch.Tensor:
    """Binary-search each point's precision beta so its row of P hits the
    target perplexity (Tsne.java's hBeta search), all rows at once."""
    n = d2.shape[0]
    off = _off_diagonal(n, d2.device)
    log_u = float(np.log(np.float32(perplexity)))

    def entropy_and_p(beta):
        p = torch.exp(-d2 * beta[:, None]) * off
        sum_p = torch.clamp(p.sum(dim=1, keepdim=True), min=1e-12)
        h = torch.log(sum_p[:, 0]) + beta * (d2 * p).sum(dim=1) / sum_p[:, 0]
        return h, p / sum_p

    beta = torch.ones((n,), dtype=torch.float32, device=d2.device)
    lo = torch.full((n,), -float("inf"), device=d2.device)
    hi = torch.full((n,), float("inf"), device=d2.device)
    for _ in range(iters):
        h, _ = entropy_and_p(beta)
        too_high = h > log_u          # entropy too high -> increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2,
                           torch.where(torch.isinf(lo), beta / 2,
                                       (lo + hi) / 2))
    _, p = entropy_and_p(beta)
    return p


def joint_probabilities(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    """P: the symmetrized conditional probabilities of ``x`` [n, d]
    over 2n, floored at 1e-12 (the perplexity clamped to the point
    count as the JAX package clamps it)."""
    n = x.shape[0]
    d2 = _pairwise_sq_dists(x)
    P = _cond_probs_for_perplexity(d2, min(perplexity,
                                           max((n - 1) / 3.0, 2.0)))
    P = (P + P.T) / (2.0 * n)
    return torch.clamp(P, min=1e-12)


def _tsne_grad(y: torch.Tensor, P: torch.Tensor, with_kl: bool = True):
    """The KL gradient at ``y`` and (with ``with_kl``) the KL itself, as
    a 0-d tensor (None without)."""
    n = y.shape[0]
    d2 = _pairwise_sq_dists(y)
    num = 1.0 / (1.0 + d2)
    num = num * _off_diagonal(n, y.device)
    Q = torch.clamp(num / torch.clamp(num.sum(), min=1e-12), min=1e-12)
    PQ = (P - Q) * num
    grad = 4.0 * torch.matmul(torch.diag(PQ.sum(dim=1)) - PQ, y)
    kl = torch.sum(P * torch.log(torch.clamp(P, min=1e-12) / Q)) \
        if with_kl else None
    return grad, kl


class Tsne:
    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, max_iter: int = 500,
                 early_exaggeration: float = 12.0, momentum: float = 0.8,
                 seed: int = 0, device=None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.early_exaggeration = early_exaggeration
        self.momentum = momentum
        self.seed = seed
        self.device = resolve_device(device)
        self.kl = None
        self.P = None      # the joint P of the last fit, on its device

    def fit_transform(self, x) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        n = x.shape[0]
        P = joint_probabilities(x, self.perplexity)
        self.P = P

        rng = np.random.default_rng(self.seed)
        y = torch.as_tensor(
            (rng.standard_normal((n, self.n_components)) * 1e-2)
            .astype(np.float32), device=self.device)
        v = torch.zeros_like(y)
        exag_until = min(250, self.max_iter // 2)
        kl = None
        for it in range(self.max_iter):
            p_eff = P * self.early_exaggeration if it < exag_until else P
            grad, kl = _tsne_grad(y, p_eff,
                                  with_kl=it == self.max_iter - 1)
            mom = 0.5 if it < exag_until else self.momentum
            v = mom * v - self.learning_rate * grad
            y = y + v
            y = y - y.mean(dim=0)
        self.kl = None if kl is None else float(kl)
        return y.cpu().numpy()


class BarnesHutTsne(Tsne):
    """Barnes-Hut t-SNE needs the SPTree (clustering/sptree.py), which
    waits for ROADMAP.md A.6; the exact ``Tsne`` runs on the card."""

    def __init__(self, *args, theta: float = 0.5, **kw):
        raise NotImplementedError(
            "BarnesHutTsne: its SPTree (clustering/sptree.py) waits for "
            "ROADMAP.md A.6; the exact Tsne runs on the card")
