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

``BarnesHutTsne`` with ``theta > 0`` is the JAX package's float64 numpy
path on the host (sparse kNN similarities and clustering/sptree.py's
repulsion), kept there; with ``theta <= 0`` it is the exact ``Tsne`` on
its device.
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
    """Barnes-Hut t-SNE (BarnesHutTsne.java parity): sparse kNN input
    similarities + an SPTree (clustering/sptree.py) approximating the
    repulsive forces with accuracy knob ``theta``.

    ``theta <= 0`` runs the exact ``Tsne`` on ``device`` (default: the
    card). ``theta > 0`` is the JAX package's float64 numpy path, kept on
    the host whatever ``device`` says: the tree's construction and its
    traversal are pointer-chasing control flow, which the reference runs
    on the CPU for large N too."""

    def __init__(self, *args, theta: float = 0.5, **kw):
        super().__init__(*args, **kw)
        self.theta = theta

    def fit_transform(self, x) -> np.ndarray:
        if self.theta <= 0.0:
            return super().fit_transform(x)
        from deeplearning4j_tpu_torch.clustering.sptree import SPTree

        x = np.asarray(x, np.float64)
        n = x.shape[0]
        perp = min(self.perplexity, max((n - 1) / 3.0, 2.0))
        k = min(n - 1, max(int(3 * perp), 3))

        # sparse input similarities over the kNN graph (the reference
        # builds these with a VPTree). Distances are computed in ROW
        # BLOCKS so memory stays O(block * N), not O(N^2)
        nbr = np.empty((n, k), np.int64)
        d2 = np.empty((n, k), np.float64)
        sq = np.sum(x * x, axis=1)
        block = max(1, min(n, int(2 ** 22 // max(n, 1)) or 1))
        for s0 in range(0, n, block):
            s1 = min(s0 + block, n)
            db = (sq[s0:s1, None] - 2.0 * x[s0:s1] @ x.T + sq[None, :])
            db[np.arange(s1 - s0), np.arange(s0, s1)] = np.inf
            nb = np.argpartition(db, k, axis=1)[:, :k]
            nbr[s0:s1] = nb
            d2[s0:s1] = np.take_along_axis(db, nb, axis=1)
        p_cond = self._knn_cond_probs(d2, perp)                  # [n, k]

        # symmetrize the sparse matrix: P = (P + P^T) / (2n)
        rows = np.repeat(np.arange(n), k)
        cols = nbr.reshape(-1)
        vals = p_cond.reshape(-1)
        sym = {}
        for r, c, v in zip(rows, cols, vals):
            sym[(r, c)] = sym.get((r, c), 0.0) + v
            sym[(c, r)] = sym.get((c, r), 0.0) + v
        keys = np.asarray(list(sym.keys()), np.int64)
        pv = np.asarray(list(sym.values()), np.float64) / (2.0 * n)
        ri, ci = keys[:, 0], keys[:, 1]

        rng = np.random.default_rng(self.seed)
        y = rng.standard_normal((n, self.n_components)) * 1e-2
        v = np.zeros_like(y)
        gains = np.ones_like(y)  # adaptive per-dim gains (the reference's
        # Tsne gradient machinery; stabilizes the sparse path without the
        # exact kernel's implicit damping)
        exag_until = min(250, self.max_iter // 2)
        for it in range(self.max_iter):
            exag = self.early_exaggeration if it < exag_until else 1.0
            # attractive: sum_j p_ij q_ij (y_i - y_j) over the sparse graph
            diff = y[ri] - y[ci]
            q_num = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
            w = (exag * pv * q_num)[:, None] * diff
            attr = np.zeros_like(y)
            np.add.at(attr, ri, w)
            # repulsive via the SPTree
            tree = SPTree(y)
            rep = np.zeros_like(y)
            z = 0.0
            for i in range(n):
                neg, zi = tree.non_edge_forces(y[i], i, self.theta)
                rep[i] = neg
                z += zi
            grad = 4.0 * (attr - rep / max(z, 1e-12))
            mom = 0.5 if it < exag_until else self.momentum
            gains = np.where(np.sign(grad) != np.sign(v),
                             gains + 0.2, gains * 0.8)
            gains = np.maximum(gains, 0.01)
            v = mom * v - self.learning_rate * (gains * grad)
            y = y + v
            y = y - y.mean(axis=0)
        # sparse KL over the kNN support (Q normalized by the tree's Z):
        # the base-class contract is a float kl after fit
        q = np.maximum(q_num / max(z, 1e-12), 1e-12)
        self.kl = float(np.sum(pv * np.log(np.maximum(pv, 1e-12) / q)))
        return np.asarray(y, np.float32)

    @staticmethod
    def _knn_cond_probs(d2, perplexity, iters=50):
        """Per-row beta binary search over the kNN distances only
        (BarnesHutTsne.java's sparse hBeta analogue)."""
        n, k = d2.shape
        log_u = np.log(perplexity)
        beta = np.ones(n)
        lo = np.full(n, -np.inf)
        hi = np.full(n, np.inf)
        for _ in range(iters):
            p = np.exp(-d2 * beta[:, None])
            s = np.maximum(p.sum(axis=1), 1e-12)
            h = np.log(s) + beta * (d2 * p).sum(axis=1) / s
            too_high = h > log_u
            lo = np.where(too_high, beta, lo)
            hi = np.where(too_high, hi, beta)
            beta = np.where(np.isinf(hi), beta * 2,
                            np.where(np.isinf(lo), beta / 2, (lo + hi) / 2))
        p = np.exp(-d2 * beta[:, None])
        return p / np.maximum(p.sum(axis=1, keepdims=True), 1e-12)
