"""K-means clustering on the card (counterpart of
deeplearning4j_tpu/clustering/kmeans.py).

Parity: deeplearning4j-core clustering/kmeans/KMeansClustering.java (+ the
cluster/ClusterSet infrastructure). Each Lloyd iteration is one step of
tensor ops on ``device`` (default: the card): the [N, K] distance
product, the argmin, and the one-hot product for the centroid sums
(``torch.matmul``; the JAX package leaves these products to XLA, no
Pallas kernel stands behind them), an empty cluster keeping its
centroid.

The k-means++ seeding draws from numpy's ``default_rng(seed)`` as the
JAX package does. Where the JAX package recomputes, for the j-th pick,
the distances of every point to all j chosen centroids ([N, j, D] at
once), the port keeps each point's running minimum over the chosen
centroids and folds in only the newest one: the same per-pair values,
the same minimum, so the same draws, in O(N D) memory a pick.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device


def _lloyd_step(x, centroids, k):
    """One Lloyd iteration: (new centroids, assignments, cost)."""
    d2 = (torch.sum(x * x, dim=1, keepdim=True)
          - 2.0 * torch.matmul(x, centroids.T)
          + torch.sum(centroids * centroids, dim=1))
    assign = torch.argmin(d2, dim=1)
    one_hot = F.one_hot(assign, k).to(x.dtype)                  # [N, K]
    counts = one_hot.sum(dim=0)                                 # [K]
    sums = torch.matmul(one_hot.T, x)                           # [K, D]
    new_centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp(counts[:, None], min=1.0),
                                centroids)
    cost = torch.sum(torch.min(d2, dim=1).values)
    return new_centroids, assign, cost


class KMeansClustering:
    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-6,
                 seed: int = 0, device=None):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.centroids = None
        self.cost = None

    def _points(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _seed_indices(self, x: torch.Tensor) -> list:
        """k-means++ style seeding: the first pick uniform, each later one
        drawn with probability proportional to the squared distance to
        the nearest centroid chosen so far."""
        n = x.shape[0]
        rng = np.random.default_rng(self.seed)
        idx = [int(rng.integers(0, n))]
        nearest = None
        for _ in range(1, self.k):
            d_new = torch.sum((x - x[idx[-1]]) ** 2, dim=-1)
            nearest = (d_new if nearest is None
                       else torch.minimum(nearest, d_new))
            d2 = nearest.cpu().numpy()
            total = d2.sum()
            if total <= 0:
                # all remaining points coincide with chosen centroids
                # (duplicates / k > distinct points): fall back to uniform
                probs = np.full(n, 1.0 / n)
            else:
                probs = d2 / total
            idx.append(int(rng.choice(n, p=probs)))
        return idx

    def fit(self, x) -> "KMeansClustering":
        x = self._points(x)
        idx = self._seed_indices(x)
        centroids = x[torch.as_tensor(idx, device=x.device)]
        prev_cost = np.inf
        cost = None
        for _ in range(self.max_iterations):
            centroids, assign, cost = _lloyd_step(x, centroids, self.k)
            cost = float(cost)
            if abs(prev_cost - cost) < self.tol * max(abs(prev_cost), 1.0):
                break
            prev_cost = cost
        self.centroids = centroids
        self.cost = cost
        return self

    def predict(self, x) -> np.ndarray:
        _, assign, _ = _lloyd_step(self._points(x), self.centroids, self.k)
        return assign.cpu().numpy()
