"""Embedding (t-SNE) publishing for the dashboard (counterpart of
deeplearning4j_tpu/ui/embedding.py) — the reference UI's tsne module
(deeplearning4j-ui-parent/.../ui/module/tsne/): project vectors to 2-D
with plot/tsne.py (the exact t-SNE, on the card by default) and attach
the labeled scatter to a session; the dashboard's embedding tab renders
it.

Works locally (any attached StatsStorage) and remotely
(RemoteStatsStorageRouter.put_static_info posts through /api/post), so a
word2vec worker can ship its vocabulary map to the cluster dashboard:

    from deeplearning4j_tpu_torch.ui.embedding import publish_embedding
    publish_embedding(storage_or_router, "session_1",
                      w2v.lookup.syn0, vocab_labels)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

EMBEDDING_KEY = "__embedding__"


def publish_embedding(storage, session_id: str, vectors,
                      labels: Sequence[str],
                      *, perplexity: float = 15.0, iterations: int = 300,
                      max_points: int = 2000,
                      seed: int = 0, device=None) -> np.ndarray:
    """Project ``vectors`` [n, d] to 2-D with t-SNE (d<=2 inputs are
    zero-padded and passed through verbatim) and publish {labels, xy} as
    the session's embedding. Returns the coordinates. ``device``: where
    the t-SNE runs (None: the card, as for every entry point)."""
    x = np.asarray(vectors, np.float32)
    labels = [str(l) for l in labels]
    if len(labels) != len(x):
        raise ValueError(f"{len(labels)} labels for {len(x)} vectors")
    if len(x) > max_points:
        x, labels = x[:max_points], labels[:max_points]
    if x.shape[1] <= 2:
        xy = np.pad(x, [(0, 0), (0, 2 - x.shape[1])])
    else:
        from deeplearning4j_tpu_torch.plot.tsne import Tsne
        # Tsne clamps perplexity to the point count internally
        xy = np.asarray(Tsne(n_components=2, perplexity=perplexity,
                             max_iter=iterations, seed=seed,
                             device=device).fit_transform(x))
    import time
    storage.put_static_info(session_id, EMBEDDING_KEY, {
        "labels": labels,
        "xy": [[float(a), float(b)] for a, b in xy],
        # version stamp: the dashboard re-fetches/re-renders only when a
        # NEW publish lands (re-published embeddings must not be served
        # from the client cache forever)
        "version": time.time(),
    })
    return xy


def get_embedding(storages, session_id: str) -> Optional[dict]:
    """Find a published embedding for ``session_id`` across storages."""
    for s in storages:
        info = s.get_static_info(session_id, EMBEDDING_KEY)
        if info:
            return info
    return None
