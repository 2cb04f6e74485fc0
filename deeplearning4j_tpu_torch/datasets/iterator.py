"""DataSetIterator and the in-memory iterators (counterpart of
deeplearning4j_tpu/datasets/iterator.py). The background-thread and
device-prefetch wrappers are not ported yet."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Iterate DataSets; ``reset()`` restarts the stream."""

    def __iter__(self):
        raise NotImplementedError

    def reset(self):
        pass

    @property
    def batch_size(self) -> Optional[int]:
        return None


class ListDataSetIterator(DataSetIterator):
    """Iterates a pre-built list of DataSet minibatches."""

    def __init__(self, datasets: List[DataSet]):
        self._datasets = list(datasets)

    def __iter__(self):
        return iter(self._datasets)

    def __len__(self):
        return len(self._datasets)

    @property
    def batch_size(self):
        return self._datasets[0].num_examples if self._datasets else None


class ArrayDataSetIterator(DataSetIterator):
    """Slices (features, labels) arrays into minibatches. With ``shuffle``
    each pass draws its order from ``seed + epoch`` (numpy's generator, the
    JAX package's scheme), and ``reset()`` rewinds to epoch 0, so a replay
    after a reset sees the same orders."""

    def __init__(self, features, labels, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels) if labels is not None else None
        self._batch = int(batch_size)
        self._shuffle = shuffle
        self._seed = int(seed)
        self._epoch = 0
        self._drop_last = drop_last

    def __iter__(self):
        n = self.features.shape[0]
        idx = np.arange(n)
        if self._shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(idx)
        self._epoch += 1
        stop = (n // self._batch) * self._batch if self._drop_last else n
        for start in range(0, stop, self._batch):
            sel = idx[start:start + self._batch]
            yield DataSet(self.features[sel],
                          None if self.labels is None else self.labels[sel])

    def __len__(self):
        n = self.features.shape[0]
        return n // self._batch if self._drop_last else -(-n // self._batch)

    def reset(self):
        self._epoch = 0

    @property
    def batch_size(self):
        return self._batch
