"""DataSet: one (features, labels) minibatch with optional [batch, time]
0/1 masks, and MultiDataSet, its multi-input/multi-output form
(counterpart of deeplearning4j_tpu/datasets/dataset.py). The
arrays are numpy arrays (or anything indexable along the example axis);
the network moves them to its device when it trains on them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


def _take(x, sel):
    return None if x is None else x[sel]


@dataclass
class DataSet:
    features: Any
    labels: Optional[Any] = None
    features_mask: Optional[Any] = None
    labels_mask: Optional[Any] = None

    @property
    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def _select(self, sel) -> "DataSet":
        return DataSet(_take(self.features, sel), _take(self.labels, sel),
                       _take(self.features_mask, sel),
                       _take(self.labels_mask, sel))

    def split_test_and_train(self, num_train: int):
        return (self._select(slice(None, num_train)),
                self._select(slice(num_train, None)))

    def shuffle(self, seed: int = 0) -> "DataSet":
        """A copy with the examples in a permutation drawn from ``seed``
        (numpy's generator, so the order equals the JAX package's)."""
        return self._select(
            np.random.default_rng(seed).permutation(self.num_examples))

    @staticmethod
    def merge(datasets) -> "DataSet":
        def cat(xs):
            if any(x is None for x in xs):
                return None
            return np.concatenate(xs, axis=0)
        return DataSet(cat([d.features for d in datasets]),
                       cat([d.labels for d in datasets]),
                       cat([d.features_mask for d in datasets]),
                       cat([d.labels_mask for d in datasets]))


@dataclass
class MultiDataSet:
    """A multi-input/multi-output minibatch, as a ComputationGraph consumes
    it: lists of arrays, with per-input/per-output masks or None."""

    features: list
    labels: list
    features_masks: Optional[list] = None
    labels_masks: Optional[list] = None

    def __post_init__(self):
        self.features = list(self.features)
        self.labels = list(self.labels)
        if self.features_masks is None:
            self.features_masks = [None] * len(self.features)
        if self.labels_masks is None:
            self.labels_masks = [None] * len(self.labels)

    @property
    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    @staticmethod
    def from_dataset(ds: DataSet) -> "MultiDataSet":
        return MultiDataSet([ds.features], [ds.labels],
                            [ds.features_mask], [ds.labels_mask])
