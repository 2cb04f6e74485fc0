"""The port's DataSet and in-memory iterators
(deeplearning4j_tpu_torch/datasets) against the JAX package's: the same
splits, shuffles, merges and batch orders on the same arrays (exact)."""

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JArrayIt
from deeplearning4j_tpu.datasets import DataSet as JDS
from deeplearning4j_tpu.datasets import ListDataSetIterator as JListIt
from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                               DataSet, ListDataSetIterator)

FIELDS = ("features", "labels", "features_mask", "labels_mask")


def _arrays(n=10, seed=0, masks=True):
    rng = np.random.default_rng(seed)
    a = [rng.normal(0, 1, (n, 4, 3)).astype(np.float32),
         rng.normal(0, 1, (n, 4, 2)).astype(np.float32)]
    if masks:
        a += [(rng.random((n, 4)) > 0.3).astype(np.float32),
              (rng.random((n, 4)) > 0.3).astype(np.float32)]
    return a


def _same(t, j):
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a, b), f


@pytest.mark.parametrize("masks", [False, True])
def test_dataset_operations_match_jax(masks):
    arrs = _arrays(masks=masks)
    t, j = DataSet(*arrs), JDS(*arrs)
    assert t.num_examples == j.num_examples == 10
    for a, b in zip(t.split_test_and_train(7), j.split_test_and_train(7)):
        _same(a, b)
    _same(t.shuffle(seed=5), j.shuffle(seed=5))
    other = _arrays(n=3, seed=1, masks=masks)
    _same(DataSet.merge([t, DataSet(*other)]),
          JDS.merge([j, JDS(*other)]))


def test_merge_drops_a_mask_that_one_part_lacks():
    a = DataSet(*_arrays())
    b = DataSet(*_arrays(n=2, seed=3, masks=False))
    merged = DataSet.merge([a, b])
    assert merged.num_examples == 12 and merged.features_mask is None


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_array_iterator_matches_jax(shuffle, drop_last):
    x, y = _arrays(n=11, masks=False)
    t = ArrayDataSetIterator(x, y, batch_size=4, shuffle=shuffle, seed=9,
                             drop_last=drop_last)
    j = JArrayIt(x, y, batch_size=4, shuffle=shuffle, seed=9,
                 drop_last=drop_last)
    assert len(t) == len(j) == (2 if drop_last else 3)
    assert t.batch_size == j.batch_size == 4
    for _ in range(2):  # two epochs: seed + epoch orders
        got, want = list(t), list(j)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    t.reset()
    j.reset()
    for a, b in zip(t, j):
        _same(a, b)


def test_list_iterator_matches_jax():
    parts = [DataSet(*_arrays(n=3, seed=s)) for s in range(3)]
    t = ListDataSetIterator(parts)
    j = JListIt([JDS(*_arrays(n=3, seed=s)) for s in range(3)])
    assert len(t) == len(j) == 3 and t.batch_size == j.batch_size == 3
    for a, b in zip(t, j):
        _same(a, b)
    assert ListDataSetIterator([]).batch_size is None
