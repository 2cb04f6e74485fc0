"""The ported iterators and record readers
(deeplearning4j_tpu_torch/datasets/{iterator,records}.py) against the JAX
package's on the same seeds and files: every batch equal, exactly (the
same numpy draws and slices)."""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets import iterator as jit
from deeplearning4j_tpu.datasets import records as jrec
from deeplearning4j_tpu_torch.datasets import dataset as tds
from deeplearning4j_tpu_torch.datasets import iterator as tit
from deeplearning4j_tpu_torch.datasets import records as trec


def _arrays(n=20, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)])


def _np(a):
    return None if a is None else (a.numpy() if isinstance(a, torch.Tensor)
                                   else np.asarray(a))


def _same(tbatches, jbatches, nonempty=True):
    tbatches, jbatches = list(tbatches), list(jbatches)
    assert len(tbatches) == len(jbatches)
    assert tbatches or not nonempty
    for t, j in zip(tbatches, jbatches):
        for name in ("features", "labels", "features_mask", "labels_mask"):
            a, b = _np(getattr(t, name)), _np(getattr(j, name))
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), name


def _pair(kind):
    """(port iterator, JAX iterator) of one kind on the same data."""
    x, y = _arrays()
    if kind == "async":
        return (tit.AsyncDataSetIterator(tit.ArrayDataSetIterator(
                    x, y, 3, shuffle=True, seed=4)),
                jit.AsyncDataSetIterator(jit.ArrayDataSetIterator(
                    x, y, 3, shuffle=True, seed=4)))
    if kind == "multiple_epochs":
        return (tit.MultipleEpochsIterator(3, tit.ArrayDataSetIterator(
                    x, y, 6, shuffle=True, seed=1)),
                jit.MultipleEpochsIterator(3, jit.ArrayDataSetIterator(
                    x, y, 6, shuffle=True, seed=1)))
    if kind == "iterator":
        return (tit.IteratorDataSetIterator(
                    lambda: [tds.DataSet(x[i:i + 5], y[i:i + 5])
                             for i in range(0, 20, 5)]),
                jit.IteratorDataSetIterator(
                    lambda: [jds.DataSet(x[i:i + 5], y[i:i + 5])
                             for i in range(0, 20, 5)]))
    if kind == "sampling":
        return (tit.SamplingDataSetIterator(tds.DataSet(x, y), 7, 5, seed=3),
                jit.SamplingDataSetIterator(jds.DataSet(x, y), 7, 5, seed=3))
    if kind == "device_prefetch":
        return (tit.DevicePrefetchIterator(tit.ArrayDataSetIterator(
                    x, y, 4), device="cpu"),
                jit.ArrayDataSetIterator(x, y, 4))
    raise KeyError(kind)


KINDS = ["async", "device_prefetch", "iterator", "multiple_epochs",
         "sampling"]


@pytest.mark.parametrize("kind", KINDS)
def test_iterator_yields_the_jax_iterators_batches(kind):
    """Two passes with a reset between, then a pass without one (a new
    epoch's draws where the iterator has them; none left for
    MultipleEpochsIterator, in both packages)."""
    t, j = _pair(kind)
    _same(t, j)
    t.reset()
    j.reset()
    _same(t, j)
    _same(t, j, nonempty=kind != "multiple_epochs")


def test_async_iterator_raises_the_producers_error_and_joins():
    def bad():
        yield tds.DataSet(np.zeros((1, 1)), np.zeros((1, 1)))
        raise OSError("disk gone")

    it = tit.AsyncDataSetIterator(tit.IteratorDataSetIterator(bad))
    with pytest.raises(OSError, match="disk gone"):
        list(it)
    x, y = _arrays(200)
    stream = iter(tit.AsyncDataSetIterator(tit.ArrayDataSetIterator(x, y, 1),
                                           queue_size=1))
    next(stream)
    stream.close()   # left early: the producer must not outlive it
    assert not any(t.name == tit.AsyncDataSetIterator.THREAD_NAME
                   and t.is_alive() for t in threading.enumerate())


def test_device_prefetch_yields_tensors_and_multidatasets():
    x, y = _arrays(8)
    mds = tds.MultiDataSet([x, x[:, :2]], [y])
    (got,) = list(tit.DevicePrefetchIterator([mds], device="cpu"))
    assert isinstance(got.features[0], torch.Tensor)
    assert np.array_equal(got.features[1].numpy(), x[:, :2])
    assert got.labels_masks == [None]


def _csv(tmp_path, rows, name="data.csv", header=True):
    path = tmp_path / name
    lines = (["a,b,c,label"] if header else []) + [
        ",".join(repr(float(v)) for v in r) for r in rows]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


CSV_MODES = {
    "classification": dict(label_index=3, num_classes=5),
    "classes_inferred": dict(label_index=3),
    "regression": dict(label_index=1, regression=True, label_index_to=2),
    "no_labels": dict(),
}


@pytest.mark.parametrize("mode", sorted(CSV_MODES))
def test_csv_record_reader_iterator_reads_a_file_as_jax_does(tmp_path, mode):
    rng = np.random.default_rng(5)
    rows = np.concatenate([rng.normal(size=(11, 3)),
                           rng.integers(0, 4, (11, 1))], axis=1)
    path = _csv(tmp_path, rows)
    kw = CSV_MODES[mode]
    t = trec.RecordReaderDataSetIterator(
        trec.CSVRecordReader(path, skip_lines=1), 4, **kw)
    j = jrec.RecordReaderDataSetIterator(
        jrec.CSVRecordReader(path, skip_lines=1), 4, **kw)
    _same(t, j)
    assert (trec.CSVRecordReader(path, skip_lines=1).records()
            == jrec.CSVRecordReader(path, skip_lines=1).records())


def test_collection_and_sequence_readers_match_jax():
    recs = [[0.5, 1.0, 2.0], [1.5, -1.0, 0.0], [2.5, 3.0, 1.0]]
    _same(trec.RecordReaderDataSetIterator(
              trec.CollectionRecordReader(recs), 2, label_index=2),
          jrec.RecordReaderDataSetIterator(
              jrec.CollectionRecordReader(recs), 2, label_index=2))
    rng = np.random.default_rng(6)
    seqs = [rng.normal(size=(t, 2)) for t in (3, 5, 2, 4)]
    for labels in ([0, 2, 1, 2],
                   [rng.normal(size=(len(s), 3)) for s in seqs]):
        _same(trec.SequenceRecordReaderDataSetIterator(seqs, labels, 3),
              jrec.SequenceRecordReaderDataSetIterator(seqs, labels, 3))
