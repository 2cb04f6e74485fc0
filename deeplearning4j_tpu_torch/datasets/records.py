"""Record readers, the DataVec bridge (counterpart of
deeplearning4j_tpu/datasets/records.py): a CSV reader and an in-memory
one feed ``RecordReaderDataSetIterator`` (features and one-hot or
regression labels) and ``SequenceRecordReaderDataSetIterator`` (padded,
masked [b, t, f] batches). Host-side numpy, as in the JAX package: the
batches reach the card through the net's ``fit``.
"""

from __future__ import annotations

import csv
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator


class CSVRecordReader:
    """Reads numeric CSV rows (DataVec CSVRecordReader parity)."""

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ","):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def iter_records(self):
        """The rows one at a time, without reading the whole file."""
        with open(self.path, newline="") as f:
            reader = csv.reader(f, delimiter=self.delimiter)
            for i, row in enumerate(reader):
                if i < self.skip_lines or not row:
                    continue
                yield [float(v) for v in row]

    def records(self) -> List[List[float]]:
        return list(self.iter_records())


class CollectionRecordReader:
    """In-memory records (CollectionRecordReader parity)."""

    def __init__(self, records: Sequence[Sequence[float]]):
        self._records = [list(r) for r in records]

    def records(self):
        return self._records


class RecordReaderDataSetIterator(DataSetIterator):
    """records -> (features, one-hot labels) minibatches
    (RecordReaderDataSetIterator.java parity): ``label_index`` names the
    label column; ``num_classes`` one-hot encodes it; regression mode keeps
    the raw value(s)."""

    def __init__(self, record_reader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        rows = np.asarray(record_reader.records(), dtype=np.float32)
        if label_index is None:
            self.features, self.labels = rows, None
        elif regression:
            to = label_index_to if label_index_to is not None else label_index
            cols = list(range(label_index, to + 1))
            self.labels = rows[:, cols]
            keep = [i for i in range(rows.shape[1]) if i not in cols]
            self.features = rows[:, keep]
        else:
            labels_raw = rows[:, label_index].astype(np.int64)
            if num_classes is None:
                num_classes = int(labels_raw.max()) + 1
            self.labels = np.eye(num_classes, dtype=np.float32)[labels_raw]
            keep = [i for i in range(rows.shape[1]) if i != label_index]
            self.features = rows[:, keep]
        self._batch = batch_size

    def __iter__(self):
        n = self.features.shape[0]
        for s in range(0, n, self._batch):
            yield DataSet(
                self.features[s:s + self._batch],
                None if self.labels is None else self.labels[s:s + self._batch])

    def reset(self):
        pass


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Per-sequence records -> padded+masked [b, t, f] batches
    (SequenceRecordReaderDataSetIterator.java parity with ALIGN_END=False:
    sequences pad at the tail and carry masks)."""

    def __init__(self, sequences, labels, batch_size: int,
                 num_classes: Optional[int] = None):
        """sequences: list of [t_i, f] arrays; labels: list of int class ids
        (one per sequence) or [t_i, out] per-step arrays."""
        self.sequences = [np.asarray(s, np.float32) for s in sequences]
        self.labels = labels
        self.num_classes = num_classes
        self._batch = batch_size

    def __iter__(self):
        n = len(self.sequences)
        for s in range(0, n, self._batch):
            seqs = self.sequences[s:s + self._batch]
            labs = self.labels[s:s + self._batch]
            t_max = max(x.shape[0] for x in seqs)
            f = seqs[0].shape[1]
            b = len(seqs)
            x = np.zeros((b, t_max, f), np.float32)
            fmask = np.zeros((b, t_max), np.float32)
            for i, sq in enumerate(seqs):
                x[i, :sq.shape[0]] = sq
                fmask[i, :sq.shape[0]] = 1.0
            if np.isscalar(labs[0]) or np.ndim(labs[0]) == 0:
                nc = self.num_classes or int(max(labs)) + 1
                y = np.eye(nc, dtype=np.float32)[np.asarray(labs, np.int64)]
                lmask = None
            else:
                out = np.asarray(labs[0]).shape[-1]
                y = np.zeros((b, t_max, out), np.float32)
                lmask = np.zeros((b, t_max), np.float32)
                for i, l in enumerate(labs):
                    l = np.asarray(l, np.float32)
                    y[i, :l.shape[0]] = l
                    lmask[i, :l.shape[0]] = 1.0
            yield DataSet(x, y, fmask, lmask)

    def reset(self):
        pass
