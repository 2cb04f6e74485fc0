"""Pipeline sources: in-memory arrays, line/CSV files, record readers
(counterpart of deeplearning4j_tpu/datapipe/sources.py).

Every source keeps its read position in ``self._pos`` (an instance
attribute mutated between yields), so ``state_dict()`` at any point is a
single integer — O(1) in the dataset. File sources restore by reopening
the file and skipping ``pos`` records: O(pos) restore work, O(1) state.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from deeplearning4j_tpu_torch.datapipe.core import Stage

__all__ = ["ArraySource", "CSVSource", "LineSource", "RecordSource"]


class ArraySource(Stage):
    """Records from in-memory arrays: yields ``(features[i], labels[i])``
    (or ``(features[i],)`` when unlabeled)."""

    name = "array_source"

    def __init__(self, features, labels=None):
        super().__init__()
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        if self.labels is not None and \
                self.labels.shape[0] != self.features.shape[0]:
            raise ValueError("features/labels row mismatch: "
                             f"{self.features.shape[0]} vs "
                             f"{self.labels.shape[0]}")
        self._pos = 0

    def __len__(self):
        return self.features.shape[0]

    def __iter__(self):
        while self._pos < self.features.shape[0]:
            i = self._pos
            rec = (self.features[i],) if self.labels is None \
                else (self.features[i], self.labels[i])
            self._pos = i + 1
            self.records_out += 1
            yield rec

    def on_epoch(self, epoch: int):
        super().on_epoch(epoch)
        self._pos = 0

    def _state(self):
        return {"pos": self._pos}

    def _load_state(self, state):
        self._pos = int(state["pos"])


class LineSource(Stage):
    """Records from a text file, one per line: yields ``(parse(line),)``
    (default parse: the stripped line as a numpy unicode scalar). The
    streaming-source archetype: only the line cursor is state."""

    name = "line_source"

    def __init__(self, path: str, parse: Optional[Callable] = None,
                 skip_lines: int = 0):
        super().__init__()
        self.path = path
        self.parse = parse
        self.skip_lines = skip_lines
        self._pos = 0            # records emitted this epoch

    def _lines(self):
        with open(self.path) as f:
            for i, line in enumerate(f):
                if i < self.skip_lines:
                    continue
                line = line.rstrip("\n")
                if line:
                    yield line

    def __iter__(self):
        for i, line in enumerate(self._lines()):
            if i < self._pos:    # skip already-emitted records on resume
                continue
            rec = (np.str_(line),) if self.parse is None \
                else (self.parse(line),)
            self._pos = i + 1
            self.records_out += 1
            yield rec

    def on_epoch(self, epoch: int):
        super().on_epoch(epoch)
        self._pos = 0

    def _state(self):
        return {"pos": self._pos}

    def _load_state(self, state):
        self._pos = int(state["pos"])


class CSVSource(Stage):
    """Streaming numeric-CSV records via the DataVec-parity reader
    conventions (``datasets/records.py``): ``label_index`` splits the
    label column out (one-hot when ``num_classes``), yielding
    ``(features, label)``; without it, ``(row,)``. Rows stream from disk
    — the file is never materialized, and resume state is one cursor."""

    name = "csv_source"

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ",",
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None):
        super().__init__()
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self.label_index = label_index
        self.num_classes = num_classes
        self._pos = 0

    def _rows(self):
        from deeplearning4j_tpu_torch.datasets.records import CSVRecordReader
        reader = CSVRecordReader(self.path, skip_lines=self.skip_lines,
                                 delimiter=self.delimiter)
        for row in reader.iter_records():
            yield np.asarray(row, np.float32)

    def _to_record(self, row: np.ndarray):
        li = self.label_index
        if li is None:
            return (row,)
        feat = np.delete(row, li)
        if self.num_classes is not None:
            y = np.zeros(self.num_classes, np.float32)
            y[int(row[li])] = 1.0
        else:
            y = row[li:li + 1]
        return (feat, y)

    def __iter__(self):
        for i, row in enumerate(self._rows()):
            if i < self._pos:
                continue
            rec = self._to_record(row)
            self._pos = i + 1
            self.records_out += 1
            yield rec

    def on_epoch(self, epoch: int):
        super().on_epoch(epoch)
        self._pos = 0

    def _state(self):
        return {"pos": self._pos}

    def _load_state(self, state):
        self._pos = int(state["pos"])


class RecordSource(Stage):
    """Records from any ``records.py``-style reader (an object with a
    ``.records()`` list method) or a plain sequence of records. Rows
    load once on first iteration; only the cursor is checkpoint state,
    so restores stay O(1) in payload."""

    name = "record_source"

    def __init__(self, record_reader):
        super().__init__()
        self._reader = record_reader
        self._rows = None
        self._pos = 0

    def _materialize(self):
        if self._rows is None:
            rows = self._reader.records() \
                if hasattr(self._reader, "records") else self._reader
            self._rows = [tuple(r) if isinstance(r, tuple)
                          else (np.asarray(r, np.float32),) for r in rows]
        return self._rows

    def __len__(self):
        return len(self._materialize())

    def __iter__(self):
        rows = self._materialize()
        while self._pos < len(rows):
            rec = rows[self._pos]
            self._pos += 1
            self.records_out += 1
            yield rec

    def on_epoch(self, epoch: int):
        super().on_epoch(epoch)
        self._pos = 0

    def _state(self):
        return {"pos": self._pos}

    def _load_state(self, state):
        self._pos = int(state["pos"])
