"""Per-example prediction metadata (counterpart of
deeplearning4j_tpu/eval/meta.py): the actual class, the predicted class
and the caller's record metadata (a file name, a row id), so that a
misclassified example can be traced to its record."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class Prediction:
    actual_class: int
    predicted_class: int
    record_meta_data: Any = None

    def __str__(self):
        return (f"Prediction(actualClass={self.actual_class},"
                f"predictedClass={self.predicted_class},"
                f"RecordMetaData={self.record_meta_data})")
