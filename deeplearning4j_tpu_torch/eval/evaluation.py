"""Classification evaluation (counterpart of
deeplearning4j_tpu/eval/evaluation.py): a confusion matrix accumulated on
the host in numpy over the network's predictions; per-class precision,
recall and F1, their macro averages, micro accuracy.

Labels and predictions may be numpy arrays or tensors on any device;
``to_host`` brings a tensor over, bf16 and f16 as f32 (numpy has no
bf16).
"""

from __future__ import annotations

import numpy as np
import torch


def to_host(a):
    """A numpy array of ``a``: a tensor is detached and copied to the
    host (bf16/f16 widened to f32, other dtypes kept); anything else goes
    through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: np.ndarray, predicted: np.ndarray):
        np.add.at(self.matrix, (actual, predicted), 1)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def actual_total(self, cls: int) -> int:
        return int(self.matrix[cls].sum())

    def predicted_total(self, cls: int) -> int:
        return int(self.matrix[:, cls].sum())

    def __str__(self):
        return str(self.matrix)


class Evaluation:
    def __init__(self, num_classes: int | None = None,
                 labels: list | None = None):
        self.class_names = labels
        self.num_classes = num_classes if num_classes else (
            len(labels) if labels else None)
        self.confusion: ConfusionMatrix | None = None
        if self.num_classes:
            self.confusion = ConfusionMatrix(self.num_classes)
        self.predictions: list = []  # Prediction records (eval with meta)

    # ------------------------------------------------------------------ eval
    def eval(self, labels, predictions, mask=None, meta=None):
        """Accumulate a batch. ``labels`` one-hot (or class indices),
        ``predictions`` probabilities or scores [batch(, time), classes];
        ``mask`` [batch(, time)] drops the zero entries. ``meta``
        (optional) is one record per example; each example kept is
        recorded as a ``Prediction``."""
        labels = to_host(labels)
        predictions = to_host(predictions)
        if meta is not None:
            meta = list(meta)
            if len(meta) != predictions.shape[0]:
                raise ValueError(
                    f"meta has {len(meta)} records for a batch of "
                    f"{predictions.shape[0]} examples")
        if predictions.ndim == 3:  # time series -> flatten (mask-aware)
            b, t, c = predictions.shape
            predictions = predictions.reshape(b * t, c)
            labels = labels.reshape(b * t, -1)
            if meta is not None:
                meta = [m for m in meta for _ in range(t)]
            if mask is not None:
                m = to_host(mask).reshape(b * t).astype(bool)
                predictions, labels = predictions[m], labels[m]
                if meta is not None:
                    meta = [md for md, keep in zip(meta, m) if keep]
        elif mask is not None:
            m = to_host(mask).reshape(-1).astype(bool)
            predictions, labels = predictions[m], labels[m]
            if meta is not None:
                meta = [md for md, keep in zip(meta, m) if keep]
        if labels.ndim == 2 and labels.shape[1] > 1:
            actual = labels.argmax(axis=1)
            ncls = labels.shape[1]
        else:
            actual = labels.reshape(-1).astype(int)
            ncls = predictions.shape[1]
        if predictions.shape[1] == 1:
            # a single-output binary head: threshold at 0.5, two classes
            predicted = (predictions.reshape(-1) > 0.5).astype(int)
            ncls = 2
        else:
            predicted = predictions.argmax(axis=1)
        if self.confusion is None:
            self.num_classes = ncls
            self.confusion = ConfusionMatrix(ncls)
        self.confusion.add(actual, predicted)
        if meta is not None:
            from deeplearning4j_tpu_torch.eval.meta import Prediction
            self.predictions.extend(
                Prediction(int(a), int(p), md)
                for a, p, md in zip(actual, predicted, meta))

    # --------------------------------------------------------------- metrics
    def _tp(self, c):
        return self.confusion.get_count(c, c)

    def _fp(self, c):
        return self.confusion.predicted_total(c) - self._tp(c)

    def _fn(self, c):
        return self.confusion.actual_total(c) - self._tp(c)

    def accuracy(self) -> float:
        m = self.confusion.matrix
        total = m.sum()
        return float(np.trace(m) / total) if total else 0.0

    def precision(self, cls: int | None = None) -> float:
        if cls is not None:
            denom = self._tp(cls) + self._fp(cls)
            return self._tp(cls) / denom if denom else 0.0
        vals = [self.precision(c) for c in range(self.num_classes)
                if self.confusion.actual_total(c) > 0 or
                self.confusion.predicted_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: int | None = None) -> float:
        if cls is not None:
            denom = self._tp(cls) + self._fn(cls)
            return self._tp(cls) / denom if denom else 0.0
        vals = [self.recall(c) for c in range(self.num_classes)
                if self.confusion.actual_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: int | None = None) -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / (p + r) if (p + r) else 0.0
        p, r = self.precision(), self.recall()
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls: int) -> float:
        fp = self._fp(cls)
        tn = self.confusion.matrix.sum() - self.confusion.actual_total(cls) - fp
        return fp / (fp + tn) if (fp + tn) else 0.0

    def matthews_correlation(self, cls: int) -> float:
        tp, fp, fn = self._tp(cls), self._fp(cls), self._fn(cls)
        tn = self.confusion.matrix.sum() - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float((tp * tn - fp * fn) / denom) if denom else 0.0

    def stats(self) -> str:
        lines = ["", "========================Evaluation Metrics"
                 "========================"]
        lines.append(f" # of classes: {self.num_classes}")
        lines.append(f" Accuracy:  {self.accuracy():.4f}")
        lines.append(f" Precision: {self.precision():.4f}")
        lines.append(f" Recall:    {self.recall():.4f}")
        lines.append(f" F1 Score:  {self.f1():.4f}")
        lines.append("")
        lines.append("=========================Confusion Matrix"
                     "=========================")
        lines.append(str(self.confusion))
        lines.append("=" * 66)
        return "\n".join(lines)

    def merge(self, other: "Evaluation"):
        """Add ``other``'s counts and prediction records to these."""
        if other.confusion is None:
            return self
        if self.confusion is None:
            self.num_classes = other.num_classes
            self.confusion = ConfusionMatrix(other.num_classes)
        self.confusion.matrix += other.confusion.matrix
        self.predictions.extend(other.predictions)
        return self

    # ----------------------------------------------- prediction metadata
    def get_prediction_errors(self):
        """The misclassified examples' records (needs eval(..., meta=))."""
        return [p for p in self.predictions
                if p.actual_class != p.predicted_class]

    def get_predictions_by_actual_class(self, cls: int):
        return [p for p in self.predictions if p.actual_class == cls]

    def get_predictions_by_predicted_class(self, cls: int):
        return [p for p in self.predictions if p.predicted_class == cls]
