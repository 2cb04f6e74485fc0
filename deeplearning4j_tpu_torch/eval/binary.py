"""Per-output binary evaluation (counterpart of
deeplearning4j_tpu/eval/binary.py): accuracy, precision, recall and F1 of
each output column on its own, at a threshold (0.5)."""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import to_host


class EvaluationBinary:
    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None):
        labels = to_host(labels)
        predictions = to_host(predictions)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
        if mask is not None:
            m = to_host(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
        y = labels >= 0.5
        p = predictions >= self.threshold
        if self.tp is None:
            c = labels.shape[-1]
            self.tp = np.zeros(c, np.int64)
            self.fp = np.zeros(c, np.int64)
            self.tn = np.zeros(c, np.int64)
            self.fn = np.zeros(c, np.int64)
        self.tp += (p & y).sum(axis=0)
        self.fp += (p & ~y).sum(axis=0)
        self.tn += (~p & ~y).sum(axis=0)
        self.fn += (~p & y).sum(axis=0)

    def num_outputs(self):
        return 0 if self.tp is None else len(self.tp)

    def accuracy(self, col: int) -> float:
        total = self.tp[col] + self.fp[col] + self.tn[col] + self.fn[col]
        return float((self.tp[col] + self.tn[col]) / total) if total else 0.0

    def precision(self, col: int) -> float:
        d = self.tp[col] + self.fp[col]
        return float(self.tp[col] / d) if d else 0.0

    def recall(self, col: int) -> float:
        d = self.tp[col] + self.fn[col]
        return float(self.tp[col] / d) if d else 0.0

    def f1(self, col: int) -> float:
        p, r = self.precision(col), self.recall(col)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def stats(self) -> str:
        lines = ["Output    Acc      Prec     Recall   F1"]
        for c in range(self.num_outputs()):
            lines.append(f"{c:<10}{self.accuracy(c):<9.4f}"
                         f"{self.precision(c):<9.4f}"
                         f"{self.recall(c):<9.4f}{self.f1(c):.4f}")
        return "\n".join(lines)
