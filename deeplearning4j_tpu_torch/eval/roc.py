"""ROC and AUC (counterpart of deeplearning4j_tpu/eval/roc.py): counts of
TP/FP/FN/TN at ``threshold_steps + 1`` fixed thresholds, accumulated
batch by batch in bounded memory, and the AUC by the trapezoid rule."""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import to_host

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class ROC:
    """Binary ROC: labels are one {0, 1} column or two one-hot columns
    (the positive class is column 1)."""

    def __init__(self, threshold_steps: int = 100):
        self.threshold_steps = threshold_steps
        self.thresholds = np.linspace(0.0, 1.0, threshold_steps + 1)
        self.tp = np.zeros(threshold_steps + 1, dtype=np.int64)
        self.fp = np.zeros(threshold_steps + 1, dtype=np.int64)
        self.fn = np.zeros(threshold_steps + 1, dtype=np.int64)
        self.tn = np.zeros(threshold_steps + 1, dtype=np.int64)

    def eval(self, labels, predictions, mask=None):
        labels = to_host(labels)
        predictions = to_host(predictions)
        if labels.ndim >= 2 and labels.shape[-1] == 2:
            y = labels[..., 1].reshape(-1)
            p = predictions[..., 1].reshape(-1)
        else:
            y = labels.reshape(-1)
            p = predictions.reshape(-1)
        if mask is not None:
            m = to_host(mask).reshape(-1).astype(bool)
            y, p = y[m], p[m]
        y = y.astype(bool)
        # over every threshold at once: predicted positive = p >= t
        pred_pos = p[None, :] >= self.thresholds[:, None]
        self.tp += (pred_pos & y[None, :]).sum(axis=1)
        self.fp += (pred_pos & ~y[None, :]).sum(axis=1)
        self.fn += (~pred_pos & y[None, :]).sum(axis=1)
        self.tn += (~pred_pos & ~y[None, :]).sum(axis=1)

    def get_roc_curve(self):
        pos = self.tp + self.fn
        neg = self.fp + self.tn
        tpr = np.where(pos > 0, self.tp / np.maximum(pos, 1), 0.0)
        fpr = np.where(neg > 0, self.fp / np.maximum(neg, 1), 0.0)
        return fpr, tpr

    def calculate_auc(self) -> float:
        fpr, tpr = self.get_roc_curve()
        order = np.argsort(fpr, kind="stable")
        fpr, tpr = fpr[order], tpr[order]
        fpr = np.concatenate([[0.0], fpr, [1.0]])
        tpr = np.concatenate([[0.0], tpr, [1.0]])
        return float(_trapezoid(tpr, fpr))

    def get_precision_recall_curve(self):
        prec = np.where(self.tp + self.fp > 0,
                        self.tp / np.maximum(self.tp + self.fp, 1), 1.0)
        rec = np.where(self.tp + self.fn > 0,
                       self.tp / np.maximum(self.tp + self.fn, 1), 0.0)
        return rec, prec


class _PerColumnROC:
    """One binary ROC per output column."""

    def __init__(self, threshold_steps: int = 100):
        self.threshold_steps = threshold_steps
        self.rocs: list[ROC] | None = None

    def eval(self, labels, predictions, mask=None):
        labels = to_host(labels)
        predictions = to_host(predictions)
        n = labels.shape[-1]
        if self.rocs is None:
            self.rocs = [ROC(self.threshold_steps) for _ in range(n)]
        for c in range(n):
            self.rocs[c].eval(labels[..., c], predictions[..., c], mask)

    def calculate_auc(self, col: int) -> float:
        return self.rocs[col].calculate_auc()

    def average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self.rocs]))


class ROCBinary(_PerColumnROC):
    """An independent binary ROC per output of a multi-label (sigmoid)
    head."""


class ROCMultiClass(_PerColumnROC):
    """One-vs-all ROC per class of a softmax head."""
