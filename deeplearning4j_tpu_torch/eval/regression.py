"""Regression evaluation (counterpart of
deeplearning4j_tpu/eval/regression.py): per-column MSE, MAE, RMSE,
relative squared error and correlation, from running sums in f64 on the
host."""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import to_host


class RegressionEvaluation:
    def __init__(self, column_names: list | None = None):
        self.column_names = column_names
        self._n = 0
        self._sum_err2 = None
        self._sum_abs = None
        self._sum_label = None
        self._sum_label2 = None
        self._sum_pred = None
        self._sum_pred2 = None
        self._sum_lp = None

    def eval(self, labels, predictions, mask=None):
        labels = to_host(labels).astype(np.float64)
        predictions = to_host(predictions).astype(np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
        if mask is not None:
            m = to_host(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
        if self._sum_err2 is None:
            c = labels.shape[-1]
            for name in ("_sum_err2", "_sum_abs", "_sum_label", "_sum_label2",
                         "_sum_pred", "_sum_pred2", "_sum_lp"):
                setattr(self, name, np.zeros(c))
        err = predictions - labels
        self._n += labels.shape[0]
        self._sum_err2 += (err ** 2).sum(axis=0)
        self._sum_abs += np.abs(err).sum(axis=0)
        self._sum_label += labels.sum(axis=0)
        self._sum_label2 += (labels ** 2).sum(axis=0)
        self._sum_pred += predictions.sum(axis=0)
        self._sum_pred2 += (predictions ** 2).sum(axis=0)
        self._sum_lp += (labels * predictions).sum(axis=0)

    def mean_squared_error(self, col: int) -> float:
        return float(self._sum_err2[col] / self._n)

    def mean_absolute_error(self, col: int) -> float:
        return float(self._sum_abs[col] / self._n)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col: int) -> float:
        mean_label = self._sum_label[col] / self._n
        ss_tot = self._sum_label2[col] - self._n * mean_label ** 2
        return float(self._sum_err2[col] / ss_tot) if ss_tot else 0.0

    def correlation_r2(self, col: int) -> float:
        n = self._n
        num = n * self._sum_lp[col] - self._sum_label[col] * self._sum_pred[col]
        den = np.sqrt(n * self._sum_label2[col] - self._sum_label[col] ** 2) * \
            np.sqrt(n * self._sum_pred2[col] - self._sum_pred[col] ** 2)
        return float(num / den) if den else 0.0

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self._sum_err2 / self._n))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean(self._sum_abs / self._n))

    def num_columns(self) -> int:
        return 0 if self._sum_err2 is None else len(self._sum_err2)

    def stats(self) -> str:
        lines = ["Column    MSE            MAE            RMSE           "
                 "RSE            R"]
        for c in range(self.num_columns()):
            name = (self.column_names[c] if self.column_names else f"col_{c}")
            lines.append(
                f"{name:<10}{self.mean_squared_error(c):<15.6g}"
                f"{self.mean_absolute_error(c):<15.6g}"
                f"{self.root_mean_squared_error(c):<15.6g}"
                f"{self.relative_squared_error(c):<15.6g}"
                f"{self.correlation_r2(c):.6g}")
        return "\n".join(lines)
