"""Evaluation (counterpart of deeplearning4j_tpu/eval: Evaluation,
ConfusionMatrix, RegressionEvaluation, ROC, ROCBinary, ROCMultiClass,
EvaluationBinary, Prediction). Counts accumulate on the host in numpy;
tensors cross at the boundary (``to_host``)."""

from deeplearning4j_tpu_torch.eval.binary import EvaluationBinary
from deeplearning4j_tpu_torch.eval.evaluation import (ConfusionMatrix,
                                                      Evaluation, to_host)
from deeplearning4j_tpu_torch.eval.meta import Prediction
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass

__all__ = ["ConfusionMatrix", "Evaluation", "EvaluationBinary",
           "Prediction", "ROC", "ROCBinary", "ROCMultiClass",
           "RegressionEvaluation", "to_host"]
