"""Early stopping (counterpart of deeplearning4j_tpu/optimize/earlystopping.py):
the eight termination conditions, the score calculators, the model
savers, the configuration, the result and the trainer, for
``MultiLayerNetwork`` and ``ComputationGraph`` alike.

The trainer reads each step's score on the host (a wait for the card)
only when an iteration condition needs it.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import List


# ---------------------------------------------------------------------------
# Termination conditions
# ---------------------------------------------------------------------------

class EpochTerminationCondition:
    #: conditions on the (validation) score are checked only on scoring
    #: epochs when evaluate_every_n_epochs > 1; the epoch-count and sanity
    #: conditions run every epoch
    uses_validation_score = True

    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, iteration: int, score: float) -> bool:
        raise NotImplementedError


@dataclass
class MaxEpochsTermination(EpochTerminationCondition):
    max_epochs: int = 10
    uses_validation_score = False

    def terminate(self, epoch, score):
        return epoch >= self.max_epochs - 1


@dataclass
class BestScoreEpochTermination(EpochTerminationCondition):
    """Stop once the score reaches or beats a target value."""

    best_expected_score: float = 0.0

    def terminate(self, epoch, score):
        return score <= self.best_expected_score


@dataclass
class ScoreImprovementEpochTermination(EpochTerminationCondition):
    """Stop after ``max_epochs_without_improvement`` epochs that did not
    improve the best score by more than ``min_improvement``."""

    max_epochs_without_improvement: int = 5
    min_improvement: float = 0.0

    def initialize(self):
        self._best = math.inf
        self._since = 0

    def terminate(self, epoch, score):
        if score < self._best - self.min_improvement:
            self._best = score
            self._since = 0
            return False
        self._since += 1
        return self._since > self.max_epochs_without_improvement


@dataclass
class MaxScoreEpochTermination(EpochTerminationCondition):
    """Stop (diverged) when the score exceeds ``max_score``."""

    max_score: float = 1e9
    uses_validation_score = False  # divergence guard: every epoch

    def terminate(self, epoch, score):
        return score > self.max_score


@dataclass
class InvalidScoreEpochTermination(EpochTerminationCondition):
    uses_validation_score = False

    def terminate(self, epoch, score):
        return math.isnan(score) or math.isinf(score)


@dataclass
class MaxTimeIterationTermination(IterationTerminationCondition):
    max_seconds: float = 3600.0

    def initialize(self):
        self._start = time.time()

    def terminate(self, iteration, score):
        return (time.time() - self._start) > self.max_seconds


@dataclass
class MaxScoreIterationTermination(IterationTerminationCondition):
    max_score: float = 1e9

    def terminate(self, iteration, score):
        return score > self.max_score


@dataclass
class InvalidScoreIterationTermination(IterationTerminationCondition):
    def terminate(self, iteration, score):
        return math.isnan(score) or math.isinf(score)


# ---------------------------------------------------------------------------
# Score calculators
# ---------------------------------------------------------------------------

class DataSetLossCalculator:
    """The loss over a validation iterator, averaged over its examples
    (or summed)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total, count = 0.0, 0
        for ds in self.iterator:
            n = ds.num_examples
            total += net.score(ds) * n
            count += n
        self.iterator.reset()
        if count == 0:
            return float("nan")
        return total / count if self.average else total


class EvaluationScoreCalculator:
    """Score = 1 - accuracy on a validation iterator (lower is better)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, net) -> float:
        ev = net.evaluate(self.iterator)
        self.iterator.reset()
        return 1.0 - ev.accuracy()


# ---------------------------------------------------------------------------
# Model savers
# ---------------------------------------------------------------------------

class InMemoryModelSaver:
    """Keeps copies (``net.clone()``) of the best and the latest model."""

    def __init__(self):
        self.best = None
        self.latest = None

    def save_best(self, net):
        self.best = net.clone()

    def save_latest(self, net):
        self.latest = net.clone()

    def get_best(self):
        return self.best

    def get_latest(self):
        return self.latest


class LocalFileModelSaver:
    """Writes ``bestModel.zip`` / ``latestModel.zip`` in ``directory``
    (the model zip of utils/serialization.py) and restores them onto
    ``device`` (default: the device of the last model saved)."""

    def __init__(self, directory: str, device=None):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)

    def _write(self, net, fname):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.utils import serialization
        path = os.path.join(self.directory, fname)
        # write a temporary file, then rename it over the old one: a crash
        # mid-save leaves the previous complete zip in place
        tmp = path + ".tmp"
        try:
            if isinstance(net, MultiLayerNetwork):
                serialization.write_model(net, tmp)
            else:
                serialization.write_computation_graph(net, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        if self.device is None:
            self.device = net.device
        return path

    def save_best(self, net):
        self._write(net, "bestModel.zip")

    def save_latest(self, net):
        self._write(net, "latestModel.zip")

    def _restore(self, fname):
        from deeplearning4j_tpu_torch.utils.serialization import restore_model
        return restore_model(os.path.join(self.directory, fname),
                             device=self.device)

    def get_best(self):
        return self._restore("bestModel.zip")

    def get_latest(self):
        return self._restore("latestModel.zip")


# ---------------------------------------------------------------------------
# Configuration, result, trainer
# ---------------------------------------------------------------------------

@dataclass
class EarlyStoppingConfiguration:
    score_calculator: object = None
    epoch_terminations: List[EpochTerminationCondition] = field(
        default_factory=list)
    iteration_terminations: List[IterationTerminationCondition] = field(
        default_factory=list)
    model_saver: object = field(default_factory=InMemoryModelSaver)
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1


@dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: object = None
    score_vs_epoch: dict = field(default_factory=dict)


class EarlyStoppingTrainer:
    """The epoch loop: ``fit_batch`` over the training iterator, the
    iteration conditions after each step, then (on scoring epochs) the
    validation score, the best model saved, and the epoch conditions.
    Works for a MultiLayerNetwork and a ComputationGraph alike. A
    ``listener`` (optional) gets ``on_start``, ``on_epoch`` and
    ``on_completion``."""

    def __init__(self, config: EarlyStoppingConfiguration, net,
                 train_iterator, listener=None):
        self.config = config
        self.net = net
        self.iterator = train_iterator
        self.listener = listener

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.epoch_terminations:
            c.initialize()
        for c in cfg.iteration_terminations:
            c.initialize()
        best_score, best_epoch = math.inf, -1
        scores = {}
        epoch = 0
        reason, details = "max_epochs", "no epoch termination configured"
        if self.listener:
            self.listener.on_start(cfg, self.net)
        while True:
            stop_iter = None
            for ds in self.iterator:
                score = self.net.fit_batch(ds)
                if not cfg.iteration_terminations:
                    continue
                score = float(score)
                for c in cfg.iteration_terminations:
                    if c.terminate(self.net.iteration, score):
                        stop_iter = (type(c).__name__,
                                     f"iteration {self.net.iteration}, "
                                     f"score {score}")
                        break
                if stop_iter:
                    break
            self.iterator.reset()
            if stop_iter:
                reason, details = stop_iter
                break

            scoring_epoch = epoch % cfg.evaluate_every_n_epochs == 0
            if scoring_epoch:
                if cfg.score_calculator is not None:
                    score = cfg.score_calculator.calculate_score(self.net)
                else:
                    score = float(self.net.score_value)
                scores[epoch] = score
                if self.listener:
                    self.listener.on_epoch(epoch, score, cfg, self.net)
                if score < best_score:
                    best_score, best_epoch = score, epoch
                    cfg.model_saver.save_best(self.net)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest(self.net)
            else:
                # off-schedule epochs: only the epoch-count and sanity
                # conditions run, on the last batch's training score
                score = float(self.net.score_value)
            stop_epoch = None
            for c in cfg.epoch_terminations:
                if c.uses_validation_score and not scoring_epoch:
                    continue
                if c.terminate(epoch, score):
                    stop_epoch = (type(c).__name__,
                                  f"epoch {epoch}, score {score}")
                    break
            if stop_epoch:
                reason, details = stop_epoch
                break
            self.net.epoch += 1
            epoch += 1

        result = EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            best_model_epoch=best_epoch,
            best_model_score=best_score,
            total_epochs=epoch + 1,
            best_model=cfg.model_saver.get_best(),
            score_vs_epoch=scores,
        )
        if self.listener:
            self.listener.on_completion(result)
        return result


# the reference's name for the graph variant: the same trainer
EarlyStoppingGraphTrainer = EarlyStoppingTrainer
