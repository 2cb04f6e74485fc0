"""Updater and learning-rate schedule configurations, as data only
(counterpart of deeplearning4j_tpu/nn/updater.py).

Layer and network configurations name an updater and a schedule, so
``configuration.json`` cannot be parsed without them. Their fields, kinds
and ``to_dict``/``from_dict`` forms match the JAX package's exactly. The
update rules themselves arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

_UPDATERS: dict[str, type] = {}
_SCHEDULES: dict[str, type] = {}


def register_updater(cls):
    _UPDATERS[cls.kind] = cls
    return cls


def updater_from_dict(d: dict) -> "Updater":
    d = dict(d)
    kind = d.pop("kind")
    return _UPDATERS[kind](**d)


@dataclass(frozen=True)
class Updater:
    kind = "base"
    learning_rate: float = 0.1

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["kind"] = self.kind
        return d


@register_updater
@dataclass(frozen=True)
class Sgd(Updater):
    kind = "sgd"


@register_updater
@dataclass(frozen=True)
class Nesterovs(Updater):
    kind = "nesterovs"
    learning_rate: float = 0.1
    momentum: float = 0.9


@register_updater
@dataclass(frozen=True)
class Adam(Updater):
    kind = "adam"
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@register_updater
@dataclass(frozen=True)
class AdaMax(Updater):
    kind = "adamax"
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@register_updater
@dataclass(frozen=True)
class AdaGrad(Updater):
    kind = "adagrad"
    learning_rate: float = 1e-1
    epsilon: float = 1e-6


@register_updater
@dataclass(frozen=True)
class AdaDelta(Updater):
    kind = "adadelta"
    rho: float = 0.95
    epsilon: float = 1e-6
    learning_rate: float = 1.0


@register_updater
@dataclass(frozen=True)
class RmsProp(Updater):
    kind = "rmsprop"
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8


@register_updater
@dataclass(frozen=True)
class NoOp(Updater):
    kind = "noop"
    learning_rate: float = 0.0


# ------------------------------------------------------------- schedules
def register_schedule(cls):
    _SCHEDULES[cls.kind] = cls
    return cls


def schedule_from_dict(d):
    if d is None:
        return NoneSchedule()
    d = dict(d)
    kind = d.pop("kind")
    # JSON turns int dict keys into strings; restore for map schedules
    if "schedule" in d and isinstance(d["schedule"], dict):
        d["schedule"] = {int(k): float(v) for k, v in d["schedule"].items()}
    return _SCHEDULES[kind](**d)


@dataclass(frozen=True)
class Schedule:
    kind = "base"

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["kind"] = self.kind
        return d


@register_schedule
@dataclass(frozen=True)
class NoneSchedule(Schedule):
    kind = "none"


@register_schedule
@dataclass(frozen=True)
class Exponential(Schedule):
    kind = "exponential"
    decay_rate: float = 0.99


@register_schedule
@dataclass(frozen=True)
class Inverse(Schedule):
    kind = "inverse"
    gamma: float = 1e-3
    power: float = 1.0


@register_schedule
@dataclass(frozen=True)
class Poly(Schedule):
    kind = "poly"
    power: float = 1.0
    max_iter: int = 10000


@register_schedule
@dataclass(frozen=True)
class Sigmoid(Schedule):
    kind = "sigmoid"
    gamma: float = 1e-2
    steps: int = 1000


@register_schedule
@dataclass(frozen=True)
class Step(Schedule):
    kind = "step"
    decay_rate: float = 0.1
    steps: int = 1000


@register_schedule
@dataclass(frozen=True)
class MapSchedule(Schedule):
    """{iteration: lr}; the lr at step t is the value of the largest key
    <= t."""
    kind = "map"
    schedule: dict = field(default_factory=dict)
