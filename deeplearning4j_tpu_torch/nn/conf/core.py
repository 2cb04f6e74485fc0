"""Global configuration, dtype policy and the multi-layer configuration
(counterpart of deeplearning4j_tpu/nn/conf/core.py).

``MultiLayerConfiguration.to_json`` gives the same bytes as the JAX
package's for the same configuration, and ``from_json`` reads what the
JAX package writes: ``configuration.json`` is the bridge a model crosses
by (utils/serialization.py).
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseLayerConfig,
    layer_from_dict,
    layer_to_dict,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    preprocessor_from_dict,
    preprocessor_to_dict,
)
from deeplearning4j_tpu_torch.nn.updater import (
    NoneSchedule,
    Schedule,
    Sgd,
    Updater,
    schedule_from_dict,
    updater_from_dict,
)

#: dtype names a policy may use, and their torch dtypes
TORCH_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                "float32": torch.float32, "float64": torch.float64}
VALID_DTYPES = tuple(TORCH_DTYPES)


def _validate_dtype(value, role: str) -> str:
    if value not in VALID_DTYPES:
        raise ValueError(
            f"DtypePolicy: unknown {role} {value!r}; expected one of "
            f"{list(VALID_DTYPES)}")
    return value


@dataclass(frozen=True)
class DtypePolicy:
    """Parameter/compute dtype policy. Products run in ``compute_dtype``;
    params stay in ``param_dtype`` (the f32 master copy under BF16).
    ``overrides`` is a tuple of ``(regex, dtype)`` pairs matched against a
    layer's name with ``re.search``; the first match sets that layer's
    compute dtype. Loss scaling (nn/precision.py): ``loss_scale`` is
    "auto" (dynamic iff the compute dtype is float16), "dynamic", "none"
    or a number (a static scale)."""

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    overrides: Tuple[Tuple[str, str], ...] = ()
    loss_scale: Any = "auto"
    loss_scale_init: float = 2.0 ** 15
    loss_scale_factor: float = 2.0
    loss_scale_growth_interval: int = 200

    def __post_init__(self):
        _validate_dtype(self.param_dtype, "param_dtype")
        _validate_dtype(self.compute_dtype, "compute_dtype")
        norm = []
        for entry in self.overrides:
            if len(entry) != 2:
                raise ValueError(
                    "DtypePolicy.overrides entries must be (regex, dtype) "
                    f"pairs, got {entry!r}")
            pattern, dtype = entry
            try:
                re.compile(pattern)
            except re.error as e:
                raise ValueError(
                    f"DtypePolicy.overrides: bad regex {pattern!r}: {e}"
                ) from None
            _validate_dtype(dtype, f"override dtype for {pattern!r}")
            norm.append((str(pattern), str(dtype)))
        object.__setattr__(self, "overrides", tuple(norm))
        ls = self.loss_scale
        if isinstance(ls, str):
            if ls not in ("auto", "dynamic", "none"):
                raise ValueError(
                    f"DtypePolicy: unknown loss_scale {ls!r}; expected "
                    "'auto', 'dynamic', 'none', or a number")
        elif not isinstance(ls, (int, float)) or ls <= 0:
            raise ValueError(
                f"DtypePolicy: loss_scale must be > 0, got {ls!r}")
        if self.loss_scale_init <= 0:
            raise ValueError("DtypePolicy: loss_scale_init must be > 0, "
                             f"got {self.loss_scale_init!r}")
        if self.loss_scale_factor <= 1.0:
            raise ValueError("DtypePolicy: loss_scale_factor must be > 1, "
                             f"got {self.loss_scale_factor!r}")
        if self.loss_scale_growth_interval < 1:
            raise ValueError(
                "DtypePolicy: loss_scale_growth_interval must be >= 1, "
                f"got {self.loss_scale_growth_interval!r}")

    def compute_dtype_for(self, path: Optional[str]) -> str:
        if path is not None:
            for pattern, dtype in self.overrides:
                if re.search(pattern, path):
                    return dtype
        return self.compute_dtype

    def loss_scale_mode(self):
        """None (no scaling), "dynamic", or a static scale as a float."""
        ls = self.loss_scale
        if ls == "auto":
            return "dynamic" if self.compute_dtype == "float16" else None
        if ls == "none":
            return None
        if ls == "dynamic":
            return "dynamic"
        return float(ls)

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "DtypePolicy":
        d = dict(d)
        if d.get("overrides") is not None:
            d["overrides"] = tuple(tuple(e) for e in d["overrides"])
        names = {f.name for f in dataclasses.fields(DtypePolicy)}
        return DtypePolicy(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class NeuralNetConfiguration:
    """Network-wide hyperparameters; per-layer configs override them field
    by field."""

    seed: int = 123
    activation: str = "sigmoid"
    weight_init: Any = "xavier"
    bias_init: float = 0.0
    learning_rate: Optional[float] = None
    lr_schedule: Schedule = field(default_factory=NoneSchedule)
    updater: Updater = field(default_factory=lambda: Sgd(0.1))
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    dropout: float = 0.0
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    minibatch: bool = True
    dtype: DtypePolicy = field(default_factory=DtypePolicy)

    @staticmethod
    def builder() -> "NeuralNetConfBuilder":
        return NeuralNetConfBuilder()

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["updater"] = self.updater.to_dict()
        d["lr_schedule"] = self.lr_schedule.to_dict()
        d["dtype"] = self.dtype.to_dict()
        return d

    @staticmethod
    def from_dict(d: dict) -> "NeuralNetConfiguration":
        d = dict(d)
        if isinstance(d.get("updater"), dict):
            d["updater"] = updater_from_dict(d["updater"])
        if isinstance(d.get("lr_schedule"), dict):
            d["lr_schedule"] = schedule_from_dict(d["lr_schedule"])
        if isinstance(d.get("dtype"), dict):
            d["dtype"] = DtypePolicy.from_dict(d["dtype"])
        names = {f.name for f in dataclasses.fields(NeuralNetConfiguration)}
        return NeuralNetConfiguration(
            **{k: v for k, v in d.items() if k in names})

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class NeuralNetConfBuilder:
    """Fluent builder: ``NeuralNetConfiguration.builder().seed(1)...list()``."""

    def __init__(self):
        self._kw = {}

    def __getattr__(self, name):
        fields = {f.name for f in dataclasses.fields(NeuralNetConfiguration)}
        if name in fields:
            def setter(value):
                self._kw[name] = value
                return self
            return setter
        raise AttributeError(name)

    def build(self) -> NeuralNetConfiguration:
        return NeuralNetConfiguration(**self._kw)

    def list(self) -> "ListBuilder":
        return ListBuilder(self.build())

    def graph_builder(self):
        """DAG builder for a ComputationGraphConfiguration."""
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder
        return GraphBuilder(self.build())


class ListBuilder:
    """Builds a MultiLayerConfiguration."""

    def __init__(self, global_conf: NeuralNetConfiguration):
        self._conf = global_conf
        self._layers: List[BaseLayerConfig] = []
        self._input_type: Optional[InputType] = None
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_bwd = 20
        self._preprocessors = {}

    def layer(self, layer_conf: BaseLayerConfig, index: int | None = None):
        if index is not None and index != len(self._layers):
            raise ValueError(
                f"Layers must be added in order; got index {index} at "
                f"position {len(self._layers)}")
        self._layers.append(layer_conf)
        return self

    def set_input_type(self, input_type: InputType):
        self._input_type = input_type
        return self

    def input_preprocessor(self, layer_index: int, preprocessor):
        """Run ``preprocessor`` on the input of layer ``layer_index``; it
        takes the place of the one ``set_input_type`` would insert."""
        self._preprocessors[int(layer_index)] = preprocessor
        return self

    def backprop_type(self, kind: str, tbptt_fwd: int = 20,
                      tbptt_bwd: int = 20):
        """"standard", or "tbptt" with forward/backward chunk lengths
        (which must be equal)."""
        self._backprop_type = kind
        self._tbptt_fwd = tbptt_fwd
        self._tbptt_bwd = tbptt_bwd
        return self

    def build(self) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            global_conf=self._conf,
            layers=tuple(self._layers),
            input_type=self._input_type,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd,
            preprocessors=dict(self._preprocessors),
        )


@dataclass(frozen=True)
class MultiLayerConfiguration:
    """A sequential stack of layer configs with the JAX package's JSON
    round trip; ``preprocessors`` maps a layer index to the explicit input
    preprocessor of that layer (``{str(i): dict}`` in the JSON)."""

    global_conf: NeuralNetConfiguration
    layers: tuple
    input_type: Optional[InputType] = None
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_bwd_length: int = 20
    preprocessors: dict = field(default_factory=dict)

    def __post_init__(self):
        if (self.backprop_type == "tbptt"
                and self.tbptt_fwd_length != self.tbptt_bwd_length):
            raise ValueError(
                f"tbptt_bwd_length ({self.tbptt_bwd_length}) must equal "
                f"tbptt_fwd_length ({self.tbptt_fwd_length})")

    def to_json(self) -> str:
        return json.dumps(
            {
                "format_version": 1,
                "global_conf": self.global_conf.to_dict(),
                "layers": [layer_to_dict(l) for l in self.layers],
                "input_type": (self.input_type.to_dict()
                               if self.input_type else None),
                "backprop_type": self.backprop_type,
                "tbptt_fwd_length": self.tbptt_fwd_length,
                "tbptt_bwd_length": self.tbptt_bwd_length,
                "preprocessors": {
                    str(k): preprocessor_to_dict(v)
                    for k, v in self.preprocessors.items()
                },
            },
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        return MultiLayerConfiguration(
            global_conf=NeuralNetConfiguration.from_dict(d["global_conf"]),
            layers=tuple(layer_from_dict(l) for l in d["layers"]),
            input_type=(InputType.from_dict(d["input_type"])
                        if d.get("input_type") else None),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_bwd_length=d.get("tbptt_bwd_length", 20),
            preprocessors={
                int(k): preprocessor_from_dict(v)
                for k, v in d.get("preprocessors", {}).items()
            },
        )
