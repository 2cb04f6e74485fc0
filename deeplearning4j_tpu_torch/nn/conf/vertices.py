"""Graph vertex configs (counterpart of deeplearning4j_tpu/nn/conf/
vertices.py): the base ``GraphVertexConfig``, the vertex JSON registry
and ``ElementWiseVertex``. Layouts: feed-forward [b, f], recurrent
[b, t, f], convolutional NHWC.

The other vertex types of the JAX package (merge, subset, stack, unstack,
scale, L2, L2-normalize, preprocessor, last-time-step, duplicate-to-time-
series) are not ported: a configuration that names one is refused by name.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

VERTEX_REGISTRY: dict[str, type] = {}


def register_vertex(cls):
    VERTEX_REGISTRY[cls.vertex_type] = cls
    return cls


def vertex_to_dict(v) -> dict:
    d = {}
    for f in dataclasses.fields(v):
        val = getattr(v, f.name)
        if val is None:
            continue
        if isinstance(val, tuple):
            val = list(val)
        d[f.name] = val
    d["vertex_type"] = v.vertex_type
    return d


def vertex_from_dict(d: dict):
    d = dict(d)
    vtype = d.pop("vertex_type")
    cls = VERTEX_REGISTRY.get(vtype)
    if cls is None:
        raise NotImplementedError(
            f"vertex type {vtype!r} is not ported to deeplearning4j_tpu_torch "
            f"yet (ported: {sorted(VERTEX_REGISTRY)})")
    fields = {f.name for f in dataclasses.fields(cls)}
    for k, v in list(d.items()):
        if isinstance(v, list) and k in fields:
            d[k] = tuple(v)
    return cls(**{k: v for k, v in d.items() if k in fields})


@dataclass(frozen=True)
class GraphVertexConfig:
    """Base for parameter-free combining vertices. ``forward(*inputs,
    masks=...)`` computes the op; ``output_type(*input_types)`` infers
    shapes."""

    vertex_type = "base"

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def forward(self, *inputs, masks=None):
        raise NotImplementedError

    def feed_forward_mask(self, *masks):
        """The first non-None input mask."""
        for m in masks:
            if m is not None:
                return m
        return None


@register_vertex
@dataclass(frozen=True)
class ElementWiseVertex(GraphVertexConfig):
    """Pointwise combine: add / subtract (2 inputs) / product / average /
    max."""

    vertex_type = "element_wise"
    op: str = "add"

    def forward(self, *inputs, masks=None):
        if self.op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if self.op == "subtract":
            if len(inputs) != 2:
                raise ValueError("ElementWiseVertex subtract needs exactly 2 "
                                 "inputs")
            return inputs[0] - inputs[1]
        if self.op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if self.op == "average":
            return sum(inputs) / len(inputs)
        if self.op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown ElementWise op {self.op}")
