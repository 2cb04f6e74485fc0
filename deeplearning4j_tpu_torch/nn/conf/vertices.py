"""Graph vertex configs (counterpart of deeplearning4j_tpu/nn/conf/
vertices.py): the base ``GraphVertexConfig``, the vertex JSON registry
and every vertex type of the JAX package: merge, element-wise, scale,
L2-normalize, L2, stack, unstack, subset, last-time-step,
duplicate-to-time-series and preprocessor. Layouts: feed-forward [b, f],
recurrent [b, t, f], convolutional NHWC; merge and subset work on the
trailing axis in all three. A vertex type the registry does not know is
refused by name.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

VERTEX_REGISTRY: dict[str, type] = {}


def register_vertex(cls):
    VERTEX_REGISTRY[cls.vertex_type] = cls
    return cls


def vertex_to_dict(v) -> dict:
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
        preprocessor_to_dict)
    d = {}
    for f in dataclasses.fields(v):
        val = getattr(v, f.name)
        if val is None:
            continue
        if f.name == "preprocessor":
            val = preprocessor_to_dict(val)
        elif isinstance(val, tuple):
            val = list(val)
        d[f.name] = val
    d["vertex_type"] = v.vertex_type
    return d


def vertex_from_dict(d: dict):
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
        preprocessor_from_dict)
    d = dict(d)
    vtype = d.pop("vertex_type")
    cls = VERTEX_REGISTRY.get(vtype)
    if cls is None:
        raise ValueError(f"unknown vertex type {vtype!r} (known: "
                         f"{sorted(VERTEX_REGISTRY)})")
    fields = {f.name for f in dataclasses.fields(cls)}
    if isinstance(d.get("preprocessor"), dict):
        d["preprocessor"] = preprocessor_from_dict(d["preprocessor"])
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
class MergeVertex(GraphVertexConfig):
    """Concatenate along the feature/channel (trailing) axis."""

    vertex_type = "merge"

    def output_type(self, *its: InputType) -> InputType:
        first = its[0]
        if first.kind == "convolutional":
            return InputType.convolutional(
                first.height, first.width, sum(it.channels for it in its))
        if first.kind == "recurrent":
            return InputType.recurrent(sum(it.size for it in its),
                                       first.timesteps)
        return InputType.feed_forward(sum(it.flat_size() for it in its))

    def forward(self, *inputs, masks=None):
        return torch.cat(inputs, dim=-1)


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


@register_vertex
@dataclass(frozen=True)
class ScaleVertex(GraphVertexConfig):
    """Multiply by a fixed scalar."""

    vertex_type = "scale"
    factor: float = 1.0

    def forward(self, *inputs, masks=None):
        return inputs[0] * self.factor


@register_vertex
@dataclass(frozen=True)
class L2NormalizeVertex(GraphVertexConfig):
    """x / (||x||_2 + eps) per example over the trailing axes."""

    vertex_type = "l2_normalize"
    eps: float = 1e-8

    def forward(self, *inputs, masks=None):
        x = inputs[0]
        axes = tuple(range(1, x.dim()))
        norm = torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True))
        return x / (norm + self.eps)


@register_vertex
@dataclass(frozen=True)
class L2Vertex(GraphVertexConfig):
    """Pairwise L2 distance between two inputs, sqrt(sum (a-b)^2 + eps)
    -> [b, 1]."""

    vertex_type = "l2"
    eps: float = 1e-8

    def output_type(self, *its: InputType) -> InputType:
        return InputType.feed_forward(1)

    def forward(self, *inputs, masks=None):
        a, b = inputs
        axes = tuple(range(1, a.dim()))
        d = torch.sqrt(torch.sum((a - b) ** 2, dim=axes) + self.eps)
        return d[:, None]


@register_vertex
@dataclass(frozen=True)
class StackVertex(GraphVertexConfig):
    """Concatenate along the batch (leading) axis; the masks too, where
    every input has one."""

    vertex_type = "stack"

    def forward(self, *inputs, masks=None):
        return torch.cat(inputs, dim=0)

    def feed_forward_mask(self, *masks):
        if all(m is None for m in masks):
            return None
        if any(m is None for m in masks):
            raise ValueError(
                "StackVertex: either all or none of the stacked inputs must "
                "carry a mask (cannot synthesize a mask for an unmasked "
                "input without its time length)")
        return torch.cat(masks, dim=0)


@register_vertex
@dataclass(frozen=True)
class UnstackVertex(GraphVertexConfig):
    """Part ``index`` of ``stack_size`` equal batch parts (and of the
    mask)."""

    vertex_type = "unstack"
    index: int = 0
    stack_size: int = 1

    def _part(self, x):
        step = x.shape[0] // self.stack_size
        return x[self.index * step:(self.index + 1) * step]

    def forward(self, *inputs, masks=None):
        return self._part(inputs[0])

    def feed_forward_mask(self, *masks):
        return None if masks[0] is None else self._part(masks[0])


@register_vertex
@dataclass(frozen=True)
class SubsetVertex(GraphVertexConfig):
    """Features [from_index, to_index] (inclusive) on the trailing axis."""

    vertex_type = "subset"
    from_index: int = 0
    to_index: int = 0

    def output_type(self, *its: InputType) -> InputType:
        n = self.to_index - self.from_index + 1
        it = its[0]
        if it.kind == "recurrent":
            return InputType.recurrent(n, it.timesteps)
        if it.kind == "convolutional":
            return InputType.convolutional(it.height, it.width, n)
        return InputType.feed_forward(n)

    def forward(self, *inputs, masks=None):
        return inputs[0][..., self.from_index:self.to_index + 1]


@register_vertex
@dataclass(frozen=True)
class LastTimeStepVertex(GraphVertexConfig):
    """[b, t, f] -> [b, f]: the last step, or the last unmasked step under
    the mask of the vertex ``mask_input`` names (the graph wires it)."""

    vertex_type = "last_time_step"
    mask_input: Optional[str] = None

    def output_type(self, *its: InputType) -> InputType:
        return InputType.feed_forward(its[0].size)

    def forward(self, *inputs, masks=None):
        from deeplearning4j_tpu_torch.ops.sequence import last_unmasked_step
        return last_unmasked_step(inputs[0], masks[0] if masks else None)

    def feed_forward_mask(self, *masks):
        return None


@register_vertex
@dataclass(frozen=True)
class DuplicateToTimeSeriesVertex(GraphVertexConfig):
    """[b, f] -> [b, t, f], repeated over the time length of the vertex
    ``seq_input`` names (the graph passes it as the second input, with its
    mask)."""

    vertex_type = "duplicate_to_time_series"
    seq_input: Optional[str] = None

    def output_type(self, *its: InputType) -> InputType:
        t = its[1].timesteps if len(its) > 1 else None
        return InputType.recurrent(its[0].flat_size(), t)

    def forward(self, *inputs, masks=None):
        x, seq = inputs[0], inputs[1]
        return x[:, None, :].expand(x.shape[0], seq.shape[1], x.shape[-1])

    def feed_forward_mask(self, *masks):
        return masks[1] if len(masks) > 1 else None


@register_vertex
@dataclass(frozen=True)
class PreprocessorVertex(GraphVertexConfig):
    """An input preprocessor (nn/conf/preprocessors.py) as a vertex."""

    vertex_type = "preprocessor"
    preprocessor: object = None

    def output_type(self, *its: InputType) -> InputType:
        return self.preprocessor.output_type(its[0])

    def forward(self, *inputs, masks=None):
        return self.preprocessor(inputs[0])
