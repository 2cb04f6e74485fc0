"""ComputationGraph configuration — a DAG of layer and op vertices
(counterpart of deeplearning4j_tpu/nn/conf/graph_conf.py). Pure data;
``to_json`` gives the JAX package's ``configuration.json`` key for key,
and the DAG is validated (cycles, unknown inputs) at construction.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from deeplearning4j_tpu_torch.nn.conf.core import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseLayerConfig,
    layer_from_dict,
    layer_to_dict,
)
from deeplearning4j_tpu_torch.nn.conf.vertices import (
    GraphVertexConfig,
    vertex_from_dict,
    vertex_to_dict,
)


@dataclass(frozen=True)
class ComputationGraphConfiguration:
    global_conf: NeuralNetConfiguration
    vertices: Dict[str, object]            # name -> layer conf | vertex conf
    vertex_inputs: Dict[str, Tuple[str, ...]]
    network_inputs: Tuple[str, ...]
    network_outputs: Tuple[str, ...]
    input_types: Optional[Tuple[InputType, ...]] = None
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_bwd_length: int = 20

    def __post_init__(self):
        self.topological_order()  # validates the DAG (raises on a cycle)
        for name, inputs in self.vertex_inputs.items():
            for i in inputs:
                if i not in self.vertices and i not in self.network_inputs:
                    raise ValueError(
                        f"Vertex '{name}' references unknown input '{i}'")
        for o in self.network_outputs:
            if o not in self.vertices:
                raise ValueError(f"Unknown network output '{o}'")

    def topological_order(self) -> list:
        """Kahn's algorithm over vertex names, ties broken by name (the
        JAX package's order)."""
        indeg = {}
        dependents: Dict[str, list] = {}
        for name, inputs in self.vertex_inputs.items():
            real = [i for i in inputs if i in self.vertices]
            indeg[name] = len(real)
            for i in real:
                dependents.setdefault(i, []).append(name)
        queue = sorted([n for n, d in indeg.items() if d == 0])
        order = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for dep in dependents.get(n, []):
                indeg[dep] -= 1
                if indeg[dep] == 0:
                    queue.append(dep)
        if len(order) != len(self.vertices):
            cyclic = sorted(set(self.vertices) - set(order))
            raise ValueError(f"Graph has a cycle involving: {cyclic}")
        return order

    # ------------------------------------------------------------------ json
    def to_json(self) -> str:
        verts = {}
        for name, conf in self.vertices.items():
            if isinstance(conf, BaseLayerConfig):
                verts[name] = {"kind": "layer", "conf": layer_to_dict(conf)}
            else:
                verts[name] = {"kind": "vertex", "conf": vertex_to_dict(conf)}
        return json.dumps({
            "format_version": 1,
            "model_kind": "computation_graph",
            "global_conf": self.global_conf.to_dict(),
            "vertices": verts,
            "vertex_inputs": {k: list(v) for k, v in self.vertex_inputs.items()},
            "network_inputs": list(self.network_inputs),
            "network_outputs": list(self.network_outputs),
            "input_types": (None if self.input_types is None else
                            [it.to_dict() for it in self.input_types]),
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_bwd_length": self.tbptt_bwd_length,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)
        vertices = {}
        for name, spec in d["vertices"].items():
            if spec["kind"] == "layer":
                vertices[name] = layer_from_dict(spec["conf"])
            else:
                vertices[name] = vertex_from_dict(spec["conf"])
        return ComputationGraphConfiguration(
            global_conf=NeuralNetConfiguration.from_dict(d["global_conf"]),
            vertices=vertices,
            vertex_inputs={k: tuple(v) for k, v in d["vertex_inputs"].items()},
            network_inputs=tuple(d["network_inputs"]),
            network_outputs=tuple(d["network_outputs"]),
            input_types=(None if d.get("input_types") is None else tuple(
                InputType.from_dict(it) for it in d["input_types"])),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_bwd_length=d.get("tbptt_bwd_length", 20),
        )


class GraphBuilder:
    """Fluent DAG builder: add_inputs -> add_layer/add_vertex ->
    set_outputs -> build."""

    def __init__(self, global_conf: NeuralNetConfiguration):
        self._conf = global_conf
        self._vertices: Dict[str, object] = {}
        self._inputs: Dict[str, Tuple[str, ...]] = {}
        self._network_inputs: Tuple[str, ...] = ()
        self._network_outputs: Tuple[str, ...] = ()
        self._input_types = None
        self._backprop_type = "standard"
        self._tbptt = (20, 20)

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._network_inputs = self._network_inputs + tuple(names)
        return self

    def _add(self, name, conf, inputs):
        if name in self._vertices or name in self._network_inputs:
            raise ValueError(f"Duplicate vertex name '{name}'")
        if not inputs:
            raise ValueError(f"Vertex '{name}' needs at least one input")
        self._vertices[name] = conf
        self._inputs[name] = tuple(inputs)
        return self

    def add_layer(self, name: str, layer_conf: BaseLayerConfig,
                  *inputs: str) -> "GraphBuilder":
        return self._add(name, layer_conf.replace(name=name), inputs)

    def add_vertex(self, name: str, vertex_conf: GraphVertexConfig,
                   *inputs: str) -> "GraphBuilder":
        return self._add(name, vertex_conf, inputs)

    def get_vertex(self, name: str):
        return self._vertices.get(name)

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._network_outputs = tuple(names)
        return self

    def set_input_types(self, *input_types: InputType) -> "GraphBuilder":
        self._input_types = tuple(input_types)
        return self

    def backprop_type(self, kind: str, tbptt_fwd: int = 20,
                      tbptt_bwd: int = 20) -> "GraphBuilder":
        self._backprop_type = kind
        self._tbptt = (tbptt_fwd, tbptt_bwd)
        return self

    def build(self) -> ComputationGraphConfiguration:
        return ComputationGraphConfiguration(
            global_conf=self._conf,
            vertices=dict(self._vertices),
            vertex_inputs=dict(self._inputs),
            network_inputs=self._network_inputs,
            network_outputs=self._network_outputs,
            input_types=self._input_types,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt[0],
            tbptt_bwd_length=self._tbptt[1],
        )
