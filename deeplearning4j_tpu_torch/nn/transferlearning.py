"""Transfer learning: clone-and-edit a trained MultiLayerNetwork
(counterpart of deeplearning4j_tpu/nn/transferlearning.py).

``TransferLearning.Builder(net)`` overrides hyperparameters
(``FineTuneConfiguration``), freezes a prefix (each layer wrapped in
``Frozen``), drops or replaces the tail, changes a layer's ``n_out``, and
``build`` makes the new net on the old one's device with the retained
layers' weights and state copied in by name (edited and new layers
initialize afresh). ``TransferLearningHelper`` featurizes inputs through
the frozen prefix so the tail trains on cached features.

A frozen prefix costs a train step no weight gradient here: its
parameters reach autograd without ``requires_grad`` (nn/multistep.py's
``step_leaves``), so the backward stops at the first trained layer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf.core import (MultiLayerConfiguration,
                                                   NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers_pretrain import Frozen
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import _copy_tree


@dataclass(frozen=True)
class FineTuneConfiguration:
    """The NeuralNetConfiguration fields to override on the new net; None
    keeps the original value."""

    seed: Optional[int] = None
    activation: Optional[str] = None
    weight_init: Optional[Any] = None
    learning_rate: Optional[float] = None
    updater: Optional[Any] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    def apply_to(self, gc: NeuralNetConfiguration) -> NeuralNetConfiguration:
        overrides = {f.name: getattr(self, f.name)
                     for f in dataclasses.fields(self)
                     if getattr(self, f.name) is not None}
        return gc.replace(**overrides)


class TransferLearningBuilder:
    """Freeze a prefix, drop or replace the tail, change n_out, fine-tune
    hyperparameters: the kept layers' weights are copied, edited and new
    layers initialize afresh."""

    def __init__(self, net: MultiLayerNetwork):
        net._require_init()
        self._net = net
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[int] = None
        # (resolved conf, carry weights) per retained layer
        self._layers = [(layer.conf, True) for layer in net.layers]
        self._input_type = net.conf.input_type

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, layer: int | str):
        """Freeze layers [0..layer], inclusive."""
        self._freeze_until = self._index_of(layer)
        return self

    def _index_of(self, layer: int | str) -> int:
        if isinstance(layer, int):
            return layer
        for i, (c, _) in enumerate(self._layers):
            if c.name == layer:
                return i
        raise ValueError(f"No layer named '{layer}'")

    def remove_output_layer(self):
        self._layers = self._layers[:-1]
        return self

    def remove_layers_from(self, layer: int | str):
        self._layers = self._layers[:self._index_of(layer)]
        return self

    def add_layer(self, conf):
        self._layers.append((conf, False))
        return self

    def n_out_replace(self, layer: int | str, n_out: int,
                      weight_init: Any = None):
        """Change a layer's n_out; that layer and the next initialize
        afresh."""
        i = self._index_of(layer)
        conf, _ = self._layers[i]
        kw = {"n_out": n_out}
        if weight_init is not None:
            kw["weight_init"] = weight_init
        self._layers[i] = (conf.replace(**kw), False)
        if i + 1 < len(self._layers):
            nxt, _ = self._layers[i + 1]
            self._layers[i + 1] = (nxt.replace(n_in=None), False)
        return self

    def build(self) -> MultiLayerNetwork:
        old = self._net
        gc = old.conf.global_conf
        if self._fine_tune is not None:
            gc = self._fine_tune.apply_to(gc)
        confs = []
        for i, (conf, _) in enumerate(self._layers):
            if self._freeze_until is not None and i <= self._freeze_until:
                conf = Frozen(inner=conf, name=conf.name)
            confs.append(conf)
        new_conf = MultiLayerConfiguration(
            global_conf=gc,
            layers=tuple(confs),
            input_type=self._input_type,
            backprop_type=old.conf.backprop_type,
            tbptt_fwd_length=old.conf.tbptt_fwd_length,
            tbptt_bwd_length=old.conf.tbptt_bwd_length,
            preprocessors=dict(old.conf.preprocessors),
        )
        new_net = MultiLayerNetwork(new_conf, device=old.device).init()
        # the retained layers' weights and state, by name
        for conf, keep in self._layers:
            if not keep:
                continue
            name = conf.name
            if name in old.params and name in new_net.params:
                new_net.params[name] = _copy_tree(old.params[name])
            if name in (old.state or {}) and name in (new_net.state or {}):
                new_net.state[name] = _copy_tree(old.state[name])
        return new_net


class TransferLearning:
    Builder = TransferLearningBuilder


class TransferLearningHelper:
    """Featurize inputs through the frozen prefix, so the unfrozen tail
    can train on cached features."""

    def __init__(self, net: MultiLayerNetwork, frozen_until: int | str):
        self.net = net
        if isinstance(frozen_until, str):
            names = [l.name for l in net.layers]
            frozen_until = names.index(frozen_until)
        self.frozen_until = frozen_until

    def featurize(self, ds: DataSet) -> DataSet:
        """``ds`` with its features replaced by the frozen prefix's output
        (a tensor on the net's device)."""
        net = self.net
        with torch.no_grad():
            h, _ = net._forward(net.params, net.state,
                                net._as_tensor(ds.features), train=False,
                                gen=None,
                                fmask=net._as_tensor(ds.features_mask),
                                to_layer=self.frozen_until + 1)
        return DataSet(h, ds.labels, ds.features_mask, ds.labels_mask)

    def unfrozen_net(self) -> MultiLayerNetwork:
        """A net of the layers after the frozen boundary, sharing this
        net's configs, with their weights copied in. The boundary layer's
        preprocessor (explicit or inserted) moves into the tail, so
        featurized activations feed it as in the full net."""
        start = self.frozen_until + 1
        confs = [l.conf for l in self.net.layers[start:]]
        preprocessors = {
            i - start: p
            for i, p in enumerate(self.net.preprocessors)
            if i >= start and p is not None
        }
        tail_conf = MultiLayerConfiguration(
            global_conf=self.net.conf.global_conf,
            layers=tuple(confs),
            preprocessors=preprocessors,
        )
        tail = MultiLayerNetwork(tail_conf, device=self.net.device).init()
        for c in confs:
            if c.name in self.net.params:
                tail.params[c.name] = _copy_tree(self.net.params[c.name])
        return tail

    def copy_back(self, tail: MultiLayerNetwork):
        """Write a trained tail's weights back into the full net."""
        for name, p in tail.params.items():
            self.net.params[name] = _copy_tree(p)
        return self.net
