"""Block-fusion pass: rewrite bottleneck-tail chains onto the fused op
(counterpart of deeplearning4j_tpu/nn/fusion.py, same pattern, same gate
and same switch, so the same tails fuse in both packages).

Pattern (all interior vertices single-consumer, none a network output):

    conv: Convolution2D, 1x1 kernel, stride 1, no bias, identity
          activation, no dropout, padding 0
    bn:   BatchNorm, identity activation
    add:  ElementWiseVertex(op="add") with exactly 2 inputs, the bn and
          a shortcut vertex
    act:  ActivationLayer("relu")

Gate: 2 * n_out > n_in and n_in % 128 == 0 (an expand conv; stage-1
bottlenecks of ResNet-50, n_in = 64, stay unfused), as in the JAX package.

Only the training walk fuses; the eval walk runs vertex by vertex. OFF by
default: ``DL4J_TPU_FUSE_BLOCKS=1``, read when the graph is initialised,
turns it on. A matched tail runs ops/fused_block.py's
``conv1x1_bn_add_relu``: the plain passes for CPU tensors, K4-K7 for CUDA
tensors, never a composed fallback.

On a mesh's model axis (parallel/tensor.py) a tail whose conv W is
sharded on its output channels runs K4-K7 on this rank's N/m columns:
x whole, gamma, beta, the shift and the shortcut cut to the same
columns. K4's and K6's column sums are then exact on the rank's own
channels; K5's output and the batch statistics are gathered on the
channel axis; K7's dx, a partial sum over the columns, is all-reduced
over the model group, and dW is the rank's own.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import ActivationLayer
from deeplearning4j_tpu_torch.nn.conf.layers_conv import (BatchNorm,
                                                          Convolution2D)
from deeplearning4j_tpu_torch.nn.conf.vertices import ElementWiseVertex


def enabled() -> bool:
    """The switch, default off: DL4J_TPU_FUSE_BLOCKS=1 turns it on."""
    return os.environ.get("DL4J_TPU_FUSE_BLOCKS", "0") == "1"


@dataclass(frozen=True)
class FusedBlockTail:
    conv: str           # conv vertex name
    bn: str             # batch-norm vertex name
    add: str            # element-wise add vertex name
    out: str            # relu activation vertex name (the chain's output)
    conv_input: str     # vertex feeding the conv
    shortcut: str       # the add's other input


def _pair_of(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_matches(conf, default_activation: str) -> bool:
    if not isinstance(conf, Convolution2D):
        return False
    if _pair_of(conf.kernel) != (1, 1) or _pair_of(conf.stride) != (1, 1):
        return False
    if _pair_of(conf.dilation or 1) != (1, 1):
        return False
    if _pair_of(conf.padding or 0) != (0, 0):
        return False
    if conf.has_bias:
        return False
    # a None activation inherits the global default (sigmoid): resolve it
    # before matching, never assume identity
    if (conf.activation or default_activation) != "identity":
        return False
    if getattr(conf, "dropout", None):
        return False
    n_in, n_out = conf.n_in, conf.n_out
    if not n_in or not n_out:
        return False
    return 2 * n_out > n_in and n_in % 128 == 0


def find_fusable_chains(vertices, vertex_inputs, network_outputs,
                        default_activation: str = "sigmoid"
                        ) -> Dict[str, FusedBlockTail]:
    """Scan a graph's RESOLVED vertex configs (n_in inferred) for fusable
    block tails. Returns {relu-vertex-name: FusedBlockTail}."""
    if not enabled():
        return {}
    consumers: Dict[str, list] = {}
    for name, ins in vertex_inputs.items():
        for i in ins:
            consumers.setdefault(i, []).append(name)
    outputs = set(network_outputs)

    def sole_consumer(name):
        c = consumers.get(name, [])
        return c[0] if len(c) == 1 and name not in outputs else None

    plans: Dict[str, FusedBlockTail] = {}
    for conv_name, conv_conf in vertices.items():
        if not _conv_matches(conv_conf, default_activation):
            continue
        bn_name = sole_consumer(conv_name)
        if bn_name is None:
            continue
        bn_conf = vertices[bn_name]
        if not isinstance(bn_conf, BatchNorm):
            continue
        if (bn_conf.activation or default_activation) != "identity":
            continue
        if getattr(bn_conf, "lock_gamma_beta", False):
            continue
        if getattr(bn_conf, "dropout", None):
            continue  # the fused tail has no dropout application point
        add_name = sole_consumer(bn_name)
        if add_name is None:
            continue
        add_conf = vertices[add_name]
        if not (isinstance(add_conf, ElementWiseVertex)
                and add_conf.op == "add"):
            continue
        add_inputs = vertex_inputs[add_name]
        if len(add_inputs) != 2 or bn_name not in add_inputs:
            continue
        shortcut = [i for i in add_inputs if i != bn_name]
        if len(shortcut) != 1:   # bn feeding both slots: not this pattern
            continue
        act_name = sole_consumer(add_name)
        if act_name is None:
            continue
        act_conf = vertices[act_name]
        if not (isinstance(act_conf, ActivationLayer)
                and (act_conf.activation
                     or default_activation) == "relu"):
            continue
        if getattr(act_conf, "dropout", None):
            continue
        plans[act_name] = FusedBlockTail(
            conv=conv_name, bn=bn_name, add=add_name, out=act_name,
            conv_input=vertex_inputs[conv_name][0],
            shortcut=shortcut[0])
    return plans


def interior_vertices(plans: Dict[str, FusedBlockTail]) -> set:
    """Vertices whose per-vertex execution a fused tail subsumes."""
    out = set()
    for fb in plans.values():
        out.update((fb.conv, fb.bn, fb.add))
    return out


def execute_fused_tail(fb: FusedBlockTail, graph, params, state, acts):
    """Run one fused tail (training mode): returns (y, bn_state_update),
    the running-statistics update done as BatchNormLayer.apply does it."""
    from deeplearning4j_tpu_torch.ops import fused_block  # noqa: F401  registers the op
    from deeplearning4j_tpu_torch.ops import registry

    conv_layer = graph._layer_by_name[fb.conv]
    bn_layer = graph._layer_by_name[fb.bn]
    bn_conf = graph._resolved_confs[fb.bn]
    cd = conv_layer.compute_dtype

    x = acts[fb.conv_input]
    sc = acts[fb.shortcut]
    W = params[fb.conv]["W"].to(cd)              # [1, 1, K, N]
    gamma, beta = bn_layer.gamma_beta(params.get(fb.bn, {}), W.shape[-1],
                                      x.device)
    bn_state = state[fb.bn]
    shift = bn_state["mean"]
    tp = conv_layer.tp if (conv_layer.tp is not None
                           and conv_layer.tp.rendered) else None
    if tp is not None:
        # K4-K7 on this rank's N/m columns of W: the whole x (its partial
        # dx all-reduced), the columns of gamma, beta, the shift and the
        # shortcut (their gradients gathered whole)
        bn_tp = bn_layer.tp
        x = tp.copy(x)
        gamma = bn_tp.columns(gamma, "gamma", 0)
        beta = bn_tp.columns(beta, "beta", 0)
        shift = tp.mg.slice(shift, 0)
        sc = tp.columns(sc.expand(tuple(x.shape[:-1]) + (sc.shape[-1],)))

    y, mean, var = registry.get("conv1x1_bn_add_relu", x.device)(
        x.to(cd), W, gamma, beta, sc, shift=shift, eps=bn_conf.eps)
    if tp is not None:
        # K5's channels gathered; the batch statistics too, so every
        # rank's running statistics stay whole and equal
        y = tp.gather(y)
        mean, var = tp.mg.all_gather(torch.stack([mean, var]), 1).unbind(0)

    d = bn_conf.decay
    sd = bn_layer.param_dtype
    new_bn_state = {
        "mean": d * bn_state["mean"] + (1 - d) * mean.to(sd),
        "var": d * bn_state["var"] + (1 - d) * var.to(sd),
    }
    return y, new_bn_state
