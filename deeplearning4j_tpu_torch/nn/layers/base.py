"""Base runtime layer (counterpart of deeplearning4j_tpu/nn/layers/base.py).

A layer is built from (config, input_type, global_conf, policy).
``init_params(gen, device)`` returns its parameter dict and
``apply(params, state, x, train=False, gen=None, mask=None)`` returns
``(output, new_state)``. Backprop is autograd of ``apply`` (through the
LSTM's own ``torch.autograd.Function``), so only forwards are written
here; ``regularization`` adds the L1/L2 penalty to the training loss.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn import remat
from deeplearning4j_tpu_torch.nn.conf.core import TORCH_DTYPES
from deeplearning4j_tpu_torch.ops import activations as activations_mod


class Layer:
    #: the layer's placement on a mesh's model axis (parallel/tensor.py
    #: ``LayerTP``), set by ``use_mesh(model_axis=)``; None unmeshed
    tp = None

    def __init__(self, conf, input_type, global_conf, policy):
        self.conf = conf
        self.input_type = input_type
        self.global_conf = global_conf
        self.policy = policy
        self.output_type = conf.get_output_type(input_type)

    def resolve(self, name, default=None):
        """A layer field, else the global one, else ``default``."""
        v = getattr(self.conf, name, None)
        if v is None:
            v = getattr(self.global_conf, name, None)
        return default if v is None else v

    @property
    def param_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.policy.param_dtype]

    @property
    def compute_dtype(self) -> torch.dtype:
        # resolved per layer name, so policy overrides can pin named layers
        return TORCH_DTYPES[self.policy.compute_dtype_for(self.name)]

    @property
    def activation_fn(self):
        return activations_mod.get(self.resolve("activation", "identity"))

    @property
    def name(self):
        return self.conf.name

    def init_params(self, gen: torch.Generator, device) -> dict:
        return {}

    def init_state(self, device="cpu") -> dict:
        return {}

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        raise NotImplementedError

    def feed_forward_mask(self, mask):
        """The per-timestep mask seen by the next layer; layers that
        collapse the time axis return None."""
        return mask

    def _input_dropout(self, x, train, gen):
        """Inverted dropout on the layer's input while training:
        ``dropout`` is the DROP probability, kept inputs are scaled by
        1/keep. ``gen`` is the net's ``torch.Generator`` on x's device; the
        bits differ from the JAX package's jax.random ones. Inside a remat
        span the mask is recorded and replayed (nn/remat.py)."""
        p = float(self.resolve("dropout", 0.0) or 0.0)
        if not train or p <= 0.0:
            return x
        if gen is None:
            raise ValueError(
                f"Layer {self.name}: dropout requires a generator during "
                f"training")
        keep = 1.0 - p
        mask = remat.keep_mask(x.shape, keep, gen, x.device)
        return torch.where(mask, x / keep, 0.0).to(x.dtype)

    def regularization(self, params) -> torch.Tensor:
        """L1/L2 penalty of this layer's params (0.5*l2*||W||^2 +
        l1*sum|W|; biases take l1_bias/l2_bias), in the param dtype. On a
        model axis a sharded leaf's terms are this rank's part: they are
        summed apart and all-reduced over the model group
        (``LayerTP.sum_sharded``), only where a sharded leaf has a term
        (the coefficients, and so the choice, are every rank's)."""
        leaves = list(_named_leaves(params))
        device = leaves[0][1].device if leaves else "cpu"
        total = torch.zeros((), dtype=self.param_dtype, device=device)
        part = torch.zeros((), dtype=self.param_dtype, device=device)
        sharded = (self.tp.sharded_flags(params, sort=False)
                   if self.tp is not None else [False] * len(leaves))
        l1 = float(self.resolve("l1", 0.0) or 0.0)
        l2 = float(self.resolve("l2", 0.0) or 0.0)
        l1b = float(self.resolve("l1_bias", 0.0) or 0.0)
        l2b = float(self.resolve("l2_bias", 0.0) or 0.0)
        shard_terms = False    # one rule for every rank of the group
        for (pname, w), shard in zip(leaves, sharded):
            is_bias = pname in ("b", "bias", "beta")
            a1, a2 = (l1b, l2b) if is_bias else (l1, l2)
            term = None
            if a1:
                # |w| with the JAX package's subgradient at 0 (+1, where
                # torch.abs takes 0): zero-initialised biases move alike
                term = a1 * torch.sum(torch.where(w >= 0, w, -w))
            if a2:
                t2 = 0.5 * a2 * torch.sum(w * w)
                term = t2 if term is None else term + t2
            if term is None:
                continue
            if shard:
                part = part + term
                shard_terms = True
            else:
                total = total + term
        if shard_terms:
            total = total + self.tp.sum_sharded(part)
        return total


def _named_leaves(tree, name=None):
    """(leaf name, tensor) of a param dict, nested dicts (a bidirectional
    LSTM's fwd/bwd) flattened in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, k)
    else:
        yield name, tree
