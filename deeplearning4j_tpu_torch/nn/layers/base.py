"""Base runtime layer (counterpart of deeplearning4j_tpu/nn/layers/base.py).

A layer is built from (config, input_type, global_conf, policy).
``init_params(gen, device)`` returns its parameter dict and
``apply(params, state, x, mask=None)`` returns ``(output, new_state)``.
Only the inference forward is ported in this slice.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.core import TORCH_DTYPES
from deeplearning4j_tpu_torch.ops import activations as activations_mod


class Layer:
    def __init__(self, conf, input_type, global_conf, policy):
        self.conf = conf
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

    def init_state(self) -> dict:
        return {}

    def apply(self, params, state, x, *, mask=None):
        raise NotImplementedError

    def feed_forward_mask(self, mask):
        """The per-timestep mask seen by the next layer; layers that
        collapse the time axis return None."""
        return mask
