"""MultiLayerNetwork — a sequential stack, inference side (counterpart of
deeplearning4j_tpu/nn/multilayer.py: ``init``, ``output``,
``feed_forward``, ``rnn_time_step``, ``rnn_clear_previous_state``).

Parameters are a dict ``{layer_name: {param_name: tensor}}`` in the JAX
package's layouts, so a model crosses between the packages through the
zip format unchanged. PyTorch runs eagerly, so there is no compiled-step
cache: each call walks the layers. ``fit`` arrives with the training slice.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.core import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.recurrent import set_streaming


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.layers = None
        self.params = None    # {layer_name: {param: tensor}}
        self.state = None     # {layer_name: {...}}
        self.iteration = 0
        self.epoch = 0
        self._rnn_state = None

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None):
        """Build the runtime layers and draw parameters from a
        ``torch.Generator`` seeded with ``seed`` (default: the config's).
        The draws do not reproduce the JAX package's; carry a JAX model
        across with utils/serialization.py instead."""
        gc = self.conf.global_conf
        seed = gc.seed if seed is None else seed
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        input_type = self.conf.input_type
        self.layers = []
        for i, lc in enumerate(self.conf.layers):
            if input_type is not None:
                lc = lc.with_n_in(input_type)
            if getattr(lc, "n_in", 1) is None:
                raise ValueError(
                    f"Layer {i} ({lc.layer_type}): n_in not set and no "
                    f"input_type provided for inference")
            if lc.name is None:
                lc = lc.replace(name=f"layer_{i}")
            layer = lc.make_layer(input_type, gc, gc.dtype)
            self.layers.append(layer)
            input_type = layer.output_type
        self.params, self.state = {}, {}
        for layer in self.layers:
            p = layer.init_params(gen, self.device)
            if p:
                self.params[layer.name] = p
            s = layer.init_state()
            if s:
                self.state[layer.name] = s
        self.iteration = 0
        self._rnn_state = None
        return self

    def _require_init(self):
        if self.params is None:
            raise RuntimeError(
                "Network not initialized — call net.init() before output()")

    # -------------------------------------------------------------- forward
    def _as_tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _forward(self, params, state, x, fmask=None, collect=False):
        acts = []
        new_state = dict(state)
        for layer in self.layers:
            x, s_new = layer.apply(params.get(layer.name, {}),
                                   state.get(layer.name, {}), x, mask=fmask)
            fmask = layer.feed_forward_mask(fmask)
            if s_new:
                new_state[layer.name] = s_new
            if collect:
                acts.append(x)
        return (acts if collect else x), new_state

    def output(self, x, mask=None) -> torch.Tensor:
        """Final layer activations. ``mask`` is the [b, t] per-timestep
        features mask for variable-length sequences."""
        self._require_init()
        with torch.inference_mode():
            out, _ = self._forward(self.params, self.state,
                                   self._as_tensor(x),
                                   None if mask is None
                                   else self._as_tensor(mask))
        return out

    def feed_forward(self, x, mask=None) -> List[torch.Tensor]:
        """Every layer's activations."""
        self._require_init()
        with torch.inference_mode():
            acts, _ = self._forward(self.params, self.state,
                                    self._as_tensor(x),
                                    None if mask is None
                                    else self._as_tensor(mask),
                                    collect=True)
        return acts

    # ------------------------------------------------- streaming inference
    def rnn_clear_previous_state(self):
        self._rnn_state = None

    def rnn_time_step(self, x, mask=None) -> torch.Tensor:
        """Stateful streaming inference: feed one step [b, f] or a chunk
        [b, t, f]; recurrent layers carry (h, c) across calls."""
        self._require_init()
        x = self._as_tensor(x)
        single = x.dim() == 2
        if single:
            x = x[:, None, :]
        set_streaming(self.layers, True)
        try:
            state_in = (self._rnn_state if self._rnn_state is not None
                        else self.state)
            with torch.inference_mode():
                out, new_state = self._forward(
                    self.params, state_in, x,
                    None if mask is None else self._as_tensor(mask))
            self._rnn_state = new_state
        finally:
            set_streaming(self.layers, False)
        return out[:, 0, :] if single else out

    # ---------------------------------------------------------------- misc
    def num_params(self) -> int:
        return sum(t.numel() for p in self.params.values()
                   for t in _leaves(p))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
