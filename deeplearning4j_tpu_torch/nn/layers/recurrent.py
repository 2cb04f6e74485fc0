"""Recurrent runtime layers: Graves LSTM (and bidirectional), the RNN
output head, last-time-step extraction (counterpart of
deeplearning4j_tpu/nn/layers/recurrent.py).

The input projection of the whole sequence is one ``torch.matmul`` in the
compute dtype; the time loop is the ``lstm_sequence`` op (ops/lstm.py):
the Hopper kernel for CUDA tensors, the plain loop for CPU tensors.

Streaming (``rnn_time_step``): when ``layer.streaming`` is set by the
network, the final (h, c) carry is read from and written to the layer's
state under "h"/"c".
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.ops import initializers as init_mod
from deeplearning4j_tpu_torch.ops import lstm as lstm_ops


def _lstm_scan(params, x, h0, c0, mask, gate_act, cell_act):
    """An LSTM over [b, t, f] in x.dtype; returns (y [b,t,n], hT, cT)."""
    cd = x.dtype
    params = {k: v.to(cd) for k, v in params.items()}
    xz = torch.matmul(x, params["Wx"]) + params["b"]
    xz_t = xz.transpose(0, 1).contiguous()  # [t, b, 4n]
    mask_t = None if mask is None else mask.transpose(0, 1).contiguous()
    out = lstm_ops.lstm_sequence(
        xz_t, h0.contiguous(), c0.contiguous(), params["Wh"].contiguous(),
        params["p"].contiguous(), mask_t, gate_act=gate_act,
        cell_act=cell_act)
    return out.y.transpose(0, 1), out.hT, out.cT


class GravesLSTMLayer(Layer):
    is_recurrent_stateful = True
    streaming = False

    def _init_direction(self, gen, device):
        n_in, n = self.conf.n_in, self.conf.n_out
        w_fn = init_mod.resolve(self.resolve("weight_init", "xavier"))
        pd = self.param_dtype
        Wx = w_fn(gen, (n_in, 4 * n), n_in, n, pd, device)
        Wh = w_fn(gen, (n, 4 * n), n, n, pd, device)
        b = torch.zeros((4 * n,), dtype=pd, device=device)
        # forget-gate bias init (gate order i, f, o, g)
        b[n:2 * n] = float(self.conf.forget_gate_bias_init)
        p = torch.zeros((3, n), dtype=pd, device=device)
        return {"Wx": Wx, "Wh": Wh, "b": b, "p": p}

    def init_params(self, gen, device):
        return self._init_direction(gen, device)

    def _run(self, params, x, mask, carry, reverse=False):
        n = self.conf.n_out
        b = x.shape[0]
        if carry is None:
            h0 = torch.zeros((b, n), dtype=x.dtype, device=x.device)
            c0 = torch.zeros((b, n), dtype=x.dtype, device=x.device)
        else:
            h0, c0 = carry[0].to(x.dtype), carry[1].to(x.dtype)
        if reverse:
            x = torch.flip(x, dims=(1,))
            mask = None if mask is None else torch.flip(mask, dims=(1,))
        y, hT, cT = _lstm_scan(params, x, h0, c0, mask,
                               self.conf.gate_activation,
                               self.resolve("activation", "tanh"))
        if reverse:
            y = torch.flip(y, dims=(1,))
        return y, hT, cT

    def _mask(self, mask, x):
        if mask is None:
            return None
        return mask.reshape(mask.shape[0], -1).to(x.dtype)

    def apply(self, params, state, x, *, mask=None):
        x = x.to(self.compute_dtype)
        m = self._mask(mask, x)
        carry = None
        if self.streaming and "h" in state:
            carry = (state["h"], state["c"])
        y, hT, cT = self._run(params, x, m, carry)
        new_state = dict(state)
        if self.streaming:
            new_state["h"] = hT
            new_state["c"] = cT
        return y, new_state


class GravesBidirectionalLSTMLayer(GravesLSTMLayer):
    """Two directions, summed; the backward one runs the same kernel on the
    time-flipped input."""

    def init_params(self, gen, device):
        return {"fwd": self._init_direction(gen, device),
                "bwd": self._init_direction(gen, device)}

    def apply(self, params, state, x, *, mask=None):
        if self.streaming:
            raise ValueError(
                "rnn_time_step streaming is undefined for a bidirectional "
                "LSTM (the backward direction needs the whole sequence)")
        x = x.to(self.compute_dtype)
        m = self._mask(mask, x)
        y_f, _, _ = self._run(params["fwd"], x, m, None)
        y_b, _, _ = self._run(params["bwd"], x, m, None, reverse=True)
        return y_f + y_b, state


class RnnOutputLayerImpl(Layer):
    """Per-timestep dense head."""

    def init_params(self, gen, device):
        n_in, n_out = self.conf.n_in, self.conf.n_out
        w_fn = init_mod.resolve(self.resolve("weight_init", "xavier"))
        params = {"W": w_fn(gen, (n_in, n_out), n_in, n_out,
                            self.param_dtype, device)}
        if self.conf.has_bias:
            params["b"] = torch.full(
                (n_out,), float(self.resolve("bias_init", 0.0)),
                dtype=self.param_dtype, device=device)
        return params

    def preout(self, params, x):
        cd = self.compute_dtype
        z = torch.matmul(x.to(cd), params["W"].to(cd))
        if "b" in params:
            z = z + params["b"].to(cd)
        return z

    def apply(self, params, state, x, *, mask=None):
        # head activation in the param dtype, so served outputs are full
        # precision under any policy
        z = self.preout(params, x).to(self.param_dtype)
        return self.activation_fn(z), state


def last_unmasked_step(x, mask):
    """[b, t, f] -> [b, f]: the last step, or the last unmasked step of
    each example when a [b, t] mask is given (an all-masked row takes
    step 0)."""
    if mask is None:
        return x[:, -1, :]
    m = mask.reshape(mask.shape[0], -1) > 0
    t = m.shape[1]
    last_nz = (t - 1) - torch.argmax(torch.flip(m, dims=(1,)).to(torch.int32),
                                     dim=1)
    idx = torch.where(m.any(dim=1), last_nz, torch.zeros_like(last_nz))
    return x[torch.arange(x.shape[0], device=x.device), idx, :]


class LastTimeStepLayer(Layer):
    def feed_forward_mask(self, mask):
        return None

    def apply(self, params, state, x, *, mask=None):
        return last_unmasked_step(x, mask), state


def set_streaming(layers, flag: bool):
    for layer in layers:
        if getattr(layer, "is_recurrent_stateful", False):
            layer.streaming = flag
