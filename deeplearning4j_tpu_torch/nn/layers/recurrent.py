"""Recurrent runtime layers: Graves LSTM (and bidirectional), the RNN
output head, the per-timestep dense without a head, last-time-step
extraction (counterpart of deeplearning4j_tpu/nn/layers/recurrent.py).

The input projection of the whole sequence is one ``torch.matmul`` in the
compute dtype; the time loop is the ``lstm_sequence`` op (ops/lstm.py):
the Hopper kernel for CUDA tensors, the plain loop for CPU tensors.

Training: with grad on, ``lstm_sequence`` differentiates through
``LstmSequenceFn`` (the backward kernel on the card, its plain loop on the
CPU); the input projection and the head are autograd of ``torch.matmul``.

Streaming (``rnn_time_step`` and truncated BPTT): when ``layer.streaming``
is set by the network, the final (h, c) carry is read from and written to
the layer's state under "h"/"c" (the attention layers' under "k"/"v"/"pos");
``strip_carries`` drops them again.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.ops import initializers as init_mod
from deeplearning4j_tpu_torch.ops import losses as losses_mod
from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
from deeplearning4j_tpu_torch.ops.sequence import last_unmasked_step

# the recurrent (h, c) carries a streaming layer keeps in its state, plus
# the attention layers' KV-cache carries (k/v caches and each row's
# absolute position, nn/layers/attention.py); the same keys as the JAX
# package's CARRY_KEYS
CARRY_KEYS = ("h", "c", "h_bwd", "c_bwd", "k", "v", "pos")


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

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._input_dropout(x, train, gen).to(self.compute_dtype)
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

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        if self.streaming:
            raise ValueError(
                "rnn_time_step/tBPTT streaming is undefined for a "
                "bidirectional LSTM (the backward direction needs the whole "
                "sequence)")
        x = self._input_dropout(x, train, gen).to(self.compute_dtype)
        m = self._mask(mask, x)
        y_f, _, _ = self._run(params["fwd"], x, m, None)
        y_b, _, _ = self._run(params["bwd"], x, m, None, reverse=True)
        return y_f + y_b, state


class RnnOutputLayerImpl(Layer):
    """Per-timestep dense head and its loss."""

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

    @property
    def loss_fn(self) -> losses_mod.Loss:
        return losses_mod.get(self.conf.loss)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        # head activation in the param dtype, so served outputs are full
        # precision under any policy
        x = self._input_dropout(x, train, gen)
        z = self.preout(params, x).to(self.param_dtype)
        return self.activation_fn(z), state

    def loss(self, params, x, labels, *, train=False, gen=None, mask=None):
        """The data loss over [b, t, n_out] labels and a [b, t] mask, in
        the param dtype (f32 under BF16) for stability."""
        x = self._input_dropout(x, train, gen)
        z = self.preout(params, x).to(self.param_dtype)
        n_out = z.shape[-1]
        z2 = z.reshape(-1, n_out)
        labels2 = labels.reshape(-1, n_out).to(z2.dtype)
        m2 = None if mask is None else mask.reshape(-1)
        return self.loss_fn.score(labels2, z2, self.activation_fn, m2)


class TimeDistributedDenseLayer(RnnOutputLayerImpl):
    """Per-timestep dense, no loss head; mid-network, so its activation
    stays in the compute dtype."""

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._input_dropout(x, train, gen)
        return self.activation_fn(self.preout(params, x)), state

    def loss(self, *args, **kwargs):
        raise ValueError(
            "TimeDistributedDense has no loss head — use RnnOutput as the "
            "terminal layer")


class LastTimeStepLayer(Layer):
    def feed_forward_mask(self, mask):
        return None

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        return last_unmasked_step(x, mask), state


def set_streaming(layers, flag: bool):
    for layer in layers:
        if getattr(layer, "is_recurrent_stateful", False):
            layer.streaming = flag


def strip_carries(state):
    """The state without its recurrent carries (the batch-boundary reset
    after tBPTT); layers left with nothing are dropped."""
    out = {}
    for name, sub in state.items():
        kept = {k: v for k, v in sub.items() if k not in CARRY_KEYS}
        if kept:
            out[name] = kept
    return out
