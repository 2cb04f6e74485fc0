"""Transformer runtime layers: GPT embedding, causal self-attention, the
pre-LN transformer block and the GPT output head (counterpart of
deeplearning4j_tpu/nn/layers/attention.py).

Two arithmetic paths, as in the JAX package:

- **training and ``output``**: compute-dtype GEMMs for the projections
  (``_dense_gemm``, ``torch.matmul``; the bias is added in the compute
  dtype) and the ``causal_mha`` op (ops/attention.py): the exact f32
  formulation on the CPU, the hand-written flash kernel K3 on the card,
  differentiated through its recompute backward. The features mask is
  ignored here, as in the JAX package.
- **streaming** (``rnn_time_step``, truncated BPTT and the decode engine,
  serving/decode.py): f32 projections (``_dense_exact``), f32 LayerNorm
  (``_layer_norm_exact``) and ``decode_mha`` against a KV cache
  ("k"/"v" [b, C, heads, dh] f32, allocated once at ``max_cache_len``)
  with each row's absolute position ("pos" [b] int32). Each of the three
  sums its reduced axis in one fixed order whatever the number of rows,
  the query length or the position (ops/stream_exact.py: plain PyTorch
  loops on the CPU, the order-fixed kernels S1-S3 on the card), so a
  token decoded one at a time has the bits it has in a one-shot or
  chunked prefill or in a padded bucket, as the JAX package's fused
  reduces give it there. Against the JAX package this path agrees to f32
  tolerance: both are exact in their own order, and the orders differ.

Rounding order follows the JAX package exactly: LayerNorm in f32, then a
cast to the compute dtype; residual adds in the compute dtype; GELU on
the compute-dtype GEMM output. Parameter names and layouts are the JAX
ones (``Wq``..``bo``, ``ln1_g``..``b2``, ``Wtok``, ``Wpos``), so the
zip's ``coefficients.npz`` keys match.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayerImpl
from deeplearning4j_tpu_torch.ops import activations as activations_mod
from deeplearning4j_tpu_torch.ops import attention as att
from deeplearning4j_tpu_torch.ops import initializers as init_mod
from deeplearning4j_tpu_torch.ops import stream_exact

_DEFAULT_CACHE_LEN = 256


def _layer_norm(x, g, b, eps):
    """LayerNorm in f32 (returns f32)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    d = xf - mu
    var = torch.mean(d * d, dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + float(eps))
    return y * g.to(torch.float32) + b.to(torch.float32)


def _layer_norm_exact(x, g, b, eps):
    """The streaming path's LayerNorm, f32, row sums in a fixed order
    (S3, ops/stream_exact.py)."""
    return stream_exact.stream_rownorm(x.to(torch.float32),
                                       g.to(torch.float32),
                                       b.to(torch.float32), eps)


def _dense_exact(x, W, b):
    """[b, t, f] @ [f, g] in f32, summed over f in a fixed order (the
    streaming path's projection; S1, ops/stream_exact.py)."""
    return stream_exact.stream_dense(
        x.to(torch.float32).contiguous(), W.to(torch.float32).contiguous(),
        None if b is None else b.to(torch.float32).contiguous())


def _dense_gemm(x, W, b, cd):
    """One compute-dtype GEMM; the bias is added in the compute dtype."""
    z = torch.matmul(x.to(cd), W.to(cd))
    if b is not None:
        z = z + b.to(cd)
    return z


def _mask_lengths(mask):
    """Per-row true length [b] int32 from a features mask (or None)."""
    if mask is None:
        return None
    m = mask.reshape(mask.shape[0], -1)
    return torch.sum(m.to(torch.int32), dim=1, dtype=torch.int32)


class GptEmbeddingLayer(Layer):
    """One-hot [b, t, vocab] -> [b, t, d]: the token row at the one-hot's
    argmax plus the learned position row (positions clipped to the
    table); the sum in f32, then cast to the compute dtype. Streaming
    carries "pos" to offset the positions."""

    is_recurrent_stateful = True
    streaming = False

    def init_params(self, gen, device):
        n_in, n_out = self.conf.n_in, self.conf.n_out
        max_len = int(self.conf.max_len)
        w_fn = init_mod.resolve(self.resolve("weight_init", "xavier"))
        pd = self.param_dtype
        return {"Wtok": w_fn(gen, (n_in, n_out), n_in, n_out, pd, device),
                "Wpos": w_fn(gen, (max_len, n_out), max_len, n_out, pd,
                             device)}

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._input_dropout(x, train, gen)
        b, t = x.shape[0], x.shape[1]
        dev = x.device
        idx = torch.argmax(x, dim=-1)                         # [b, t]
        tok = params["Wtok"][idx]                             # param dtype
        if self.streaming and "pos" in state:
            p0 = state["pos"]
        else:
            p0 = torch.zeros((b,), dtype=torch.int32, device=dev)
        positions = p0[:, None] + torch.arange(t, dtype=torch.int32,
                                               device=dev)[None, :]
        positions = torch.clamp(positions, 0, int(self.conf.max_len) - 1)
        pos_emb = params["Wpos"][positions.to(torch.int64)]   # [b, t, d]
        y = tok.to(torch.float32) + pos_emb.to(torch.float32)
        new_state = dict(state)
        if self.streaming:
            lengths = _mask_lengths(mask)
            new_state["pos"] = p0 + (t if lengths is None else lengths)
            return y, new_state                               # f32
        return y.to(self.compute_dtype), new_state


class _AttentionCore(Layer):
    """The QKV and output projections and the KV-cache machinery shared
    by ``SelfAttentionLayer`` and ``TransformerBlockLayer``."""

    is_recurrent_stateful = True
    streaming = False

    def __init__(self, conf, input_type, global_conf, policy):
        super().__init__(conf, input_type, global_conf, policy)
        d = int(conf.n_out)
        heads = int(conf.n_heads)
        if d % heads != 0:
            raise ValueError(
                f"{type(conf).__name__} '{conf.name}': n_out={d} not "
                f"divisible by n_heads={heads}")
        self.n_heads = heads
        self.head_dim = d // heads

    @property
    def cache_len(self) -> int:
        return int(self.resolve("max_cache_len", None) or _DEFAULT_CACHE_LEN)

    def _init_attn_params(self, gen, device):
        d_in, d = int(self.conf.n_in), int(self.conf.n_out)
        w_fn = init_mod.resolve(self.resolve("weight_init", "xavier"))
        bias0 = float(self.resolve("bias_init", 0.0))
        pd = self.param_dtype
        full = lambda: torch.full((d,), bias0, dtype=pd,  # noqa: E731
                                  device=device)
        return {
            "Wq": w_fn(gen, (d_in, d), d_in, d, pd, device),
            "Wk": w_fn(gen, (d_in, d), d_in, d, pd, device),
            "Wv": w_fn(gen, (d_in, d), d_in, d, pd, device),
            "Wo": w_fn(gen, (d, d), d, d, pd, device),
            "bq": full(), "bk": full(), "bv": full(), "bo": full(),
        }

    def _attn(self, params, state, h, mask):
        """MHA of ``h`` [b, t, d_in]: (projected output [b, t, d], the new
        carries or None). Streaming attends against the fixed-extent cache;
        otherwise the ``causal_mha`` op runs over the live sequence."""
        b, t = h.shape[0], h.shape[1]
        heads, dh, d = self.n_heads, self.head_dim, int(self.conf.n_out)
        if self.streaming:
            q = _dense_exact(h, params["Wq"], params["bq"])
            k = _dense_exact(h, params["Wk"], params["bk"])
            v = _dense_exact(h, params["Wv"], params["bv"])
            q = q.reshape(b, t, heads, dh)
            k = k.reshape(b, t, heads, dh)
            v = v.reshape(b, t, heads, dh)
            if "k" in state:
                kc, vc, pos0 = state["k"], state["v"], state["pos"]
            else:
                C = self.cache_len
                kc = torch.zeros((b, C, heads, dh), dtype=torch.float32,
                                 device=h.device)
                vc = torch.zeros_like(kc)
                pos0 = torch.zeros((b,), dtype=torch.int32, device=h.device)
            kc, vc = att.extend_cache(kc, vc, k, v, pos0)
            out = att.decode_mha(q, kc, vc, pos0)
            lengths = _mask_lengths(mask)
            new_pos = pos0 + (t if lengths is None else lengths)
            proj = _dense_exact(out.reshape(b, t, d), params["Wo"],
                                params["bo"])
            return proj, {"k": kc, "v": vc, "pos": new_pos}
        cd = h.dtype
        q = _dense_gemm(h, params["Wq"], params["bq"], cd)
        k = _dense_gemm(h, params["Wk"], params["bk"], cd)
        v = _dense_gemm(h, params["Wv"], params["bv"], cd)
        out = att.causal_mha(q.reshape(b, t, heads, dh),
                             k.reshape(b, t, heads, dh),
                             v.reshape(b, t, heads, dh))
        proj = _dense_gemm(out.reshape(b, t, d), params["Wo"], params["bo"],
                           cd)
        return proj, None


class SelfAttentionLayer(_AttentionCore):
    """Bare causal MHA (projections, attention, output projection), no
    residual or norm; ``activation`` (default identity) applies to the
    projected output."""

    def init_params(self, gen, device):
        return self._init_attn_params(gen, device)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._input_dropout(x, train, gen)
        if self.streaming:
            h = x.to(torch.float32)
        else:
            h = x.to(self.compute_dtype)
        proj, carries = self._attn(params, state, h, mask)
        y = self.activation_fn(proj)
        new_state = dict(state)
        if carries:
            new_state.update(carries)
        return y, new_state


class TransformerBlockLayer(_AttentionCore):
    """Pre-LN block: ``a = x + attn(ln1(x))``, ``y = a + mlp(ln2(a))``,
    with n_in == n_out; the MLP nonlinearity is ``activation`` (gelu
    unless overridden)."""

    def __init__(self, conf, input_type, global_conf, policy):
        super().__init__(conf, input_type, global_conf, policy)
        if int(conf.n_in) != int(conf.n_out):
            raise ValueError(
                f"TransformerBlock '{conf.name}': residual stream needs "
                f"n_in == n_out, got {conf.n_in} != {conf.n_out}")

    @property
    def activation_fn(self):
        return activations_mod.get(self.resolve("activation", "gelu"))

    def init_params(self, gen, device):
        d = int(self.conf.n_out)
        hidden = int(self.conf.ffn_mult) * d
        w_fn = init_mod.resolve(self.resolve("weight_init", "xavier"))
        pd = self.param_dtype
        bias0 = float(self.resolve("bias_init", 0.0))
        params = self._init_attn_params(gen, device)
        params.update({
            "ln1_g": torch.ones((d,), dtype=pd, device=device),
            "ln1_b": torch.zeros((d,), dtype=pd, device=device),
            "ln2_g": torch.ones((d,), dtype=pd, device=device),
            "ln2_b": torch.zeros((d,), dtype=pd, device=device),
            "W1": w_fn(gen, (d, hidden), d, hidden, pd, device),
            "b1": torch.full((hidden,), bias0, dtype=pd, device=device),
            "W2": w_fn(gen, (hidden, d), hidden, d, pd, device),
            "b2": torch.full((d,), bias0, dtype=pd, device=device),
        })
        return params

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        eps = float(self.conf.ln_eps)
        x = self._input_dropout(x, train, gen)
        if self.streaming:
            xf = x.to(torch.float32)
            h1 = _layer_norm_exact(xf, params["ln1_g"], params["ln1_b"], eps)
            proj, carries = self._attn(params, state, h1, mask)
            a = xf + proj
            h2 = _layer_norm_exact(a, params["ln2_g"], params["ln2_b"], eps)
            m = self.activation_fn(_dense_exact(h2, params["W1"],
                                                params["b1"]))
            y = a + _dense_exact(m, params["W2"], params["b2"])
            new_state = dict(state)
            new_state.update(carries)
            return y, new_state
        cd = self.compute_dtype
        xc = x.to(cd)
        h1 = _layer_norm(xc, params["ln1_g"], params["ln1_b"], eps)
        proj, _ = self._attn(params, state, h1.to(cd), mask)
        a = xc + proj
        h2 = _layer_norm(a, params["ln2_g"], params["ln2_b"], eps)
        m = self.activation_fn(
            _dense_gemm(h2.to(cd), params["W1"], params["b1"], cd))
        y = a + _dense_gemm(m, params["W2"], params["b2"], cd)
        return y, state


class GptOutputLayer(RnnOutputLayerImpl):
    """The RnnOutput head; its streaming pre-output is the f32 projection
    of the streaming path."""

    is_recurrent_stateful = True
    streaming = False

    def preout(self, params, x):
        if self.streaming:
            return _dense_exact(x.to(torch.float32), params["W"],
                                params.get("b"))
        return super().preout(params, x)
