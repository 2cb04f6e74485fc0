"""Sequence (context) parallelism for recurrent models (counterpart of
deeplearning4j_tpu/parallel/sequence.py).

The TIME axis of a sequence is sharded over a mesh axis, one chunk a
rank, and the recurrent carry travels the ranks in a wavefront: rank s
projects its chunk's inputs (x.Wx + b, fully parallel), waits for the
carry (h, c) from rank s - 1, runs its chunk's recurrence through
``ops/lstm.py::lstm_sequence`` (K1 on the card, and K2 in its backward
through ``LstmSequenceFn``), and hands its final carry to rank s + 1. The
last rank's final carry is (hT, cT) for every rank. The output stays
time-sharded: each rank holds its own chunk's [b, T / d, n], so the
activations of a sequence d times longer than one device's memory
split d ways. The recurrence itself is sequential, as it must be: the
chunks' scans run one rank at a time.

The carry's hop is ``parallel/mesh.py::ring_shift`` (the JAX package's
``lax.ppermute``), whose backward sends each chunk's carry cotangent
back down the ranks, so ``backward()`` of a loss of the outputs trains
every chunk. The parameters and the initial carry are replicated: their
gradients, a partial sum on each rank (its chunk's share), are summed
over the axis once, at the end of the backward (the transpose of the
JAX package's replicated ``in_specs``). Masked steps carry (h, c)
through unchanged and emit zeros, across chunk boundaries too: a chunk
whose steps are all masked hands its carry on untouched.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.parallel.mesh import (axis_group, axis_rank,
                                                    axis_size,
                                                    broadcast_from,
                                                    new_token, ring_shift,
                                                    tie)

__all__ = ["shard_sequence", "sequence_parallel_lstm"]


def shard_sequence(mesh, seq_axis: str, x, time_dim: int = 1):
    """This rank's chunk of ``x`` [b, T, ...] along ``time_dim`` (chunk
    s of d equal ones for rank s of ``seq_axis``), on this rank's device.
    Raises ``ValueError`` when T does not divide the axis."""
    from deeplearning4j_tpu_torch.parallel import distributed
    d = axis_size(mesh, seq_axis)
    x = torch.as_tensor(x)
    T = x.shape[time_dim]
    if T % d != 0:
        raise ValueError(
            f"sequence length {T} is not divisible by the '{seq_axis}' "
            f"mesh axis ({d} devices) — pad the time axis")
    part = T // d
    return x.narrow(time_dim, axis_rank(mesh, seq_axis) * part,
                    part).contiguous().to(distributed.device())


class _Replicated(torch.autograd.Function):
    """Identity forward on a schedule's token and the replicated leaves;
    backward: the leaves' gradients summed over the axis, one all-reduce
    of them all flattened (a flat buffer a dtype). The token output keeps
    the node on every rank's backward (the hop chain ends here), so every
    rank runs the same all-reduces."""

    @staticmethod
    def forward(ctx, mg, token, *leaves):
        ctx.mg = mg
        ctx.likes = [(t.shape, t.dtype, t.device) for t in leaves]
        return (token.clone(),) + tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, g_token, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=device)
                 if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.likes)]
        out = list(grads)
        for dtype in dict.fromkeys(g.dtype for g in grads):
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            flat = ctx.mg.all_reduce(torch.cat(
                [grads[i].reshape(-1) for i in idx]))
            for i, part in zip(idx, flat.split(
                    [grads[i].numel() for i in idx])):
                out[i] = part.view(grads[i].shape)
        return (None, torch.zeros_like(g_token)) + tuple(out)


def sequence_parallel_lstm(mesh, seq_axis: str, params, x_local, h0, c0, *,
                           mask=None, gate_act: str = "sigmoid",
                           cell_act: str = "tanh"):
    """Graves-LSTM forward over a time-sharded sequence.

    ``params``: the GravesLSTM param dict {Wx, Wh, b, p} (replicated);
    ``x_local``: this rank's chunk [b, T / d, f] (``shard_sequence``);
    ``h0``/``c0``: [b, n] replicated initial carry; ``mask``: this rank's
    chunk [b, T / d] of the per-timestep mask, or None. Every rank of the
    axis calls it. Returns (y_local [b, T / d, n], hT, cT): this rank's
    output chunk and the last rank's final carry, in ``x_local``'s
    dtype (the compute dtype: the carry crosses ranks in it)."""
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.parallel.tensor import ModelGroup
    group = axis_group(mesh, seq_axis)
    d, s = axis_size(mesh, seq_axis), axis_rank(mesh, seq_axis)
    cd = x_local.dtype
    names = ("Wx", "Wh", "b", "p")
    token = new_token(x_local, device=x_local.device)
    if d > 1 and torch.is_grad_enabled():
        token, *leaves = _Replicated.apply(
            ModelGroup(group), token, *(params[k] for k in names), h0, c0)
        p = dict(zip(names, leaves[:4]))
        h0, c0 = leaves[4:]
    else:
        p = dict(params)
    p = {k: p[k].to(cd) for k in names}
    # the input projection: fully parallel over the local chunk
    xz_t = (torch.matmul(x_local, p["Wx"]) + p["b"]).transpose(0, 1) \
        .contiguous()                                    # [t, b, 4n]
    m_t = None if mask is None else \
        torch.as_tensor(mask).to(device=x_local.device, dtype=cd) \
        .transpose(0, 1).contiguous()
    carry = torch.stack((h0.to(cd), c0.to(cd)))         # [2, b, n]
    if s > 0:
        carry, token = ring_shift(None, group, recv_from=s - 1, like=carry,
                                  token=token)
    out = lstm_ops.lstm_sequence(
        xz_t, carry[0].contiguous(), carry[1].contiguous(),
        p["Wh"].contiguous(), p["p"].contiguous(), m_t, gate_act=gate_act,
        cell_act=cell_act)
    fin = torch.stack((out.hT, out.cT))
    if s < d - 1:
        _, token = ring_shift(fin, group, send_to=s + 1, token=token)
    if d > 1:
        fin = tie(broadcast_from(fin, group, d - 1), token)
    y_local = out.y.transpose(0, 1)
    if d > 1:
        y_local = tie(y_local, token)
    return y_local, fin[0], fin[1]
