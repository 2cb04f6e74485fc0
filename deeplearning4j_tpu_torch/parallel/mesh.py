"""Device-mesh helpers (counterpart of deeplearning4j_tpu/parallel/mesh.py).

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
process group's ranks, one process (and one device) per rank: the axes are
logical ('data', 'model', ...) and each axis carries the process group its
collectives run in (``axis_group``): on ``{"data": 2, "model": 2}`` ranks
0 and 1 form one model group and ranks 0 and 2 one data group. The
default is one 'data' axis over the world: pure data parallelism, the
reference's only strategy.

**The hop** (``ring_shift``) is the port's ``lax.ppermute`` for the
pipeline and sequence axes (parallel/pipeline.py, parallel/sequence.py):
one autograd Function that sends a tensor to the next rank of an axis
and receives one from the previous, and in its backward sends the
received tensor's cotangent back and receives the sent one's. Where the
JAX package runs one SPMD program, whose transpose pairs every
``ppermute`` on every device, each rank here differentiates its own
graph: so every hop also passes a 0-d *token* along, and the outputs of
a schedule are tied to the last token (``tie``), so that every rank's
backward runs every hop it ran forward, in reverse order, and each
message finds its partner. A hop moves only what the static schedule
says is live (no message where the JAX package shifts garbage). Under
gloo a CUDA tensor travels through the host (gloo has no send or
receive of CUDA tensors); under NCCL it stays on the card. Every wait
is bounded by the collective timeout (parallel/distributed.py).
``broadcast_from`` hands one rank's tensor to the axis: every rank then
holds the same value and computes the same loss from it, so its backward
takes the source rank's own cotangent and sends nothing.
"""

from __future__ import annotations

import datetime
import math

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "axis_group", "axis_size", "axis_rank",
           "ring_shift", "broadcast_from", "tie", "new_token"]


def make_mesh(axes: dict | None = None, devices=None):
    """A DeviceMesh from {axis_name: size} over ``devices`` (ranks of the
    initialized process group; default all of them), on the kind of this
    rank's device (parallel/distributed.py ``initialize``). Default axes:
    one 'data' axis over every rank. Raises when no process group is up
    (``parallel.distributed.initialize``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from deeplearning4j_tpu_torch.parallel import distributed

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call parallel.distributed."
            "initialize(...) first (a single process is a group of one)")
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    if axes is None:
        axes = {"data": len(ranks)}
    total = math.prod(axes.values())
    if total > len(ranks):
        raise ValueError(
            f"Mesh needs {total} devices but only {len(ranks)} available")
    layout = torch.tensor(ranks[:total]).reshape(list(axes.values()))
    return DeviceMesh(distributed.device().type, layout,
                      mesh_dim_names=tuple(axes))


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s axis ``axis``."""
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    return dist.get_world_size(axis_group(mesh, axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along ``mesh``'s axis ``axis``."""
    return dist.get_rank(axis_group(mesh, axis))


# ------------------------------------------------------------- the hop
def _timeout():
    from deeplearning4j_tpu_torch.parallel import distributed
    return datetime.timedelta(seconds=distributed.collective_timeout_s())


def _through_host(device) -> bool:
    """Gloo has no send or receive of CUDA tensors: they travel through
    the host; NCCL moves them on the card."""
    return device.type == "cuda" and dist.get_backend() != "nccl"


def _exchange(group, send, dst, recv_like, src, tag):
    """One paired send and receive (either may be None); returns the
    received tensor, of ``recv_like``'s (shape, dtype, device)."""
    ops, buf = [], None
    if send is not None:
        send = send.detach()
        ops.append(dist.P2POp(
            dist.isend, send.cpu() if _through_host(send.device)
            else send.contiguous(), dist.get_global_rank(group, dst),
            group, tag))
    if recv_like is not None:
        shape, dtype, device = recv_like
        buf = torch.empty(shape, dtype=dtype, device="cpu"
                          if _through_host(device) else device)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, src), group, tag))
    if ops:
        timeout = _timeout()
        for work in dist.batch_isend_irecv(ops):
            work.wait(timeout)
    return None if buf is None else buf.to(recv_like[2])


def _like(t):
    return None if t is None else (t.shape, t.dtype, t.device)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, token, x, group, dst, recv_like, src, tag):
        ctx.group, ctx.dst, ctx.src, ctx.tag = group, dst, src, tag
        ctx.x_like = _like(x)
        got = _exchange(group, x, dst, _like(recv_like), src, tag)
        ctx.got_like = _like(got)
        return token.clone(), got

    @staticmethod
    def backward(ctx, g_token, g_got):
        # the partners of this hop run theirs too: what was received
        # sends its cotangent back (zeros where it went unused), what was
        # sent receives its own
        send = g_got
        if ctx.got_like is not None and g_got is None:
            shape, dtype, device = ctx.got_like
            send = torch.zeros(shape, dtype=dtype, device=device)
        back = _exchange(ctx.group, send if ctx.got_like else None,
                         ctx.src, ctx.x_like, ctx.dst, ctx.tag)
        return (torch.zeros_like(g_token), back, None, None, None, None,
                None)


class _Anchor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, token, *anchors):
        ctx.n = len(anchors)
        return token.clone()

    @staticmethod
    def backward(ctx, g):
        return (torch.zeros_like(g),) + (None,) * ctx.n


def new_token(*anchors, device=None):
    """The first token of a schedule: a 0-d tensor autograd tracks (with
    grad on), made to depend on ``anchors`` (the schedule's parameters
    and inputs), so that a backward asked only for their gradients
    (``torch.autograd.grad``) still runs every hop of the schedule."""
    token = torch.zeros((), device=device).requires_grad_(
        torch.is_grad_enabled())
    anchors = [a for a in anchors if isinstance(a, torch.Tensor)]
    if anchors and torch.is_grad_enabled():
        token = _Anchor.apply(token, *anchors)
    return token


def ring_shift(x, group, *, send_to=None, recv_from=None, like=None,
               token=None, tag: int = 0):
    """The hop: send ``x`` to the group's rank ``send_to`` and receive a
    tensor shaped as ``like`` from ``recv_from`` (either side may be
    None), through an autograd Function whose backward sends the
    received tensor's cotangent back to ``recv_from`` and receives
    ``x``'s from ``send_to``. Returns (received or None, next token).
    Ranks of a hop agree on it by their static schedule; ``tag`` keeps
    the hops of one schedule apart."""
    if token is None:
        token = new_token()
    if send_to is None:
        x = None
    if recv_from is None:
        like = None
    return _RingShift.apply(token, x, group, send_to, like, recv_from,
                            tag)[::-1]


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.mine = dist.get_rank(group) == src
        buf = x.detach().clone().contiguous()
        dist.broadcast(buf, dist.get_global_rank(group, src), group=group,
                       async_op=True).wait(_timeout())
        return buf

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else None), None, None


def broadcast_from(x, group, src: int):
    """``x`` of the group's rank ``src`` on every rank of ``group`` (the
    other ranks pass a tensor of the same shape and dtype). Every rank
    then computes the same loss from it, so the backward hands the
    source its own cotangent and the others none: no message."""
    if dist.get_world_size(group) == 1:
        return x
    return _BroadcastFrom.apply(x, group, src)


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, token):
        ctx.token_device = token.device
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), device=ctx.token_device)


def tie(x, token):
    """``x`` unchanged, made to depend on ``token``: a loss of ``x``
    reaches every hop of the token's schedule."""
    return _Tie.apply(x, token)
