"""Expert (MoE) parallelism over an ``expert`` mesh axis (counterpart of
deeplearning4j_tpu/parallel/experts.py).

A mixture-of-experts feed-forward bank: each token is routed to its
top-k experts, the experts' weights are stacked with a leading expert
dimension, and dispatch and combine are the Shazeer einsums against the
one-hot routing tensors (the dispatch one expert at a time). Each expert
takes at most ``capacity`` tokens a batch; overflow tokens are dropped
from the expert path (GShard) and pass with zero expert contribution,
so training stays differentiable through the router's probabilities.

Where the JAX package lets GSPMD partition the einsums over the expert
axis, the port renders it: on an expert-sharded dict (``shard_experts``:
this rank's slice of the expert dimension, the router replicated) every
rank routes every token (the same bits on each rank), runs its own
experts' FFN on its slice of the dispatch, and all-gathers the experts'
outputs over the axis in expert order; the combine then runs whole on
each rank, in one process's arithmetic. No partial sum crosses ranks in
the forward, so the output and the aux loss are one process's bit for
bit, and the router's gradient, computed whole on each rank, keeps the
replicated router equal across ranks. The gather's backward takes this
rank's slice of the cotangent (``parallel/tensor.py``'s
``gather_from_model``); a token's gradient through the dispatch is a
partial sum over the ranks' experts and is all-reduced (Megatron's *f*).
The einsums are ``torch.einsum``: the JAX package leaves them to XLA and
no Pallas kernel covers them.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel.mesh import (axis_group, axis_rank,
                                                    axis_size)

__all__ = ["init_moe_params", "shard_experts", "moe_ffn", "ExpertShard"]


def init_moe_params(generator: torch.Generator, n_experts: int, f_in: int,
                    f_hidden: int, f_out: Optional[int] = None,
                    dtype=torch.float32, device=None):
    """Router and stacked expert FFN params (expert dimension first),
    drawn from ``generator`` (the JAX package's scales)."""
    f_out = f_out or f_in
    device = device if device is not None else generator.device
    s1 = (2.0 / (f_in + f_hidden)) ** 0.5
    s2 = (2.0 / (f_hidden + f_out)) ** 0.5

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)
    return {
        "router": normal(f_in, n_experts) * 0.02,
        "W1": normal(n_experts, f_in, f_hidden) * s1,
        "b1": torch.zeros((n_experts, f_hidden), dtype=dtype, device=device),
        "W2": normal(n_experts, f_hidden, f_out) * s2,
        "b2": torch.zeros((n_experts, f_out), dtype=dtype, device=device),
    }


class ExpertShard(dict):
    """This rank's MoE params: its slice of the expert-stacked leaves,
    the whole router, and the expert axis's ``ModelGroup`` (``mg``,
    which counts the gathers)."""

    def __init__(self, tree, mg):
        super().__init__(tree)
        self.mg = mg


def shard_experts(mesh, expert_axis: str, params):
    """This rank's MoE params on its device: the expert-stacked weights'
    slice of the expert dimension, the router replicated."""
    from deeplearning4j_tpu_torch.parallel import distributed
    from deeplearning4j_tpu_torch.parallel.tensor import ModelGroup
    m, r = axis_size(mesh, expert_axis), axis_rank(mesh, expert_axis)
    n_experts = params["W1"].shape[0]
    if n_experts % m:
        raise ValueError(f"{n_experts} experts do not divide the "
                         f"'{expert_axis}' mesh axis ({m} devices)")
    part = n_experts // m
    dev = distributed.device()
    out = {k: (v if k == "router" else v[r * part:(r + 1) * part])
           .contiguous().to(dev) for k, v in params.items()}
    return ExpertShard(out, ModelGroup(axis_group(mesh, expert_axis)))


def _one_hot(idx, n, dtype):
    """One-hot rows of ``idx`` over n classes; an index outside [0, n)
    gives a zero row (``jax.nn.one_hot``'s)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)[None, :]) \
        .to(dtype)


def moe_ffn(params, x, *, capacity: Optional[int] = None, top_k: int = 1):
    """Routed mixture-of-experts FFN on ``x`` [tokens, f_in]: returns
    ([tokens, f_out], aux_loss), aux_loss the load-balancing loss (mean
    probability times mean pre-capacity assignment, times E). On an
    ``ExpertShard`` every rank of the axis calls it with the same tokens
    and gets the same result (module docstring)."""
    from deeplearning4j_tpu_torch.parallel.tensor import (copy_to_model,
                                                          gather_from_model)
    n_tokens = x.shape[0]
    n_experts = params["router"].shape[-1]
    if capacity is None:
        capacity = max(2 * top_k * n_tokens // n_experts, 4)

    logits = x @ params["router"].to(x.dtype)                # [T, E]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)

    combine = None
    masked = probs
    occupancy = torch.zeros((n_experts,), dtype=probs.dtype,
                            device=x.device)                 # kept so far
    assign = None      # pre-capacity routing decisions, summed over rounds
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)                   # [T]
        onehot = _one_hot(idx, n_experts, probs.dtype)
        assign = onehot if assign is None else assign + onehot
        # 1-based position in the chosen expert's queue, continuing after
        # the slots earlier rounds claimed
        pos = (torch.cumsum(onehot, dim=0) + occupancy[None, :]) * onehot
        keep = (pos <= capacity).to(probs.dtype) * onehot
        occupancy = occupancy + keep.sum(0)
        gate = (masked * keep).sum(-1, keepdim=True)         # [T, 1]
        pos_oh = _one_hot(((pos * keep).sum(-1) - 1).to(torch.int64),
                          capacity, probs.dtype)
        chunk = gate[:, :, None] * keep[:, :, None] * pos_oh[:, None, :]
        combine = chunk if combine is None else combine + chunk
        masked = masked * (1.0 - onehot)
    dispatch = (combine > 0).to(x.dtype)                     # [T, E, C]

    mg = getattr(params, "mg", None)
    sharded = mg is not None and mg.size > 1
    n_local = params["W1"].shape[0]
    lo = mg.rank * n_local if sharded else 0
    x_exp = copy_to_model(x, mg) if sharded else x
    cd = x.dtype
    outs = []
    for i in range(n_local):
        # one expert at a time, each product of one shape whatever the
        # expert count: a rank's experts compute one process's bits
        d_e = dispatch[:, lo + i].contiguous()               # [T, C]
        e_in = torch.einsum("tc,tf->cf", d_e, x_exp)         # [C, f_in]
        h = torch.relu(e_in @ params["W1"][i].to(cd)
                       + params["b1"][i].to(cd))
        outs.append(h @ params["W2"][i].to(cd) + params["b2"][i].to(cd))
    expert_out = torch.stack(outs)                           # [E, C, f]
    if sharded:
        expert_out = gather_from_model(expert_out, mg, 0)
    y = torch.einsum("tec,eco->to", combine.to(x.dtype), expert_out)

    # the balancing loss counts the router's pre-capacity choices: under
    # overflow the dropped tokens sit on the overloaded experts, which the
    # loss exists to penalise
    aux = (probs.mean(0) * assign.to(torch.float32).mean(0)).sum() \
        * n_experts
    return y, aux
