"""Mixed-precision train step: loss scaling and the step builder
(counterpart of deeplearning4j_tpu/nn/precision.py).

The dtype policy lives in nn/conf/core.py (``DtypePolicy``); the layers
honor it at their boundaries. This module is the step's discipline:

- **No scaling (f32/bf16 policies):** forward, loss, ``backward``, then
  the per-layer update.
- **Loss scaling (f16, or an explicit ``loss_scale``):** the loss is
  multiplied by the current scale before ``backward``, the gradients are
  unscaled in the master dtype, and a step whose gradients hold any
  inf/nan is SKIPPED: params and optimizer state are not touched at all
  (bit-identical), while the scale backs off by ``1/loss_scale_factor``.
  After ``loss_scale_growth_interval`` finite steps in a row the scale
  regrows by ``loss_scale_factor``, up to 2**24. The skip is a select on
  the card, as the JAX package's ``jnp.where``: the update runs, then
  every parameter and updater slot takes its new value where the
  gradients were finite and its old one where not. The step reads nothing
  back to the host, so a CUDA graph can capture it.

The scale state lives in ``opt_state`` under :data:`LOSS_SCALE_KEY` as
``{"scale": f32, "good_steps": int32}``, as in the JAX package, so it is
written to and read from ``updaterState.npz`` with the updater slots.
The score a step returns is the TRUE (unscaled) loss.
"""

from __future__ import annotations

import contextlib

import torch

from deeplearning4j_tpu_torch.nn.updater import (_fill, _leaves,
                                                 apply_layer_updates)

#: reserved top-level opt_state key holding {"scale", "good_steps"}
LOSS_SCALE_KEY = "_loss_scale"

#: dynamic-scale ceiling, far from f32's exponent limit
_SCALE_MAX = 2.0 ** 24


def init_loss_scale_state(policy, device="cpu"):
    """The opt_state entry for ``policy``, or None when it runs unscaled."""
    mode = policy.loss_scale_mode()
    if mode is None:
        return None
    init = policy.loss_scale_init if mode == "dynamic" else float(mode)
    return {"scale": torch.tensor(init, dtype=torch.float32, device=device),
            "good_steps": torch.zeros((), dtype=torch.int32, device=device)}


def all_finite(tree) -> torch.Tensor:
    """0-d bool: every leaf of ``tree`` is free of inf/nan (None leaves,
    a frozen layer's gradients, are left out)."""
    leaves = [l for l in _leaves(tree) if l is not None]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(l).all() for l in leaves]).all()


def next_scale_state(ls, finite, mode, policy):
    """The scale transition after a step. Static mode only counts
    good_steps; dynamic mode backs off on a skipped step and regrows
    after the growth interval."""
    good = torch.where(finite, ls["good_steps"] + 1,
                       torch.zeros_like(ls["good_steps"]))
    if mode != "dynamic":
        return {"scale": ls["scale"], "good_steps": good}
    factor = policy.loss_scale_factor
    grow = good >= policy.loss_scale_growth_interval
    scale = torch.where(
        finite,
        torch.where(grow, torch.clamp(ls["scale"] * factor, max=_SCALE_MAX),
                    ls["scale"]),
        torch.clamp(ls["scale"] / factor, min=1.0))
    good = torch.where(grow, torch.zeros_like(good), good)
    return {"scale": scale, "good_steps": good}


def tree_grads(loss, params):
    """d loss / d params as a tree shaped like ``params``: zeros for a
    leaf the loss does not reach, None for a leaf that does not require
    grad (a frozen layer's, which autograd is not asked for)."""
    leaves = list(_leaves(params))
    wanted = [p for p in leaves if p.requires_grad]
    gs = iter(torch.autograd.grad(loss, wanted, allow_unused=True)
              if wanted else ())
    out = []
    for p in leaves:
        g = next(gs) if p.requires_grad else None
        if g is None and p.requires_grad:
            g = torch.zeros_like(p)
        out.append(g)
    return _fill(params, iter(out))


def build_step_fn(loss_fn, layers, gc, lr_scale, reduce=None):
    """The train step: ``step(params, state, opt_state, it, *data) ->
    (new_state, score)``. ``loss_fn(params, state, *data) -> (loss,
    new_state)``. ``params`` hold the leaf tensors the step differentiates
    and updates in place; ``opt_state``'s tensors are updated in place.
    ``it`` is the iteration (an int, or the net's int32 device twin).
    A leaf that does not require grad (a frozen layer's, see
    nn/multistep.py's ``step_leaves``) gets no gradient and no update.
    ``reduce``, when given, is a meshed step's collectives
    (parallel/data_parallel.py ``GradAllReduce``): ``reduce.share(labels,
    lmask)`` before the forward, ``reduce.batch_stats(share)`` around the
    forward and backward, and ``reduce(grads, loss, share) -> (grads,
    loss)`` between the (unscaled) gradients and the update."""
    policy = gc.dtype
    mode = policy.loss_scale_mode()
    master = getattr(torch, policy.param_dtype)

    if mode is None:
        def step(params, state, opt_state, it, *data):
            if reduce is None:
                loss, new_state = loss_fn(params, state, *data)
                grads = tree_grads(loss, params)
            else:
                share = reduce.share(data[1], data[3])
                with reduce.batch_stats(share):
                    loss, new_state = loss_fn(params, state, *data)
                    grads = tree_grads(loss, params)
                grads, loss = reduce(grads, loss, share)
            apply_layer_updates(layers, gc, params, grads, opt_state, it,
                                lr_scale)
            return new_state, loss.detach()

        return step

    def step(params, state, opt_state, it, *data):
        ls = opt_state[LOSS_SCALE_KEY]
        scale = ls["scale"]
        share = None if reduce is None else reduce.share(data[1], data[3])
        with (contextlib.nullcontext() if reduce is None
              else reduce.batch_stats(share)):
            loss, new_state = loss_fn(params, state, *data)
            grads = tree_grads(loss * scale.to(loss.dtype), params)
        inv = (1.0 / scale).to(master)
        grads = _fill(grads, iter([None if g is None else g.to(master) * inv
                                   for g in _leaves(grads)]))
        if reduce is not None:
            grads, loss = reduce(grads, loss, share)
        finite = all_finite(grads)
        # the skip as a select on the card: no host read
        kept = list(_leaves(params)) + [
            t for k, sub in opt_state.items() if k != LOSS_SCALE_KEY
            for t in _leaves(sub)]
        with torch.no_grad():
            before = [t.clone() for t in kept]
            apply_layer_updates(layers, gc, params, grads, opt_state, it,
                                lr_scale)
            for t, old in zip(kept, before):
                t.copy_(torch.where(finite, t, old))
            for k, v in next_scale_state(ls, finite, mode, policy).items():
                ls[k].copy_(v)
        return new_state, loss.detach()

    return step


def current_loss_scale(net):
    """The net's live loss scale as a float, or None when it runs
    unscaled."""
    opt = getattr(net, "opt_state", None)
    if not isinstance(opt, dict) or LOSS_SCALE_KEY not in opt:
        return None
    return float(opt[LOSS_SCALE_KEY]["scale"])
