"""Selective rematerialization spans (counterpart of the JAX package's
``_remat_match``/``_remat_prefixes`` and the remat spans of
deeplearning4j_tpu/nn/{graph,multilayer}.py).

``DL4J_TPU_REMAT`` holds comma-separated vertex- or layer-name prefixes; a
trailing ``$`` anchors an exact name (``layer_1$`` does not match
``layer_10``). A net reads it once, when its first train step runs
(``resolve``), and warns if it changes later. Each maximal contiguous run
of matching vertices (layers, in a MultiLayerNetwork) runs under one
non-reentrant ``torch.utils.checkpoint``: only the span's inputs are
saved, its interior is recomputed in the backward. Default off.

Dropout inside a span. The port draws its masks from the net's own
``torch.Generator``, which ``checkpoint`` neither saves nor restores, so a
recompute would draw other masks and the gradient would be wrong. A span
therefore records the keep masks its forward draws (``keep_mask``) and its
recompute replays them, in order, without touching the generator: the
forward draws once, as without remat, and nothing is read from or written
to the generator's state, so the span also captures in a CUDA graph. The
recorded masks (bool, one per dropout in the span) stay alive until the
backward, the one thing a span saves besides its inputs.

The layers return their new state (batch-norm running statistics) as
values, so the state a span returns is its forward's; a recompute's is
dropped with the rest of its outputs.
"""

from __future__ import annotations

import os
import threading
import warnings

import torch
from torch.utils.checkpoint import checkpoint

ENV = "DL4J_TPU_REMAT"


def match(name: str, prefixes) -> bool:
    """Prefix match; a trailing ``$`` anchors an exact name."""
    for p in prefixes:
        if p.endswith("$"):
            if name == p[:-1]:
                return True
        elif name.startswith(p):
            return True
    return False


def prefixes() -> tuple:
    """The prefixes ``DL4J_TPU_REMAT`` names now."""
    v = os.environ.get(ENV, "").strip()
    return tuple(p for p in (s.strip() for s in v.split(",")) if p)


def resolve(net) -> tuple:
    """The net's prefixes: read once, at its first train step, and kept
    in ``net.remat_prefixes``; a later change of the variable warns once
    and is ignored, as the JAX package's cached step ignores it."""
    current = prefixes()
    if net.remat_prefixes is None:
        net.remat_prefixes = current
    elif current != net.remat_prefixes and not net._remat_warned:
        warnings.warn(
            f"{ENV} changed to {current!r} after the train step was built "
            f"with {net.remat_prefixes!r}; the net ignores the change (set "
            "the variable before the first training step, or rebuild the "
            "model)", RuntimeWarning, stacklevel=3)
        net._remat_warned = True
    return net.remat_prefixes


def active(net) -> tuple:
    """The prefixes a training walk uses: the resolved ones, else the
    variable as it stands (a walk outside a train step)."""
    return (net.remat_prefixes if net.remat_prefixes is not None
            else prefixes())


class _Tape:
    """The keep masks a span's forward drew, replayed by its recompute."""

    def __init__(self):
        self.masks = []


class _OnTape:
    """Makes ``tape`` the calling thread's tape while entered: recording
    (the span's forward) or replaying from its first mask (a recompute).
    Reusable: a recompute enters it again."""

    def __init__(self, tape, replay: bool):
        self.tape, self.replay = tape, replay

    def __enter__(self):
        self.outer = getattr(_LOCAL, "cursor", None)
        _LOCAL.cursor = [self.tape, self.replay, 0]

    def __exit__(self, *exc):
        _LOCAL.cursor = self.outer


# per thread: [tape, replaying, next mask] of the span running on it
_LOCAL = threading.local()


def keep_mask(shape, keep: float, gen, device):
    """A dropout keep mask (``rand < keep`` from ``gen``); inside a remat
    span, recorded by the forward and replayed by the recompute."""
    cur = getattr(_LOCAL, "cursor", None)
    if cur is not None and cur[1]:
        cur[2] += 1
        return cur[0].masks[cur[2] - 1]
    m = torch.rand(shape, generator=gen, device=device) < keep
    if cur is not None:
        cur[0].masks.append(m)
    return m


def run_span(fn, *args):
    """``fn(*args)`` as one remat span: under a non-reentrant checkpoint
    when grad is on, else plainly. The global RNG states are not saved
    (``preserve_rng_state=False``): a span draws only through
    ``keep_mask``. ``checkpoint`` enters the recording context around the
    forward and the replaying one around each recompute, each on the
    thread that runs it (autograd's, for the card's backward), so the
    tape is that thread's alone."""
    if not torch.is_grad_enabled():
        return fn(*args)
    tape = _Tape()
    return checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (_OnTape(tape, False), _OnTape(tape, True)))
