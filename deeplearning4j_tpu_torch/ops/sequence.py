"""Sequence and masking helpers shared by recurrent layers (counterpart of
deeplearning4j_tpu/ops/sequence.py)."""

from __future__ import annotations

import torch


def last_unmasked_step(x, mask):
    """[b, t, f] -> [b, f]: the last step, or the last unmasked step of
    each example when a [b, t] mask is given (the last nonzero entry, so
    end-aligned padding and gaps are right; an all-masked row takes
    step 0)."""
    if mask is None:
        return x[:, -1, :]
    m = mask.reshape(mask.shape[0], -1) > 0
    t = m.shape[1]
    last_nz = (t - 1) - torch.argmax(torch.flip(m, dims=(1,)).to(torch.int32),
                                     dim=1)
    idx = torch.where(m.any(dim=1), last_nz, torch.zeros_like(last_nz))
    return x[torch.arange(x.shape[0], device=x.device), idx, :]
