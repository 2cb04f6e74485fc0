"""Global pooling runtime layer (counterpart of
deeplearning4j_tpu/nn/layers/pooling.py): max / avg / sum / pnorm over
the spatial dims of [b, h, w, c] or the time axis of [b, t, f]. A time
series with a [b, t] mask reduces over its unmasked steps with the
reference's MaskedReductionUtil semantics: max fills masked steps with
the dtype's lowest finite value, avg divides by max(sum of the mask,
1e-8), pnorm adds no eps (p-norm pooling's eps is inside its root)."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer


class GlobalPoolingLayerImpl(Layer):
    def feed_forward_mask(self, mask):
        return None

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        c = self.conf
        m = None
        if x.dim() == 3:
            axes = (1,)
            if mask is not None:
                m = mask.reshape(mask.shape[0], -1)[:, :, None].to(x.dtype)
        elif x.dim() == 4:
            axes = (1, 2)
        else:
            raise ValueError(
                f"GlobalPooling expects 3d or 4d input, got shape "
                f"{tuple(x.shape)}")
        if m is not None:
            return _masked_pool(x, m, c.pooling, c.pnorm), state
        if c.pooling == "max":
            y = torch.amax(x, dim=axes)
        elif c.pooling == "avg":
            y = torch.mean(x, dim=axes)
        elif c.pooling == "sum":
            y = torch.sum(x, dim=axes)
        elif c.pooling == "pnorm":
            y = torch.sum(torch.abs(x) ** c.pnorm, dim=axes) ** (1.0 / c.pnorm)
        else:
            raise ValueError(f"Unknown pooling type: {c.pooling}")
        return y, state


def _masked_pool(x, m, pooling, pnorm):
    """[b, t, f] reduced over the steps where the [b, t, 1] mask m > 0."""
    if pooling == "max":
        low = torch.finfo(x.dtype).min
        return torch.amax(torch.where(m > 0, x, low), dim=1)
    if pooling == "avg":
        denom = torch.clamp(torch.sum(m, dim=1), min=1e-8)
        return torch.sum(x * m, dim=1) / denom
    if pooling == "sum":
        return torch.sum(x * m, dim=1)
    if pooling == "pnorm":
        return torch.sum(torch.abs(x * m) ** pnorm, dim=1) ** (1.0 / pnorm)
    raise ValueError(f"Unknown pooling type: {pooling}")
