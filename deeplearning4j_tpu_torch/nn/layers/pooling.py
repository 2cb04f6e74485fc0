"""Global pooling runtime layer (counterpart of
deeplearning4j_tpu/nn/layers/pooling.py): max / avg / sum / pnorm over
the spatial dims of [b, h, w, c] or the time axis of an unmasked
[b, t, f]. Masked time series are not ported and are refused."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer


class GlobalPoolingLayerImpl(Layer):
    def feed_forward_mask(self, mask):
        return None

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        c = self.conf
        if x.dim() == 3:
            if mask is not None:
                raise NotImplementedError(
                    "GlobalPooling over a masked time series is not ported "
                    "to deeplearning4j_tpu_torch yet")
            axes = (1,)
        elif x.dim() == 4:
            axes = (1, 2)
        else:
            raise ValueError(
                f"GlobalPooling expects 3d or 4d input, got shape "
                f"{tuple(x.shape)}")
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
