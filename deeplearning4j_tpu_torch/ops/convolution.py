"""Convolution and pooling ops (counterpart of
deeplearning4j_tpu/ops/convolution.py).

Layouts are the JAX package's: activations NHWC, weights HWIO. The shape
math (``pair``, ``out_size``, ``_same_pads``, ``spatial_padding``) follows
the reference's ConvolutionMode: ``truncate`` floors partial windows,
``strict`` requires an exact fit, ``same`` pads to ceil(in / stride).

The JAX package leaves convolution to XLA; here it goes to
``F.conv2d`` (cuDNN on the card) through channels-last views of the NHWC
tensors, so no layout copy is made. ``F.conv2d`` and the pooling functions
pad only symmetrically, so an asymmetric SAME padding (the 7x7/s2 stem at
224 pads (2, 3), the 3x3/s2 max pool at 112 pads (0, 1)) is applied first:
zeros for convolution and average pooling, -inf for max pooling.

An f32 convolution runs with cuDNN's TF32 off, whatever the caller's
``torch.backends.cudnn.allow_tf32`` says (PyTorch's default is on): the
JAX package's F32 convolution rounds no input to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# ConvolutionMode shape math (shared by configs and runtime)
# ---------------------------------------------------------------------------

def pair(v):
    """Normalize an int-or-pair spec to a (h, w) tuple."""
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def out_size(in_size: int, kernel: int, stride: int, pad: int,
             mode: str, dilation: int = 1) -> int:
    """Output length along one spatial dim for a ConvolutionMode."""
    eff_k = (kernel - 1) * dilation + 1
    if mode == "same":
        return -(-in_size // stride)  # ceil
    n = in_size + 2 * pad - eff_k
    if mode == "strict":
        if n % stride != 0:
            raise ValueError(
                f"ConvolutionMode=strict: (in={in_size} + 2*pad={pad} - "
                f"kernel={eff_k}) = {n} is not divisible by stride={stride}. "
                f"Use mode='truncate' or 'same', or adjust the geometry")
        return n // stride + 1
    if n < 0:
        raise ValueError(
            f"Kernel {eff_k} larger than padded input {in_size + 2 * pad}")
    return n // stride + 1  # truncate


def _same_pads(in_size: int, kernel: int, stride: int, dilation: int = 1):
    eff_k = (kernel - 1) * dilation + 1
    out = -(-in_size // stride)
    total = max((out - 1) * stride + eff_k - in_size, 0)
    return total // 2, total - total // 2


def spatial_padding(in_sizes, kernels, strides, pads, mode, dilations=None):
    """Per-dim (lo, hi) padding pairs implementing a ConvolutionMode."""
    dilations = dilations or [1] * len(in_sizes)
    if mode == "same":
        return [
            _same_pads(i, k, s, d)
            for i, k, s, d in zip(in_sizes, kernels, strides, dilations)
        ]
    return [(p, p) for p in pads]


def _pad_nhwc(x, padding, value=0.0):
    """``x`` [N, H, W, C] padded by ((h_lo, h_hi), (w_lo, w_hi)) with
    ``value``, and the symmetric remainder left to the caller: returns
    (x padded asymmetrically where needed, (ph, pw) symmetric pads)."""
    (h_lo, h_hi), (w_lo, w_hi) = padding
    if h_lo == h_hi and w_lo == w_hi:
        return x, (h_lo, w_lo)
    x = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi), value=value)
    return x, (0, 0)


def _nchw(x):
    """The NCHW view of a contiguous NHWC tensor (channels-last strides)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    """The NHWC view of a channels-last NCHW result, made contiguous."""
    return y.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------

def conv2d(x, w, *, strides, padding, dilation=(1, 1)):
    """x: [N, H, W, C], w: [kH, kW, C_in, C_out] (HWIO), padding:
    [(lo, hi), (lo, hi)] -> [N, H', W', C_out]. f32 runs without TF32,
    forward and backward (``Conv2dF32``)."""
    x, sym = _pad_nhwc(x, padding)
    args = (_nchw(x), w.permute(3, 2, 0, 1), tuple(strides), tuple(sym),
            tuple(dilation))
    if x.dtype == torch.float32:
        return _nhwc(Conv2dF32.apply(*args))
    return _nhwc(F.conv2d(args[0], args[1], stride=args[2], padding=args[3],
                          dilation=args[4]))


def _no_tf32():
    """cuDNN's flags with TF32 off and every other flag left as it stands
    (None sets nothing)."""
    return torch.backends.cudnn.flags(enabled=None, benchmark=None,
                                      benchmark_limit=None,
                                      deterministic=None, allow_tf32=False)


class Conv2dF32(torch.autograd.Function):
    """``F.conv2d`` of f32 tensors with cuDNN's TF32 off in the forward and
    in the backward: autograd's own backward would read the global flag
    when it runs, after any context around the forward has closed."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation)
        with _no_tf32():
            return F.conv2d(x, w, stride=stride, padding=padding,
                            dilation=dilation)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation = ctx.conf
        with _no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, list(stride), list(padding), list(dilation),
                False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None


# ---------------------------------------------------------------------------
# Pooling (SubsamplingLayer.java semantics)
# ---------------------------------------------------------------------------

def max_pool2d(x, *, kernel, strides, padding):
    """Max over windows; padded positions hold -inf, so they never win."""
    (h_lo, h_hi), (w_lo, w_hi) = padding
    if h_lo or h_hi or w_lo or w_hi:
        x = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi), value=float("-inf"))
    y = F.max_pool2d(_nchw(x), tuple(kernel), tuple(strides))
    return _nhwc(y)


def avg_pool2d(x, *, kernel, strides, padding):
    """Average pooling dividing by the FULL kernel area (padding
    included), as the reference's AVG pooling does."""
    x, sym = _pad_nhwc(x, padding)
    y = F.avg_pool2d(_nchw(x), tuple(kernel), tuple(strides), padding=sym,
                     count_include_pad=True)
    return _nhwc(y)

