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

Besides: the 1-D convolution on [N, T, C], p-norm pooling, across-channel
LRN, and the JAX package's two exact stride-2 rewrites (space-to-depth
for a few-channel stem, a strided 1x1 as slice + 1x1), which
``ConvolutionLayer`` selects only under ``DL4J_TPU_S2D_STEM=1`` /
``DL4J_TPU_SLICE_1X1=1``.
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
    forward and backward (``ConvF32``)."""
    x, sym = _pad_nhwc(x, padding)
    return _nhwc(_conv(_nchw(x), w.permute(3, 2, 0, 1), tuple(strides),
                       tuple(sym), tuple(dilation)))


def conv1d(x, w, *, stride, padding, dilation=1):
    """x: [N, T, C], w: [k, C_in, C_out] (WIO), padding: [(lo, hi)] ->
    [N, T', C_out]; f32 without TF32, as ``conv2d``."""
    (lo, hi), = padding
    if lo != hi:
        x = F.pad(x, (0, 0, lo, hi))
        lo = 0
    y = _conv(x.transpose(1, 2), w.permute(2, 1, 0), (int(stride),), (lo,),
              (int(dilation),))
    return y.transpose(1, 2).contiguous()


def _conv(x, w, stride, padding, dilation):
    """``F.conv1d``/``F.conv2d`` of channels-first x and OI(H)W w."""
    if x.dtype == torch.float32:
        return ConvF32.apply(x, w, stride, padding, dilation)
    fn = F.conv1d if x.dim() == 3 else F.conv2d
    return fn(x, w, stride=stride, padding=padding, dilation=dilation)


def _no_tf32():
    """cuDNN's flags with TF32 off and every other flag left as it stands
    (None sets nothing)."""
    return torch.backends.cudnn.flags(enabled=None, benchmark=None,
                                      benchmark_limit=None,
                                      deterministic=None, allow_tf32=False)


class ConvF32(torch.autograd.Function):
    """``F.conv1d``/``F.conv2d`` of f32 tensors with cuDNN's TF32 off in
    the forward and in the backward: autograd's own backward would read
    the global flag when it runs, after any context around the forward
    has closed."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation)
        fn = F.conv1d if x.dim() == 3 else F.conv2d
        with _no_tf32():
            return fn(x, w, stride=stride, padding=padding,
                      dilation=dilation)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation = ctx.conf
        with _no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, list(stride), list(padding), list(dilation),
                False, [0] * len(stride), 1,
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



def pnorm_pool2d(x, *, kernel, strides, padding, p, eps=1e-8):
    """P-norm pooling, (sum |x|^p + eps)^(1/p) over each window, eps inside
    the root (PoolingType.PNORM); padded positions add 0."""
    x, sym = _pad_nhwc(torch.abs(x) ** p, padding)
    summed = F.avg_pool2d(_nchw(x), tuple(kernel), tuple(strides),
                          padding=sym, divisor_override=1)
    return _nhwc((summed + eps) ** (1.0 / p))


# ---------------------------------------------------------------------------
# Local response normalization (LocalResponseNormalization.java)
# ---------------------------------------------------------------------------

def lrn(x, *, k=2.0, n=5, alpha=1e-4, beta=0.75):
    """Across-channel LRN on NHWC: y = x / (k + alpha * sum x^2)^beta, the
    sum over the channel window [c - n//2, c + n-1-n//2] (zeros past the
    ends). Not ``F.local_response_norm``: that one divides alpha by n,
    works on dim 1 and centres an even window the other way."""
    half = n // 2
    sq = F.pad(x * x, (half, n - 1 - half))
    ssum = sq.unfold(-1, n, 1).sum(-1)
    return x / (k + alpha * ssum) ** beta


# ---------------------------------------------------------------------------
# Exact stride-2 conv rewrites (off by default; nn/layers/convolution.py)
# ---------------------------------------------------------------------------

def conv2d_space_to_depth(x, w, *, padding):
    """An odd-kernel stride-2 conv as a stride-1 VALID conv on 2x2 blocks
    folded into channels, with the kernel zero-padded to even size and
    re-blocked the same way: y[i, j] = sum w[di, dj, c] xp[2i+di, 2j+dj, c]
    with di = 2p+a, dj = 2q+b is a (kh+1)/2 x (kw+1)/2 window over the
    block grid. The same function as ``conv2d`` (the JAX package's
    ``conv2d_space_to_depth``)."""
    n, h, wd, c = x.shape
    kh, kw, _, c_out = w.shape
    (lo_h, hi_h), (lo_w, hi_w) = padding
    big_kh, big_kw = kh + (kh % 2), kw + (kw % 2)
    out_h = (h + lo_h + hi_h - kh) // 2 + 1
    out_w = (wd + lo_w + hi_w - kw) // 2 + 1
    pad_h = 2 * (out_h - 1) + big_kh
    pad_w = 2 * (out_w - 1) + big_kw
    xp = F.pad(x, (0, 0, lo_w, pad_w - wd - lo_w, lo_h, pad_h - h - lo_h))
    xsd = xp.reshape(n, pad_h // 2, 2, pad_w // 2, 2, c)
    xsd = xsd.permute(0, 1, 3, 2, 4, 5).reshape(
        n, pad_h // 2, pad_w // 2, 4 * c)
    w8 = F.pad(w, (0, 0, 0, 0, 0, big_kw - kw, 0, big_kh - kh))
    wsd = w8.reshape(big_kh // 2, 2, big_kw // 2, 2, c, c_out)
    wsd = wsd.permute(0, 2, 1, 3, 4, 5).reshape(
        big_kh // 2, big_kw // 2, 4 * c, c_out)
    return conv2d(xsd.contiguous(), wsd, strides=(1, 1),
                  padding=[(0, 0), (0, 0)])


def conv2d_strided_1x1_as_slice(x, w, *, strides):
    """An unpadded strided 1x1 conv as a slice and a 1x1 stride-1 conv (the
    JAX package's ``conv2d_strided_1x1_as_slice``)."""
    sh, sw = strides
    return conv2d(x[:, ::sh, ::sw, :].contiguous(), w, strides=(1, 1),
                  padding=[(0, 0), (0, 0)])
