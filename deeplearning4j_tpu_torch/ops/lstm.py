"""Whole-sequence Graves LSTM forward: plain PyTorch version and the
Hopper kernel's wrapper (counterpart of deeplearning4j_tpu/ops/lstm.py).

The op consumes the pre-projected input ``xz[t] = x[t] @ Wx + b`` (one
large matrix product outside the time loop, left to ``torch.matmul`` as
the JAX package leaves it to XLA) and runs the recurrence:

    i = sigmoid(zi + p_i * c_prev)      f = sigmoid(zf + p_f * c_prev)
    g = tanh(zg)                        c = f * c_prev + i * g
    o = sigmoid(zo + p_o * c)           h = o * tanh(c)

with z = xz[t] + h_prev @ Wh, gate order i, f, o, g. Masked steps
(m <= 0) carry (h, c) through unchanged and emit h * m.

Both versions follow the numerics of the JAX package's Pallas kernel
(``_fwd_kernel``), not those of its lax.scan backend: the (h, c) carry is
f32, h_prev is rounded to the compute dtype before the product with Wh,
products accumulate in f32, gates are computed in f32, and outputs are
rounded to the compute dtype.

Dispatch is by device (ops/registry.py): a CPU tensor runs
``lstm_sequence_torch``; a CUDA tensor launches ``csrc/lstm_fwd.cu`` or
raises. The CUDA route replaces deeplearning4j_tpu/ops/lstm.py::_fwd_kernel;
its source note says what bounds it and what its design does about it.
The backward kernel (``_bwd_kernel``) belongs to the training slice, so a
CUDA tensor that requires grad is refused here.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.ops import activations as act_mod
from deeplearning4j_tpu_torch.ops import registry

KERNEL = "lstm_fwd"


class LstmOut(NamedTuple):
    y: torch.Tensor            # [T, b, n]
    hT: torch.Tensor           # [b, n]
    cT: torch.Tensor           # [b, n]
    # residuals, only when asked for: gates [T, b, 4n] (i, f, o, g) and the
    # carry each step started from, [T, b, n] each
    G: Optional[torch.Tensor] = None
    h_prev: Optional[torch.Tensor] = None
    c_prev: Optional[torch.Tensor] = None


def lstm_sequence(xz_t, h0, c0, Wh, p, mask_t=None, *, gate_act="sigmoid",
                  cell_act="tanh", save_residuals=False) -> LstmOut:
    """Time-major LSTM over pre-projected inputs.

    xz_t [T, b, 4n] in the compute dtype; h0, c0 [b, n]; Wh [n, 4n];
    p [3, n] peepholes; mask_t [T, b] or None."""
    impl = registry.get("lstm_sequence", xz_t.device)
    return impl(xz_t, h0, c0, Wh, p, mask_t, gate_act=gate_act,
                cell_act=cell_act, save_residuals=save_residuals)


# ---------------------------------------------------------------- plain
@registry.register("lstm_sequence", "cpu")
def lstm_sequence_torch(xz_t, h0, c0, Wh, p, mask_t=None, *,
                        gate_act="sigmoid", cell_act="tanh",
                        save_residuals=False) -> LstmOut:
    """A Python loop over T with the kernel's numerics: the CPU path, and
    the yardstick the kernel is held against on the card."""
    ga = act_mod.get(gate_act)
    ca = act_mod.get(cell_act)
    cd = xz_t.dtype
    T = xz_t.shape[0]
    n = h0.shape[-1]
    W = Wh.to(cd).float()
    pv = p.to(cd).float()
    h = h0.to(cd).float()
    c = c0.to(cd).float()
    m_all = None if mask_t is None else mask_t.to(cd).float()
    ys, Gs, hps, cps = [], [], [], []
    for t in range(T):
        z = xz_t[t].float() + h.to(cd).float() @ W
        i = ga(z[:, :n] + pv[0] * c)
        f = ga(z[:, n:2 * n] + pv[1] * c)
        g = ca(z[:, 3 * n:])
        c_new = f * c + i * g
        o = ga(z[:, 2 * n:3 * n] + pv[2] * c_new)
        h_new = o * ca(c_new)
        if save_residuals:
            Gs.append(torch.cat([i, f, o, g], dim=-1).to(cd))
            hps.append(h.to(cd))
            cps.append(c.to(cd))
        if m_all is None:
            ys.append(h_new.to(cd))
            h, c = h_new, c_new
        else:
            m = m_all[t][:, None]
            ys.append((h_new * m).to(cd))
            keep = m > 0
            h = torch.where(keep, h_new, h)
            c = torch.where(keep, c_new, c)
    out = LstmOut(torch.stack(ys), h.to(cd), c.to(cd))
    if save_residuals:
        out = out._replace(G=torch.stack(Gs), h_prev=torch.stack(hps),
                           c_prev=torch.stack(cps))
    return out


# ----------------------------------------------------------------- cuda
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    if getattr(lib, "_dl4j_bound", False):
        return lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dl4j_lstm_fwd.argtypes = ([i32] + [ptr] * 14 + [i32] * 4 + [ptr])
    lib.dl4j_lstm_fwd.restype = i32
    lib.dl4j_lstm_fwd_smem_bytes.argtypes = [i32, i32]
    lib.dl4j_lstm_fwd_smem_bytes.restype = i32
    lib.dl4j_cuda_error_string.argtypes = [i32]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    lib._dl4j_bound = True
    return lib


def _check_cuda_inputs(xz_t, h0, c0, Wh, p, mask_t, gate_act, cell_act):
    if gate_act != "sigmoid" or cell_act != "tanh":
        raise NotImplementedError(
            f"the CUDA LSTM kernel computes sigmoid gates and a tanh cell; "
            f"gate_act={gate_act!r}, cell_act={cell_act!r} has no kernel yet")
    cd = xz_t.dtype
    if cd not in _DTYPE_CODES:
        raise NotImplementedError(
            f"the CUDA LSTM kernel takes float32 or bfloat16, got {cd}")
    if xz_t.dim() != 3 or xz_t.shape[2] % 4:
        raise ValueError(f"xz_t must be [T, b, 4n], got {tuple(xz_t.shape)}")
    T, b, n4 = xz_t.shape
    n = n4 // 4
    if T < 1 or b < 1 or n < 1:
        raise ValueError(f"empty LSTM input {tuple(xz_t.shape)}")
    want = {"h0": (h0, (b, n)), "c0": (c0, (b, n)), "Wh": (Wh, (n, n4)),
            "p": (p, (3, n)), "mask_t": (mask_t, (T, b))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != cd:
            raise ValueError(f"{name} is {x.dtype}; the kernel needs every "
                             f"input in the compute dtype {cd}")
        if x.device != xz_t.device:
            raise ValueError(f"{name} is on {x.device}, xz_t on "
                             f"{xz_t.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not xz_t.is_contiguous():
        raise ValueError("xz_t must be contiguous")
    if any(x.requires_grad for x in (xz_t, h0, c0, Wh, p)):
        raise NotImplementedError(
            "the LSTM backward kernel is not ported yet; run the CUDA "
            "forward under torch.inference_mode() or torch.no_grad()")
    return T, b, n


@registry.register("lstm_sequence", "cuda")
def lstm_sequence_cuda(xz_t, h0, c0, Wh, p, mask_t=None, *,
                       gate_act="sigmoid", cell_act="tanh",
                       save_residuals=False) -> LstmOut:
    """Launch csrc/lstm_fwd.cu on the current stream. Raises on what the
    kernel does not take; never falls back to the plain version."""
    from deeplearning4j_tpu_torch.ops import _build

    if xz_t.device.type != "cuda":
        raise ValueError(f"the CUDA LSTM kernel needs CUDA tensors, got "
                         f"{xz_t.device}")
    cd = xz_t.dtype
    if mask_t is None:
        mask_t = torch.ones(xz_t.shape[:2], dtype=cd, device=xz_t.device)
    T, b, n = _check_cuda_inputs(xz_t, h0, c0, Wh, p, mask_t, gate_act,
                                 cell_act)
    lib = _bind(_build.load(KERNEL))
    dev = xz_t.device
    empty = lambda *shape: torch.empty(shape, dtype=cd, device=dev)  # noqa: E731
    y, hT, cT = empty(T, b, n), empty(b, n), empty(b, n)
    G = hprev = cprev = None
    if save_residuals:
        G, hprev, cprev = empty(T, b, 4 * n), empty(T, b, n), empty(T, b, n)
    # f32 carry scratch. It may be freed as soon as this returns: the
    # caching allocator reuses it only for work queued after the kernel on
    # this stream.
    hbuf = torch.empty((2, b, n), dtype=torch.float32, device=dev)
    cbuf = torch.empty((b, n), dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dl4j_lstm_fwd(
            _DTYPE_CODES[cd], ptr(xz_t), ptr(mask_t), ptr(h0), ptr(c0),
            ptr(Wh), ptr(p), ptr(y), ptr(hT), ptr(cT), ptr(G), ptr(hprev),
            ptr(cprev), ptr(hbuf), ptr(cbuf), T, b, n, int(save_residuals),
            stream)
    if rc != 0:
        msg = lib.dl4j_cuda_error_string(rc).decode()
        raise RuntimeError(
            f"lstm_fwd kernel launch failed (T={T}, b={b}, n={n}, {cd}, "
            f"{lib.dl4j_lstm_fwd_smem_bytes(_DTYPE_CODES[cd], n)} B shared "
            f"memory per block): cudaError {rc}: {msg}")
    registry.count_launch(KERNEL)
    return LstmOut(y, hT, cT, G, hprev, cprev)
