"""Whole-sequence Graves LSTM, forward and backward: plain PyTorch versions
and the Hopper kernels' wrappers (counterpart of
deeplearning4j_tpu/ops/lstm.py).

The op consumes the pre-projected input ``xz[t] = x[t] @ Wx + b`` (one
large matrix product outside the time loop, left to ``torch.matmul`` as
the JAX package leaves it to XLA) and runs the recurrence:

    i = sigmoid(zi + p_i * c_prev)      f = sigmoid(zf + p_f * c_prev)
    g = tanh(zg)                        c = f * c_prev + i * g
    o = sigmoid(zo + p_o * c)           h = o * tanh(c)

with z = xz[t] + h_prev @ Wh, gate order i, f, o, g. Masked steps
(m <= 0) carry (h, c) through unchanged and emit h * m.

Both directions follow the numerics of the JAX package's Pallas kernels
(``_fwd_kernel``, ``_bwd_kernel``), not those of its lax.scan backend: the
carries are f32, h_prev (forward) and dz (backward) are rounded to the
compute dtype before their products, products accumulate in f32, gates
are computed in f32, and outputs are rounded to the compute dtype.

Dispatch is by device (ops/registry.py): a CPU tensor runs the plain
loops; a CUDA tensor launches ``csrc/lstm_fwd.cu`` (op ``lstm_sequence``,
replaces ``_fwd_kernel``) or ``csrc/lstm_bwd.cu`` (op
``lstm_sequence_bwd``, replaces ``_bwd_kernel``), or raises. Each source
note says what bounds the kernel and what its design does about it.

Gradients: ``lstm_sequence`` routes through ``LstmSequenceFn`` when grad
is enabled and an input requires it (sigmoid gates and a tanh cell, the
pair the kernels compute): its forward is the forward op with residuals,
its backward the backward op, as ``_lstm_seq_pallas`` is a
``jax.custom_vjp`` in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.ops import activations as act_mod
from deeplearning4j_tpu_torch.ops import registry

KERNEL = "lstm_fwd"
BWD_KERNEL = "lstm_bwd"


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
    p [3, n] peepholes; mask_t [T, b] or None. Differentiable: with grad
    on, sigmoid/tanh goes through ``LstmSequenceFn`` (the kernels on the
    card); another activation pair is differentiated through the plain
    loop by autograd on the CPU and refused by the CUDA wrapper."""
    if (not save_residuals and (gate_act, cell_act) == ("sigmoid", "tanh")
            and torch.is_grad_enabled()
            and any(x.requires_grad for x in (xz_t, h0, c0, Wh, p))):
        return LstmOut(*LstmSequenceFn.apply(xz_t, h0, c0, Wh, p, mask_t))
    impl = registry.get("lstm_sequence", xz_t.device)
    return impl(xz_t, h0, c0, Wh, p, mask_t, gate_act=gate_act,
                cell_act=cell_act, save_residuals=save_residuals)


class LstmSequenceFn(torch.autograd.Function):
    """The LSTM sequence with its hand-written backward (counterpart of
    ``_lstm_seq_pallas``): the forward op saves the residuals (G, h_prev,
    c_prev), and the backward op computes (dxz, dh0, dc0, dWh, dp) from
    them. Both dispatch by device; cotangents are cast to the compute
    dtype first, as ``_bwd_call`` does."""

    @staticmethod
    def forward(ctx, xz_t, h0, c0, Wh, p, mask_t):
        cd = xz_t.dtype
        if mask_t is None:
            mask_t = torch.ones(xz_t.shape[:2], dtype=cd, device=xz_t.device)
        else:
            mask_t = mask_t.to(cd)
        fwd = registry.get("lstm_sequence", xz_t.device)
        out = fwd(xz_t, h0, c0, Wh, p, mask_t, save_residuals=True)
        ctx.save_for_backward(out.G, out.h_prev, out.c_prev, mask_t, Wh, p)
        return out.y, out.hT, out.cT

    @staticmethod
    def backward(ctx, dy, dhT, dcT):
        G, hprev, cprev, mask_t, Wh, p = ctx.saved_tensors
        cd = G.dtype
        bwd = registry.get("lstm_sequence_bwd", G.device)
        dxz, dh0, dc0, dWh, dp = bwd(
            (G, hprev, cprev), mask_t, Wh, p, dy.to(cd).contiguous(),
            dhT.to(cd).contiguous(), dcT.to(cd).contiguous())
        return dxz, dh0, dc0, dWh, dp, None


# ---------------------------------------------------------------- plain
def _acc_dtype(cd):
    """f32 for the kernels' dtypes; f64 stays f64 (gradient checks)."""
    return torch.promote_types(cd, torch.float32)


@registry.register("lstm_sequence", "cpu")
def lstm_sequence_torch(xz_t, h0, c0, Wh, p, mask_t=None, *,
                        gate_act="sigmoid", cell_act="tanh",
                        save_residuals=False) -> LstmOut:
    """A Python loop over T with the kernel's numerics: the CPU path, and
    the yardstick the kernel is held against on the card."""
    ga = act_mod.get(gate_act)
    ca = act_mod.get(cell_act)
    cd = xz_t.dtype
    acc = _acc_dtype(cd)
    T = xz_t.shape[0]
    n = h0.shape[-1]
    W = Wh.to(cd).to(acc)
    pv = p.to(cd).to(acc)
    h = h0.to(cd).to(acc)
    c = c0.to(cd).to(acc)
    m_all = None if mask_t is None else mask_t.to(cd).to(acc)
    ys, Gs, hps, cps = [], [], [], []
    for t in range(T):
        z = xz_t[t].to(acc) + h.to(cd).to(acc) @ W
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


@registry.register("lstm_sequence_bwd", "cpu")
def lstm_sequence_bwd_torch(residuals, mask_t, Wh, p, dy, dhT, dcT):
    """The backward from the residuals, statement for statement as
    ``_bwd_kernel`` (a Python loop over reversed t): the CPU path, and the
    yardstick K2 is held against on the card.

    residuals = (G [T,b,4n], h_prev [T,b,n], c_prev [T,b,n]) in the
    compute dtype; mask_t [T,b]; Wh [n,4n]; p [3,n]; cotangents dy
    [T,b,n], dhT and dcT [b,n]. Returns (dxz, dh0, dc0, dWh, dp) in the
    compute dtype."""
    G, hprev, cprev = residuals
    cd = G.dtype
    acc = _acc_dtype(cd)
    T, b, n = hprev.shape
    up = lambda x: x.to(cd).to(acc)  # noqa: E731
    W = up(Wh)
    pv = up(p)
    dh_next = up(dhT)
    dc_next = up(dcT)
    dWh = torch.zeros((n, 4 * n), dtype=acc, device=G.device)
    dp = torch.zeros((3, n), dtype=acc, device=G.device)
    dxz = [None] * T
    for t in reversed(range(T)):
        Gt = G[t].to(acc)
        i, f, o, g = (Gt[:, :n], Gt[:, n:2 * n], Gt[:, 2 * n:3 * n],
                      Gt[:, 3 * n:])
        h_prev = hprev[t].to(acc)
        c_prev = cprev[t].to(acc)
        m = up(mask_t[t])[:, None]

        c = f * c_prev + i * g
        tc = torch.tanh(c)

        dh = m * (dh_next + up(dy[t]))
        do = dh * tc
        dzo = do * o * (1.0 - o)
        dc_in = m * dc_next + dh * o * (1.0 - tc * tc) + dzo * pv[2]
        di = dc_in * g
        df = dc_in * c_prev
        dg = dc_in * i
        dzi = di * i * (1.0 - i)
        dzf = df * f * (1.0 - f)
        dzg = dg * (1.0 - g * g)

        dz_cd = torch.cat([dzi, dzf, dzo, dzg], dim=-1).to(cd)
        dza = dz_cd.to(acc)
        dh_prev = dza @ W.T + (1.0 - m) * dh_next
        dc_prev = (dc_in * f + dzi * pv[0] + dzf * pv[1]
                   + (1.0 - m) * dc_next)

        dWh += h_prev.T @ dza
        dp[0] += torch.sum(dzi * c_prev, dim=0)
        dp[1] += torch.sum(dzf * c_prev, dim=0)
        dp[2] += torch.sum(dzo * c, dim=0)

        dxz[t] = dz_cd
        dh_next, dc_next = dh_prev, dc_prev
    return (torch.stack(dxz), dh_next.to(cd), dc_next.to(cd), dWh.to(cd),
            dp.to(cd))


# ----------------------------------------------------------------- cuda
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(kernel, n_ptrs, n_ints):
    """The loaded library of ``kernel`` with its C entry points typed:
    ``dl4j_<kernel>(dtype, n_ptrs pointers, n_ints ints, stream)``,
    ``dl4j_<kernel>_smem_bytes`` and ``dl4j_cuda_error_string``."""
    from deeplearning4j_tpu_torch.ops import _build

    lib = _build.load(kernel)
    if getattr(lib, "_dl4j_bound", False):
        return lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"dl4j_{kernel}")
    fn.argtypes = [i32] + [ptr] * n_ptrs + [i32] * n_ints + [ptr]
    fn.restype = i32
    smem = getattr(lib, f"dl4j_{kernel}_smem_bytes")
    smem.argtypes = [i32, i32]
    smem.restype = i32
    lib.dl4j_cuda_error_string.argtypes = [i32]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    lib._dl4j_bound = True
    return lib


def _check_like(cd, device, want: dict):
    """Every tensor in ``want`` ({name: (tensor, shape)}) has that shape,
    the compute dtype ``cd``, lies on ``device`` and is contiguous."""
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != cd:
            raise ValueError(f"{name} is {x.dtype}; the kernel needs every "
                             f"input in the compute dtype {cd}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_dtype(cd):
    if cd not in _DTYPE_CODES:
        raise NotImplementedError(
            f"the CUDA LSTM kernels take float32 or bfloat16, got {cd}")


def _check_cuda_inputs(xz_t, h0, c0, Wh, p, mask_t, gate_act, cell_act):
    if gate_act != "sigmoid" or cell_act != "tanh":
        raise NotImplementedError(
            f"the CUDA LSTM kernel computes sigmoid gates and a tanh cell; "
            f"gate_act={gate_act!r}, cell_act={cell_act!r} has no kernel yet")
    cd = xz_t.dtype
    _check_dtype(cd)
    if xz_t.dim() != 3 or xz_t.shape[2] % 4:
        raise ValueError(f"xz_t must be [T, b, 4n], got {tuple(xz_t.shape)}")
    T, b, n4 = xz_t.shape
    n = n4 // 4
    if T < 1 or b < 1 or n < 1:
        raise ValueError(f"empty LSTM input {tuple(xz_t.shape)}")
    _check_like(cd, xz_t.device, {
        "xz_t": (xz_t, (T, b, n4)), "h0": (h0, (b, n)), "c0": (c0, (b, n)),
        "Wh": (Wh, (n, n4)), "p": (p, (3, n)), "mask_t": (mask_t, (T, b))})
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (xz_t, h0, c0, Wh, p)):
        raise NotImplementedError(
            "the CUDA forward wrapper records no graph; call lstm_sequence, "
            "which differentiates through LstmSequenceFn (the backward "
            "kernel), or run under torch.inference_mode()/torch.no_grad()")
    return T, b, n


@registry.register("lstm_sequence", "cuda")
def lstm_sequence_cuda(xz_t, h0, c0, Wh, p, mask_t=None, *,
                       gate_act="sigmoid", cell_act="tanh",
                       save_residuals=False) -> LstmOut:
    """Launch csrc/lstm_fwd.cu on the current stream. Raises on what the
    kernel does not take; never falls back to the plain version."""
    if xz_t.device.type != "cuda":
        raise ValueError(f"the CUDA LSTM kernel needs CUDA tensors, got "
                         f"{xz_t.device}")
    cd = xz_t.dtype
    if mask_t is None:
        mask_t = torch.ones(xz_t.shape[:2], dtype=cd, device=xz_t.device)
    T, b, n = _check_cuda_inputs(xz_t, h0, c0, Wh, p, mask_t, gate_act,
                                 cell_act)
    lib = _bind(KERNEL, n_ptrs=14, n_ints=4)
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


def _check_cuda_bwd_inputs(residuals, mask_t, Wh, p, dy, dhT, dcT):
    G, hprev, cprev = residuals
    cd = G.dtype
    _check_dtype(cd)
    if G.dim() != 3 or G.shape[2] % 4:
        raise ValueError(f"G must be [T, b, 4n], got {tuple(G.shape)}")
    T, b, n4 = G.shape
    n = n4 // 4
    if T < 1 or b < 1 or n < 1:
        raise ValueError(f"empty LSTM residuals {tuple(G.shape)}")
    _check_like(cd, G.device, {
        "G": (G, (T, b, n4)), "h_prev": (hprev, (T, b, n)),
        "c_prev": (cprev, (T, b, n)), "mask_t": (mask_t, (T, b)),
        "Wh": (Wh, (n, n4)), "p": (p, (3, n)), "dy": (dy, (T, b, n)),
        "dhT": (dhT, (b, n)), "dcT": (dcT, (b, n))})
    return T, b, n


@registry.register("lstm_sequence_bwd", "cuda")
def lstm_sequence_bwd_cuda(residuals, mask_t, Wh, p, dy, dhT, dcT):
    """Launch csrc/lstm_bwd.cu (the reverse chain, then dWh) on the current
    stream. Raises on what the kernel does not take; never falls back to
    the plain version."""
    G = residuals[0]
    if G.device.type != "cuda":
        raise ValueError(f"the CUDA LSTM backward kernel needs CUDA tensors, "
                         f"got {G.device}")
    T, b, n = _check_cuda_bwd_inputs(residuals, mask_t, Wh, p, dy, dhT, dcT)
    cd = G.dtype
    lib = _bind(BWD_KERNEL, n_ptrs=16, n_ints=3)
    dev = G.device
    empty = lambda *shape: torch.empty(shape, dtype=cd, device=dev)  # noqa: E731
    dxz, dh0, dc0 = empty(T, b, 4 * n), empty(b, n), empty(b, n)
    dWh, dp = empty(n, 4 * n), empty(3, n)
    # f32 (dh, dc) carry scratch, freed as for the forward
    dhbuf = torch.empty((b, n), dtype=torch.float32, device=dev)
    dcbuf = torch.empty((b, n), dtype=torch.float32, device=dev)
    _, hprev, cprev = residuals
    args = [x.data_ptr() for x in (G, cprev, hprev, mask_t, Wh, p, dy, dhT,
                                   dcT, dxz, dh0, dc0, dWh, dp, dhbuf,
                                   dcbuf)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dl4j_lstm_bwd(_DTYPE_CODES[cd], *args, T, b, n, stream)
    if rc != 0:
        msg = lib.dl4j_cuda_error_string(rc).decode()
        raise RuntimeError(
            f"lstm_bwd kernel launch failed (T={T}, b={b}, n={n}, {cd}, "
            f"{lib.dl4j_lstm_bwd_smem_bytes(_DTYPE_CODES[cd], n)} B shared "
            f"memory per block): cudaError {rc}: {msg}")
    registry.count_launch(BWD_KERNEL, 2)  # the chain, then the dWh GEMM
    return dxz, dh0, dc0, dWh, dp
