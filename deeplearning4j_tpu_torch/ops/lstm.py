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
``lstm_sequence_bwd``, replaces ``_bwd_kernel``), or raises. Each kernel
has three routes, chosen by dtype and n only (``kernel_route``): bf16
with n a multiple of 64 up to 512 takes the cluster kernels (Wh resident
in a thread-block cluster of n / 32 blocks, h and dh exchanged through
distributed shared memory, the per-step products and dWh on wgmma; each
call counted once more under ``FWD_SM90`` / ``BWD_SM90``); an n the
persistent-grid kernels hold (``grid_fits``) takes them; a wider n that
the JAX package's Pallas kernel takes runs the wide grid kernels (Wh read
from global memory, each block walking several unit groups; counted once
more under ``FWD_WIDE`` / ``BWD_WIDE``). A failure raises; nothing falls
back. What the JAX package sends to XLA and the kernels do not cover
(another activation pair, a dtype other than f32 and bf16, an n past the
grid kernels' limits that its Pallas kernel would not take either) takes
the composed route, decided by ``lstm_route`` before any launch: the
plain loops on the card's tensors, counted under
``lstm_sequence:composed[<reason>]`` (ops/registry.py).
Each source note says what bounds the kernel and what its design does
about it; ``lstm_sequence_cluster_emulation`` and
``lstm_sequence_bwd_cluster_emulation`` write the cluster route's
decomposition plainly for the tests.

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
# calls on the cluster route (takes_cluster), counted beside the above
FWD_SM90 = "lstm_fwd_sm90"
BWD_SM90 = "lstm_bwd_sm90"
# calls on the wide route (past the grid kernels' limits), counted beside
FWD_WIDE = "lstm_fwd_wide"
BWD_WIDE = "lstm_bwd_wide"
CLUSTER_UNITS = 32   # hidden units a cluster block owns
CLUSTER_ROWS = 32    # batch rows one cluster walks
MAX_CLUSTER = 16     # the largest cluster Hopper schedules (non-portable)


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
    loop by autograd, on the card through the composed route
    (``lstm_route``)."""
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


# ------------------------------------------------- the cluster kernels' plan
# What the cluster route (takes_cluster) splits and how, written plainly:
# the tests hold these against the plain loops above, which shows that the
# decomposition computes the same function. Only the tests use them.
def _rank_columns(n, ranks):
    """The gate columns rank q owns, in its local order g * U + u: units
    [q U, (q + 1) U) of each gate g, U = n / ranks."""
    U = n // ranks
    return [torch.cat([torch.arange(g * n + q * U, g * n + (q + 1) * U)
                       for g in range(4)]) for q in range(ranks)]


def lstm_sequence_cluster_emulation(xz_t, h0, c0, Wh, p, mask_t=None, *,
                                    ranks=MAX_CLUSTER) -> LstmOut:
    """K1's cluster decomposition (sigmoid gates, tanh cell): each step,
    rank q forms z of its 4U columns from its slice Wh[:, columns] and the
    whole of h[t-1] rounded to the compute dtype (its copy, filled by every
    rank), updates its U units, and the new h is gathered from the ranks
    (the DSMEM exchange). Returns what lstm_sequence_torch returns with
    residuals."""
    cd = xz_t.dtype
    acc = _acc_dtype(cd)
    T, n = xz_t.shape[0], h0.shape[-1]
    U = n // ranks
    cols = _rank_columns(n, ranks)
    up = lambda x: x.to(cd).to(acc)  # noqa: E731
    W, pv, h, c = up(Wh), up(p), up(h0), up(c0)
    ys, Gs, hps, cps = [], [], [], []
    for t in range(T):
        hb = up(h)  # every rank's copy of h[t-1]
        m = None if mask_t is None else up(mask_t[t])[:, None]
        outs = []
        for q in range(ranks):
            z = xz_t[t][:, cols[q]].to(acc) + hb @ W[:, cols[q]]
            zi, zf, zo, zg = z.split(U, dim=1)
            own = slice(q * U, (q + 1) * U)
            cp, hp = c[:, own], h[:, own]
            i = torch.sigmoid(zi + pv[0, own] * cp)
            f = torch.sigmoid(zf + pv[1, own] * cp)
            g = torch.tanh(zg)
            cn = f * cp + i * g
            o = torch.sigmoid(zo + pv[2, own] * cn)
            hn = o * torch.tanh(cn)
            y = hn if m is None else hn * m
            if m is not None:
                keep = m > 0
                hn, cn = torch.where(keep, hn, hp), torch.where(keep, cn, cp)
            outs.append((y, hn, cn, (i, f, o, g)))
        ys.append(torch.cat([o[0] for o in outs], dim=1).to(cd))
        Gs.append(torch.cat([torch.cat([o[3][k] for o in outs], dim=1)
                             for k in range(4)], dim=1).to(cd))
        hps.append(h.to(cd))
        cps.append(c.to(cd))
        h = torch.cat([o[1] for o in outs], dim=1)
        c = torch.cat([o[2] for o in outs], dim=1)
    return LstmOut(torch.stack(ys), h.to(cd), c.to(cd), torch.stack(Gs),
                   torch.stack(hps), torch.stack(cps))


def lstm_sequence_bwd_cluster_emulation(residuals, mask_t, Wh, p, dy, dhT,
                                        dcT, *, ranks=MAX_CLUSTER):
    """K2's cluster decomposition: each step, rank q forms dz of its 4U
    columns and dc of its units (phase A), then its partial P_q = Wh[:,
    its columns] dz_q^T for all n units; rank q's dh_prev is the sum of
    rows [q U, (q + 1) U) of P_0, P_1, ... in rank order (the reduce-
    scatter) plus (1 - m) dh_next. dWh = h_prev^T dxz over all T b rows
    after the chain. Returns what lstm_sequence_bwd_torch returns."""
    G, hprev, cprev = residuals
    cd = G.dtype
    acc = _acc_dtype(cd)
    T, b, n = hprev.shape
    U = n // ranks
    cols = _rank_columns(n, ranks)
    up = lambda x: x.to(cd).to(acc)  # noqa: E731
    W, pv = up(Wh), up(p)
    dh, dc = up(dhT), up(dcT)
    dxz = torch.zeros((T, b, 4 * n), dtype=acc)
    dp = torch.zeros((3, n), dtype=acc)
    for t in reversed(range(T)):
        m = up(mask_t[t])[:, None]
        P, dcs = [], []
        for q in range(ranks):
            own = slice(q * U, (q + 1) * U)
            i, f, o, g = G[t][:, cols[q]].to(acc).split(U, dim=1)
            cp = cprev[t][:, own].to(acc)
            c = f * cp + i * g
            tc = torch.tanh(c)
            dhv = m * (dh[:, own] + up(dy[t][:, own]))
            dzo = dhv * tc * o * (1.0 - o)
            dc_in = (m * dc[:, own] + dhv * o * (1.0 - tc * tc)
                     + dzo * pv[2, own])
            dzi = dc_in * g * i * (1.0 - i)
            dzf = dc_in * cp * f * (1.0 - f)
            dzg = dc_in * i * (1.0 - g * g)
            dz = up(torch.cat([dzi, dzf, dzo, dzg], dim=1))
            dxz[t][:, cols[q]] = dz
            P.append(W[:, cols[q]] @ dz.T)
            dcs.append(dc_in * f + dzi * pv[0, own] + dzf * pv[1, own]
                       + (1.0 - m) * dc[:, own])
            dp[0, own] += torch.sum(dzi * cp, dim=0)
            dp[1, own] += torch.sum(dzf * cp, dim=0)
            dp[2, own] += torch.sum(dzo * c, dim=0)
        dh_prev = []
        for q in range(ranks):
            own = slice(q * U, (q + 1) * U)
            s = P[0][own]
            for d in range(1, ranks):
                s = s + P[d][own]
            dh_prev.append(s.T + (1.0 - m) * dh[:, own])
        dh, dc = torch.cat(dh_prev, dim=1), torch.cat(dcs, dim=1)
    dWh = (hprev.reshape(T * b, n).to(acc).T
           @ dxz.reshape(T * b, 4 * n))
    return (dxz.to(cd), dh.to(cd), dc.to(cd), dWh.to(cd), dp.to(cd))


# ----------------------------------------------------------------- cuda
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def takes_cluster(dtype, n) -> bool:
    """Whether K1 and K2 take their cluster route for hidden size ``n``
    in ``dtype``: bf16, and n a multiple of 64 that clusters of at most 16
    blocks of 32 units cover (64 <= n <= 512), so that each block's Wh
    slice [n, 128] and its buffers fit in its shared memory. Decided by
    dtype and n only, never by b, T or the mask: a row served in a bucket
    takes the route it takes alone. Everything else (f32, wider or ragged
    n) takes the grid kernels."""
    return (dtype == torch.bfloat16 and n % 64 == 0
            and 64 <= n <= CLUSTER_UNITS * MAX_CLUSTER)


def fwd_flops(T, b, n) -> int:
    """K1's operations as FlopCounterMode counts its plain version: one
    [b, n] x [n, 4n] product a step (``step_cost_analysis`` adds it, since
    FlopCounterMode does not see a kernel launched through ``ctypes``)."""
    return 8 * T * b * n * n


def bwd_flops(T, b, n) -> int:
    """K2's operations, counted as ``fwd_flops``: dz Whᵀ and h_prevᵀ dz,
    each [b, n] x [n, 4n] a step."""
    return 16 * T * b * n * n


def bwd_launches_per_call(dtype, n) -> int:
    """Device launches one K2 call makes: the chain, the sum of dp's
    partials and dWh on the cluster route; the chain and dWh on the grid
    route."""
    return 3 if takes_cluster(dtype, n) else 2


# entry point -> (pointers, ints) before the stream
_ENTRIES = {
    KERNEL: {"dl4j_lstm_fwd": (14, 4), "dl4j_lstm_fwd_sm90": (12, 4),
             "dl4j_lstm_fwd_wide": (14, 4)},
    BWD_KERNEL: {"dl4j_lstm_bwd": (16, 3), "dl4j_lstm_bwd_sm90": (15, 3),
                 "dl4j_lstm_bwd_wide": (17, 3)},
}


def _bind(kernel):
    """The loaded library of ``kernel`` with its C entry points typed (the
    grid and wide routes' take the dtype code first), their ``_smem_bytes`` and
    ``_sm90_clusters`` queries and ``dl4j_cuda_error_string``."""
    from deeplearning4j_tpu_torch.ops import _build

    lib = _build.load(kernel)
    if getattr(lib, "_dl4j_bound", False):
        return lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for entry, (n_ptrs, n_ints) in _ENTRIES[kernel].items():
        fn = getattr(lib, entry)
        code = [] if entry.endswith("_sm90") else [i32]
        fn.argtypes = code + [ptr] * n_ptrs + [i32] * n_ints + [ptr]
        fn.restype = i32
    smem = getattr(lib, f"dl4j_{kernel}_smem_bytes")
    smem.argtypes = [i32, i32]
    for query in (f"dl4j_{kernel}_sm90_smem_bytes",
                  f"dl4j_{kernel}_sm90_clusters"):
        getattr(lib, query).argtypes = [i32]
    for fn in (smem, getattr(lib, f"dl4j_{kernel}_sm90_smem_bytes"),
               getattr(lib, f"dl4j_{kernel}_sm90_clusters")):
        fn.restype = i32
    lib.dl4j_cuda_error_string.argtypes = [i32]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    lib._dl4j_bound = True
    return lib


def _check_on_cuda(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {x.device}")


def _aligned(x):
    """x, or a copy of it whose data is 16-byte aligned: the cluster
    kernels read Wh, h0 and h_prev 16 bytes at a time (and h_prev through
    TMA). A view into another tensor may start anywhere."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


_ENTRY_SUFFIX = {"cluster": "_sm90", "grid": "", "wide": "_wide"}


def _launch(lib, kernel, route, args, dev, what):
    """Calls ``kernel``'s entry point on ``route`` ("cluster", "grid" or
    "wide"; the latter two with the dtype code ``args[0]``) on the
    current stream of ``dev``; raises, naming the kernel, the route and
    ``what``, on any error, and when not one cluster fits on the card."""
    name = f"dl4j_{kernel}{_ENTRY_SUFFIX[route]}"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc == 0:
        return
    if rc == -1:
        raise RuntimeError(
            f"{kernel} ({route} route, {what}): not one cluster of "
            f"{what.n // CLUSTER_UNITS} blocks with "
            f"{getattr(lib, f'dl4j_{kernel}_sm90_smem_bytes')(what.n)} B of "
            f"shared memory each fits on this card")
    msg = lib.dl4j_cuda_error_string(rc).decode()
    raise RuntimeError(f"{kernel} kernel launch failed ({route} route, "
                       f"{what}): cudaError {rc}: {msg}")


class _Shape(NamedTuple):
    T: int
    b: int
    n: int
    dtype: torch.dtype

    def __str__(self):
        return f"T={self.T}, b={self.b}, n={self.n}, {self.dtype}"


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


# the card's limits the grid kernels are held to (H100 SXM): shared
# memory a block may have, shared memory and 256-thread blocks a
# multiprocessor holds, and its multiprocessors; registers aside, so a
# call these admit may still fail to launch (and raises)
MAX_BLOCK_SMEM = 232448
SM_SMEM = 233472
SM_BLOCKS = 8
SMS = 132
GRID_UNITS = 8       # hidden units a grid block owns (K1's and K2's kUnits)
WIDE_DP_SLOTS = 32   # K2's wide chain: phase-A threads a unit (kSlots)


def grid_fits(backward: bool, dtype, n) -> bool:
    """Whether K1's (``backward`` False) or K2's grid kernel can hold
    hidden size ``n`` in ``dtype`` on the card: a block's Wh slice and
    staging in its shared memory (K1 64 n, K2 32 n elements), and every
    block of the cooperative grid resident at once."""
    elem = 2 if dtype == torch.bfloat16 else 4
    smem = (32 if backward else 64) * n * elem
    if smem > MAX_BLOCK_SMEM:
        return False
    per_sm = min(SM_BLOCKS, SM_SMEM // smem)
    return SMS * per_sm >= -(-n // GRID_UNITS)


#: device memory of the card (H100 SXM, 80 GB): the wide route takes an n
#: whose Wh and its gradient, [n, 4n] each, fit in it
CARD_BYTES = 80 * 10**9


def wide_fits(dtype, n) -> bool:
    """Whether the wide route can hold hidden size ``n`` in ``dtype``: Wh
    and dWh ([n, 4n] each) within the card's memory. The wide kernels'
    shared memory and grid do not grow with n."""
    elem = 2 if dtype == torch.bfloat16 else 4
    return 2 * 4 * n * n * elem <= CARD_BYTES


def kernel_route(dtype, n, backward=False) -> str:
    """Which of K1's (K2's, ``backward``) kernels a call on the kernel
    route launches, by dtype and n only: "cluster" (``takes_cluster``),
    "grid" (``grid_fits``) or "wide" (everything wider)."""
    if takes_cluster(dtype, n):
        return "cluster"
    return "grid" if grid_fits(backward, dtype, n) else "wide"


def _jax_pallas_takes(dtype, b, n) -> bool:
    """The JAX package's ``_pallas_supported`` as it answers on a TPU
    (sigmoid/tanh aside): bf16 or f32, n % 128 == 0 and b a multiple of
    the sublane (16 for bf16, 8 for f32)."""
    if dtype not in _DTYPE_CODES:
        return False
    sublane = 16 if dtype == torch.bfloat16 else 8
    return n % 128 == 0 and b % sublane == 0


def _lstm_route(dtype, b, n, gate_act, cell_act, backward):
    """(route, reason): see ``lstm_route``."""
    if gate_act != "sigmoid":
        return "composed", f"gate_act={gate_act}"
    if cell_act != "tanh":
        return "composed", f"cell_act={cell_act}"
    if dtype not in _DTYPE_CODES:
        return "composed", f"dtype={str(dtype).replace('torch.', '')}"
    if takes_cluster(dtype, n) or grid_fits(backward, dtype, n):
        return "kernel", None
    if not _jax_pallas_takes(dtype, b, n):
        return "composed", f"n={n}"
    if wide_fits(dtype, n):
        return "kernel", None
    which = "K2 (backward)" if backward else "K1 (forward)"
    raise NotImplementedError(
        f"the CUDA LSTM {which} wide kernel needs Wh and its gradient "
        f"([n, 4n] each) in the card's memory ({CARD_BYTES} bytes): n={n} "
        f"in {dtype} does not fit")


def lstm_route(dtype, b, n, gate_act="sigmoid", cell_act="tanh",
               backward=False) -> str:
    """Where a call on CUDA tensors runs: "kernel" (K1, or K2 for
    ``backward``; ``kernel_route`` says which of its kernels) wherever a
    kernel covers it, which is every call the JAX package's Pallas kernel
    takes; "composed" (the plain loop on the card's tensors) exactly
    where the JAX package's predicate sends the call to XLA and the
    kernels do not cover it: another activation pair than sigmoid/tanh,
    a dtype other than bf16 and f32, or an n past the grid kernels'
    limits (``grid_fits``) that the Pallas kernel would not take either
    (n % 128 != 0 or b not a sublane multiple). Only an n whose Wh and
    dWh do not fit in the card's memory (``wide_fits``) raises
    ``NotImplementedError``."""
    return _lstm_route(dtype, b, n, gate_act, cell_act, backward)[0]


def _check_dtype(cd):
    if cd not in _DTYPE_CODES:
        raise NotImplementedError(
            f"the CUDA LSTM kernels take float32 or bfloat16, got {cd}")


def _check_shapes(xz_t, h0, c0, Wh, p, mask_t):
    """``ValueError`` for malformed inputs, whatever route the call
    takes; returns (T, b, n)."""
    cd = xz_t.dtype
    if xz_t.dim() != 3 or xz_t.shape[2] % 4:
        raise ValueError(f"xz_t must be [T, b, 4n], got {tuple(xz_t.shape)}")
    T, b, n4 = xz_t.shape
    n = n4 // 4
    if T < 1 or b < 1 or n < 1:
        raise ValueError(f"empty LSTM input {tuple(xz_t.shape)}")
    _check_like(cd, xz_t.device, {
        "xz_t": (xz_t, (T, b, n4)), "h0": (h0, (b, n)), "c0": (c0, (b, n)),
        "Wh": (Wh, (n, n4)), "p": (p, (3, n)), "mask_t": (mask_t, (T, b))})
    return T, b, n


def _check_cuda_inputs(xz_t, h0, c0, Wh, p, mask_t, gate_act, cell_act):
    """The kernel route's checks: malformed inputs raise ``ValueError``;
    what K1 does not compute, and a call recording a graph, raise
    ``NotImplementedError``. Returns (T, b, n)."""
    if gate_act != "sigmoid" or cell_act != "tanh":
        raise NotImplementedError(
            f"the CUDA LSTM kernel computes sigmoid gates and a tanh cell; "
            f"gate_act={gate_act!r}, cell_act={cell_act!r} take the "
            f"composed route (lstm_route)")
    _check_dtype(xz_t.dtype)
    T, b, n = _check_shapes(xz_t, h0, c0, Wh, p, mask_t)
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
    """Launch csrc/lstm_fwd.cu on the current stream, on the route
    ``kernel_route`` names: the cluster route (counted once more under
    ``FWD_SM90``), the grid route, or the wide route (counted once more
    under ``FWD_WIDE``). Raises on what the kernel does not take; never
    falls back to the plain version. A call ``lstm_route`` sends to the
    composed route runs ``lstm_sequence_torch`` on the card's tensors
    (autograd differentiates it), counted under ``count_route``."""
    _check_on_cuda(xz_t, "the CUDA LSTM kernel")
    cd = xz_t.dtype
    if mask_t is None:
        mask_t = torch.ones(xz_t.shape[:2], dtype=cd, device=xz_t.device)
    T, b, n = _check_shapes(xz_t, h0, c0, Wh, p, mask_t)
    route, reason = _lstm_route(cd, b, n, gate_act, cell_act, False)
    if route == "composed":
        registry.count_route("lstm_sequence", reason)
        return lstm_sequence_torch(xz_t, h0, c0, Wh, p, mask_t,
                                   gate_act=gate_act, cell_act=cell_act,
                                   save_residuals=save_residuals)
    T, b, n = _check_cuda_inputs(xz_t, h0, c0, Wh, p, mask_t, gate_act,
                                 cell_act)
    route = kernel_route(cd, n)
    out = lstm_fwd_launch(route, xz_t, h0, c0, Wh, p, mask_t,
                          save_residuals)
    also = {"cluster": (FWD_SM90,), "wide": (FWD_WIDE,)}.get(route, ())
    registry.count_launch(KERNEL)
    for name in also:
        registry.count_launch(name)
    registry.count_flops(KERNEL, fwd_flops(T, b, n))
    registry.note_kernel(KERNEL, out, also)
    return out


def lstm_fwd_launch(route, xz_t, h0, c0, Wh, p, mask_t, save_residuals):
    """One K1 launch on ``route`` ("cluster", "grid" or "wide"), on
    checked inputs, not counted: the wrapper's, and chip_smoke.py's way to hold and time a
    route the wrapper would not take for these inputs (the grid kernel's
    bf16 instantiation beside the cluster kernel, the wide kernel at an n
    the grid kernel holds)."""
    T, b, n4 = xz_t.shape
    n, cd, dev = n4 // 4, xz_t.dtype, xz_t.device
    lib = _bind(KERNEL)
    empty = lambda *shape: torch.empty(shape, dtype=cd, device=dev)  # noqa: E731
    y, hT, cT = empty(T, b, n), empty(b, n), empty(b, n)
    G = hprev = cprev = None
    if save_residuals:
        G, hprev, cprev = empty(T, b, 4 * n), empty(T, b, n), empty(T, b, n)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    outs = [ptr(x) for x in (y, hT, cT, G, hprev, cprev)]
    ints = [T, b, n, int(save_residuals)]
    if route == "cluster":
        ins = [ptr(_aligned(x)) for x in (xz_t, mask_t, h0, c0, Wh, p)]
        args = ins + outs + ints
    else:
        # f32 carry scratch. It may be freed as soon as this returns: the
        # caching allocator reuses it only for work queued after the
        # kernel on this stream.
        hbuf = torch.empty((2, b, n), dtype=torch.float32, device=dev)
        cbuf = torch.empty((b, n), dtype=torch.float32, device=dev)
        ins = [ptr(x) for x in (xz_t, mask_t, h0, c0, Wh, p)]
        args = ([_DTYPE_CODES[cd]] + ins + outs + [ptr(hbuf), ptr(cbuf)]
                + ints)
    _launch(lib, KERNEL, route, args, dev, _Shape(T, b, n, cd))
    return LstmOut(y, hT, cT, G, hprev, cprev)


def _check_cuda_bwd_inputs(residuals, mask_t, Wh, p, dy, dhT, dcT):
    """``ValueError`` for malformed inputs, whatever route the call
    takes; returns (T, b, n)."""
    G, hprev, cprev = residuals
    cd = G.dtype
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
    stream, on the route ``kernel_route(backward=True)`` names: the
    cluster route (counted once more under ``BWD_SM90``), the grid route,
    or the wide route (counted once more under ``BWD_WIDE``). Raises on
    what the kernel does not take; never falls back to the plain version. A
    call ``lstm_route(backward=True)`` sends to the composed route runs
    ``lstm_sequence_bwd_torch`` on the card's tensors."""
    _check_on_cuda(residuals[0], "the CUDA LSTM backward kernel")
    T, b, n = _check_cuda_bwd_inputs(residuals, mask_t, Wh, p, dy, dhT, dcT)
    cd = residuals[0].dtype
    route, reason = _lstm_route(cd, b, n, "sigmoid", "tanh", True)
    if route == "composed":
        registry.count_route("lstm_sequence_bwd", reason)
        return lstm_sequence_bwd_torch(residuals, mask_t, Wh, p, dy, dhT,
                                       dcT)
    route = kernel_route(cd, n, backward=True)
    out = lstm_bwd_launch(route, residuals, mask_t, Wh, p, dy, dhT, dcT)
    also = {"cluster": (BWD_SM90,), "wide": (BWD_WIDE,)}.get(route, ())
    registry.count_launch(BWD_KERNEL, bwd_launches_per_call(cd, n))
    for name in also:
        registry.count_launch(name)
    registry.count_flops(BWD_KERNEL, bwd_flops(T, b, n))
    registry.note_kernel(BWD_KERNEL, out, also)
    return out


def lstm_bwd_launch(route, residuals, mask_t, Wh, p, dy, dhT, dcT):
    """One K2 call on ``route`` (as ``lstm_fwd_launch``), on checked
    inputs, not counted."""
    G, hprev, cprev = residuals
    T, b, n4 = G.shape
    n, cd, dev = n4 // 4, G.dtype, G.device
    lib = _bind(BWD_KERNEL)
    empty = lambda *shape: torch.empty(shape, dtype=cd, device=dev)  # noqa: E731
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=dev)
    dxz, dh0, dc0 = empty(T, b, 4 * n), empty(b, n), empty(b, n)
    dWh, dp = empty(n, 4 * n), empty(3, n)
    outs = [x.data_ptr() for x in (dxz, dh0, dc0, dWh, dp)]
    if route == "cluster":
        # per-cluster f32 partials of dp, summed by the second launch
        part = f32(-(-b // CLUSTER_ROWS), 3, n)
        ins = [x.data_ptr() for x in (G, cprev, _aligned(hprev), mask_t,
                                      _aligned(Wh), p, dy, dhT, dcT)]
        args = ins + outs + [part.data_ptr(), T, b, n]
    else:
        # the f32 (dh, dc) carry scratch, freed as for the forward, and on
        # the wide route the peephole sums' slots
        scratch = [f32(b, n), f32(b, n)]
        if route == "wide":
            scratch.append(f32(3, WIDE_DP_SLOTS, n))
        ins = [x.data_ptr() for x in (G, cprev, hprev, mask_t, Wh, p, dy,
                                      dhT, dcT)]
        args = ([_DTYPE_CODES[cd]] + ins + outs
                + [x.data_ptr() for x in scratch] + [T, b, n])
    _launch(lib, BWD_KERNEL, route, args, dev, _Shape(T, b, n, cd))
    return dxz, dh0, dc0, dWh, dp
