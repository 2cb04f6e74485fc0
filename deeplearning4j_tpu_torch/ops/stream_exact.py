"""The decode-stable streaming ops: order-fixed projections and attention,
with plain PyTorch versions and the Hopper kernels' wrappers.

The JAX package's streaming path (``_dense_exact``,
``_causal_mha_exact``) is written as multiply+reduce chains that XLA
lowers to fused reduces. Each output element then sums its reduced axis in
an order that depends only on that axis's length, so a token's logits have
the same bits whether it came from a one-shot prefill, a chunked prefill,
a single-token step or a row padded into a bucket: the decode engine's
guarantees (serving/decode.py) rest on that. The JAX package leaves these
products to XLA; the port may not leave them to ``torch.matmul``, because
cuBLAS (and the CPU's GEMM) pick their kernel, and with it the reduction
order, by the number of rows. So both devices compute them here in one
fixed order:

- ``stream_dense`` (S1): y = x.W + b in f32. Each output sums over f in
  ascending order, each product and each sum rounded on its own (no FMA),
  then adds the bias.
- ``stream_mha`` (S2): causal MHA of q [b, t, h, dh] against the
  fixed-extent f32 cache [b, C, h, dh], row i of batch row r at absolute
  position pos[r] + i. Scores sum over dh in ascending order, times
  1/sqrt(dh); positions past the row's own are masked; the row max, then
  p = exp(s - max); the sum of p and the weighted sum of v over the cache
  positions in ascending order; normalised after the sum.
- ``stream_rownorm`` (S3): LayerNorm of each row in f32, its mean and
  variance each summed in one fixed order that depends only on the row's
  width (32 lane partials over columns l, l + 32, ... ascending, then a
  five-round butterfly, ``_row_tree``), the reciprocal square root as a
  rounded square root and a rounded division. PyTorch's own
  mean moves on the card with the number of rows (chip_smoke.py
  ``[stream_invariance]``); its softmax and GELU do not, so the head's
  softmax and the MLP's GELU stay PyTorch's.

Dispatch by device (ops/registry.py): a CPU tensor runs the plain version,
an ascending loop of elementwise products and sums over [rows, out] slabs
(never a [rows, f, g] product); a CUDA tensor runs
``csrc/stream_exact.cu`` (S1 ``dl4j_stream_dense``, S2
``dl4j_stream_mha``, S3 ``dl4j_stream_rownorm``), whose threads sum in
the same order with the same roundings, or raises, naming the route.
Nothing falls back. With gradients on (a truncated-BPTT step through
the streaming path), each kernel runs inside an autograd Function whose
backward is the same function's ordinary derivative in PyTorch (the
linear map's, ``F.layer_norm``'s, ``causal_mha_exact``'s): decode
stability is a property of the forward. On the card each kernel agrees
with its plain version bit for bit (chip_smoke.py
``[stream_exact_vs_plain]``); between the devices only exp may differ, in
its last bit (the card's ``expf`` against the CPU's).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from deeplearning4j_tpu_torch.ops import registry

LIB = "stream_exact"
KERNEL_DENSE = "stream_dense"
KERNEL_MHA = "stream_mha"
KERNEL_NORM = "stream_rownorm"


# ----------------------------------------------------------------- plain
@registry.register(KERNEL_DENSE, "cpu")
def stream_dense_torch(x, W, b=None):
    """S1's plain version: x [..., f] @ W [f, g] (+ b [g]) in f32, summed
    over f in ascending order, each product and sum rounded on its own."""
    lead = x.shape[:-1]
    f, g = W.shape
    x2 = x.reshape(-1, f).to(torch.float32)
    Wf = W.to(torch.float32)
    acc = torch.zeros((x2.shape[0], g), dtype=torch.float32,
                      device=x.device)
    for i in range(f):
        acc = torch.add(acc, torch.mul(x2[:, i:i + 1], Wf[i]))
    if b is not None:
        acc = torch.add(acc, b.to(torch.float32))
    return acc.reshape(*lead, g)


def _positions(pos, b, t, device):
    """Absolute position of every query row, [b, t] int64."""
    p = torch.as_tensor(pos, device=device).to(torch.int64).reshape(-1)
    p = p.expand(b) if p.numel() == 1 else p
    return p[:, None] + torch.arange(t, device=device)[None, :]


@registry.register(KERNEL_MHA, "cpu")
def stream_mha_torch(q, k_cache, v_cache, pos):
    """S2's plain version: causal MHA of q [b, t, h, dh] against the
    caches [b, C, h, dh], in f32, every sum in ascending order of its
    reduced index. Returns [b, t, h, dh] f32."""
    b, t, h, dh = q.shape
    C = k_cache.shape[1]
    scale = 1.0 / math.sqrt(dh)
    qh = q.to(torch.float32).permute(0, 2, 1, 3)           # [b, h, t, dh]
    kh = k_cache.to(torch.float32).permute(0, 2, 1, 3)     # [b, h, C, dh]
    vh = v_cache.to(torch.float32).permute(0, 2, 1, 3)
    s = torch.zeros((b, h, t, C), dtype=torch.float32, device=q.device)
    for d in range(dh):
        s = torch.add(s, torch.mul(qh[:, :, :, d, None],
                                   kh[:, :, None, :, d]))
    s = torch.mul(s, scale)
    qpos = _positions(pos, b, t, q.device)                 # [b, t]
    j = torch.arange(C, device=q.device)
    visible = qpos[:, None, :, None] >= j[None, None, None, :]
    s = torch.where(visible, s, float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(torch.sub(s, m))                         # [b, h, t, C]
    l = torch.zeros((b, h, t, 1), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, t, dh), dtype=torch.float32, device=q.device)
    for jj in range(C):
        pj = p[:, :, :, jj, None]
        l = torch.add(l, pj)
        o = torch.add(o, torch.mul(pj, vh[:, :, None, jj, :]))
    return torch.div(o, l).permute(0, 2, 1, 3).contiguous()


def _full_div(a, n):
    """a / n elementwise, n as a tensor: a scalar divisor may be taken as
    a product with its reciprocal, which rounds otherwise."""
    return torch.div(a, torch.full_like(a, float(n)))


def _row_tree(x):
    """S3's sum of each row of x [..., w] (f32): lane l of a 32-lane warp
    sums columns l, l + 32, ... in ascending order from +0.0 (a lane with
    no column keeps +0.0), then five butterfly rounds p = p + p[l ^ m] for
    m = 16, 8, 4, 2, 1; every lane ends with the same bits (IEEE addition
    commutes), lane 0's are returned as [..., 1]. w / 32 + 5 vectorised
    adds, each rounded on its own."""
    w = x.shape[-1]
    p = torch.zeros(x.shape[:-1] + (WARP,), dtype=torch.float32,
                    device=x.device)
    for c0 in range(0, w, WARP):
        n = min(WARP, w - c0)
        head = torch.add(p[..., :n], x[..., c0:c0 + n])
        p = torch.cat((head, p[..., n:]), dim=-1) if n < WARP else head
    lanes = torch.arange(WARP, device=x.device)
    for m in (16, 8, 4, 2, 1):
        p = torch.add(p, p[..., lanes ^ m])
    return p[..., :1]


@registry.register(KERNEL_NORM, "cpu")
def stream_rownorm_torch(x, gamma, beta, eps):
    """S3's plain version: LayerNorm over the last axis of x in f32, the
    two row sums in S3's fixed order (``_row_tree``), the square root and
    the division each correctly rounded. Returns f32."""
    w = x.shape[-1]
    xf = x.to(torch.float32)
    d = torch.sub(xf, _full_div(_row_tree(xf), w))
    var = torch.add(_full_div(_row_tree(torch.mul(d, d)), w), float(eps))
    # the CPU's float32 sqrt may miss the correct rounding by an ulp; the
    # float64 root rounded once to float32 is the correctly rounded one
    root = torch.sqrt(var.to(torch.float64)).to(torch.float32)
    inv = torch.div(torch.ones_like(var), root)
    y = torch.mul(torch.mul(d, inv), gamma.to(torch.float32))
    return torch.add(y, beta.to(torch.float32))


#: the counter of a dense layer's product that ``dense_route`` sent to S1
DENSE_ROUTED = "dense:route[stream]"


def dense_route(dtype, device, train) -> str:
    """Where a dense layer's product x.W (+ b) runs (nn/layers/
    feedforward.py ``dense_product``: Dense, Output, RnnOutput and the
    layers built on them): "stream", S1, for an F32 inference product on
    the card, whose every output then sums over f in one order whatever
    the rows and the output width, so a column shard of W gives the whole
    product's columns bit for bit (mesh serving, parallel/inference.py);
    "matmul" for everything else: ``train`` (a product autograd records,
    as the layers pass grad mode), other dtypes and the CPU, whose
    product the JAX parity tests hold."""
    if (dtype == torch.float32 and torch.device(device).type == "cuda"
            and not train):
        return "stream"
    return "matmul"


def stream_dense(x, W, b=None):
    """S1 through the registry: the plain version on the CPU, the kernel
    on the card."""
    return registry.get(KERNEL_DENSE, x.device)(x, W, b)


def stream_mha(q, k_cache, v_cache, pos):
    """S2 through the registry: the plain version on the CPU, the kernel
    on the card."""
    return registry.get(KERNEL_MHA, q.device)(q, k_cache, v_cache, pos)


def stream_rownorm(x, gamma, beta, eps):
    """S3 through the registry: the plain version on the CPU, the kernel
    on the card."""
    return registry.get(KERNEL_NORM, x.device)(x, gamma, beta, eps)


# ------------------------------------------------------------ launch plans
# The launch geometry of S1 and S2, mirrored by csrc/stream_exact.cu's
# constants. A plan never changes a sum's order: it only says how many
# outputs a thread and a block own.
SMEM_MAX = 232448        # bytes of shared memory a block can use (227 KB)
WAVE_BLOCKS = 128        # about one block for each of the card's 132 SMs
SCHEDULERS = 512         # about one warp for each of its 528 schedulers
DENSE_FK = 64            # S1: f values a staged chunk
DENSE_STAGES = 4
DENSE_XS = DENSE_FK + 4  # S1: a staged x row, padded by 16 bytes
MAX_COL_TILES = 65535
MHA_THREADS = 128
MHA_STAGE_FLOATS = 8192  # S2: a stage holds 8192 / dh cache rows
MHA_STAGES = 3
MHA_MAX_ITEMS = 8        # S2: (query row, column) outputs a thread
MHA_BLOCKS = 2 * 132     # S2: blocks a prefill aims at (two an SM)
WARP = 32                # S3: lanes a row's partial sums
NORM_WARPS = 4           # S3: rows a block (one warp a row)
NORM_MAX_COLS = 32       # S3: columns a lane holds in registers
NORM_MAX_W = 2 ** 31 - 1
NORM_MAX_BLOCKS = 2 ** 31 - 1


def _cdiv(a, b):
    return -(-a // b)


class DensePlan(NamedTuple):
    rt: int          # rows a thread (2 rt independent chains: 2 columns)
    tc: int          # column threads a warp (a warp spans 2 tc columns)
    wb: int          # warps a block
    row_tiles: int   # grid x: blocks of (32 / tc) rt wb rows
    col_tiles: int   # grid y: blocks of 2 tc columns
    smem: int        # bytes of shared memory a block

    @property
    def blocks(self):
        return self.row_tiles * self.col_tiles


def dense_plan(rows, f, g, rt=None, tc=None, wb=None) -> DensePlan:
    """S1's launch for x [rows, f] @ W [f, g]: the most rows a thread (4,
    2, 1) that still leaves a warp for each of ~512 warp schedulers (a
    warp owns 64 rt outputs); then blocks of four warps 16 column threads
    wide (8 rt rows by 32 columns) where that gives ~a block an SM
    (WAVE_BLOCKS), else of two warps 4 column threads wide (16 rt rows by
    8 columns): the fastest of the 18 choices at each decode shape in
    chip_smoke.py --stream-split's sweep, or within 1% of it.
    ``rt``/``tc``/``wb`` force a choice (for timing the alternatives)."""
    if rows > 2 ** 31 - 1:
        raise NotImplementedError(
            f"stream_dense takes at most {2 ** 31 - 1} rows, got {rows}")
    if rt is None:
        rt = next((r for r in (4, 2)
                   if _cdiv(rows * g, 64 * r) >= SCHEDULERS), 1)
    if tc is None and wb is None:
        wide = _cdiv(rows, 2 * rt * 4) * _cdiv(g, 32) >= WAVE_BLOCKS
        tc, wb = (16, 4) if wide else (4, 2)
    tc, wb = tc or 16, wb or 4
    col_tiles = _cdiv(g, 2 * tc)
    if col_tiles > MAX_COL_TILES:
        raise NotImplementedError(
            f"stream_dense takes at most {MAX_COL_TILES * 2 * tc} output "
            f"columns at {tc} column threads a warp, got {g}")
    br = (32 // tc) * rt * wb
    return DensePlan(rt, tc, wb, _cdiv(rows, br), col_tiles,
                     4 * DENSE_STAGES * (br * DENSE_XS + DENSE_FK * 2 * tc))


class MhaPlan(NamedTuple):
    qg: int          # query rows a block
    groups: int      # blocks a (batch row, head)
    tj: int          # cache rows a stage of the ring (8192 / dh, at most C)
    smem: int        # bytes of shared memory a block
    blocks: int


def mha_cache_limit(dh, v4=True) -> int:
    """The longest cache S2 takes at head width ``dh``: one row of p for
    the whole cache beside the ring, in 227 KB."""
    ks = dh + 4 if v4 else dh + 1
    ring = MHA_STAGES * max(1, MHA_STAGE_FLOATS // dh) * ks
    return SMEM_MAX // 4 - ring - dh - 5


def mha_plan(b, t, h, dh, C, v4=True) -> MhaPlan:
    """S2's launch for q [b, t, h, dh] against caches of C rows: one block
    per (batch row, head, group of qg query rows), the query rows split so
    that a prefill launches ~two blocks an SM where t allows, as few rows
    a block as that needs; qg bounded by the outputs a thread holds and by
    shared memory (the ring, q's rows, a row of p of C floats each).
    ``v4``: 16-byte copies into rows padded to dh + 4 (dh % 4 == 0,
    aligned bases); else 4-byte copies into rows of dh + 1."""
    if dh > MHA_MAX_ITEMS * MHA_THREADS:
        raise NotImplementedError(
            f"stream_mha takes head widths up to "
            f"{MHA_MAX_ITEMS * MHA_THREADS}, got dh={dh}")
    ks = dh + 4 if v4 else dh + 1
    tj = max(1, min(MHA_STAGE_FLOATS // dh, C))
    ring = MHA_STAGES * tj * ks
    row = dh + C + 5     # q's row, p's row, the row max and its 4 parts
    qg_max = min(MHA_MAX_ITEMS * MHA_THREADS // dh,
                 (SMEM_MAX // 4 - ring) // row)
    if qg_max < 1:
        raise NotImplementedError(
            f"stream_mha holds a row of p for the whole cache in shared "
            f"memory beside its {4 * ring} B ring: C={C}, dh={dh} needs "
            f"{4 * (ring + row)} B per block (at most 227 KB, "
            f"so C <= {mha_cache_limit(dh, v4)} at dh={dh})")
    groups = min(t, _cdiv(MHA_BLOCKS, b * h))
    qg = min(_cdiv(t, groups), qg_max)
    groups = _cdiv(t, qg)
    return MhaPlan(qg, groups, tj, 4 * (ring + qg * row), b * h * groups)


def rownorm_plan(rows, w) -> int:
    """S3's launch for x [rows, w]: the columns a lane holds in registers
    (the least power of two from 1 to NORM_MAX_COLS with 32 of them >= w),
    or 0 for the looped kernel past 32 NORM_MAX_COLS = 1024 columns, which
    reads the row three times. Raises on widths or row counts the kernel
    does not take (its widths are an int's; its blocks of NORM_WARPS rows
    a grid's)."""
    if w > NORM_MAX_W:
        raise NotImplementedError(
            f"stream_rownorm takes rows of at most {NORM_MAX_W} columns, "
            f"got w={w}")
    if _cdiv(rows, NORM_WARPS) > NORM_MAX_BLOCKS:
        raise NotImplementedError(
            f"stream_rownorm takes at most {NORM_WARPS * NORM_MAX_BLOCKS} "
            f"rows, got {rows}")
    if w > WARP * NORM_MAX_COLS:
        return 0
    cols = 1
    while WARP * cols < w:
        cols *= 2
    return cols


# ------------------------------------------------------------------ cuda
_LIB = None
_RAW_STREAM = None


def _bind():
    global _LIB, _RAW_STREAM
    if _LIB is not None:
        return _LIB
    from deeplearning4j_tpu_torch.ops import _build

    lib = _build.load(LIB)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dl4j_stream_dense.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.dl4j_stream_dense.restype = i32
    lib.dl4j_stream_dense_v1.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.dl4j_stream_dense_v1.restype = i32
    lib.dl4j_stream_mha.argtypes = ([ptr] * 5 + [i32] * 8
                                    + [ctypes.c_float, ptr])
    lib.dl4j_stream_mha.restype = i32
    lib.dl4j_stream_mha_v1.argtypes = ([ptr] * 5 + [i32] * 5
                                       + [ctypes.c_float, ptr])
    lib.dl4j_stream_mha_v1.restype = i32
    lib.dl4j_stream_rownorm.argtypes = ([ptr] * 4
                                        + [ctypes.c_longlong, i32, i32]
                                        + [ctypes.c_float, ptr])
    lib.dl4j_stream_rownorm.restype = i32
    lib.dl4j_stream_rownorm_v1.argtypes = ([ptr] * 4 + [i32] * 2
                                           + [ctypes.c_float, ptr])
    lib.dl4j_stream_rownorm_v1.restype = i32
    lib.dl4j_stream_chain_probe.argtypes = [ptr] * 3 + [i32, ptr]
    lib.dl4j_stream_chain_probe.restype = i32
    lib.dl4j_cuda_error_string.argtypes = [i32]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    _RAW_STREAM = get or (lambda i: torch.cuda.current_stream(i).cuda_stream)
    _LIB = lib
    return lib


def _launch(device, fn, *args):
    """fn(*args, stream) on ``device``'s current stream: the device is
    entered only when it is not the thread's current one."""
    idx = device.index
    if idx is None or idx == torch.cuda.current_device():
        return fn(*args, _RAW_STREAM(torch.cuda.current_device()
                                     if idx is None else idx))
    with torch.cuda.device(idx):
        return fn(*args, _RAW_STREAM(idx))


def _require(x, name, device, dtype=torch.float32):
    if x.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise(lib, rc, route, what):
    msg = lib.dl4j_cuda_error_string(rc).decode()
    raise RuntimeError(f"{route} kernel launch failed ({what}): "
                       f"cudaError {rc}: {msg}")


def dense_flops(rows, f, g, bias=True) -> int:
    """S1's operations: a product and a sum per (row, f, g), plus the
    bias."""
    return 2 * rows * f * g + (rows * g if bias else 0)


def _grad_needed(*xs):
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


class StreamDenseFn(torch.autograd.Function):
    """S1 forward; the backward is the linear map's own (dx = dy.Wᵀ,
    dW = xᵀ.dy, db = sum dy) in ``torch.matmul``: decode stability is a
    property of the forward, and a truncated-BPTT step differentiates
    through it."""

    @staticmethod
    def forward(ctx, x, W, b):
        ctx.save_for_backward(x, W)
        ctx.has_bias = b is not None
        return _dense_launch(x, W, b)

    @staticmethod
    def backward(ctx, g):
        x, W = ctx.saved_tensors
        g2 = g.reshape(-1, W.shape[1])
        x2 = x.reshape(-1, W.shape[0])
        dx = torch.matmul(g2, W.t()).reshape(x.shape)
        dW = torch.matmul(x2.t(), g2)
        db = g2.sum(0) if ctx.has_bias else None
        return dx, dW, db


class StreamMhaFn(torch.autograd.Function):
    """S2 forward; the backward differentiates ``causal_mha_exact`` (the
    same function as batched products) by autograd, as K3's backward
    recomputes through its plain version."""

    @staticmethod
    def forward(ctx, q, k, v, pos):
        ctx.save_for_backward(q, k, v, pos)
        return _mha_launch(q, k, v, pos)

    @staticmethod
    def backward(ctx, g):
        from deeplearning4j_tpu_torch.ops import attention as att
        q, k, v, pos = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = att.causal_mha_exact(*leaves, q_start=pos)
            return (*torch.autograd.grad(out, leaves, g), None)


class StreamRowNormFn(torch.autograd.Function):
    """S3 forward; the backward differentiates ``F.layer_norm`` (the same
    function) by autograd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        return _rownorm_launch(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, gamma, beta)]
            y = torch.nn.functional.layer_norm(
                leaves[0], (x.shape[-1],), leaves[1], leaves[2], ctx.eps)
            return (*torch.autograd.grad(y, leaves, g), None)


@registry.register(KERNEL_DENSE, "cuda")
def stream_dense_cuda(x, W, b=None):
    """S1 on the card; with gradients on, through ``StreamDenseFn``."""
    if _grad_needed(x, W, b):
        return StreamDenseFn.apply(x, W, b)
    return _dense_launch(x, W, b)


@registry.register(KERNEL_MHA, "cuda")
def stream_mha_cuda(q, k_cache, v_cache, pos):
    """S2 on the card; with gradients on, through ``StreamMhaFn``."""
    if _grad_needed(q, k_cache, v_cache):
        return StreamMhaFn.apply(q, k_cache, v_cache,
                                 _positions_i32(pos, q.shape[0], q.device))
    return _mha_launch(q, k_cache, v_cache, pos)


@registry.register(KERNEL_NORM, "cuda")
def stream_rownorm_cuda(x, gamma, beta, eps):
    """S3 on the card; with gradients on, through ``StreamRowNormFn``."""
    if _grad_needed(x, gamma, beta):
        return StreamRowNormFn.apply(x, gamma, beta, eps)
    return _rownorm_launch(x, gamma, beta, eps)


def _dense_args(x, W, b):
    """x as [rows, f] after the checks S1's kernels share."""
    if W.dim() != 2 or x.shape[-1] != W.shape[0] or (
            b is not None and (b.dim() != 1 or b.shape[0] != W.shape[1])):
        raise ValueError(f"stream_dense: x {tuple(x.shape)}, W "
                         f"{tuple(W.shape)}, b "
                         f"{None if b is None else tuple(b.shape)}")
    x2 = x if x.dim() == 2 else x.reshape(-1, W.shape[0])
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {dev}")
    _require(x2, "x", dev)
    _require(W, "W", dev)
    if b is not None:
        _require(b, "b", dev)
    return x2


def _dense_launch(x, W, b=None, plan=None):
    """Launch S1 on the current stream: x [..., f] f32 @ W [f, g] f32
    (+ b [g] f32) -> [..., g] f32. Raises on what the kernel does not
    take; never falls back. ``plan`` forces a launch geometry (for timing
    the alternatives); by default ``dense_plan``'s."""
    x2 = _dense_args(x, W, b)
    rows, (f, g) = x2.shape[0], W.shape
    y = x2.new_empty((rows, g))
    if rows == 0:
        return y.reshape(*x.shape[:-1], g)
    plan = plan or _dense_plan(rows, f, g)
    lib = _bind()
    rc = _launch(x.device, lib.dl4j_stream_dense, x2.data_ptr(),
                 W.data_ptr(), None if b is None else b.data_ptr(),
                 y.data_ptr(), rows, f, g, plan.rt, plan.tc, plan.wb)
    if rc != 0:
        _raise(lib, rc, KERNEL_DENSE, f"rows={rows}, f={f}, g={g}, {plan}")
    registry.count_launch(KERNEL_DENSE)
    registry.count_flops(KERNEL_DENSE, dense_flops(rows, f, g,
                                                   b is not None))
    registry.note_kernel(KERNEL_DENSE, y)
    return y if x.dim() == 2 else y.reshape(*x.shape[:-1], g)


@functools.lru_cache(maxsize=256)
def _dense_plan(rows, f, g):
    return dense_plan(rows, f, g)


def mha_flops(b, t, h, dh, C) -> int:
    """S2's operations as its plain version counts them: q.k and p.v over
    the whole fixed extent."""
    return 4 * b * h * t * C * dh


def _positions_i32(pos, b, device):
    """``pos`` ([b] or a scalar) as a contiguous int32 [b] tensor on
    ``device``; one already so is taken as it is, without a copy."""
    if isinstance(pos, torch.Tensor) and pos.dtype == torch.int32 and \
            pos.device == device and pos.shape == (b,) and \
            pos.is_contiguous():
        return pos
    p = torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1)
    p = (p.expand(b) if p.numel() == 1 else p).contiguous()
    if p.numel() != b:
        raise ValueError(f"stream_mha: pos has {p.numel()} rows, q {b}")
    return p


def _mha_args(q, k_cache, v_cache, pos):
    """(b, t, h, dh, C, int32 positions) after the checks S2's kernels
    share."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {dev}")
    for name, a in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _require(a, name, dev)
        if a.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(a.shape)}")
    b, t, h, dh = q.shape
    C = k_cache.shape[1]
    if k_cache.shape != (b, C, h, dh) or v_cache.shape != (b, C, h, dh):
        raise ValueError(f"stream_mha: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    return b, t, h, dh, C, _positions_i32(pos, b, dev)


def _v4(dh, *ts):
    """S2 takes 16-byte copies: dh a multiple of 4, every base aligned."""
    return dh % 4 == 0 and all(a.data_ptr() % 16 == 0 for a in ts)


@functools.lru_cache(maxsize=256)
def _mha_plan(b, t, h, dh, C, v4):
    return mha_plan(b, t, h, dh, C, v4)


def _mha_launch(q, k_cache, v_cache, pos):
    """Launch S2 on the current stream: q [b, t, h, dh] f32 against the
    caches [b, C, h, dh] f32 with per-row positions ``pos`` ([b] or a
    scalar) -> [b, t, h, dh] f32. Raises on what the kernel does not take;
    never falls back."""
    b, t, h, dh, C, p = _mha_args(q, k_cache, v_cache, pos)
    v4 = _v4(dh, q, k_cache, v_cache)
    plan = _mha_plan(b, t, h, dh, C, v4)
    out = torch.empty_like(q)
    lib = _bind()
    rc = _launch(q.device, lib.dl4j_stream_mha, q.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(), p.data_ptr(),
                 out.data_ptr(), b, t, h, dh, C, plan.qg, plan.groups,
                 int(v4), 1.0 / math.sqrt(dh))
    if rc != 0:
        _raise(lib, rc, KERNEL_MHA,
               f"b={b}, t={t}, h={h}, dh={dh}, C={C}, {plan}")
    registry.count_launch(KERNEL_MHA)
    registry.count_flops(KERNEL_MHA, mha_flops(b, t, h, dh, C))
    registry.note_kernel(KERNEL_MHA, out)
    return out


def dense_launch_v1(x, W, b=None):
    """S1's first version (one thread an output, W read once a row),
    kept for timing beside the new kernel; the registry never reaches it
    and it counts no launch."""
    x2 = _dense_args(x, W, b)
    rows, (f, g) = x2.shape[0], W.shape
    if rows > 65535:
        raise NotImplementedError(
            f"stream_dense's first version takes at most 65535 rows, got "
            f"{rows}")
    y = torch.empty((rows, g), dtype=torch.float32, device=x.device)
    lib = _bind()
    rc = _launch(x.device, lib.dl4j_stream_dense_v1, x2.data_ptr(),
                 W.data_ptr(), None if b is None else b.data_ptr(),
                 y.data_ptr(), rows, f, g)
    if rc != 0:
        _raise(lib, rc, KERNEL_DENSE + "_v1", f"rows={rows}, f={f}, g={g}")
    return y.reshape(*x.shape[:-1], g)


def mha_launch_v1(q, k_cache, v_cache, pos):
    """S2's first version (a warp a (row, query, head), k read a row a
    lane), kept for timing beside the new kernel; the registry never
    reaches it and it counts no launch."""
    b, t, h, dh, C, p = _mha_args(q, k_cache, v_cache, pos)
    out = torch.empty_like(q)
    lib = _bind()
    rc = _launch(q.device, lib.dl4j_stream_mha_v1, q.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(), p.data_ptr(),
                 out.data_ptr(), b, t, h, dh, C, 1.0 / math.sqrt(dh))
    if rc != 0:
        _raise(lib, rc, KERNEL_MHA + "_v1",
               f"b={b}, t={t}, h={h}, dh={dh}, C={C}")
    return out


def chain_cycles(n=4096):
    """Cycles a step of a dependent add chain takes on the current card,
    as S1 and S2 sum (a separately rounded product and sum): (operands
    in registers, operands read from shared memory just before the step).
    The chain floor of a kernel whose outputs are single chains."""
    lib = _bind()
    dev = torch.device("cuda", torch.cuda.current_device())
    src = torch.rand(1024, device=dev)
    out = torch.empty(32, device=dev)
    cyc = torch.zeros(2, dtype=torch.int64, device=dev)
    for _ in range(2):                      # the second run is timed warm
        rc = _launch(dev, lib.dl4j_stream_chain_probe, src.data_ptr(),
                     out.data_ptr(), cyc.data_ptr(), n)
        if rc != 0:
            _raise(lib, rc, "stream_chain_probe", f"n={n}")
    torch.cuda.synchronize(dev)
    return tuple(c / n for c in cyc.tolist())


def _rownorm_args(x, gamma, beta):
    """x as [rows, w] after the checks S3's kernels share."""
    w = x.shape[-1]
    x2 = x if x.dim() == 2 else x.reshape(-1, w)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {dev}")
    for name, a in (("x", x2), ("gamma", gamma), ("beta", beta)):
        _require(a, name, dev)
    if gamma.shape != (w,) or beta.shape != (w,):
        raise ValueError(f"stream_rownorm: x {tuple(x.shape)}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    return x2


def _rownorm_launch(x, gamma, beta, eps):
    """Launch S3 on the current stream: LayerNorm over the last axis of x
    f32 with gamma, beta [w] f32 -> f32 of x's shape. Raises on what the
    kernel does not take; never falls back."""
    x2 = _rownorm_args(x, gamma, beta)
    rows, w = x2.shape
    y = torch.empty((rows, w), dtype=torch.float32, device=x.device)
    if rows == 0:
        return y.reshape(x.shape)
    cols = rownorm_plan(rows, w)
    lib = _bind()
    rc = _launch(x.device, lib.dl4j_stream_rownorm, x2.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), rows, w,
                 cols, float(eps))
    if rc != 0:
        _raise(lib, rc, KERNEL_NORM, f"rows={rows}, w={w}, cols={cols}")
    registry.count_launch(KERNEL_NORM)
    registry.count_flops(KERNEL_NORM, 8 * rows * w)
    registry.note_kernel(KERNEL_NORM, y)
    return y if x.dim() == 2 else y.reshape(x.shape)


def rownorm_launch_v1(x, gamma, beta, eps):
    """S3's first version (a block of 128 threads a row, the row in shared
    memory, one thread summing it in ascending order), kept for timing
    beside the new kernel; the registry never reaches it and it counts no
    launch. Its sums run in another order than the plain version's."""
    x2 = _rownorm_args(x, gamma, beta)
    rows, w = x2.shape
    if (w + 2) * 4 > SMEM_MAX or rows > 2 ** 31 - 1:
        raise NotImplementedError(
            f"stream_rownorm's first version holds a row in shared memory "
            f"(w <= {SMEM_MAX // 4 - 2}), got rows={rows}, w={w}")
    y = torch.empty((rows, w), dtype=torch.float32, device=x.device)
    lib = _bind()
    rc = _launch(x.device, lib.dl4j_stream_rownorm_v1, x2.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), rows, w,
                 float(eps))
    if rc != 0:
        _raise(lib, rc, KERNEL_NORM + "_v1", f"rows={rows}, w={w}")
    return y.reshape(x.shape)
