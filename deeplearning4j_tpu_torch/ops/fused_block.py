"""Fused bottleneck-tail op: 1x1 conv + batch norm + residual add + relu
(counterpart of deeplearning4j_tpu/ops/fused_block.py's Pallas schedule:
``_fwd_impl``, ``_bwd_impl`` and the ``_fused_pallas`` custom VJP).

    y = relu((x @ W - mean) * inv * gamma + beta + shortcut)

with mean/var the batch statistics of z = x @ W. BN needs all of z before
it can normalise any of it, so the schedule recomputes z in each pass
instead of storing it:

- K4 ``fused_block_stats``: s1 = sum(z - shift), s2 = sum((z - shift)^2)
- K5 ``fused_block_apply``: y = relu(z * scale + sh + shortcut)
- K6 ``fused_block_bwd_stats``: a = sum(g), b = sum(g * xhat), g = dy * [y > 0]
- K7 ``fused_block_bwd_apply``: dz = scale * (g - a/M - xhat * b/M) rounded
  to the compute dtype; dx = dz @ W^T, dW = x^T @ dz (f32), dshortcut = g

Every pass rounds z through the compute dtype before use (``_round_trip``)
and runs its epilogue in f32. Each kernel has its plain PyTorch version
here (``*_torch``, used for CPU tensors) and its CUDA wrapper (``*_cuda``,
csrc/fused_block.cu, used for CUDA tensors; it raises on what the kernel
does not take and never falls back, and counts every device launch it
makes under the kernel's name: K4 and K6 make two, K7 three or four).
In bf16 all four take the Hopper path (TMA + wgmma, csrc/sm90_gemm.cuh)
when TMA can read their operands (``takes_sm90``: rows of a multiple of 16
bytes, 16-byte-aligned bases), and count each such call once more under
their ``*_sm90`` counter (``SM90_COUNTER``: ``fused_block_stats_sm90``,
``fused_block_apply_sm90``, ``fused_block_bwd_stats_sm90``,
``fused_block_bwd_apply_sm90``); any other call takes the first
mainloops. The choice is by dtype, shape and alignment only: a failure
raises.
``conv1x1_bn_add_relu`` is the op the block-fusion pass calls
(nn/fusion.py); ``FusedTailFn`` is its ``torch.autograd.Function``.

Under BF16 this differs from the JAX package's fused training step, which
goes through its ``xla_recompute`` backend and forms the epilogue in the
compute dtype: K4-K7 follow the Pallas function and form it in f32. The
tests hold this op against ``conv1x1_bn_add_relu_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import registry

KERNEL = "fused_block"
STATS, APPLY, BWD_STATS, BWD_APPLY = (
    "fused_block_stats", "fused_block_apply", "fused_block_bwd_stats",
    "fused_block_bwd_apply")
# calls on the sm90 path
STATS_SM90 = "fused_block_stats_sm90"
APPLY_SM90 = "fused_block_apply_sm90"
BWD_STATS_SM90 = "fused_block_bwd_stats_sm90"
BWD_APPLY_SM90 = "fused_block_bwd_apply_sm90"
SM90_COUNTER = {STATS: STATS_SM90, APPLY: APPLY_SM90,
                BWD_STATS: BWD_STATS_SM90, BWD_APPLY: BWD_APPLY_SM90}
# each kernel's entry point on the first mainloops (dtype code first);
# its sm90 entry point is the same name + "_sm90", without the code
_ENTRY = {STATS: "dl4j_fused_stats", APPLY: "dl4j_fused_apply",
          BWD_STATS: "dl4j_fused_bwd_stats", BWD_APPLY: "dl4j_fused_bwd_apply"}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's tile (dl4j_fused_tile_rows/cols), and the number of blocks
# the two reduction passes and the dW split aim for: about four resident
# waves of 132 SMs at two blocks each; a function of the shape only, so
# the sums' order, and the bits, do not depend on the card
TILE_M = TILE_N = 128
_TARGET_BLOCKS = 528
# the sm90 mainloop's reduction step (dl4j_fused_sm90_step): dW's chunks
# of M are multiples of it there, so no step reads the next chunk's rows
SM90_STEP = 64


def _round_trip(z, cd):
    """The f32 product rounded through the compute dtype, so every pass
    sees the values the unfused path would have stored."""
    return z.to(cd).to(torch.float32)


def _z(x2, W):
    return _round_trip(torch.matmul(x2.float(), W.float()), x2.dtype)


def _g(dy2, y2, relu):
    g = dy2.float()
    if relu:
        g = torch.where(y2.float() > 0, g, torch.zeros_like(g))
    return g


# --------------------------------------------------------------- plain
def fused_stats_torch(x2, W, shift):
    """K4's function: (s1, s2), [N] f32 each."""
    zs = _z(x2, W) - shift.float()
    return torch.sum(zs, dim=0), torch.sum(zs * zs, dim=0)


def fused_apply_torch(x2, W, scale, sh, sc2, relu):
    """K5's function: y [M, N] in the compute dtype."""
    o = _z(x2, W) * scale + sh + sc2.float()
    if relu:
        o = torch.clamp(o, min=0.0)
    return o.to(x2.dtype)


def fused_bwd_stats_torch(x2, W, mean, inv, dy2, y2, relu):
    """K6's function: (a, b), [N] f32 each."""
    xhat = (_z(x2, W) - mean) * inv
    g = _g(dy2, y2, relu)
    return torch.sum(g, dim=0), torch.sum(g * xhat, dim=0)


def fused_bwd_apply_torch(x2, W, mean, inv, scale, ca, cb, dy2, y2, relu):
    """K7's function: (dx [M, K] cd, dW [K, N] f32, dsc [M, N] cd)."""
    cd = x2.dtype
    xhat = (_z(x2, W) - mean) * inv
    g = _g(dy2, y2, relu)
    dz = (scale * (g - ca - xhat * cb)).to(cd).float()
    dx = torch.matmul(dz, W.float().t()).to(cd)
    dW = torch.matmul(x2.float().t(), dz)
    return dx, dW, g.to(cd)


# ---------------------------------------------------------------- cuda
def check_fused_inputs(x, W, shortcut=None):
    """Raise ``NotImplementedError``, naming the reason, for a call that
    K4-K7 do not cover: a dtype other than f32 and bf16, or a W that is
    not a 1x1 kernel ([K, N] or [1, 1, K, N]); and ``ValueError`` for
    malformed inputs. Returns (M, K, N)."""
    if x.dtype not in _DTYPE_CODES:
        raise NotImplementedError(
            f"conv1x1_bn_add_relu takes float32 or bfloat16 activations, "
            f"got {x.dtype}")
    if not (W.dim() == 2 or (W.dim() == 4 and tuple(W.shape[:2]) == (1, 1))):
        raise NotImplementedError(
            f"conv1x1_bn_add_relu takes a 1x1 kernel, [K, N] or "
            f"[1, 1, K, N]; got W of shape {tuple(W.shape)}")
    K, N = W.shape[-2], W.shape[-1]
    if x.dim() < 1 or x.shape[-1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not end in K={K}")
    M = x.numel() // K if K else 0
    if M < 1 or K < 1 or N < 1:
        raise ValueError(f"empty fused tail: M={M}, K={K}, N={N}")
    if shortcut is not None:
        try:
            torch.broadcast_shapes(tuple(shortcut.shape),
                                   tuple(x.shape[:-1]) + (N,))
        except RuntimeError:
            raise ValueError(
                f"shortcut {tuple(shortcut.shape)} does not broadcast to "
                f"{tuple(x.shape[:-1]) + (N,)}") from None
    return M, K, N


def _bind():
    from deeplearning4j_tpu_torch.ops import _build

    lib = _build.load(KERNEL)
    if getattr(lib, "_dl4j_bound", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dl4j_fused_stats.argtypes = [i] + [p] * 5 + [i] * 4 + [p]
    lib.dl4j_fused_apply.argtypes = [i] + [p] * 6 + [i] * 4 + [p]
    lib.dl4j_fused_bwd_stats.argtypes = [i] + [p] * 8 + [i] * 5 + [p]
    lib.dl4j_fused_bwd_apply.argtypes = [i] + [p] * 14 + [i] * 6 + [p]
    for entry in _ENTRY.values():
        first, sm90 = getattr(lib, entry), getattr(lib, entry + "_sm90")
        sm90.argtypes = first.argtypes[1:]  # no dtype code
        first.restype = sm90.restype = i
    for fn in (lib.dl4j_fused_sm90_step, lib.dl4j_fused_tile_rows,
               lib.dl4j_fused_tile_cols):
        fn.restype = i
    lib.dl4j_cuda_error_string.argtypes = [i]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    tile = (lib.dl4j_fused_tile_rows(), lib.dl4j_fused_tile_cols())
    if tile != (TILE_M, TILE_N):
        raise RuntimeError(f"fused_block.cu tiles {tile}, the wrapper "
                           f"expects {(TILE_M, TILE_N)}")
    if lib.dl4j_fused_sm90_step() != SM90_STEP:
        raise RuntimeError(f"fused_block.cu's sm90 step is "
                           f"{lib.dl4j_fused_sm90_step()}, the wrapper "
                           f"expects {SM90_STEP}")
    lib._dl4j_bound = True
    return lib


def _cdiv(a, b):
    return -(-a // b)


def stat_rows(M, N, sm90=False):
    """Rows of partial sums K4 and K6 write: on the first mainloops the
    m-tiles are dealt to this many blocks per column tile; their sm90
    paths write one row for each 128-row m-tile."""
    if sm90:
        return _cdiv(M, TILE_M)
    return max(1, min(_cdiv(M, TILE_M), _TARGET_BLOCKS // _cdiv(N, TILE_N)))


def dw_splits(M, K, N, sm90=False):
    """(S, chunk): K7 sums dW over S chunks of ``chunk`` rows of M, about
    264 blocks (two resident a multiprocessor) in all; chunks are
    multiples of 16 rows, of SM90_STEP on the sm90 path."""
    tiles = _cdiv(K, TILE_M) * _cdiv(N, TILE_N)
    S = max(1, min(_TARGET_BLOCKS // 2 // tiles, _cdiv(M, 1024)))
    step = SM90_STEP if sm90 else 16
    chunk = _cdiv(_cdiv(M, S), step) * step
    return _cdiv(M, chunk), chunk


def launches_per_call(name, M, K, N, sm90=False):
    """Device launches one call of kernel ``name`` makes: K4 and K6 a pass
    over the tiles and the sum of its partials (K6 on either path), K5
    one, K7 dz, dx and dW and, when dW is split over M, the sum of its
    splits (on either path)."""
    if name == BWD_APPLY:
        return 3 + (dw_splits(M, K, N, sm90)[0] > 1)
    return 1 if name == APPLY else 2


# [M, K] x [K, N] products in each kernel's plain version: z for K4, K5
# and K6; z, dz Wᵀ and xᵀ dz for K7
_PRODUCTS = {STATS: 1, APPLY: 1, BWD_STATS: 1, BWD_APPLY: 3}


def flops(name, M, K, N) -> int:
    """Kernel ``name``'s operations as FlopCounterMode counts its plain
    version (``step_cost_analysis`` adds them: FlopCounterMode does not
    see a kernel launched through ``ctypes``)."""
    return 2 * _PRODUCTS[name] * M * K * N


def takes_sm90(x2, W, *mn):
    """Whether K4-K7 run on the sm90 path (TMA + wgmma) for x [M, K],
    W [K, N] and the [M, N] tensors ``mn`` each reads (K4 none, K5 the
    shortcut, K6 and K7 dy and y): bf16, K and N multiples of 8 (every row
    a multiple of 16 bytes) and every base 16-byte aligned. The outputs
    and scratch the wrappers allocate are aligned by the allocator."""
    return (x2.dtype == torch.bfloat16 and x2.shape[-1] % 8 == 0
            and W.shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x2, W, *mn)))


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every input must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"the {name} wrapper records no graph; call "
            f"conv1x1_bn_add_relu, which differentiates through "
            f"FusedTailFn, or run under torch.no_grad()")


def _f32(*vs):
    return [v.float().contiguous() for v in vs]


def _launch_routed(lib, name, sm90, code, *args, launches):
    """Launches kernel ``name`` through its sm90 entry point, counted once
    more under ``SM90_COUNTER[name]``, or through its first one, which
    takes the dtype ``code`` first."""
    if sm90:
        _launch(lib, name, getattr(lib, _ENTRY[name] + "_sm90"), *args,
                launches=launches)
        registry.count_launch(SM90_COUNTER[name])
    else:
        _launch(lib, name, getattr(lib, _ENTRY[name]), code, *args,
                launches=launches)


def _launch(lib, name, fn, *args, launches):
    """Calls entry point ``fn`` on the current stream of the device
    ``args[-1]`` and counts the ``launches`` device launches it makes
    under ``name``."""
    with torch.cuda.device(args[-1]):
        stream = torch.cuda.current_stream(args[-1]).cuda_stream
        rc = fn(*args[:-1], stream)
    if rc != 0:
        msg = lib.dl4j_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}: "
                           f"{msg}")
    registry.count_launch(name, launches)


def _operands(name, x2, W, **mn):
    """Checks x [M, K], W [K, N] and each [M, N] tensor in ``mn`` (same
    device and dtype, contiguous). Returns (M, K, N, dtype code)."""
    _check_cuda(name, x2, W, *mn.values())
    if x2.dim() != 2 or W.dim() != 2 or x2.shape[1] != W.shape[0]:
        raise ValueError(f"{name}: x [M, K] and W [K, N], got "
                         f"{tuple(x2.shape)} and {tuple(W.shape)}")
    if W.dtype != x2.dtype:
        raise ValueError(f"{name}: W is {W.dtype}, x is {x2.dtype}")
    M, K, N = check_fused_inputs(x2, W)
    for nm, t in mn.items():
        if tuple(t.shape) != (M, N) or t.dtype != x2.dtype:
            raise ValueError(f"{name}: {nm} must be [{M}, {N}] {x2.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    return M, K, N, _DTYPE_CODES[x2.dtype]


@registry.register(STATS, "cuda")
def fused_stats_cuda(x2, W, shift):
    M, K, N, code = _operands(STATS, x2, W)
    (shift,) = _f32(shift)
    lib = _bind()
    sm90 = takes_sm90(x2, W)
    R = stat_rows(M, N, sm90)
    part = torch.empty((2, R, N), dtype=torch.float32, device=x2.device)
    out = torch.empty((2, N), dtype=torch.float32, device=x2.device)
    _launch_routed(lib, STATS, sm90, code, x2.data_ptr(), W.data_ptr(),
                   shift.data_ptr(), part.data_ptr(), out.data_ptr(), M, K,
                   N, R, x2.device,
                   launches=launches_per_call(STATS, M, K, N, sm90))
    registry.count_flops(STATS, flops(STATS, M, K, N))
    return out[0], out[1]


@registry.register(APPLY, "cuda")
def fused_apply_cuda(x2, W, scale, sh, sc2, relu):
    M, K, N, code = _operands(APPLY, x2, W, shortcut=sc2)
    scale, sh = _f32(scale, sh)
    lib = _bind()
    sm90 = takes_sm90(x2, W, sc2)
    y = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    _launch_routed(lib, APPLY, sm90, code, x2.data_ptr(), W.data_ptr(),
                   scale.data_ptr(), sh.data_ptr(), sc2.data_ptr(),
                   y.data_ptr(), M, K, N, int(bool(relu)), x2.device,
                   launches=launches_per_call(APPLY, M, K, N, sm90))
    registry.count_flops(APPLY, flops(APPLY, M, K, N))
    return y


@registry.register(BWD_STATS, "cuda")
def fused_bwd_stats_cuda(x2, W, mean, inv, dy2, y2, relu):
    M, K, N, code = _operands(BWD_STATS, x2, W, dy=dy2, y=y2)
    mean, inv = _f32(mean, inv)
    lib = _bind()
    sm90 = takes_sm90(x2, W, dy2, y2)
    R = stat_rows(M, N, sm90)
    part = torch.empty((2, R, N), dtype=torch.float32, device=x2.device)
    out = torch.empty((2, N), dtype=torch.float32, device=x2.device)
    _launch_routed(lib, BWD_STATS, sm90, code, x2.data_ptr(), W.data_ptr(),
                   mean.data_ptr(), inv.data_ptr(), dy2.data_ptr(),
                   y2.data_ptr(), part.data_ptr(), out.data_ptr(), M, K, N,
                   R, int(bool(relu)), x2.device,
                   launches=launches_per_call(BWD_STATS, M, K, N, sm90))
    registry.count_flops(BWD_STATS, flops(BWD_STATS, M, K, N))
    return out[0], out[1]


@registry.register(BWD_APPLY, "cuda")
def fused_bwd_apply_cuda(x2, W, mean, inv, scale, ca, cb, dy2, y2, relu):
    M, K, N, code = _operands(BWD_APPLY, x2, W, dy=dy2, y=y2)
    mean, inv, scale, ca, cb = _f32(mean, inv, scale, ca, cb)
    lib = _bind()
    sm90 = takes_sm90(x2, W, dy2, y2)
    S, chunk = dw_splits(M, K, N, sm90)
    dev = x2.device
    dz = torch.empty((M, N), dtype=x2.dtype, device=dev)
    dsc = torch.empty((M, N), dtype=x2.dtype, device=dev)
    dx = torch.empty((M, K), dtype=x2.dtype, device=dev)
    dW = torch.empty((K, N), dtype=torch.float32, device=dev)
    part = (torch.empty((S, K, N), dtype=torch.float32, device=dev)
            if S > 1 else dW)
    _launch_routed(lib, BWD_APPLY, sm90, code, x2.data_ptr(), W.data_ptr(),
                   mean.data_ptr(), inv.data_ptr(), scale.data_ptr(),
                   ca.data_ptr(), cb.data_ptr(), dy2.data_ptr(),
                   y2.data_ptr(), dz.data_ptr(), dsc.data_ptr(),
                   dx.data_ptr(), part.data_ptr(), dW.data_ptr(), M, K, N, S,
                   chunk, int(bool(relu)), dev,
                   launches=launches_per_call(BWD_APPLY, M, K, N, sm90))
    registry.count_flops(BWD_APPLY, flops(BWD_APPLY, M, K, N))
    return dx, dW, dsc


registry.register(STATS, "cpu")(fused_stats_torch)
registry.register(APPLY, "cpu")(fused_apply_torch)
registry.register(BWD_STATS, "cpu")(fused_bwd_stats_torch)
registry.register(BWD_APPLY, "cpu")(fused_bwd_apply_torch)


# ------------------------------------------------------------ autograd
def fused_forward(x2, W, gamma, beta, sc2, shift, eps, relu):
    """``_fwd_impl``: K4, the statistics in f32, K5. Returns (y, mean,
    var, inv, scale)."""
    dev = x2.device
    M = x2.shape[0]
    s1, s2 = registry.get(STATS, dev)(x2, W, shift)
    k = shift.float()
    m1 = s1 / M
    mean = m1 + k
    var = torch.clamp(s2 / M - m1 * m1, min=0.0)
    inv = torch.rsqrt(var + eps)
    scale = gamma.float() * inv
    sh = beta.float() - mean * scale
    y = registry.get(APPLY, dev)(x2, W, scale, sh, sc2, relu)
    return y, mean, var, inv, scale


def fused_backward(x2, W, mean, inv, scale, dy2, y2, relu):
    """``_bwd_impl``: K6, then K7. Returns (dx, dW f32, dgamma, dbeta,
    dshortcut)."""
    dev = x2.device
    M = x2.shape[0]
    a, b = registry.get(BWD_STATS, dev)(x2, W, mean, inv, dy2, y2, relu)
    dx, dW, dsc = registry.get(BWD_APPLY, dev)(
        x2, W, mean, inv, scale, a / M, b / M, dy2, y2, relu)
    return dx, dW, b, a, dsc


class FusedTailFn(torch.autograd.Function):
    """The ``_fused_pallas`` custom VJP: (y, mean, var) forward; the
    backward gives dx, dW, dgamma, dbeta and dshortcut; mean and var feed
    only the running-statistics update and get no cotangent."""

    @staticmethod
    def forward(ctx, x2, W, gamma, beta, sc2, shift, eps, relu):
        with torch.no_grad():
            y, mean, var, inv, scale = fused_forward(x2, W, gamma, beta, sc2,
                                                     shift, eps, relu)
        ctx.save_for_backward(x2, W, gamma, mean, inv, scale, y)
        ctx.relu = relu
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2, W, gamma, mean, inv, scale, y = ctx.saved_tensors
        with torch.no_grad():
            dx, dW, dgamma, dbeta, dsc = fused_backward(
                x2, W, mean, inv, scale, dy.to(x2.dtype).contiguous(), y,
                ctx.relu)
        return (dx, dW.to(W.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), dsc, None, None, None)


def conv1x1_bn_add_relu(x, W, gamma, beta, shortcut, *, shift, eps,
                        relu=True):
    """z = x @ W over the trailing channel axis; (zn, mean, var) = batch
    norm of z with the running mean ``shift`` as the variance shift;
    returns (relu(zn + shortcut), mean, var). A broadcast shortcut is
    expanded explicitly (its gradient is summed back by autograd). On CPU
    tensors the passes run their plain versions, on CUDA tensors K4-K7."""
    M, K, N = check_fused_inputs(x, W, shortcut)
    out_shape = tuple(x.shape[:-1]) + (N,)
    x2 = x.reshape(M, K).contiguous()
    W2 = W.reshape(K, N).to(x.dtype).contiguous()
    sc2 = shortcut.to(x.dtype).expand(out_shape).reshape(M, N).contiguous()
    y, mean, var = FusedTailFn.apply(
        x2, W2, gamma.float(), beta.float(), sc2, shift.detach().float(),
        float(eps), bool(relu))
    return y.reshape(out_shape), mean, var


registry.register("conv1x1_bn_add_relu", "cpu")(conv1x1_bn_add_relu)
registry.register("conv1x1_bn_add_relu", "cuda")(conv1x1_bn_add_relu)
