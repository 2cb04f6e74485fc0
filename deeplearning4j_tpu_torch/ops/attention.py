"""Causal multi-head attention: plain PyTorch versions and the Hopper
flash-attention kernel's wrapper (counterpart of
deeplearning4j_tpu/ops/attention.py).

Tensors are in the layers' layout, q/k/v [b, t, h, dh]. Scores and the
softmax run in f32 whatever the compute dtype; masked positions get
``-inf`` in the plain versions, so they add an exact 0.0 to every sum.

- ``causal_mha_exact``: the f32 formulation of the JAX package's
  ``_causal_mha_exact``: f32 products and sums, normalised after the
  weighted sum, with both products as ``torch.matmul``. The CPU dispatch
  of ``causal_mha`` (the JAX package runs its exact formulation on its
  CPU, where ``attention_supported`` is false), and the reference whose
  autograd K3's backward is held against. Its reduction order follows the
  GEMM's choice of kernel, so it is not decode-stable.
- ``causal_mha_dot``: the batched-product formulation (``_causal_mha_dot``):
  the scores as an f32 product of the inputs, p rounded to the compute
  dtype before the product with v. The plain version of K3, and the
  recompute that K3's backward differentiates.
- ``causal_mha``: dispatch by device (ops/registry.py). A CPU tensor runs
  ``causal_mha_exact``. A CUDA tensor runs ``csrc/flash_attn_fwd.cu`` (K3,
  op ``flash_attn_fwd``, replaces ``_flash_kernel``) for the cases it
  covers (q_start == 0, tq == tk, bf16 or f32, dh 64 or any multiple of
  128), which include every call the JAX flash kernel takes; what the
  JAX package sends to XLA and K3 does not cover takes the composed
  route (``attention_route``: ``causal_mha_exact`` on the card's
  tensors, counted under ``flash_attn:composed[<reason>]``); with grad
  on K3 goes through ``FlashAttentionFn``, whose backward recomputes
  through ``causal_mha_dot`` by autograd, as ``_flash_vjp_bwd`` does.
  ``flash_route`` picks the kernel: at dh 64 and 128 bf16 runs the
  Hopper kernel (TMA loads, wgmma products; each launch also counted
  under ``flash_attn_fwd_sm90``), f32 the f32-FMA kernel (the tensor
  cores' f32 path, TF32, would round the inputs); every other dh (256,
  384, ...) takes the wide route (the output's dh split over blocks, each
  recomputing the row statistics; each launch also counted under
  ``flash_attn_fwd_wide``): bf16 on the wide Hopper kernel (TMA, wgmma,
  slices of 256 columns; also counted under ``flash_attn_fwd_wide_sm90``;
  ``wide_sm90_plan`` states its layout), f32 on the FMA wide kernel.
  ``launch_route`` names a call's kernel, ``ROUTE_COUNTERS`` its
  counters. A failure raises, naming the route; nothing falls back.
- ``extend_cache``: the streaming KV-cache write, with
  ``lax.dynamic_update_slice``'s clamp of the start.
- ``decode_mha``: incremental decode, the new tokens' queries against the
  fixed-extent cache from each row's own position. It runs the
  order-fixed ``stream_mha`` (ops/stream_exact.py: the plain loop on the
  CPU, the kernel S2 on the card), so a token's output has the same bits
  whatever the query length, the bucket or the position it was fed at;
  the attention layers' streaming path attends through it.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from deeplearning4j_tpu_torch.ops import registry, stream_exact

KERNEL = "flash_attn_fwd"
KERNEL_SM90 = "flash_attn_fwd_sm90"  # launches on the bf16 (sm90) route
KERNEL_WIDE = "flash_attn_fwd_wide"  # launches on the wide route
# bf16 launches on the wide route, on flash_fwd_wide_kernel_sm90
KERNEL_WIDE_SM90 = "flash_attn_fwd_wide_sm90"
# the head sizes K3's sm90 and FMA kernels are compiled for; the wide
# kernel takes every other multiple of WIDE_DH_STEP
KERNEL_HEAD_DIMS = (64, 128)
WIDE_DH_STEP = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _positions(q_start, tq, device):
    """Absolute position of every query row: [b|1, tq] int32. An int
    ``q_start`` is a range on the device (a copy of a host value would
    keep a captured train step from capturing)."""
    if isinstance(q_start, int):
        return torch.arange(q_start, q_start + tq, dtype=torch.int32,
                            device=device)[None, :]
    qs = torch.as_tensor(q_start, dtype=torch.int32, device=device)
    if qs.dim() == 0:
        qs = qs[None]
    return qs[:, None] + torch.arange(tq, dtype=torch.int32,
                                      device=device)[None, :]


def _mask_softmax(s, q_start, tq, tk):
    """The shared mask and softmax tail: (p, l), p the unnormalised
    exp-weights [b, h, tq, tk] and l the per-row sum [b, h, tq, 1]."""
    qpos = _positions(q_start, tq, s.device)             # [b|1, tq]
    j = torch.arange(tk, dtype=torch.int32, device=s.device)
    visible = qpos[:, None, :, None] >= j[None, None, None, :]
    s = torch.where(visible, s, float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True)              # >= one real score
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    return p, l


def _attend(q, k, v, q_start, round_p):
    """Causal MHA with f32 scores, softmax and products; p is rounded to
    the compute dtype before the product with v when ``round_p``."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    cd = q.dtype
    acc = torch.promote_types(cd, torch.float32)
    scale = 1.0 / math.sqrt(dh)
    qh = q.transpose(1, 2).to(acc)                       # [b, h, tq, dh]
    kh = k.transpose(1, 2).to(acc)                       # [b, h, tk, dh]
    vh = v.transpose(1, 2).to(acc)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale   # [b, h, tq, tk]
    p, l = _mask_softmax(s, q_start, tq, tk)
    if round_p:
        p = p.to(cd).to(acc)
    out = torch.matmul(p, vh) / l                        # [b, h, tq, dh]
    return out.transpose(1, 2).to(cd)


@registry.register("causal_mha", "cpu")
def causal_mha_exact(q, k, v, *, q_start=0):
    """Causal MHA with f32 products and sums, normalised after the
    weighted sum (the flash acc/l form). ``q_start`` is the absolute
    position of q's first row: an int, or [b] per row (a streaming call
    against a KV cache). Returns [b, tq, h, dh] in q's dtype."""
    return _attend(q, k, v, q_start, round_p=False)


def causal_mha_dot(q, k, v, *, q_start=0):
    """The batched-product formulation: as ``causal_mha_exact``, but p is
    rounded to the compute dtype before the f32 product with v. K3
    computes this function (it rounds p at the same place), so it is the
    kernel's plain version."""
    return _attend(q, k, v, q_start, round_p=True)


def causal_mha(q, k, v, *, q_start=0):
    """Causal MHA through the registry (the layers' training and output
    path): the exact formulation on the CPU, K3 on the card."""
    return registry.get("causal_mha", q.device)(q, k, v, q_start=q_start)


@registry.register("causal_mha", "cuda")
def _causal_mha_cuda(q, k, v, *, q_start=0):
    """K3 where ``attention_route`` says "kernel"; the composed route,
    ``causal_mha_exact`` on the card's tensors (what the CPU runs, and
    the JAX package's XLA route), counted under
    ``flash_attn:composed[<reason>]``."""
    b, tq, tk, h, dh = check_attention_inputs(q, k, v)
    route, reason = _attention_route(q.dtype, tq, tk, dh, q_start)
    if route == "composed":
        registry.count_route("flash_attn", reason)
        return causal_mha_exact(q, k, v, q_start=q_start)
    check_flash_inputs(q, k, v, q_start)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v)
    return flash_attn_fwd_cuda(q, k, v)


class FlashAttentionFn(torch.autograd.Function):
    """K3 forward with the recompute backward (counterpart of the
    ``jax.custom_vjp`` around ``_flash``): the forward runs the
    ``flash_attn_fwd`` op and saves q, k, v; the backward differentiates
    ``causal_mha_dot`` at q_start 0 with torch autograd, as
    ``_flash_vjp_bwd`` does. The JAX package computes that backward
    outside any Pallas kernel, so its products here are ``torch.matmul``."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return registry.get("flash_attn_fwd", q.device)(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = causal_mha_dot(*leaves)
            return torch.autograd.grad(out, leaves, g.to(out.dtype))


@registry.register("flash_attn_fwd", "cpu")
def flash_attn_fwd_torch(q, k, v):
    """K3's plain version: ``causal_mha_dot`` at q_start 0."""
    return causal_mha_dot(q, k, v)


def decode_mha(q, k_cache, v_cache, pos):
    """Incremental decode: ``q`` [b, t_new, h, dh] holds the new tokens'
    queries, the caches [b, C, h, dh] hold every earlier position and the
    new tokens (written by ``extend_cache``), ``pos`` [b] is each row's
    prefix length. Row i of the step attends keys j <= pos + i, the
    visible set the full-sequence forward gives that position, summed in
    one fixed order (``stream_mha``). Returns f32 [b, t_new, h, dh]."""
    return stream_exact.stream_mha(q, k_cache, v_cache, pos)


def extend_cache(k_cache, v_cache, k_new, v_new, pos):
    """Write t_new rows per batch row into the caches at that row's own
    offset: cache[i, s:s + t_new] = new[i] with s = pos[i] clamped to
    [0, C - t_new], as ``lax.dynamic_update_slice`` clamps its start so the
    slice fits. Caches [b, C, h, dh]; returns new caches (the inputs are
    left as they are)."""
    b, t = k_new.shape[0], k_new.shape[1]
    C = k_cache.shape[1]
    pos = torch.as_tensor(pos, device=k_cache.device)
    start = torch.clamp(pos.to(torch.int64).reshape(-1).expand(b), 0,
                        max(C - t, 0))
    rows = torch.arange(b, device=k_cache.device)[:, None]
    cols = start[:, None] + torch.arange(t, device=k_cache.device)[None, :]

    def write(cache, new):
        out = cache.clone()
        out[rows, cols] = new.to(cache.dtype)
        return out

    return write(k_cache, k_new), write(v_cache, v_new)


# ----------------------------------------------------------------- cuda
# the JAX flash kernel's tiles and the VMEM budget its predicate holds a
# configuration to (``attention_supported``)
_JAX_BQ = _JAX_BK = 128
_JAX_VMEM_BUDGET = 12 * 1024 * 1024


def _jax_flash_takes(dtype, tq, tk, dh) -> bool:
    """The JAX package's ``attention_supported`` as it answers on a TPU
    for q_start 0 and a bf16/f32 dtype: tq == tk, dh a multiple of 128,
    T a multiple of its 128-row tiles, and its VMEM footprint in
    budget."""
    if tq != tk or dh % 128 or tq % _JAX_BQ or tk % _JAX_BK:
        return False
    itemsize = 2 if dtype == torch.bfloat16 else 4
    foot = (3 * 2 * _JAX_BQ * dh * itemsize + _JAX_BQ * dh * (itemsize + 4)
            + 2 * _JAX_BQ * 128 * 4 + 2 * _JAX_BQ * _JAX_BK * 4)
    return foot <= _JAX_VMEM_BUDGET


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _attention_route(dtype, tq, tk, dh, q_start=0):
    """(route, reason): see ``attention_route``."""
    if not (isinstance(q_start, int) and q_start == 0):
        return "composed", "q_start"
    if dtype not in _DTYPE_CODES:
        return "composed", f"dtype={_dtype_name(dtype)}"
    if tq != tk:
        return "composed", "tq!=tk"
    if dh in KERNEL_HEAD_DIMS or _jax_flash_takes(dtype, tq, tk, dh):
        return "kernel", None
    return "composed", f"dh={dh}"


def attention_route(dtype, tq, tk, dh, q_start=0) -> str:
    """Where causal MHA on CUDA tensors runs: "kernel" (K3) for q_start
    0, tq == tk, bf16 or f32 at dh 64 or 128 (the JAX package sends dh 64
    to XLA, the port keeps K3 there) and at every head size the JAX flash
    kernel takes (dh % 128 == 0, T % 128 == 0, within its VMEM budget:
    the wide kernel, ``flash_route``); "composed" (``causal_mha_exact`` on
    the card's tensors) exactly where the JAX package's
    ``attention_supported`` sends the call to XLA and K3's routes do not
    take it: q_start != 0 (or a per-row q_start), tq != tk, a dtype other
    than bf16 and f32, or another head size (dh % 128 != 0, T % 128 != 0,
    past the budget). Nothing raises."""
    return _attention_route(dtype, tq, tk, dh, q_start)[0]


def check_attention_inputs(q, k, v):
    """``ValueError`` for malformed q, k, v [b, t, h, dh] whatever route
    the call takes: k and v of one shape, the batch, heads and head size
    of q, the same dtype and device. Returns (b, tq, tk, h, dh)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [b, t, h, dh]")
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    want = (b, tk, h, dh)
    for name, x in (("k", k), ("v", v)):
        if tuple(x.shape) != want:
            raise ValueError(f"{name} must be {want}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if b < 1 or tq < 1 or tk < 1 or h < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    return b, tq, tk, h, dh


def check_flash_inputs(q, k, v, q_start=0):
    """Raise ``NotImplementedError``, naming the reason, for a call that K3
    does not cover: q_start != 0 (incremental decode), tq != tk, a head
    size other than 64 and the multiples of 128, or a dtype other than
    f32 and bf16; and ``ValueError`` for malformed inputs. Returns (b, T,
    h, dh)."""
    if not (isinstance(q_start, int) and q_start == 0):
        raise NotImplementedError(
            "flash_attn_fwd covers q_start == 0 only; incremental decode "
            f"(q_start={q_start!r}) has no CUDA kernel yet")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [b, t, h, dh]")
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if tq != tk:
        raise NotImplementedError(
            f"flash_attn_fwd covers tq == tk only, got tq={tq}, tk={tk}")
    if dh not in KERNEL_HEAD_DIMS and (dh < WIDE_DH_STEP
                                       or dh % WIDE_DH_STEP):
        raise NotImplementedError(
            f"flash_attn_fwd covers head size dh in {KERNEL_HEAD_DIMS} "
            f"and every multiple of {WIDE_DH_STEP}, got dh={dh}")
    if q.dtype not in _DTYPE_CODES:
        raise NotImplementedError(
            f"flash_attn_fwd takes float32 or bfloat16, got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if tuple(x.shape) != tuple(q.shape):
            raise ValueError(f"{name} must be {tuple(q.shape)}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if b < 1 or tq < 1 or h < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    return b, tq, h, dh


def _bind():
    from deeplearning4j_tpu_torch.ops import _build

    lib = _build.load(KERNEL)
    if getattr(lib, "_dl4j_bound", False):
        return lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dl4j_flash_attn_fwd.argtypes = [i32] + [ptr] * 4 + [i32] * 4 + [ptr]
    lib.dl4j_flash_attn_fwd.restype = i32
    lib.dl4j_flash_attn_fwd_smem_bytes.argtypes = [i32, i32]
    lib.dl4j_flash_attn_fwd_smem_bytes.restype = i32
    lib.dl4j_flash_attn_fwd_sm90.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.dl4j_flash_attn_fwd_sm90.restype = i32
    lib.dl4j_flash_attn_fwd_sm90_smem_bytes.argtypes = [i32]
    lib.dl4j_flash_attn_fwd_sm90_smem_bytes.restype = i32
    lib.dl4j_flash_attn_fwd_wide.argtypes = [i32] + [ptr] * 4 + [i32] * 4 \
        + [ptr]
    lib.dl4j_flash_attn_fwd_wide.restype = i32
    lib.dl4j_flash_attn_fwd_wide_smem_bytes.argtypes = []
    lib.dl4j_flash_attn_fwd_wide_smem_bytes.restype = i32
    lib.dl4j_flash_attn_fwd_wide_sm90.argtypes = [ptr] * 4 + [i32] * 4 \
        + [ptr]
    lib.dl4j_flash_attn_fwd_wide_sm90.restype = i32
    lib.dl4j_flash_attn_fwd_wide_sm90_smem_bytes.argtypes = [i32]
    lib.dl4j_flash_attn_fwd_wide_sm90_smem_bytes.restype = i32
    lib.dl4j_cuda_error_string.argtypes = [i32]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    lib._dl4j_bound = True
    return lib


def flash_flops(b, T, h, dh) -> int:
    """K3's operations as FlopCounterMode counts its plain version
    (``causal_mha_dot``): q kᵀ and p v over the whole T x T square (the
    causal mask is applied to the scores, not to the products)."""
    return 4 * b * h * T * T * dh


# flash_fwd_wide_kernel_sm90's layout (csrc/flash_attn_fwd.cu, fw90):
# output slices of 256 columns, a ring of 4 stages of 32 KB, 1 KB of
# alignment and 9 barriers, 128 query rows a block (two warpgroups) where
# that q tile fits beside them in bf16, else 64, and q resident where its
# tile fits
WIDE_SM90_SLICE = 256
WIDE_SM90_STAGES = 4
WIDE_SM90_STAGE_BYTES = 32 * 1024
SMEM_PER_BLOCK = 232448          # the most shared memory an H100 block has


#: the wide Hopper kernel at one head size: ``slices`` the (first column,
#: width) of each block's output slice along dh, ``q_rows`` a block's
#: query rows (64 a consumer warpgroup)
WideSm90Plan = collections.namedtuple(
    "WideSm90Plan", "slices q_resident stages smem_bytes q_rows")


def wide_sm90_plan(dh) -> WideSm90Plan:
    """The wide Hopper kernel's choices at head size ``dh`` (a multiple of
    128 from 256 up; ``ValueError`` otherwise), as its C side makes them
    (``dl4j_flash_attn_fwd_wide_sm90_smem_bytes`` gives the same bytes):
    the output's dh in slices of 256 columns, the last 128 where dh % 256
    == 128, each slice one block's accumulator (128 f32 a thread of a
    warpgroup); 128 query rows a block (two warpgroups sharing each k and
    v tile) where that q tile fits in shared memory beside the ring (dh
    <= 384), else 64; q resident where its tile fits (dh <= 768), else
    streamed through the ring with k."""
    if dh < 2 * WIDE_DH_STEP or dh % WIDE_DH_STEP:
        raise ValueError(f"the wide sm90 kernel takes multiples of "
                         f"{WIDE_DH_STEP} from {2 * WIDE_DH_STEP}, got "
                         f"dh={dh}")
    slices = tuple((d0, min(WIDE_SM90_SLICE, dh - d0))
                   for d0 in range(0, dh, WIDE_SM90_SLICE))
    fixed = (1024 + WIDE_SM90_STAGES * WIDE_SM90_STAGE_BYTES
             + (1 + 2 * WIDE_SM90_STAGES) * 8)
    rows = 128 if fixed + 128 * dh * 2 <= SMEM_PER_BLOCK else 64
    q_tile = rows * dh * 2
    resident = fixed + q_tile <= SMEM_PER_BLOCK
    return WideSm90Plan(slices, resident, WIDE_SM90_STAGES,
                        fixed + (q_tile if resident else 0), rows)


#: the launch counters one K3 call on the card adds 1 to, by its
#: ``launch_route``
ROUTE_COUNTERS = {
    "sm90": (KERNEL, KERNEL_SM90),
    "fma": (KERNEL,),
    "wide": (KERNEL, KERNEL_WIDE),
    "wide_sm90": (KERNEL, KERNEL_WIDE, KERNEL_WIDE_SM90),
}


def launch_route(dtype, dh=64) -> str:
    """The kernel a K3 call on the card launches: ``flash_route``'s, with
    the wide route's bf16 calls on the wide Hopper kernel ("wide_sm90")
    and its f32 calls on the FMA wide kernel ("wide")."""
    route = flash_route(dtype, dh)
    if route == "wide" and dtype == torch.bfloat16:
        return "wide_sm90"
    return route


def flash_route(dtype, dh=64):
    """The kernel K3 runs for inputs of ``dtype`` at head size ``dh``:
    "wide" for a dh outside ``KERNEL_HEAD_DIMS`` (either dtype), else
    "sm90" (bf16: TMA and wgmma) or "fma" (f32: f32 FMA). Raises for any
    other dtype."""
    if dtype not in _DTYPE_CODES:
        raise NotImplementedError(
            f"flash_attn_fwd takes float32 or bfloat16, got {dtype}")
    if dh not in KERNEL_HEAD_DIMS:
        return "wide"
    return "sm90" if dtype == torch.bfloat16 else "fma"


@registry.register("flash_attn_fwd", "cuda")
def flash_attn_fwd_cuda(q, k, v):
    """Launch csrc/flash_attn_fwd.cu on the current stream: causal MHA
    over contiguous q/k/v [b, T, h, dh], read in that layout; at dh 64 and
    128 bf16 on the sm90 kernel and f32 on the FMA kernel, at any other
    multiple of 128 the wide route (``flash_route``): bf16 on the wide
    sm90 kernel, f32 on the FMA wide kernel. Raises on what the kernel
    does not take; never falls back to the other kernel or to the plain
    version."""
    b, T, h, dh = check_flash_inputs(q, k, v)
    route = launch_route(q.dtype, dh)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd needs CUDA tensors, got "
                         f"{q.device} (the {route} route's kernel runs on "
                         f"the card only)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous [b, T, h, dh]")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(the kernel loads 16 bytes at a time)")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "the flash_attn_fwd wrapper records no graph; call causal_mha, "
            "which differentiates through FlashAttentionFn, or run under "
            "torch.inference_mode()/torch.no_grad()")
    lib = _bind()
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    code = _DTYPE_CODES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "sm90":
            rc = lib.dl4j_flash_attn_fwd_sm90(*ptrs, b, T, h, dh, stream)
        elif route == "wide_sm90":
            rc = lib.dl4j_flash_attn_fwd_wide_sm90(*ptrs, b, T, h, dh,
                                                   stream)
        elif route == "wide":
            rc = lib.dl4j_flash_attn_fwd_wide(code, *ptrs, b, T, h, dh,
                                              stream)
        else:
            rc = lib.dl4j_flash_attn_fwd(code, *ptrs, b, T, h, dh, stream)
    if rc != 0:
        msg = lib.dl4j_cuda_error_string(rc).decode()
        smem = (lib.dl4j_flash_attn_fwd_sm90_smem_bytes(dh) if route == "sm90"
                else lib.dl4j_flash_attn_fwd_wide_sm90_smem_bytes(dh)
                if route == "wide_sm90"
                else lib.dl4j_flash_attn_fwd_wide_smem_bytes()
                if route == "wide"
                else lib.dl4j_flash_attn_fwd_smem_bytes(code, dh))
        raise RuntimeError(
            f"flash_attn_fwd kernel launch failed on the {route} route "
            f"(b={b}, T={T}, h={h}, dh={dh}, {q.dtype}, {smem} B shared "
            f"memory per block): cudaError {rc}: {msg}")
    counters = ROUTE_COUNTERS[route]
    for name in counters:
        registry.count_launch(name)
    registry.count_flops(KERNEL, flash_flops(b, T, h, dh))
    registry.note_kernel(KERNEL, out, counters[1:])
    return out
