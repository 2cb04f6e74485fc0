"""Causal multi-head attention: plain PyTorch versions and the Hopper
flash-attention kernel's wrapper (counterpart of
deeplearning4j_tpu/ops/attention.py).

Tensors are in the layers' layout, q/k/v [b, t, h, dh]. Scores and the
softmax run in f32 whatever the compute dtype; masked positions get
``-inf`` in the plain versions, so they add an exact 0.0 to every sum.

- ``causal_mha_exact``: the JAX package's contract-bearing formulation
  (``_causal_mha_exact``): f32 products and sums, normalised after the
  weighted sum. The CPU dispatch of ``causal_mha`` (the JAX package runs
  it on its CPU, where ``attention_supported`` is false) and the
  attention layers' streaming path on either device.
- ``causal_mha_dot``: the batched-product formulation (``_causal_mha_dot``):
  the scores as an f32 product of the inputs, p rounded to the compute
  dtype before the product with v. The plain version of K3, and the
  recompute that K3's backward differentiates.
- ``causal_mha``: dispatch by device (ops/registry.py). A CPU tensor runs
  ``causal_mha_exact``. A CUDA tensor runs ``csrc/flash_attn_fwd.cu`` (K3,
  op ``flash_attn_fwd``, replaces ``_flash_kernel``) for the case it
  covers (q_start == 0, tq == tk, dh 64 or 128, bf16 or f32) and raises
  ``NotImplementedError`` for anything else; with grad on it goes through
  ``FlashAttentionFn``, whose backward recomputes through
  ``causal_mha_dot`` by autograd, as ``_flash_vjp_bwd`` does. The dtype
  picks the kernel (``flash_route``): bf16 runs the Hopper kernel (TMA
  loads, wgmma products; each launch also counted under
  ``flash_attn_fwd_sm90``), f32 the f32-FMA kernel (the tensor cores' f32
  path, TF32, would round the inputs). A failure raises, naming the
  route; nothing falls back.
- ``extend_cache``: the streaming KV-cache write, with
  ``lax.dynamic_update_slice``'s clamp of the start.

Incremental decode (``decode_mha``, q_start != 0 on the card) is not
ported yet: the streaming path attends through ``causal_mha_exact``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deeplearning4j_tpu_torch.ops import registry

KERNEL = "flash_attn_fwd"
KERNEL_SM90 = "flash_attn_fwd_sm90"  # launches on the bf16 (sm90) route
# the head sizes K3 is compiled for
KERNEL_HEAD_DIMS = (64, 128)
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
def check_flash_inputs(q, k, v, q_start=0):
    """Raise ``NotImplementedError``, naming the reason, for a call that K3
    does not cover: q_start != 0 (incremental decode), tq != tk, a head
    size other than 64 or 128, or a dtype other than f32 and bf16; and
    ``ValueError`` for malformed inputs. Returns (b, T, h, dh)."""
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
    if dh not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attn_fwd covers head size dh in {KERNEL_HEAD_DIMS}, "
            f"got dh={dh}")
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
    lib.dl4j_cuda_error_string.argtypes = [i32]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    lib._dl4j_bound = True
    return lib


def flash_flops(b, T, h, dh) -> int:
    """K3's operations as FlopCounterMode counts its plain version
    (``causal_mha_dot``): q kᵀ and p v over the whole T x T square (the
    causal mask is applied to the scores, not to the products)."""
    return 4 * b * h * T * T * dh


def flash_route(dtype):
    """The kernel K3 runs for inputs of ``dtype``: "sm90" (bf16: TMA and
    wgmma) or "fma" (f32: f32 FMA). Raises for any other dtype."""
    if dtype == torch.bfloat16:
        return "sm90"
    if dtype == torch.float32:
        return "fma"
    raise NotImplementedError(
        f"flash_attn_fwd takes float32 or bfloat16, got {dtype}")


@registry.register("flash_attn_fwd", "cuda")
def flash_attn_fwd_cuda(q, k, v):
    """Launch csrc/flash_attn_fwd.cu on the current stream: causal MHA
    over contiguous q/k/v [b, T, h, dh], read in that layout; bf16 on the
    sm90 kernel, f32 on the FMA kernel (``flash_route``). Raises on what
    the kernel does not take; never falls back to the other kernel or to
    the plain version."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd needs CUDA tensors, got "
                         f"{q.device}")
    b, T, h, dh = check_flash_inputs(q, k, v)
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
    route = flash_route(q.dtype)
    lib = _bind()
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    code = _DTYPE_CODES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "sm90":
            rc = lib.dl4j_flash_attn_fwd_sm90(*ptrs, b, T, h, dh, stream)
        else:
            rc = lib.dl4j_flash_attn_fwd(code, *ptrs, b, T, h, dh, stream)
    if rc != 0:
        msg = lib.dl4j_cuda_error_string(rc).decode()
        smem = (lib.dl4j_flash_attn_fwd_sm90_smem_bytes(dh) if route == "sm90"
                else lib.dl4j_flash_attn_fwd_smem_bytes(code, dh))
        raise RuntimeError(
            f"flash_attn_fwd kernel launch failed on the {route} route "
            f"(b={b}, T={T}, h={h}, dh={dh}, {q.dtype}, {smem} B shared "
            f"memory per block): cudaError {rc}: {msg}")
    registry.count_launch(KERNEL)
    if route == "sm90":
        registry.count_launch(KERNEL_SM90)
    registry.count_flops(KERNEL, flash_flops(b, T, h, dh))
    return out
