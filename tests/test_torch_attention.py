"""Causal attention in the port (deeplearning4j_tpu_torch/ops/attention.py)
against the JAX package's (deeplearning4j_tpu/ops/attention.py), on the
CPU: the exact and batched-product formulations, the flash kernel's
function (the JAX side runs ``_flash`` in Pallas interpret mode), its
recompute backward, the KV-cache write and the CUDA gate.

Tolerances, each with its reason:

- f32: 1e-5 abs and rel, the JAX package's own forward tolerance (the same
  f32 products summed in another order).
- bf16, the same formulation in both packages: one bf16 ulp at the
  output's largest magnitude. Both compute in f32 from the same bf16
  inputs and round once at the end; an f32 sum in another order can land
  that one rounding the other way.
- bf16, the flash function vs the batched-product one: two bf16 ulps at
  the largest |v|, which bounds |out| (out is a convex combination of v's
  rows). The flash form rounds p = exp(s - m) to bf16 against each tile's
  running max and rescales by alpha in f32, the product form against the
  row's final max: each weight may differ by 2**-8 relative, so out by
  2**-8 * max|v| (one ulp at max|v|), plus each side's final rounding
  (half an ulp each).
- Gradients of the recompute backward vs ``jax.grad`` of ``_flash``: 2e-4
  abs and rel, the JAX package's own gradient tolerance.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as jatt
from deeplearning4j_tpu_torch.ops import attention as tatt
from deeplearning4j_tpu_torch.ops import registry

F32_TOL = 1e-5
GRAD_TOL = 2e-4


def _qkv(b, t, h, dh, seed, tk=None):
    rng = np.random.default_rng(seed)
    tk = t if tk is None else tk
    return (rng.normal(0, 0.5, (b, t, h, dh)).astype(np.float32),
            rng.normal(0, 0.5, (b, tk, h, dh)).astype(np.float32),
            rng.normal(0, 0.5, (b, tk, h, dh)).astype(np.float32))


_JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax(arrs, dtype):
    return [jnp.asarray(a, _JD[dtype]) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(_TD[dtype]) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulp(top):
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def _assert_close(got, want, dtype, ulps=1, ulp_ref=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        top = float(np.abs(want).max() if ulp_ref is None else ulp_ref)
        assert np.abs(got - want).max() <= ulps * _ulp(top)


SHAPES = [(2, 16, 2, 16), (1, 7, 4, 8), (3, 33, 2, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_causal_mha_on_cpu_matches_jax_xla(shape, dtype):
    arrs = _qkv(*shape, seed=1)
    want = jatt.causal_mha_xla(*_jax(arrs, dtype))
    got = tatt.causal_mha(*_torch(arrs, dtype))
    assert got.dtype == _TD[dtype]
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_causal_mha_dot_matches_jax_xla_dot(shape, dtype):
    arrs = _qkv(*shape, seed=2)
    want = jatt.causal_mha_xla_dot(*_jax(arrs, dtype))
    got = tatt.causal_mha_dot(*_torch(arrs, dtype))
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_with_per_row_q_start_matches_jax(dtype):
    """A streaming call: 3 new queries per row against a cache of 12, each
    row at its own position."""
    arrs = _qkv(2, 3, 2, 16, seed=3, tk=12)
    pos = np.array([0, 7], np.int32)
    want = jatt.causal_mha_exact(*_jax(arrs, dtype), q_start=jnp.asarray(pos))
    got = tatt.causal_mha_exact(*_torch(arrs, dtype),
                                q_start=torch.from_numpy(pos))
    _assert_close(got, want, dtype)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_flash_interpret(pallas_interpret, dtype):
    """At the JAX package's own flash-test shape, where ``_flash`` runs
    its Pallas kernel in interpret mode."""
    arrs = _qkv(2, 128, 2, 128, seed=4)
    jq, jk, jv = _jax(arrs, dtype)
    assert jatt.attention_supported(jq, jk, jv)
    want = jatt._flash(jq, jk, jv)
    got = tatt.flash_attn_fwd_torch(*_torch(arrs, dtype))
    vmax = float(np.abs(_np(jv)).max())
    _assert_close(got, want, dtype, ulps=2, ulp_ref=vmax)
    _assert_close(tatt.causal_mha_exact(*_torch(arrs, dtype)), want, dtype,
                  ulps=2, ulp_ref=vmax)


def _weighted(y):
    n = y.numel() if isinstance(y, torch.Tensor) else y.size
    w = np.cos(np.arange(n, dtype=np.float64)).reshape(y.shape)
    if isinstance(y, torch.Tensor):
        return torch.sum(y * torch.from_numpy(w.astype(np.float32)))
    return jnp.sum(y * jnp.asarray(w, jnp.float32))


def test_recompute_backward_matches_jax_grad_of_flash(pallas_interpret):
    arrs = _qkv(1, 128, 2, 128, seed=5)
    jg = jax.grad(lambda q, k, v: _weighted(jatt._flash(q, k, v)),
                  argnums=(0, 1, 2))(*_jax(arrs, "float32"))
    leaves = [t.requires_grad_() for t in _torch(arrs, "float32")]
    out = tatt.FlashAttentionFn.apply(*leaves)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    tg = torch.autograd.grad(_weighted(out), leaves)
    for name, g, w in zip(("dq", "dk", "dv"), tg, jg):
        np.testing.assert_allclose(_np(g), _np(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_recompute_backward_in_bf16_keeps_the_compute_dtype():
    arrs = _qkv(1, 9, 2, 16, seed=6)
    leaves = [t.requires_grad_() for t in _torch(arrs, "bfloat16")]
    out = tatt.FlashAttentionFn.apply(*leaves)
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert all(g.dtype == torch.bfloat16 and g.shape == x.shape
               for g, x in zip(grads, leaves))


@pytest.mark.parametrize("pos,t", [([0, 3], 2), ([5, 1], 3), ([7, 9], 4),
                                   ([12, 0], 4)],
                         ids=["start", "mid", "clamped", "past_end"])
def test_extend_cache_matches_jax(pos, t):
    """Caches of 10 rows; a start past C - t is clamped as
    ``lax.dynamic_update_slice`` clamps it."""
    rng = np.random.default_rng(7)
    kc, vc = (rng.normal(size=(2, 10, 2, 4)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.normal(size=(2, t, 2, 4)).astype(np.float32)
              for _ in range(2))
    p = np.asarray(pos, np.int32)
    jk, jv = jatt.extend_cache(jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(kn), jnp.asarray(vn),
                               jnp.asarray(p))
    tk, tv = tatt.extend_cache(*(torch.from_numpy(a) for a in (kc, vc, kn,
                                                                vn, p)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the inputs are left as they are
    assert not np.array_equal(tk.numpy(), kc)


@pytest.mark.parametrize("over,match", [
    ({"q_start": 3}, "q_start"),
    ({"q_start": torch.zeros(2, dtype=torch.int32)}, "q_start"),
    ({"tk": 8}, "tq == tk"),
    ({"dh": 32}, "head size"),
    ({"dh": 96}, "head size"),
    ({"dtype": torch.float16}, "float32 or bfloat16"),
])
def test_cuda_gate_refuses_by_name(over, match):
    """Checked through the gate's predicate, which needs no card."""
    b, t, h = 2, 16, 2
    dh = over.get("dh", 64)
    tk = over.get("tk", t)
    dt = over.get("dtype", torch.float32)
    q = torch.zeros(b, t, h, dh, dtype=dt)
    k = torch.zeros(b, tk, h, dh, dtype=dt)
    with pytest.raises(NotImplementedError, match=match):
        tatt.check_flash_inputs(q, k, k, over.get("q_start", 0))


@pytest.mark.parametrize("dh", tatt.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t", [(1, 1), (2, 200), (32, 256)])
def test_cuda_gate_accepts_what_the_kernel_covers(b, t, dtype, dh):
    q = torch.zeros(b, t, 2, dh, dtype=dtype)
    assert tatt.check_flash_inputs(q, q, q, 0) == (b, t, 2, dh)


@pytest.mark.parametrize("over,match", [
    ({"q_start": 3}, "q_start"),
    ({"tk": 8}, "tq == tk"),
    ({"dh": 32}, "head size"),
    ({"dh": 256}, "head size"),
])
def test_cuda_gate_refuses_bf16_calls_the_sm90_route_does_not_cover(over,
                                                                    match):
    """bf16 takes the sm90 kernel, and the gate in front of it refuses the
    same calls by name as for f32."""
    b, t, h = 2, 16, 2
    dh, tk = over.get("dh", 64), over.get("tk", t)
    q = torch.zeros(b, t, h, dh, dtype=torch.bfloat16)
    k = torch.zeros(b, tk, h, dh, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match=match):
        tatt.check_flash_inputs(q, k, k, over.get("q_start", 0))


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "sm90"),
                                         (torch.float32, "fma")])
def test_route_is_chosen_by_dtype_alone(dtype, route):
    """bf16 runs the Hopper kernel (TMA, wgmma), f32 the f32-FMA kernel
    (the tensor cores' f32 path would round the inputs to TF32)."""
    assert tatt.flash_route(dtype) == route


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_route_refuses_other_dtypes_by_name(dtype):
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        tatt.flash_route(dtype)


def test_cuda_gate_refuses_malformed_inputs():
    q = torch.zeros(2, 16, 2, 64)
    with pytest.raises(ValueError, match="v must be"):
        tatt.check_flash_inputs(q, q, torch.zeros(2, 16, 4, 64))
    with pytest.raises(ValueError, match="k is"):
        tatt.check_flash_inputs(q, q.to(torch.bfloat16), q)


def test_registry_dispatch_by_device():
    assert registry.get("causal_mha", "cpu") is tatt.causal_mha_exact
    assert registry.get("causal_mha", "cuda") is tatt._causal_mha_cuda
    assert registry.get("flash_attn_fwd", "cpu") is tatt.flash_attn_fwd_torch
    assert registry.get("flash_attn_fwd", "cuda") is tatt.flash_attn_fwd_cuda
    arrs = _torch(_qkv(2, 16, 2, 16, seed=8), "float32")
    assert torch.equal(tatt.causal_mha(*arrs), tatt.causal_mha_exact(*arrs))


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tatt.flash_attn_fwd_cuda(q, q, q)


def test_cuda_wrapper_refuses_cpu_tensors_on_the_sm90_route_too():
    """bf16 CPU tensors are refused before any route is taken, and
    nothing is counted."""
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    registry.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tatt.flash_attn_fwd_cuda(q, q, q)
    assert registry.launches() == {}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 128, 2, 128), (3, 200, 4, 64),
                                   (1, 1, 4, 64)], ids=str)
def test_cuda_kernel_matches_plain(cuda_device, shape, dtype):
    arrs = [t.to(cuda_device) for t in _torch(_qkv(*shape, seed=9), dtype)]
    with torch.inference_mode():
        got = tatt.flash_attn_fwd_cuda(*arrs)
        again = tatt.flash_attn_fwd_cuda(*arrs)
        want = tatt.flash_attn_fwd_torch(*arrs)
    assert torch.equal(got, again)
    vmax = float(arrs[2].float().abs().max())
    _assert_close(got.cpu(), want.cpu(), dtype, ulps=2, ulp_ref=vmax)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_launches_are_counted_by_route(cuda_device, dtype):
    arrs = [t.to(cuda_device)
            for t in _torch(_qkv(2, 64, 2, 64, seed=10), str(dtype)[6:])]
    registry.reset_launches()
    with torch.inference_mode():
        tatt.flash_attn_fwd_cuda(*arrs)
    want = {tatt.KERNEL: 1}
    if dtype == torch.bfloat16:
        want[tatt.KERNEL_SM90] = 1
    assert registry.launches() == want


def test_cuda_wrapper_refuses_grad_outside_the_function(cuda_device):
    q = torch.zeros(1, 4, 2, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="FlashAttentionFn"):
        tatt.flash_attn_fwd_cuda(q, q, q)
