"""The card's routes for the three kernel-backed ops (ops/lstm.py,
ops/attention.py, ops/fused_block.py) against the JAX package's own
predicates, case by case, on the CPU.

Each JAX predicate (``_pallas_supported``, ``attention_supported``,
``pallas_supported``) is evaluated with DL4J_TPU_PALLAS_INTERPRET=1, so it
answers as it does on a TPU, and set beside the port's route function:

- "composed" exactly where the JAX package sends the call to XLA and the
  port's kernel does not cover it;
- "kernel" wherever the port's kernel covers the call (it took it
  before: the LSTM's sigmoid/tanh in bf16 or f32 within the grid
  kernels' limits, K3's q_start 0, tq == tk, dh 64/128 in bf16 or f32,
  K4-K7's bf16 and f32), even where the JAX package goes to XLA (e.g.
  gpt_mini's dh = 64);
- a named ``NotImplementedError`` for the remainder: what the JAX kernel
  takes and the port's does not (the LSTM past K1/K2's limits at n %
  128 == 0, attention at dh 256 with T % 128 == 0).

The predicates read shapes and dtypes only, so the cases use
``jax.ShapeDtypeStruct`` stand-ins.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as jatt
from deeplearning4j_tpu.ops import fused_block as jfb
from deeplearning4j_tpu.ops import lstm as jlstm
from deeplearning4j_tpu_torch.ops import attention as tatt
from deeplearning4j_tpu_torch.ops import fused_block as tfb
from deeplearning4j_tpu_torch.ops import lstm as tlstm
from deeplearning4j_tpu_torch.ops import registry

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16),
          "float64": (torch.float64, jnp.float64)}


@pytest.fixture(autouse=True)
def as_on_a_tpu(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")


def _s(shape, dt):
    return jax.ShapeDtypeStruct(shape, dt)


def _port(fn, *args):
    try:
        return fn(*args)
    except NotImplementedError:
        return "raises"


def _expected(jax_takes, kernel_covers):
    if kernel_covers:
        return "kernel"
    return "raises" if jax_takes else "composed"


# ------------------------------------------------------------------ LSTM
LSTM_ACTS = [("sigmoid", "tanh"), ("hardsigmoid", "tanh"),
             ("sigmoid", "softsign")]


def _lstm_kernel_covers(td, n, acts, backward):
    """What K1/K2 took before this route existed: sigmoid/tanh in bf16 or
    f32, on the cluster route or within the grid kernels' limits."""
    return (acts == ("sigmoid", "tanh") and td in (torch.float32,
                                                   torch.bfloat16)
            and (tlstm.takes_cluster(td, n)
                 or tlstm.grid_fits(backward, td, n)))


@pytest.mark.parametrize("acts", LSTM_ACTS, ids=lambda a: "/".join(a))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lstm_route_beside_the_jax_predicate(dtype, acts):
    td, jd = DTYPES[dtype]
    seen = set()
    for b in (8, 16, 20, 32):
        for n in (8, 64, 96, 128, 512, 640, 896, 1000, 1024, 1792, 2048):
            jax_takes = jlstm._pallas_supported(
                _s((4, b, 4 * n), jd), _s((b, n), jd), *acts)
            for backward in (False, True):
                want = _expected(jax_takes, _lstm_kernel_covers(
                    td, n, acts, backward))
                got = _port(tlstm.lstm_route, td, b, n, *acts, backward)
                assert got == want, (b, n, backward, jax_takes)
                seen.add(got)
    if acts != ("sigmoid", "tanh") or dtype in ("float16", "float64"):
        assert seen == {"composed"}
    else:
        assert "kernel" in seen and "raises" in seen


def test_lstm_route_limits_and_reasons():
    f32, bf16 = torch.float32, torch.bfloat16
    # the grid kernels' limits (shared memory and residency on the card)
    assert tlstm.grid_fits(False, f32, 908) and not tlstm.grid_fits(
        False, f32, 916)
    assert tlstm.grid_fits(False, bf16, 1056) and not tlstm.grid_fits(
        False, bf16, 1064)
    assert tlstm.grid_fits(True, f32, 1056) and not tlstm.grid_fits(
        True, f32, 1064)
    assert tlstm.grid_fits(True, bf16, 1824) and not tlstm.grid_fits(
        True, bf16, 1832)
    # the cluster route holds bf16 to n = 512 whatever the grid's limits
    assert tlstm.lstm_route(bf16, 32, 512) == "kernel"
    assert tlstm._lstm_route(f32, 8, 8, "hardsigmoid", "tanh", False) == (
        "composed", "gate_act=hardsigmoid")
    assert tlstm._lstm_route(f32, 8, 8, "sigmoid", "softsign", True) == (
        "composed", "cell_act=softsign")
    assert tlstm._lstm_route(torch.float16, 8, 8, "sigmoid", "tanh",
                             False) == ("composed", "dtype=float16")
    assert tlstm._lstm_route(f32, 20, 1000, "sigmoid", "tanh", False) == (
        "composed", "n=1000")
    with pytest.raises(NotImplementedError, match="n=2048"):
        tlstm.lstm_route(f32, 32, 2048)


# ------------------------------------------------------------- attention
def _attention_kernel_covers(td, tq, tk, dh, q_start):
    """What K3 took before: ``check_flash_inputs``' gate."""
    q = torch.zeros(1, tq, 1, dh, dtype=td)
    k = torch.zeros(1, tk, 1, dh, dtype=td)
    try:
        tatt.check_flash_inputs(q, k, k, q_start)
        return True
    except NotImplementedError:
        return False


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("q_start", [0, 3, "per_row"])
def test_attention_route_beside_the_jax_predicate(dtype, q_start):
    td, jd = DTYPES[dtype]
    seen = set()
    for tq, tk in ((16, 16), (128, 128), (256, 256), (128, 64), (1, 1)):
        for dh in (32, 64, 96, 128, 192, 256, 384):
            qs = (torch.zeros(1, dtype=torch.int32) if q_start == "per_row"
                  else q_start)
            jqs = jnp.zeros(1, jnp.int32) if q_start == "per_row" \
                else q_start
            jax_takes = jatt.attention_supported(
                _s((1, tq, 2, dh), jd), _s((1, tk, 2, dh), jd),
                _s((1, tk, 2, dh), jd), jqs)
            want = _expected(jax_takes, _attention_kernel_covers(
                td, tq, tk, dh, qs))
            got = _port(tatt.attention_route, td, tq, tk, dh, qs)
            assert got == want, (tq, tk, dh, jax_takes)
            seen.add(got)
    if q_start != 0 or dtype in ("float16", "float64"):
        assert seen == {"composed"}
    else:
        assert seen == {"kernel", "composed", "raises"}


def test_attention_route_keeps_k3_where_the_jax_package_goes_to_xla():
    """gpt_mini's dh = 64: the JAX package's predicate sends it to XLA
    (dh % 128 != 0), the port keeps K3."""
    for td, jd in (DTYPES["bfloat16"], DTYPES["float32"]):
        q = _s((2, 256, 4, 64), jd)
        assert not jatt.attention_supported(q, q, q, 0)
        assert tatt.attention_route(td, 256, 256, 64) == "kernel"
    assert tatt._attention_route(torch.bfloat16, 256, 256, 32) == (
        "composed", "dh=32")
    assert tatt._attention_route(torch.float16, 256, 256, 64) == (
        "composed", "dtype=float16")
    assert tatt._attention_route(torch.float32, 8, 16, 64) == (
        "composed", "tq!=tk")
    assert tatt._attention_route(torch.float32, 8, 8, 64, 5) == (
        "composed", "q_start")
    with pytest.raises(NotImplementedError, match="dh=256"):
        tatt.attention_route(torch.bfloat16, 256, 256, 256)


def test_attention_inputs_malformed_raise_whatever_the_route():
    q = torch.zeros(2, 16, 2, 32, dtype=torch.float16)
    with pytest.raises(ValueError, match="v must be"):
        tatt.check_attention_inputs(q, q, torch.zeros(2, 16, 4, 32,
                                                      dtype=torch.float16))
    with pytest.raises(ValueError, match="k is"):
        tatt.check_attention_inputs(q, q.float(), q)
    with pytest.raises(ValueError, match="b, t, h, dh"):
        tatt.check_attention_inputs(q[0], q, q)
    k = torch.zeros(2, 8, 2, 32, dtype=torch.float16)
    assert tatt.check_attention_inputs(q, k, k) == (2, 16, 8, 2, 32)


# ------------------------------------------------------------ fused tail
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_route_beside_the_jax_predicate(dtype):
    td, jd = DTYPES[dtype]
    for M, K, N in ((64, 64, 128), (64, 128, 128), (35, 37, 5),
                    (256, 256, 512), (8, 64, 100)):
        jax_takes = jfb.pallas_supported(_s((M, K), jd), _s((K, N), jd),
                                         _s((M, N), jd))
        kernel_covers = td in (torch.float32, torch.bfloat16)
        assert tfb.fused_route(td) == _expected(jax_takes, kernel_covers)
    if dtype in ("float16", "float64"):
        assert not jax_takes


def test_fused_route_keeps_the_kernel_off_the_jax_kernel_s_shapes():
    """K = 37, N = 5: the JAX package goes to XLA (K % 64, N % 128), the
    port's K4-K7 cover it."""
    assert not jfb.pallas_supported(_s((35, 37), jnp.float32),
                                    _s((37, 5), jnp.float32))
    assert tfb.fused_route(torch.float32) == "kernel"


# ----------------------------------------------------- counted and named
def test_a_route_is_counted_and_logged_once_per_reason(caplog):
    registry.reset_launches()
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
        for _ in range(3):
            registry.count_route("lstm_sequence", "gate_act=hardsigmoid")
        registry.count_route("flash_attn", "dtype=float16")
    assert registry.routes() == {
        "lstm_sequence:composed[gate_act=hardsigmoid]": 3,
        "flash_attn:composed[dtype=float16]": 1}
    logged = [r for r in caplog.records if "composed route" in r.getMessage()]
    assert len(logged) <= 2
    # the counters beside the launch counters: a captured step's
    # recording takes them too
    with registry.recording() as rec:
        registry.count_route("fused_tail", "dtype=float16")
    assert rec == {"fused_tail:composed[dtype=float16]": 1}
    registry.reset_launches()


def test_the_plain_version_is_what_the_composed_route_runs():
    """On the CPU the wrappers' plain versions run for every dtype; the
    composed route runs the same functions on the card's tensors. f16 and
    f64 calls are accepted by the shape checks."""
    rng = np.random.default_rng(0)
    T, b, n = 3, 2, 8
    for td in (torch.float16, torch.float64):
        xz = torch.tensor(rng.normal(size=(T, b, 4 * n)), dtype=td)
        h0 = torch.zeros(b, n, dtype=td)
        Wh = torch.tensor(rng.normal(size=(n, 4 * n)) * 0.1, dtype=td)
        p = torch.zeros(3, n, dtype=td)
        m = torch.ones(T, b, dtype=td)
        assert tlstm._check_shapes(xz, h0, h0, Wh, p, m) == (T, b, n)
        out = tlstm.lstm_sequence(xz, h0, h0, Wh, p, m,
                                  gate_act="hardsigmoid")
        assert out.y.dtype == td and torch.isfinite(out.y.float()).all()
        with pytest.raises(ValueError):
            tlstm._check_shapes(xz, h0, h0, Wh.float(), p, m)
