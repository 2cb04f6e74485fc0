"""The port's fused bottleneck tail (deeplearning4j_tpu_torch/ops/
fused_block.py) against the JAX package's Pallas function
(``conv1x1_bn_add_relu_pallas``, ``_fwd_impl``, ``_bwd_impl``), run on the
CPU in interpret mode as tests/test_fused_block.py runs it. On CPU tensors
the port's op runs the plain versions of K4-K7, so this holds their
arithmetic; chip_smoke.py holds the CUDA kernels against the same plain
versions on the card.

Tolerances, each with its reason:

- f32: 1e-5 of each output's largest magnitude (the same f32 arithmetic,
  the products and the sums over M taken in another order).
- bf16: 2 bf16 ulps at each output's largest magnitude. z is the f32
  product rounded to bf16; an f32 sum in another order can land that
  rounding the other way (one ulp of z), which moves y, dz and dshortcut
  by about one ulp of their own scale, and each side rounds its output
  once more. The f32 statistics and dW move by far less than that.
- The batch statistics (mean, var, inv, scale): 1e-5 relative under f32.
  Under bf16 each rounding of z that lands the other way moves s1 by one
  ulp of z and s2 by 2|z| ulps of z, so the limit is 4 such flips over M:
  4 * ulp(max|z|) * (1 + 2 max|z|) / M absolute, plus 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import fused_block as jfb
from deeplearning4j_tpu_torch.ops import fused_block as tfb
from deeplearning4j_tpu_torch.ops import registry

EPS = 1e-5


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")


def _inputs(M, K, N, seed=0, sc_shape=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    W = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, N).astype(np.float32)
    beta = rng.normal(size=N).astype(np.float32)
    sc = rng.normal(size=sc_shape or (M, N)).astype(np.float32)
    shift = rng.normal(scale=0.1, size=N).astype(np.float32)
    dy = rng.normal(size=(M, N)).astype(np.float32)
    return x, W, gamma, beta, sc, shift, dy


def _jdt(dtype):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]


def _tdt(dtype):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _tol(want, dtype):
    m = float(np.abs(want).max())
    if dtype == "float32":
        return 1e-5 * max(m, 1e-30)
    return 2.0 * 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7)


def _close(got, want, dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    tol = _tol(want, dtype)
    assert err <= tol, f"{what} ({dtype}): max err {err:.3e} > {tol:.3e}"


def _close_stats(got, want, dtype, x, W, what):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=what)
        return
    zmax = float(np.abs(x @ W).max())
    ulp = 2.0 ** (np.floor(np.log2(zmax)) - 7)
    atol = 4 * ulp * (1 + 2 * zmax) / x.shape[0]
    # inv and scale are 1/sqrt(var) scaled: their error is the var error
    # times |d inv / d var| = inv^3 / 2
    if what in ("inv", "scale"):
        atol *= float(np.abs(want).max()) ** 3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                               err_msg=what)


def _loss_weights(shape):
    return np.cos(np.arange(int(np.prod(shape))).reshape(shape) * 0.01
                  ).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("M,K,N", [(128, 64, 128), (768, 64, 256)],
                         ids=["one_tile", "multi_tile"])
def test_op_forward_and_gradients_match_pallas(interpret_mode, dtype, relu,
                                               M, K, N):
    x, W, gamma, beta, sc, shift, _ = _inputs(M, K, N)
    jd, td = _jdt(dtype), _tdt(dtype)
    wts = _loss_weights((M, N))

    def jloss(x, W, gamma, beta, sc):
        y, mean, var = jfb.conv1x1_bn_add_relu_pallas(
            x, W, gamma, beta, sc, shift=jnp.asarray(shift), eps=EPS,
            relu=relu)
        return jnp.sum(y.astype(jnp.float32) * wts), (y, mean, var)

    jargs = (jnp.asarray(x, jd), jnp.asarray(W, jd), jnp.asarray(gamma),
             jnp.asarray(beta), jnp.asarray(sc, jd))
    assert jfb.pallas_supported(jargs[0], jargs[1], jargs[4])
    (_, (jy, jm, jv)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*jargs)

    targs = [torch.tensor(x, dtype=td), torch.tensor(W, dtype=td),
             torch.tensor(gamma), torch.tensor(beta),
             torch.tensor(sc, dtype=td)]
    for t in targs:
        t.requires_grad_()
    ty, tm, tv = tfb.conv1x1_bn_add_relu(*targs, shift=torch.tensor(shift),
                                         eps=EPS, relu=relu)
    assert ty.dtype == td and tm.dtype == torch.float32
    torch.sum(ty.float() * torch.from_numpy(wts)).backward()

    _close(ty, jy, dtype, "y")
    for name, got, want in (("mean", tm, jm), ("var", tv, jv)):
        _close_stats(got, want, dtype, x, W, name)
    for name, t, g in zip(("dx", "dW", "dgamma", "dbeta", "dshortcut"),
                          targs, jg):
        _close(t.grad, g, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_kernels_match_fwd_and_bwd_impl(interpret_mode, dtype, relu):
    """The four plain functions, composed as fused_forward and
    fused_backward, against _fwd_impl and _bwd_impl output by output."""
    M, K, N = 768, 128, 256
    x, W, gamma, beta, sc, shift, dy = _inputs(M, K, N, seed=1)
    jd, td = _jdt(dtype), _tdt(dtype)
    jx, jW, jsc, jdy = (jnp.asarray(a, jd) for a in (x, W, sc, dy))
    jy, jm, jv, jinv, jscale = jax.jit(
        jfb._fwd_impl, static_argnums=(6, 7))(
        jx, jW, jnp.asarray(gamma), jnp.asarray(beta), jsc,
        jnp.asarray(shift), EPS, relu)
    jdx, jdW, jdg, jdb, jdsc = jax.jit(
        jfb._bwd_impl, static_argnums=(7,))(
        jx, jW, jm, jinv, jscale, jdy, jy, relu)

    tx, tW, tsc, tdy = (torch.tensor(a, dtype=td) for a in (x, W, sc, dy))
    ty, tm, tv, tinv, tscale = tfb.fused_forward(
        tx, tW, torch.tensor(gamma), torch.tensor(beta), tsc,
        torch.tensor(shift), EPS, relu)
    _close(ty, jy, dtype, "y")
    for name, got, want in (("mean", tm, jm), ("var", tv, jv),
                            ("inv", tinv, jinv), ("scale", tscale, jscale)):
        _close_stats(got, want, dtype, x, W, name)
    # the backward from the JAX forward's own statistics and y, so each
    # side's backward sees the same inputs
    tdx, tdW, tdg, tdb, tdsc = tfb.fused_backward(
        tx, tW, torch.from_numpy(_np(jm)), torch.from_numpy(_np(jinv)),
        torch.from_numpy(_np(jscale)), tdy,
        torch.tensor(_np(jy), dtype=td), relu)
    for name, got, want in (("dx", tdx, jdx), ("dW", tdW, jdW),
                            ("dgamma", tdg, jdg), ("dbeta", tdb, jdb),
                            ("dshortcut", tdsc, jdsc)):
        _close(got, want, dtype, name)


def test_registered_by_device_and_counted_only_on_the_card():
    for name in (tfb.STATS, tfb.APPLY, tfb.BWD_STATS, tfb.BWD_APPLY):
        assert registry.get(name, "cpu").__name__.endswith("_torch")
        assert registry.get(name, "cuda").__name__.endswith("_cuda")
    assert (registry.get("conv1x1_bn_add_relu", "cpu")
            is tfb.conv1x1_bn_add_relu)
    registry.reset_launches()
    x, W, gamma, beta, sc, shift, _ = _inputs(64, 64, 128)
    tfb.conv1x1_bn_add_relu(torch.tensor(x), torch.tensor(W),
                            torch.tensor(gamma), torch.tensor(beta),
                            torch.tensor(sc), shift=torch.tensor(shift),
                            eps=EPS)
    assert registry.launches() == {}


def test_broadcast_shortcut_and_nhwc(interpret_mode):
    """A [N] shortcut broadcast over an NHWC input: expanded explicitly,
    its gradient summed back; held against the Pallas function on the
    broadcast array."""
    b, h, w, K, N = 2, 4, 4, 64, 128
    x, W, gamma, beta, sc, shift, _ = _inputs(b * h * w, K, N, seed=2,
                                              sc_shape=(N,))
    x4 = x.reshape(b, h, w, K)
    wts = _loss_weights((b, h, w, N))

    def jloss(x, sc):
        y, _, _ = jfb.conv1x1_bn_add_relu_pallas(
            x, jnp.asarray(W).reshape(1, 1, K, N), jnp.asarray(gamma),
            jnp.asarray(beta), jnp.broadcast_to(sc, (b, h, w, N)),
            shift=jnp.asarray(shift), eps=EPS)
        return jnp.sum(y * wts), y

    (_, jy), (jdx, jdsc) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x4),
                                              jnp.asarray(sc))
    tx = torch.tensor(x4, requires_grad=True)
    tsc = torch.tensor(sc, requires_grad=True)
    ty, _, _ = tfb.conv1x1_bn_add_relu(
        tx, torch.tensor(W).reshape(1, 1, K, N), torch.tensor(gamma),
        torch.tensor(beta), tsc, shift=torch.tensor(shift), eps=EPS)
    assert ty.shape == (b, h, w, N)
    torch.sum(ty * torch.from_numpy(wts)).backward()
    _close(ty, jy, "float32", "y")
    _close(tx.grad, jdx, "float32", "dx")
    _close(tsc.grad, jdsc, "float32", "dshortcut")


@pytest.mark.parametrize("case,exc,match", [
    ("f16", NotImplementedError, "float32 or bfloat16"),
    ("f64", NotImplementedError, "float32 or bfloat16"),
    ("3x3", NotImplementedError, "1x1 kernel"),
    ("3d_w", NotImplementedError, "1x1 kernel"),
    ("k_mismatch", ValueError, "does not end in K"),
    ("bad_shortcut", ValueError, "does not broadcast"),
])
def test_gate_refuses_by_name(case, exc, match):
    x = torch.zeros(8, 64)
    W = torch.zeros(64, 128)
    sc = torch.zeros(8, 128)
    if case == "f16":
        x = x.half()
    elif case == "f64":
        x = x.double()
    elif case == "3x3":
        W = torch.zeros(3, 3, 64, 128)
    elif case == "3d_w":
        W = torch.zeros(1, 64, 128)
    elif case == "k_mismatch":
        x = torch.zeros(8, 32)
    elif case == "bad_shortcut":
        sc = torch.zeros(8, 64)
    with pytest.raises(exc, match=match):
        tfb.check_fused_inputs(x, W, sc)
    with pytest.raises(exc, match=match):
        tfb.conv1x1_bn_add_relu(x, W, torch.ones(128), torch.zeros(128), sc,
                                shift=torch.zeros(128), eps=EPS)


@pytest.mark.parametrize("M,K,N", [(200704, 128, 512), (50176, 256, 1024),
                                   (12544, 512, 2048), (1000, 128, 512),
                                   (1, 3, 5)])
def test_grid_and_split_plan_covers_every_row(M, K, N):
    """The reduction rows and the dW split that the CUDA wrappers pass to
    the kernels cover M exactly once, whatever the shape."""
    R = tfb.stat_rows(M, N)
    m_tiles = -(-M // tfb.TILE_M)
    assert 1 <= R <= m_tiles
    S, chunk = tfb.dw_splits(M, K, N)
    assert S >= 1 and chunk % 16 == 0 and S * chunk >= M
    assert (S - 1) * chunk < M


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(8, 64)
    W = torch.zeros(64, 128)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfb.fused_stats_cuda(x, W, torch.zeros(128))


def _k7_operands(case, M=64):
    """x [M, K], W [K, N], dy and y [M, N] for one sm90 path case."""
    K, N = 128, 256
    dt = torch.float32 if case == "f32" else torch.bfloat16
    if case == "k_not_multiple_of_8":
        K = 76
    if case == "n_not_multiple_of_8":
        N = 252

    def make(rows, cols, misaligned):
        if not misaligned:
            return torch.zeros(rows, cols, dtype=dt)
        # one element into the buffer: 2 bytes off a 16-byte boundary
        return torch.zeros(rows * cols + 1, dtype=dt)[1:].view(rows, cols)

    return (make(M, K, case == "x_misaligned"),
            make(K, N, case == "w_misaligned"),
            make(M, N, case in ("dy_misaligned", "sc_misaligned")),
            make(M, N, case == "y_misaligned"))


@pytest.mark.parametrize("case,want", [
    ("bf16", True), ("f32", False), ("k_not_multiple_of_8", False),
    ("n_not_multiple_of_8", False), ("x_misaligned", False),
    ("w_misaligned", False), ("dy_misaligned", False),
    ("y_misaligned", False)])
def test_sm90_path_is_chosen_by_dtype_stride_and_alignment(case, want):
    """K7 takes its TMA path only where TMA can read every operand: bf16,
    rows of a multiple of 16 bytes, 16-byte-aligned bases."""
    x, W, dy, y = _k7_operands(case)
    assert x.is_contiguous() and dy.is_contiguous()
    assert tfb.takes_sm90(x, W, dy, y) is want


@pytest.mark.parametrize("M,K,N,sm90,want", [
    (200704, 128, 512, True, 4), (200704, 128, 512, False, 4),
    (50176, 256, 1024, True, 4), (12544, 512, 2048, True, 4),
    (1000, 128, 512, True, 3), (1000, 128, 512, False, 3),
    (777, 72, 200, True, 3), (37, 5, 7, False, 3)])
def test_launches_per_call_on_both_paths(M, K, N, sm90, want):
    """K7 makes dz, dx and dW launches and, when dW is split over M, the
    sum of its splits, on either path; K4-K6 do not depend on it."""
    assert tfb.launches_per_call(tfb.BWD_APPLY, M, K, N, sm90) == want
    assert want == 3 + (tfb.dw_splits(M, K, N, sm90)[0] > 1)
    for name, n in ((tfb.STATS, 2), (tfb.APPLY, 1), (tfb.BWD_STATS, 2)):
        assert tfb.launches_per_call(name, M, K, N, sm90) == n


@pytest.mark.parametrize("M,K,N", [(200704, 128, 512), (50176, 256, 1024),
                                   (12544, 512, 2048), (1000, 128, 512),
                                   (130, 8, 8), (1, 8, 8)])
def test_sm90_dw_split_covers_every_row_in_whole_steps(M, K, N):
    """On the sm90 path dW's chunks of M are whole 64-row steps (no step
    reads the next chunk's rows) and still cover M exactly once."""
    S, chunk = tfb.dw_splits(M, K, N, sm90=True)
    assert S >= 1 and chunk % tfb.SM90_STEP == 0
    assert S * chunk >= M and (S - 1) * chunk < M
    assert S <= tfb.dw_splits(M, K, N)[0]


class _Recorder:
    """Stands in for the built library and the launcher, so the CUDA
    wrappers' plan (entry point, partial rows, launch count) can be read
    on the CPU: records each entry point called and its arguments."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(tfb, "_check_cuda", lambda name, *t: None)
        monkeypatch.setattr(tfb, "_bind", lambda: self)
        monkeypatch.setattr(tfb, "_launch", self._launch)

    def __getattr__(self, name):
        if not name.startswith("dl4j_"):
            raise AttributeError(name)
        return name

    def _launch(self, lib, kern, fn, *args, launches):
        self.calls.append((fn, args[:-1], launches))
        registry.count_launch(kern, launches)


# (case, want, M) for each kernel whose wrapper test_k6_takes_its_path_as_
# k7_does reads: K4 reads no [M, N] tensor, K5 the shortcut (in dy's
# place), K6 dy and y
_K6_CASES = [
    ("bf16", True, 64), ("f32", False, 64), ("k_not_multiple_of_8", False, 64),
    ("n_not_multiple_of_8", False, 64), ("x_misaligned", False, 64),
    ("w_misaligned", False, 64), ("dy_misaligned", False, 64),
    ("y_misaligned", False, 64), ("bf16", True, 1), ("bf16", True, 127),
    ("bf16", True, 129), ("bf16", True, 777), ("f32", False, 777)]
_K4_CASES = [
    ("bf16", True, 64), ("f32", False, 64), ("k_not_multiple_of_8", False, 64),
    ("n_not_multiple_of_8", False, 64), ("x_misaligned", False, 64),
    ("w_misaligned", False, 64), ("dy_misaligned", True, 64),
    ("bf16", True, 1), ("bf16", True, 127), ("bf16", True, 129),
    ("bf16", True, 777), ("f32", False, 777)]
_K5_CASES = [
    ("bf16", True, 64), ("f32", False, 64), ("k_not_multiple_of_8", False, 64),
    ("n_not_multiple_of_8", False, 64), ("x_misaligned", False, 64),
    ("w_misaligned", False, 64), ("sc_misaligned", False, 64),
    ("y_misaligned", True, 64), ("bf16", True, 1), ("bf16", True, 129),
    ("bf16", True, 777), ("f32", False, 777)]
# where the shape arguments start: after the pointers, and on the first
# path after the dtype code too
_N_POINTERS = {tfb.STATS: 5, tfb.APPLY: 6, tfb.BWD_STATS: 8}


@pytest.mark.parametrize("kern,case,want,M", [
    *(pytest.param(tfb.BWD_STATS, c, w, m, id=f"{c}-{w}-{m}")
      for c, w, m in _K6_CASES),
    *(pytest.param(tfb.STATS, c, w, m, id=f"k4-{c}-{w}-{m}")
      for c, w, m in _K4_CASES),
    *(pytest.param(tfb.APPLY, c, w, m, id=f"k5-{c}-{w}-{m}")
      for c, w, m in _K5_CASES)])
def test_k6_takes_its_path_as_k7_does(monkeypatch, kern, case, want, M):
    """K4's, K5's and K6's wrappers ask takes_sm90 as K7's does, on the
    operands each reads (K4 x and W, K5 also the shortcut, K6 also dy and
    y): the sm90 entry point and one more count under its sm90 counter
    where TMA can read every one of them; else the first mainloop (bf16
    on mma.sync: a misaligned shortcut sends K5 there) and no sm90 count.
    K4 and K6 on the sm90 path pass one row of partials a 128-row m-tile
    (ragged M included: the rows cover every row of M exactly once), on
    the first path their own partial rows. Either way each counts
    launches_per_call's device launches."""
    x, W, dy, y = _k7_operands(case, M)
    M, K = x.shape
    N = W.shape[1]
    rec = _Recorder(monkeypatch)
    registry.reset_launches()
    with torch.no_grad():
        if kern == tfb.STATS:
            tfb.fused_stats_cuda(x, W, torch.zeros(N))
            mn = ()
        elif kern == tfb.APPLY:
            tfb.fused_apply_cuda(x, W, torch.ones(N), torch.zeros(N), dy,
                                 True)
            mn = (dy,)
        else:
            tfb.fused_bwd_stats_cuda(x, W, torch.zeros(N), torch.ones(N), dy,
                                     y, True)
            mn = (dy, y)
    (fn, args, launches), = rec.calls
    assert tfb.takes_sm90(x, W, *mn) is want
    first = tfb._ENTRY[kern]
    assert fn == (first + "_sm90" if want else first)
    at = _N_POINTERS[kern]
    if not want:
        assert args[0] == tfb._DTYPE_CODES[x.dtype]
        at += 1
    assert args[at:at + 3] == (M, K, N)
    if kern != tfb.APPLY:
        R = args[at + 3]
        if want:
            assert R * tfb.TILE_M >= M > (R - 1) * tfb.TILE_M
        else:
            assert R == tfb.stat_rows(M, N)
    assert launches == tfb.launches_per_call(kern, M, K, N, want)
    want_counts = {kern: launches}
    if want:
        want_counts[tfb.SM90_COUNTER[kern]] = 1
    assert registry.launches() == want_counts
