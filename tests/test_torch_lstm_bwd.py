"""The port's LSTM backward (deeplearning4j_tpu_torch/ops/lstm.py) against the
JAX package's: the plain version ``lstm_sequence_bwd_torch`` vs the Pallas
backward kernel ``_bwd_call`` run in interpret mode on the same residuals,
vs JAX autodiff of ``lstm_sequence_xla`` and vs torch.autograd through the
plain forward loop; ``LstmSequenceFn`` under gradcheck; and the CUDA
wrapper's input checks. K2 itself is held against the plain version on the
card by ``test_cuda_bwd_kernel_matches_plain`` (skipped without one) and by
chip_smoke.py.

Tolerances. f32: 1e-5 abs and rel, the same f32 arithmetic summed in
another order. bf16: two bf16 ulps at the output's largest magnitude
(``_bf16_tol``). Both sides round dz to bf16 once per step and every output
once at the end; an f32 sum taken in another order can land one of those
roundings the other way (one ulp), and dWh sums T*b products in another
order before its one rounding, which can do the same.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import lstm as jlstm
from deeplearning4j_tpu_torch.ops import lstm as tlstm
from deeplearning4j_tpu_torch.ops import registry

F32_TOL = 1e-5
OUT_NAMES = ("dxz", "dh0", "dc0", "dWh", "dp")


def _bf16_tol(want):
    """Two bf16 ulps at the largest magnitude of ``want``."""
    top = float(np.abs(want).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _draw(T, b, n, seed, carry=False, masked=False):
    rng = np.random.default_rng(seed)
    d = {"xz": rng.normal(0, 1, (T, b, 4 * n)),
         "h0": (0.5 if carry else 0.0) * rng.normal(0, 1, (b, n)),
         "c0": (0.5 if carry else 0.0) * rng.normal(0, 1, (b, n)),
         "Wh": rng.normal(0, np.sqrt(1.0 / n), (n, 4 * n)),
         "p": rng.normal(0, 0.2, (3, n)),
         "dy": rng.normal(0, 1, (T, b, n)),
         "dhT": rng.normal(0, 1, (b, n)),
         "dcT": rng.normal(0, 1, (b, n))}
    m = np.ones((T, b))
    if masked:
        m = (rng.random((T, b)) > 0.3).astype(np.float64)
        m[:, 0] = 1.0
        m[T // 2:, -1] = 0.0
    d["mask"] = m
    return {k: v.astype(np.float32) for k, v in d.items()}


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _fwd_args(d):
    return d["xz"], d["h0"], d["c0"], d["Wh"], d["p"], d["mask"]


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_interpret(monkeypatch, dtype, masked, carry):
    """All five outputs against the Pallas backward kernel itself, on the
    residuals its own forward wrote."""
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    T, b, n = 8, 16, 128
    d = _draw(T, b, n, seed=3, carry=carry, masked=masked)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    j = {k: jnp.asarray(v, jd) for k, v in d.items()}
    _, _, _, G, hp, cp = jlstm._fwd_call(*_fwd_args(j))
    want = jlstm._bwd_call((G, hp, cp, j["mask"], j["Wh"], j["p"]),
                           (j["dy"], j["dhT"], j["dcT"]))
    tt = lambda a: _t(_np(a), td)  # noqa: E731 (exact: bf16 -> f32 -> bf16)
    got = tlstm.lstm_sequence_bwd_torch(
        (tt(G), tt(hp), tt(cp)), tt(j["mask"]), tt(j["Wh"]), tt(j["p"]),
        tt(j["dy"]), tt(j["dhT"]), tt(j["dcT"]))
    for name, g, w in zip(OUT_NAMES, got, want):
        assert g.dtype == td and tuple(g.shape) == tuple(w.shape), name
        tol = F32_TOL if dtype == "float32" else _bf16_tol(_np(w))
        _close(g, w, tol)


def _loss_through_torch(y, hT, cT):
    """The weighting of tests/test_backend_equivalence.py::_loss_through."""
    w = torch.cos(torch.arange(y.numel(), dtype=y.dtype)).reshape(y.shape)
    return (torch.sum(y * w) + 2.0 * torch.sum(torch.sin(hT))
            + 0.5 * torch.sum(cT * cT))


def _loss_through_jax(fn):
    def loss(xz, h0, c0, Wh, p, mask):
        y, hT, cT = fn(xz, h0, c0, Wh, p, mask)
        w = jnp.cos(jnp.arange(y.size, dtype=y.dtype)).reshape(y.shape)
        return (jnp.sum(y * w) + 2.0 * jnp.sum(jnp.sin(hT))
                + 0.5 * jnp.sum(cT * cT))
    return loss


def _fn_grads(d, dtype=torch.float32, plain=False):
    """Gradients of the weighted loss w.r.t. (xz, h0, c0, Wh, p) through
    LstmSequenceFn, or through autograd of the plain loop."""
    leaves = [_t(d[k], dtype).requires_grad_() for k in
              ("xz", "h0", "c0", "Wh", "p")]
    mask = _t(d["mask"], dtype)
    if plain:
        out = tlstm.lstm_sequence_torch(*leaves, mask)
    else:
        out = tlstm.lstm_sequence(*leaves, mask)
        assert type(out.y.grad_fn).__name__ == "LstmSequenceFnBackward"
    return torch.autograd.grad(_loss_through_torch(*out[:3]), leaves)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fn_grads_match_jax_autodiff_f32(masked, carry):
    d = _draw(5, 4, 32, seed=4, carry=carry, masked=masked)
    j = {k: jnp.asarray(v, jnp.float32) for k, v in d.items()}
    want = jax.grad(_loss_through_jax(jlstm.lstm_sequence_xla),
                    argnums=(0, 1, 2, 3, 4))(*_fwd_args(j))
    got = _fn_grads(d)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, F32_TOL)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fn_grads_match_autograd_of_plain_loop_f32(masked, carry):
    d = _draw(6, 3, 16, seed=5, carry=carry, masked=masked)
    for g, w in zip(_fn_grads(d), _fn_grads(d, plain=True)):
        _close(g, w, F32_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_fn_gradcheck_float64(masked):
    d = _draw(3, 2, 4, seed=6, carry=True, masked=masked)
    leaves = tuple(_t(d[k], torch.float64).requires_grad_()
                   for k in ("xz", "h0", "c0", "Wh", "p"))
    mask = _t(d["mask"], torch.float64)
    assert torch.autograd.gradcheck(
        lambda *a: tlstm.LstmSequenceFn.apply(*a, mask), leaves,
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_public_op_routes_by_grad_mode():
    d = _draw(3, 2, 8, seed=7, carry=True)
    leaves = [_t(d[k], torch.float32) for k in ("xz", "h0", "c0", "Wh", "p")]
    assert tlstm.lstm_sequence(*leaves).y.grad_fn is None
    leaves[3].requires_grad_()
    out = tlstm.lstm_sequence(*leaves)
    assert type(out.y.grad_fn).__name__ == "LstmSequenceFnBackward"
    with torch.no_grad():
        assert tlstm.lstm_sequence(*leaves).y.grad_fn is None
    # another activation pair: autograd through the plain loop
    out = tlstm.lstm_sequence(*leaves, gate_act="hardsigmoid")
    assert type(out.y.grad_fn).__name__ != "LstmSequenceFnBackward"
    assert registry.get("lstm_sequence_bwd", "cpu") is \
        tlstm.lstm_sequence_bwd_torch
    assert registry.get("lstm_sequence_bwd", "cuda") is \
        tlstm.lstm_sequence_bwd_cuda


def test_fn_cotangents_of_unused_outputs_are_zeros():
    """Standard backprop uses y only: hT and cT get materialized zeros."""
    d = _draw(4, 3, 8, seed=8, carry=True)
    leaves = [_t(d[k], torch.float32).requires_grad_()
              for k in ("xz", "h0", "c0", "Wh", "p")]
    mask = _t(d["mask"], torch.float32)
    y = tlstm.lstm_sequence(*leaves, mask).y
    got = torch.autograd.grad(y.sum(), leaves)
    res = tlstm.lstm_sequence_torch(*[x.detach() for x in leaves], mask,
                                    save_residuals=True)
    zeros = torch.zeros_like(leaves[1])
    want = tlstm.lstm_sequence_bwd_torch(
        (res.G, res.h_prev, res.c_prev), mask, leaves[3].detach(),
        leaves[4].detach(), torch.ones_like(res.y), zeros, zeros)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _bwd_check_args(**over):
    T, b, n = 3, 2, 8
    f = lambda *s: torch.zeros(s)  # noqa: E731
    args = dict(residuals=(f(T, b, 4 * n), f(T, b, n), f(T, b, n)),
                mask_t=f(T, b), Wh=f(n, 4 * n), p=f(3, n), dy=f(T, b, n),
                dhT=f(b, n), dcT=f(b, n))
    args.update(over)
    return args


@pytest.mark.parametrize("over,err", [
    ({"residuals": (torch.zeros(3, 2, 32, dtype=torch.float16),
                    torch.zeros(3, 2, 8, dtype=torch.float16),
                    torch.zeros(3, 2, 8, dtype=torch.float16))},
     NotImplementedError),
    ({"residuals": (torch.zeros(3, 2, 30), torch.zeros(3, 2, 8),
                    torch.zeros(3, 2, 8))}, ValueError),
    ({"Wh": torch.zeros(8, 16)}, ValueError),
    ({"dy": torch.zeros(3, 2, 8, dtype=torch.bfloat16)}, ValueError),
    ({"mask_t": torch.ones(2, 3)}, ValueError),
    ({"dhT": torch.zeros(8, 2).t()}, ValueError),
    ({"Wh": torch.zeros(32, 8).t()}, ValueError),
])
def test_cuda_bwd_wrapper_refuses_what_the_kernel_does_not_take(over, err):
    with pytest.raises(err):
        tlstm._check_cuda_bwd_inputs(**_bwd_check_args(**over))


def test_cuda_bwd_wrapper_accepts_its_inputs():
    assert tlstm._check_cuda_bwd_inputs(**_bwd_check_args()) == (3, 2, 8)


def test_cuda_bwd_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlstm.lstm_sequence_bwd_cuda(**_bwd_check_args())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernel_matches_plain(cuda_device, dtype):
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    d = _draw(7, 3, 512, seed=9, carry=True, masked=True)
    t = {k: _t(v, td).to(cuda_device) for k, v in d.items()}
    with torch.no_grad():
        res = tlstm.lstm_sequence_cuda(*_fwd_args(t), save_residuals=True)
        args = ((res.G, res.h_prev, res.c_prev), t["mask"], t["Wh"], t["p"],
                t["dy"], t["dhT"], t["dcT"])
        got = tlstm.lstm_sequence_bwd_cuda(*args)
        again = tlstm.lstm_sequence_bwd_cuda(*args)
        want = tlstm.lstm_sequence_bwd_torch(*args)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        wn = w.float().cpu().numpy()
        tol = 1e-4 if dtype == "float32" else _bf16_tol(wn)
        np.testing.assert_allclose(g.float().cpu().numpy(), wn, atol=tol,
                                   rtol=tol)


# ------------------------------------------------- the cluster route's gate
class _Recorder:
    """Stands in for the built library and the launcher (as in
    test_torch_lstm.py), so K2's route and counters can be read on the
    CPU."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(tlstm, "_check_on_cuda", lambda x, what: None)
        monkeypatch.setattr(tlstm, "_bind", lambda kernel: self)
        monkeypatch.setattr(tlstm, "_launch", self._launch)

    def _launch(self, lib, kernel, cluster, args, dev, what):
        self.calls.append((kernel, cluster, args, what))


@pytest.mark.parametrize("b", [1, 3, 32, 33, 1024])
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("dtype,n,cluster", [(torch.bfloat16, 512, True),
                                             (torch.float32, 512, False),
                                             (torch.bfloat16, 576, False),
                                             (torch.bfloat16, 96, False)])
def test_backward_route_depends_on_dtype_and_n_only(monkeypatch, dtype, n,
                                                     cluster, T, b):
    rec = _Recorder(monkeypatch)
    registry.reset_launches()
    z = lambda *s: torch.zeros(s, dtype=dtype)  # noqa: E731
    with torch.no_grad():
        out = tlstm.lstm_sequence_bwd_cuda(
            (z(T, b, 4 * n), z(T, b, n), z(T, b, n)), z(T, b), z(n, 4 * n),
            z(3, n), z(T, b, n), z(b, n), z(b, n))
    (kernel, got_cluster, args, what), = rec.calls
    assert (kernel, got_cluster) == (tlstm.BWD_KERNEL, cluster)
    assert (what.T, what.b, what.n) == (T, b, n)
    # the cluster entry point: 15 pointers (dp's partials last), no dtype
    # code; the grid one: the code, 16 pointers (two carry scratches)
    assert len(args) == (18 if cluster else 20)
    assert args[-3:] == [T, b, n]
    assert [tuple(o.shape) for o in out] == [(T, b, 4 * n), (b, n), (b, n),
                                            (n, 4 * n), (3, n)]
    per_call = tlstm.bwd_launches_per_call(dtype, n)
    assert per_call == (3 if cluster else 2)
    want = {tlstm.BWD_KERNEL: per_call}
    if cluster:
        want[tlstm.BWD_SM90] = 1
    assert registry.launches() == want


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_cluster_decomposition_matches_plain_bwd_f32(masked, carry):
    """K2's cluster decomposition (16 ranks; phase A on each rank's
    columns, the partials P_q = Wh[:, q's columns] dz_q^T summed in rank
    order for each rank's units, dWh over all T b rows after the chain)
    computes the plain backward's function: f32 at n = 64, 1e-6."""
    d = _draw(6, 3, 64, seed=13, carry=carry, masked=masked)
    t = {k: _t(v, torch.float32) for k, v in d.items()}
    res = tlstm.lstm_sequence_torch(*_fwd_args(t), save_residuals=True)
    args = ((res.G, res.h_prev, res.c_prev), t["mask"], t["Wh"], t["p"],
            t["dy"], t["dhT"], t["dcT"])
    got = tlstm.lstm_sequence_bwd_cluster_emulation(*args)
    want = tlstm.lstm_sequence_bwd_torch(*args)
    for name, g, w in zip(OUT_NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _close(g, w, 1e-6)


def test_cluster_decomposition_matches_pallas_bwd_bf16(monkeypatch):
    """The decomposition in bf16 (16 ranks of 8 units) against the Pallas
    backward kernel in interpret mode on its own forward's residuals, at
    two bf16 ulps of each output's largest magnitude."""
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    d = _draw(5, 16, 128, seed=14, carry=True, masked=True)
    j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in d.items()}
    _, _, _, G, hp, cp = jlstm._fwd_call(*_fwd_args(j))
    want = jlstm._bwd_call((G, hp, cp, j["mask"], j["Wh"], j["p"]),
                           (j["dy"], j["dhT"], j["dcT"]))
    tt = lambda a: _t(_np(a), torch.bfloat16)  # noqa: E731
    got = tlstm.lstm_sequence_bwd_cluster_emulation(
        (tt(G), tt(hp), tt(cp)), tt(j["mask"]), tt(j["Wh"]), tt(j["p"]),
        tt(j["dy"]), tt(j["dhT"]), tt(j["dcT"]))
    for name, g, w in zip(OUT_NAMES, got, want):
        assert g.dtype == torch.bfloat16, name
        _close(g, w, _bf16_tol(_np(w)))


@pytest.mark.parametrize("ranks", [2, 4, 8])
def test_cluster_decomposition_holds_for_every_cluster_size(ranks):
    """Clusters of n / 32 blocks for n below 512 split the same function
    into fewer, wider ranks: forward and backward decompositions at 2, 4
    and 8 ranks of n = 64 agree with the plain loops to 1e-6 (f32)."""
    d = _draw(4, 3, 64, seed=15, carry=True, masked=True)
    t = {k: _t(v, torch.float32) for k, v in d.items()}
    res = tlstm.lstm_sequence_torch(*_fwd_args(t), save_residuals=True)
    emu = tlstm.lstm_sequence_cluster_emulation(*_fwd_args(t), ranks=ranks)
    for g, w in zip(emu, res):
        _close(g, w, 1e-6)
    args = ((res.G, res.h_prev, res.c_prev), t["mask"], t["Wh"], t["p"],
            t["dy"], t["dhT"], t["dcT"])
    got = tlstm.lstm_sequence_bwd_cluster_emulation(*args, ranks=ranks)
    for g, w in zip(got, tlstm.lstm_sequence_bwd_torch(*args)):
        _close(g, w, 1e-6)
