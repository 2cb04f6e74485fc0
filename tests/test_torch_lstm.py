"""The port's LSTM op (deeplearning4j_tpu_torch/ops/lstm.py) against the JAX
package's: the plain PyTorch version vs ``lstm_sequence_xla`` and vs the
Pallas kernel run in interpret mode, plus the CUDA wrapper's input checks.
The kernel itself is held against the plain version on the card by
``test_cuda_kernel_matches_plain`` (skipped without one) and chip_smoke.py.

Tolerances: f32 1e-5 abs and rel (the same f32 arithmetic summed in
another order). bf16 1.6e-2 abs and rel: outputs are bf16 and h is
rounded to bf16 before every product, so one rounding that lands the
other way is one bf16 ulp (2**-7 at |y| <= 1); 2 ulps are allowed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import lstm as jlstm
from deeplearning4j_tpu_torch.ops import lstm as tlstm
from deeplearning4j_tpu_torch.ops import registry

F32_TOL = 1e-5
BF16_TOL = 1.6e-2


def _draw(T, b, n, seed, carry=False, masked=False):
    rng = np.random.default_rng(seed)
    d = {"xz": rng.normal(0, 1, (T, b, 4 * n)),
         "Wh": rng.normal(0, np.sqrt(1.0 / n), (n, 4 * n)),
         "p": rng.normal(0, 0.2, (3, n)),
         "h0": (0.5 if carry else 0.0) * rng.normal(0, 1, (b, n)),
         "c0": (0.5 if carry else 0.0) * rng.normal(0, 1, (b, n))}
    if masked:
        m = (rng.random((T, b)) > 0.3).astype(np.float64)
        m[:, 0] = 1.0
        m[T // 2:, -1] = 0.0
        d["mask"] = m
    return {k: v.astype(np.float32) for k, v in d.items()}


def _torch(d, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in d.items()}


def _args(d, mask_default=None):
    return (d["xz"], d["h0"], d["c0"], d["Wh"], d["p"],
            d.get("mask", mask_default))


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float()) if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_xla_f32(carry, masked):
    d = _draw(6, 4, 32, seed=1, carry=carry, masked=masked)
    t = _torch(d, torch.float32)
    out = tlstm.lstm_sequence_torch(*_args(t))
    j = {k: jnp.asarray(v, jnp.float32) for k, v in d.items()}
    ys, hT, cT = jlstm.lstm_sequence_xla(*_args(j))
    _close(out.y, ys, F32_TOL)
    _close(out.hT, hT, F32_TOL)
    _close(out.cT, cT, F32_TOL)


@pytest.mark.parametrize("gate_act,cell_act", [("hardsigmoid", "softsign"),
                                               ("sigmoid", "relu")])
def test_plain_other_activations_match_xla(gate_act, cell_act):
    d = _draw(5, 3, 16, seed=2, carry=True, masked=True)
    out = tlstm.lstm_sequence_torch(*_args(_torch(d, torch.float32)),
                                    gate_act=gate_act, cell_act=cell_act)
    j = {k: jnp.asarray(v, jnp.float32) for k, v in d.items()}
    ys, hT, cT = jlstm.lstm_sequence_xla(*_args(j), gate_act=gate_act,
                                         cell_act=cell_act)
    _close(out.y, ys, F32_TOL)
    _close(out.hT, hT, F32_TOL)
    _close(out.cT, cT, F32_TOL)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(monkeypatch, dtype, masked, carry):
    """Against the Pallas kernel itself (interpret mode, called directly
    past its TPU shape gate), residuals included."""
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    T, b, n = 8, 16, 128
    d = _draw(T, b, n, seed=3, carry=carry, masked=masked)
    d.setdefault("mask", np.ones((T, b), np.float32))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    want = jlstm._fwd_call(*_args({k: jnp.asarray(v, jd)
                                   for k, v in d.items()}))
    got = tlstm.lstm_sequence_torch(*_args(_torch(d, td)),
                                    save_residuals=True)
    for g, w in zip(got, want):
        assert g.dtype == td and tuple(g.shape) == tuple(w.shape)
        _close(g, np.asarray(w.astype(jnp.float32)), tol)


def test_public_op_dispatches_cpu_tensors_to_plain():
    d = _torch(_draw(3, 2, 8, seed=4, carry=True), torch.float32)
    a = tlstm.lstm_sequence(*_args(d), save_residuals=True)
    b = tlstm.lstm_sequence_torch(*_args(d), save_residuals=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert registry.get("lstm_sequence", "cpu") is tlstm.lstm_sequence_torch
    assert registry.get("lstm_sequence", "cuda") is tlstm.lstm_sequence_cuda
    with pytest.raises(NotImplementedError, match="meta"):
        registry.get("lstm_sequence", "meta")


def _cuda_check_args(**over):
    d = _torch(_draw(3, 2, 8, seed=5), torch.float32)
    args = dict(xz_t=d["xz"], h0=d["h0"], c0=d["c0"], Wh=d["Wh"], p=d["p"],
                mask_t=torch.ones(3, 2), gate_act="sigmoid", cell_act="tanh")
    args.update(over)
    return args


@pytest.mark.parametrize("over,err", [
    ({"gate_act": "hardsigmoid"}, NotImplementedError),
    ({"cell_act": "softsign"}, NotImplementedError),
    ({"xz_t": torch.zeros(3, 2, 32, dtype=torch.float16)},
     NotImplementedError),
    ({"Wh": torch.zeros(8, 16)}, ValueError),
    ({"h0": torch.zeros(2, 8, dtype=torch.bfloat16)}, ValueError),
    ({"mask_t": torch.ones(2, 3)}, ValueError),
    ({"Wh": torch.zeros(32, 8).t()}, ValueError),
    ({"Wh": torch.zeros(8, 32, requires_grad=True)}, NotImplementedError),
])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(over, err):
    args = _cuda_check_args(**over)
    with pytest.raises(err):
        tlstm._check_cuda_inputs(**args)
    if err is NotImplementedError and "Wh" not in over:
        # what K1 does not compute takes the composed route on the card
        assert tlstm.lstm_route(args["xz_t"].dtype, 2, 8, args["gate_act"],
                                args["cell_act"]) == "composed"


def test_cuda_wrapper_accepts_its_inputs():
    assert tlstm._check_cuda_inputs(**_cuda_check_args()) == (3, 2, 8)


def test_cuda_wrapper_refuses_cpu_tensors():
    d = _torch(_draw(3, 2, 8, seed=5), torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlstm.lstm_sequence_cuda(*_args(d))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = 1e-4 if dtype == "float32" else BF16_TOL
    d = _draw(7, 3, 512, seed=6, carry=True, masked=True)
    t = {k: v.to(cuda_device) for k, v in _torch(d, td).items()}
    with torch.inference_mode():
        got = tlstm.lstm_sequence_cuda(*_args(t), save_residuals=True)
        want = tlstm.lstm_sequence_torch(*_args(t), save_residuals=True)
    for g, w in zip(got, want):
        _close(g.cpu(), w.float().cpu().numpy(), tol)


# ------------------------------------------------- the cluster route's gate
class _Recorder:
    """Stands in for the built library and the launcher, so the CUDA
    wrappers' choice of route and their counters can be read on the CPU:
    records each launch's kernel, route and arguments."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(tlstm, "_check_on_cuda", lambda x, what: None)
        monkeypatch.setattr(tlstm, "_bind", lambda kernel: self)
        monkeypatch.setattr(tlstm, "_launch", self._launch)

    def _launch(self, lib, kernel, route, args, dev, what):
        self.calls.append((kernel, route, args, what))


def _zeros_fwd(T, b, n, dtype, masked=False):
    z = lambda *s: torch.zeros(s, dtype=dtype)  # noqa: E731
    mask = torch.ones(T, b, dtype=dtype) if masked else None
    return z(T, b, 4 * n), z(b, n), z(b, n), z(n, 4 * n), z(3, n), mask


# (dtype, n, cluster): bf16 at n a multiple of 64 up to 16 blocks of 32
# units takes the cluster route; f32, ragged and too wide n the grid
_ROUTES = [(torch.bfloat16, 512, True), (torch.bfloat16, 64, True),
           (torch.bfloat16, 256, True), (torch.float32, 512, False),
           (torch.bfloat16, 576, False), (torch.bfloat16, 96, False),
           (torch.bfloat16, 32, False), (torch.float32, 64, False)]


@pytest.mark.parametrize("dtype,n,cluster", _ROUTES)
def test_takes_cluster_reads_dtype_and_width(dtype, n, cluster):
    assert tlstm.takes_cluster(dtype, n) is cluster


@pytest.mark.parametrize("b", [1, 3, 32, 33, 1024])
@pytest.mark.parametrize("T,masked", [(1, False), (2, True)])
@pytest.mark.parametrize("dtype,n,cluster", [(torch.bfloat16, 512, True),
                                             (torch.float32, 512, False),
                                             (torch.bfloat16, 576, False)])
def test_forward_route_depends_on_dtype_and_n_only(monkeypatch, dtype, n,
                                                    cluster, T, masked, b):
    rec = _Recorder(monkeypatch)
    registry.reset_launches()
    with torch.no_grad():
        out = tlstm.lstm_sequence_cuda(*_zeros_fwd(T, b, n, dtype, masked),
                                       save_residuals=True)
    (kernel, route, args, what), = rec.calls
    assert (kernel, route) == (tlstm.KERNEL,
                               "cluster" if cluster else "grid")
    assert (what.T, what.b, what.n, what.dtype) == (T, b, n, dtype)
    # the cluster entry point takes no dtype code and no carry scratch
    assert len(args) == (16 if cluster else 19)
    assert args[-4:] == [T, b, n, 1]
    assert out.G.shape == (T, b, 4 * n) and out.y.dtype == dtype
    want = {tlstm.KERNEL: 1}
    if cluster:
        want[tlstm.FWD_SM90] = 1
    assert registry.launches() == want


@pytest.mark.parametrize("dtype,n", [(torch.float32, 1024),
                                     (torch.bfloat16, 1152)])
def test_forward_past_the_grid_limits_takes_the_wide_route(monkeypatch,
                                                           dtype, n):
    """Past grid_fits, a call the JAX kernel takes (n % 128 == 0, b a
    sublane multiple) launches the wide entry point with the grid route's
    arguments, counted once more under FWD_WIDE."""
    rec = _Recorder(monkeypatch)
    registry.reset_launches()
    with torch.no_grad():
        out = tlstm.lstm_sequence_cuda(*_zeros_fwd(2, 16, n, dtype, True),
                                       save_residuals=True)
    (kernel, route, args, what), = rec.calls
    assert (kernel, route, len(args)) == (tlstm.KERNEL, "wide", 19)
    assert args[-4:] == [2, 16, n, 1] and out.y.shape == (2, 16, n)
    assert registry.launches() == {tlstm.KERNEL: 1, tlstm.FWD_WIDE: 1}


def test_cluster_route_reads_wh_and_h0_aligned(monkeypatch):
    """The cluster kernels read Wh and h0 16 bytes at a time: a view that
    starts off a 16-byte boundary is copied first (the route stays)."""
    rec = _Recorder(monkeypatch)
    T, b, n = 2, 3, 64
    xz, h0, c0, Wh, p, _ = _zeros_fwd(T, b, n, torch.bfloat16)
    Wh_off = torch.zeros(n * 4 * n + 1, dtype=torch.bfloat16)[1:].view(n,
                                                                      4 * n)
    h0_off = torch.zeros(b * n + 3, dtype=torch.bfloat16)[3:].view(b, n)
    assert Wh_off.data_ptr() % 16 and h0_off.data_ptr() % 16
    with torch.no_grad():
        tlstm.lstm_sequence_cuda(xz, h0_off, c0, Wh_off, p)
    (_, cluster, args, _), = rec.calls
    assert cluster
    assert all(a % 16 == 0 for a in args[:6])


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_cluster_decomposition_matches_plain_f32(carry, masked):
    """K1's cluster decomposition (16 ranks, each its 4 units' columns of
    Wh, h gathered from the ranks every step) computes the plain loop's
    function: f32 at n = 64, 1e-6 (the same products in slices)."""
    d = _torch(_draw(6, 3, 64, seed=11, carry=carry, masked=masked),
               torch.float32)
    got = tlstm.lstm_sequence_cluster_emulation(*_args(d))
    want = tlstm.lstm_sequence_torch(*_args(d), save_residuals=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w.numpy(), 1e-6)


def test_cluster_decomposition_matches_jax_bf16(monkeypatch):
    """The decomposition in bf16 (16 ranks of 8 units) against the JAX
    package's Pallas kernel in interpret mode, residuals included, at the
    bf16 tolerance."""
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    d = _draw(5, 16, 128, seed=12, carry=True, masked=True)
    want = jlstm._fwd_call(*_args({k: jnp.asarray(v, jnp.bfloat16)
                                   for k, v in d.items()}))
    got = tlstm.lstm_sequence_cluster_emulation(
        *_args(_torch(d, torch.bfloat16)))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == tuple(w.shape)
        _close(g, np.asarray(w.astype(jnp.float32)), BF16_TOL)
