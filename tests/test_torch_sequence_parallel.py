"""The port's sequence parallelism
(deeplearning4j_tpu_torch/parallel/sequence.py, the carry's hop
parallel/mesh.py::ring_shift) against the JAX package's
``sequence_parallel_lstm``, on the CPU.

Fleets: gloo rank processes, one module-scoped run, at ``{"seq": 2}``
and ``{"seq": 4}``. Each rank takes its time chunk (``shard_sequence``)
of tests/test_sequence_parallel.py's F64 GravesLSTM problem (n_in 3,
n 5, b 2, T 24), without and with a ragged mask whose short row leaves
whole chunks masked, runs the forward and the backward of a loss of its
output chunk and the final carry, and writes its chunk, the carry and
the gradients. The JAX package's ``sequence_parallel_lstm`` runs on its
forced-host devices (tests/conftest.py) meanwhile, with ``jax.grad`` of
the same loss.

Tolerances: the forward at the JAX test's 1e-10 relative (atol 1e-12);
the gradients at 1e-8 (the same f64 arithmetic, summed in another order
over the chunks and by another backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeplearning4j_tpu.ops.lstm  # noqa: F401 (registers lstm_sequence)
from _torch_fleet import run_fleets
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.sequence import (
    sequence_parallel_lstm as jsp_lstm, shard_sequence as jshard)

PROC_TIMEOUT_S = 300
N_IN, N, B, T = 3, 5, 2, 24
LENGTHS = (24, 7)
FWD = dict(rtol=1e-10, atol=1e-12)
GRAD = dict(rtol=1e-8, atol=1e-10)
DEVICES = (2, 4)


def _problem():
    rng = np.random.default_rng(0)
    params = {"Wx": rng.normal(0, 0.3, (N_IN, 4 * N)),
              "Wh": rng.normal(0, 0.3, (N, 4 * N)),
              "b": rng.normal(0, 0.1, (4 * N,)),
              "p": rng.normal(0, 0.1, (3, N))}
    return dict(params, x=rng.normal(0, 1, (B, T, N_IN)),
                h0=rng.normal(0, 0.5, (B, N)), c0=rng.normal(0, 0.5, (B, N)),
                wy=rng.normal(0, 1, (B, T, N)),
                mask=(np.arange(T)[None] < np.array(LENGTHS)[:, None])
                .astype(np.float64))


_WORKER = r"""
from deeplearning4j_tpu_torch.parallel.sequence import (
    sequence_parallel_lstm, shard_sequence)
d = np.load(f"{tmp}/problem.npz")
mesh = make_mesh({"seq": world})
res, arrays = {}, {}
try:
    try:
        shard_sequence(mesh, "seq", np.zeros((2, 25, 3)))
        res["indivisible"] = None
    except ValueError as e:
        res["indivisible"] = str(e)
    for arm in ("plain", "masked"):
        params = {k: torch.tensor(d[k], requires_grad=True)
                  for k in ("Wx", "Wh", "b", "p")}
        h0 = torch.tensor(d["h0"], requires_grad=True)
        c0 = torch.tensor(d["c0"], requires_grad=True)
        x = shard_sequence(mesh, "seq", d["x"]).requires_grad_()
        mask = shard_sequence(mesh, "seq", d["mask"]) if arm == "masked" \
            else None
        y, hT, cT = sequence_parallel_lstm(mesh, "seq", params, x, h0, c0,
                                           mask=mask)
        wy = shard_sequence(mesh, "seq", d["wy"])
        loss = (y * wy).sum() + 0.5 * hT.sum() + (cT ** 2).sum()
        loss.backward()
        arrays[f"{arm}/y"] = y.detach().numpy()
        arrays[f"{arm}/hT"] = hT.detach().numpy()
        arrays[f"{arm}/cT"] = cT.detach().numpy()
        for k, v in list(params.items()) + [("h0", h0), ("c0", c0),
                                            ("x", x)]:
            arrays[f"{arm}/g_{k}"] = v.grad.numpy()
finally:
    save(res, **arrays)
    D.shutdown()
"""


def _jax_side(prob, devices):
    """{arm: (y, hT, cT, grads)} of the JAX package on ``devices`` forced-
    host devices."""
    mesh = jmake_mesh({"seq": devices})
    names = ("Wx", "Wh", "b", "p")
    out = {}
    for arm in ("plain", "masked"):
        mask = jnp.asarray(prob["mask"]) if arm == "masked" else None

        def run(params, h0, c0, x):
            xs = jshard(mesh, "seq", x)
            ms = None if mask is None else jshard(mesh, "seq", mask)
            return jsp_lstm(mesh, "seq", params, xs, h0, c0, mask=ms)

        def loss(params, h0, c0, x):
            y, hT, cT = run(params, h0, c0, x)
            return (jnp.sum(y * prob["wy"]) + 0.5 * jnp.sum(hT)
                    + jnp.sum(cT ** 2)), (y, hT, cT)

        args = ({k: jnp.asarray(prob[k]) for k in names},
                jnp.asarray(prob["h0"]), jnp.asarray(prob["c0"]),
                jnp.asarray(prob["x"]))
        (_, (y, hT, cT)), (g_params, g_h0, g_c0, g_x) = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
            *args)
        grads = {k: np.asarray(v) for k, v in g_params.items()}
        grads.update(h0=np.asarray(g_h0), c0=np.asarray(g_c0),
                     x=np.asarray(g_x))
        out[arm] = (np.asarray(y), np.asarray(hT), np.asarray(cT), grads)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq")
    prob = _problem()
    np.savez(tmp / "problem.npz", **prob)
    fleets = [(d, _WORKER, d, tmp) for d in DEVICES]
    port, jax_out = run_fleets(
        fleets, lambda: {d: _jax_side(prob, d) for d in DEVICES},
        PROC_TIMEOUT_S)
    return port, jax_out


def _chunk(a, d, rank):
    k = a.shape[1] // d
    return a[:, rank * k:(rank + 1) * k]


@pytest.mark.parametrize("arm", ["plain", "masked"])
@pytest.mark.parametrize("d", DEVICES)
def test_forward_matches_the_jax_package(runs, d, arm):
    port, jax_out = runs
    y, hT, cT, _ = jax_out[d][arm]
    for rank, (_, arrays) in enumerate(port[d]):
        np.testing.assert_allclose(arrays[f"{arm}/y"], _chunk(y, d, rank),
                                   **FWD, err_msg=f"rank {rank} y")
        np.testing.assert_allclose(arrays[f"{arm}/hT"], hT, **FWD)
        np.testing.assert_allclose(arrays[f"{arm}/cT"], cT, **FWD)
    if arm == "masked":
        # masked positions emit exactly zero, across chunk boundaries
        got = np.concatenate([a[f"{arm}/y"] for _, a in port[d]], axis=1)
        assert not got[1, LENGTHS[1]:].any()


@pytest.mark.parametrize("arm", ["plain", "masked"])
@pytest.mark.parametrize("d", DEVICES)
def test_gradient_matches_jax_grad(runs, d, arm):
    port, jax_out = runs
    grads = jax_out[d][arm][3]
    for rank, (_, arrays) in enumerate(port[d]):
        for k, want in grads.items():
            if k == "x":
                want = _chunk(want, d, rank)
            np.testing.assert_allclose(arrays[f"{arm}/g_{k}"], want, **GRAD,
                                       err_msg=f"rank {rank} d{k}")


@pytest.mark.parametrize("d", DEVICES)
def test_output_stays_time_sharded(runs, d):
    port, _ = runs
    for _, arrays in port[d]:
        assert arrays["plain/y"].shape == (B, T // d, N)
        assert arrays["masked/y"].shape == (B, T // d, N)


@pytest.mark.parametrize("d", DEVICES)
def test_an_indivisible_sequence_raises(runs, d):
    port, _ = runs
    for res, _ in port[d]:
        assert res["indivisible"] is not None
        assert "not divisible by the 'seq' mesh axis" in res["indivisible"]
