"""The port's expert parallelism (deeplearning4j_tpu_torch/parallel/
experts.py) against the JAX package's ``moe_ffn``, on the CPU.

- Routing: the JAX package's ``init_moe_params`` weights (the test's
  E 4, F 8, H 16) carried over as tensors, the same tokens through both
  packages' ``moe_ffn``: top-1 and top-2 with ample capacity, top-1 and
  top-2 under overflow (capacity 4 and 6), a zero router that sends
  every token to expert 0; the same cases' gradients (every param and
  x, of a weighted sum of the output plus the aux loss) against
  ``jax.grad``; and the aux-loss cases of tests/test_experts.py
  (pre-capacity counting, balance preferred). No processes.
- A fleet of two gloo rank processes on ``{"expert": 2}``: each rank's
  ``shard_experts`` slice against one process's ``moe_ffn`` on the same
  params, forward and one backward (its slice of the experts' gradients,
  the router's and x's), then 30 SGD steps of the JAX test's regression
  (lr 0.3) on the sharded params, writing the losses and the router.

Tolerances: the JAX test's 1e-5 between the packages (the same f32
einsums in other orders); the sharded output and aux loss bit for bit
against one process (the same products on each rank, no partial sum
crossing ranks); the sharded gradients bit for bit against one
process's, x's within 1e-6 relative (its two ranks' shares meet in an
all-reduce, one process sums them expert by expert); the router bit for
bit across the ranks after training; the loss falling below 0.8 of its
first value (the JAX test's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fleet import run_fleets
from deeplearning4j_tpu.parallel import experts as jexperts
from deeplearning4j_tpu_torch.parallel import experts as texperts

PROC_TIMEOUT_S = 300
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {  # name: (experts, tokens, capacity, top_k, zero router)
    "top1_ample": (4, 32, 32, 1, False),
    "top2_ample": (4, 24, 24, 2, False),
    "top1_overflow": (2, 16, 4, 1, True),
    "top2_overflow": (4, 32, 6, 2, False),
    "default_capacity": (4, 32, None, 2, False),
}


def _jparams(E=4, F=8, H=16, seed=0):
    return jexperts.init_moe_params(jax.random.PRNGKey(seed), E, F, H)


def _port(jp):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in jp.items()}


def _case(name):
    E, n, cap, k, zero = CASES[name]
    jp = dict(_jparams(E=E))
    if zero:
        jp["router"] = jnp.zeros_like(jp["router"])
    x = np.random.default_rng(len(name)).normal(size=(n, 8)) \
        .astype(np.float32)
    return jp, x, cap, k


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_matches_the_jax_package(name):
    jp, x, cap, k = _case(name)
    jy, jaux = jexperts.moe_ffn(jp, jnp.asarray(x), capacity=cap, top_k=k)
    ty, taux = texperts.moe_ffn(_port(jp), torch.from_numpy(x),
                                capacity=cap, top_k=k)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    if name == "top1_overflow":
        # the first 4 tokens processed, the rest dropped to zero
        norms = np.linalg.norm(ty.numpy(), axis=-1)
        assert (norms[:4] > 1e-3).all() and not norms[4:].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_gradients_match_jax_grad(name):
    jp, x, cap, k = _case(name)
    w = np.random.default_rng(7).normal(size=(x.shape[0], 8)) \
        .astype(np.float32)

    def jloss(p, xx):
        y, aux = jexperts.moe_ffn(p, xx, capacity=cap, top_k=k)
        return (y * jnp.asarray(w)).sum() + 0.5 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {n: v.requires_grad_() for n, v in _port(jp).items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = texperts.moe_ffn(tp, tx, capacity=cap, top_k=k)
    ((y * torch.from_numpy(w)).sum() + 0.5 * aux).backward()
    for n, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[n]),
                                   err_msg=n, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    assert tp["router"].grad.abs().max() > 0


def test_aux_loss_counts_pre_capacity_assignment():
    jp = dict(_jparams(E=2))
    jp["router"] = jnp.zeros_like(jp["router"])
    p = _port(jp)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(16, 8))
                         .astype(np.float32))
    _, over = texperts.moe_ffn(p, x, capacity=4, top_k=1)
    _, ample = texperts.moe_ffn(p, x, capacity=16, top_k=1)
    assert float(over) == float(ample)
    np.testing.assert_allclose(float(over), 1.0, rtol=1e-6)


def test_aux_loss_prefers_balance():
    p = _port(_jparams(E=4))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 8))
                         .astype(np.float32))
    _, balanced = texperts.moe_ffn(p, x, capacity=64)
    skew = dict(p)
    skew["router"] = torch.zeros_like(p["router"])
    skew["router"][:, 0] = 9.0
    _, skewed = texperts.moe_ffn(skew, x, capacity=64)
    assert float(skewed) > float(balanced)


def test_init_moe_params_takes_a_generator():
    a = texperts.init_moe_params(torch.Generator().manual_seed(3), 4, 8, 16)
    b = texperts.init_moe_params(torch.Generator().manual_seed(3), 4, 8, 16)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        k: tuple(np.shape(v)) for k, v in _jparams().items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not a["b1"].any() and not a["b2"].any()


# ------------------------------------------------------------ the fleet
_WORKER = r"""
from deeplearning4j_tpu_torch.parallel.experts import (
    ExpertShard, moe_ffn, shard_experts)
d = np.load(f"{tmp}/moe.npz")
mesh = make_mesh({"expert": world})
res, arrays = {"equal": {}}, {}
try:
    params = {k: torch.from_numpy(d[k]) for k in
              ("router", "W1", "b1", "W2", "b2")}
    mine = shard_experts(mesh, "expert", params)
    res["shapes"] = {k: list(v.shape) for k, v in mine.items()}
    x = torch.from_numpy(d["x"])
    for cap, k in ((32, 1), (32, 2), (6, 2)):
        y, aux = moe_ffn(mine, x, capacity=cap, top_k=k)
        y1, aux1 = moe_ffn(params, x, capacity=cap, top_k=k)
        res["equal"][f"{cap}/{k}"] = [bool(torch.equal(y, y1)),
                                      bool(torch.equal(aux, aux1))]
    # one backward on the shard and on one process's params
    w = torch.from_numpy(d["w"])
    grads = []
    for p in (mine, params):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xg = x.clone().requires_grad_()
        y, aux = moe_ffn(ExpertShard(leaves, mine.mg) if p is mine
                         else leaves, xg, capacity=6, top_k=2)
        ((y * w).sum() + 0.5 * aux).backward()
        grads.append({"x": xg.grad, **{k: v.grad for k, v in leaves.items()}})
    g, g1 = grads
    for k in ("W1", "b1", "W2", "b2"):
        g1[k] = g1[k][rank * 2:(rank + 1) * 2]
    res["grad_equal"] = {k: bool(torch.equal(g[k], g1[k])) for k in g}
    res["grad_rel"] = {k: float((g[k] - g1[k]).norm() / g1[k].norm())
                       for k in g}
    p = ExpertShard({k: v.clone().requires_grad_() for k, v in mine.items()},
                    mine.mg)
    target = x @ torch.from_numpy(d["amat"])
    losses = []
    for _ in range(30):
        y, aux = moe_ffn(p, x, capacity=32)
        loss = ((y - target) ** 2).mean() + 0.01 * aux
        loss.backward()
        with torch.no_grad():
            for v in p.values():
                v -= 0.3 * v.grad
                v.grad = None
        losses.append(float(loss))
    res["losses"] = losses
    res["gathers"] = mine.mg.calls
    arrays["router"] = p["router"].detach().numpy()
finally:
    save(res, **arrays)
    D.shutdown()
"""


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    rng = np.random.default_rng(4)
    params = _port(_jparams(E=4))
    np.savez(tmp / "moe.npz", x=rng.normal(size=(32, 8)).astype(np.float32),
             amat=rng.normal(0, 0.5, (8, 8)).astype(np.float32),
             w=rng.normal(size=(32, 8)).astype(np.float32),
             **{k: v.numpy() for k, v in params.items()})
    port, _ = run_fleets([("moe", _WORKER, 2, tmp)], lambda: None,
                         PROC_TIMEOUT_S)
    return port["moe"]


def test_experts_sharded_router_replicated(fleet):
    for res, _ in fleet:
        assert res["shapes"]["W1"] == [2, 8, 16]
        assert res["shapes"]["b2"] == [2, 8]
        assert res["shapes"]["router"] == [8, 4]


@pytest.mark.parametrize("case", ["32/1", "32/2", "6/2"])
def test_sharded_output_and_aux_bit_equal_to_one_process(fleet, case):
    for res, _ in fleet:
        assert res["equal"][case] == [True, True]


@pytest.mark.parametrize("leaf", ["router", "W1", "b1", "W2", "b2"])
def test_sharded_gradients_bit_equal_to_one_process(fleet, leaf):
    for res, _ in fleet:
        assert res["grad_equal"][leaf], res["grad_rel"]


def test_sharded_input_gradient_matches_one_process(fleet):
    for res, _ in fleet:
        assert res["grad_rel"]["x"] <= 1e-6, res["grad_rel"]


def test_sharded_training_descends_and_keeps_the_router_equal(fleet):
    (r0, a0), (r1, a1) = fleet
    assert r0["losses"] == r1["losses"]
    assert r0["losses"][-1] < 0.8 * r0["losses"][0], r0["losses"]
    assert np.array_equal(a0["router"], a1["router"])
    # one gather of the experts a forward (3 calls, the backward's, 30
    # steps) and the all-reduce of x's gradient in the backward
    assert r0["gathers"] == 3 + 1 + 1 + 30
