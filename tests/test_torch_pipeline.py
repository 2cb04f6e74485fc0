"""The port's pipeline parallelism
(deeplearning4j_tpu_torch/parallel/pipeline.py, the activations' hop
parallel/mesh.py::ring_shift) against the JAX package's, on the CPU.

A fleet of four gloo rank processes on ``{"pipe": 4}``, one
module-scoped run: tests/test_pipeline.py's problem (4 tanh stages of
16 x 16, 8 microbatches of 4) through ``pipeline_forward`` and one
``pipeline_train_step`` (SGD, lr 0.1); the stage-count refusal; and a
gpt_mini-shaped trunk at narrow width (8 F32 TransformerBlocks of width
32, 2 heads, T 16, two blocks a stage, 4 microbatches of 2) forward and
one SGD step, against the same blocks applied in turn in one process.
The JAX package's ``pipeline_forward`` and ``pipeline_train_step`` run
on its forced-host devices (tests/conftest.py) meanwhile.

Tolerances: the JAX test's own (tests/test_pipeline.py:47-49, 83-84):
the forward 1e-6, the SGD step 1e-5 against the JAX step and against
sequential stages; the gpt-shaped forward bit for bit against its
blocks in turn (the same products on the same microbatches), its step
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_fleet import run_fleets
from deeplearning4j_tpu.parallel import pipeline as jpipe
from deeplearning4j_tpu_torch.parallel.pipeline import split_microbatches

PROC_TIMEOUT_S = 300
S, M, MB, F = 4, 8, 4, 16
LR = 0.1
FWD = dict(rtol=1e-6, atol=1e-6)
STEP = dict(rtol=1e-5, atol=1e-5)


def _problem():
    rng = np.random.default_rng(0)
    W = rng.normal(0, 0.3, (S, F, F)).astype(np.float32)
    b = rng.normal(0, 0.1, (S, F)).astype(np.float32)
    x = rng.normal(0, 1, (M * MB, F)).astype(np.float32)
    labels = np.random.default_rng(1).normal(0, 1, x.shape) \
        .astype(np.float32)
    return dict(W=W, b=b, x=x, labels=labels)


_WORKER = r"""
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.parallel.pipeline import (
    pipeline_forward, pipeline_train_step, shard_stages,
    split_microbatches, stack_stage_params)
d = np.load(f"{tmp}/problem.npz")
mesh = make_mesh({"pipe": world})
res, arrays = {}, {}

def tanh_stage(p, x):
    return torch.tanh(x @ p["W"] + p["b"])

def mse(y, l):
    return ((y - l) ** 2).mean()

try:
    stacked = {k: torch.from_numpy(d[k]) for k in ("W", "b")}
    mine = shard_stages(mesh, "pipe", stacked)
    res["shard_shape"] = list(mine["W"].shape)
    xm = split_microbatches(torch.from_numpy(d["x"]), 8)
    lm = split_microbatches(torch.from_numpy(d["labels"]), 8)
    arrays["y"] = pipeline_forward(mesh, "pipe", mine, xm,
                                   tanh_stage).detach().numpy()
    step = pipeline_train_step(mesh, "pipe", tanh_stage, mse, lr=0.1)
    new, loss = step(mine, xm, lm)
    res["loss"] = float(loss)
    arrays["new_W"] = new["W"][0].numpy()
    arrays["new_b"] = new["b"][0].numpy()
    eight = {"W": torch.zeros(8, 4, 4), "b": torch.zeros(8, 4)}
    try:
        pipeline_forward(mesh, "pipe", eight, torch.zeros(4, 2, 4),
                         tanh_stage)
        res["eight_stages"] = None
    except ValueError as e:
        res["eight_stages"] = str(e)

    # a gpt_mini-shaped trunk: two TransformerBlocks a stage
    net = zoo.gpt_mini(vocab_size=12, width=32, n_layers=8, n_heads=2,
                       max_len=16, seed=5, dtype=zoo.F32, device="cpu")
    block = net.layers[1]
    blocks = [net.params[f"layer_{i}"] for i in range(1, 9)]
    per_stage = [{"b0": blocks[2 * s], "b1": blocks[2 * s + 1]}
                 for s in range(4)]

    def two_blocks(p, x):
        for k in ("b0", "b1"):
            x = block.apply(p[k], {}, x)[0]
        return x

    g = np.random.default_rng(7)
    gx = split_microbatches(torch.from_numpy(
        g.normal(size=(8, 16, 32)).astype(np.float32)), 4)
    glab = split_microbatches(torch.from_numpy(
        g.normal(size=(8, 16, 32)).astype(np.float32)), 4)
    gmine = shard_stages(mesh, "pipe", stack_stage_params(per_stage))
    with torch.no_grad():
        gy = pipeline_forward(mesh, "pipe", gmine, gx, two_blocks)
        seq = []
        for mb in gx:
            h = mb
            for p in blocks:
                h = block.apply(p, {}, h)[0]
            seq.append(h)
    res["gpt_bit_equal"] = bool(torch.equal(gy, torch.stack(seq)))
    res["gpt_max_abs"] = float((gy - torch.stack(seq)).abs().max())
    gstep = pipeline_train_step(mesh, "pipe", two_blocks, mse, lr=0.1)
    gnew, _ = gstep(gmine, gx, glab)
    leaves = [{k: v.detach().clone().requires_grad_() for k, v in p.items()}
              for p in blocks]
    h = gx.reshape(-1, 16, 32)
    for p in leaves:
        h = block.apply(p, {}, h)[0]
    mse(h.reshape(glab.shape), glab).backward()
    err = 0.0
    for j, k in enumerate(("b0", "b1")):
        want = leaves[2 * rank + j]
        for name, v in gnew[k].items():
            ref = want[name] - 0.1 * want[name].grad
            err = max(err, float((v[0] - ref).abs().max()
                                 / max(float(ref.abs().max()), 1e-30)))
    res["gpt_step_rel_err"] = err
finally:
    save(res, **arrays)
    D.shutdown()
"""


def _stage_fn(p, x):
    return jnp.tanh(x @ p["W"] + p["b"])


def _jax_side(prob):
    mesh = Mesh(np.array(jax.devices()[:S]), ("pipe",))
    stacked = jpipe.shard_stages(mesh, "pipe", {
        "W": jnp.asarray(prob["W"]), "b": jnp.asarray(prob["b"])})
    xm = jpipe.split_microbatches(jnp.asarray(prob["x"]), M)
    lm = jpipe.split_microbatches(jnp.asarray(prob["labels"]), M)
    y = jpipe.pipeline_forward(mesh, "pipe", stacked, xm, _stage_fn)
    step = jax.jit(jpipe.pipeline_train_step(
        mesh, "pipe", _stage_fn, lambda y, l: jnp.mean((y - l) ** 2),
        lr=LR))
    new, loss = step(stacked, xm, lm)
    return (np.asarray(y), {k: np.asarray(jax.device_get(v))
                            for k, v in new.items()}, float(loss))


def _sequential_step(prob):
    """Sequential stages in one process (the port's plain torch): the SGD
    step's new params, by stage."""
    W = torch.from_numpy(prob["W"]).requires_grad_()
    b = torch.from_numpy(prob["b"]).requires_grad_()
    h = torch.from_numpy(prob["x"])
    for s in range(S):
        h = torch.tanh(h @ W[s] + b[s])
    ((h - torch.from_numpy(prob["labels"])) ** 2).mean().backward()
    return (h.detach().numpy(),
            {"W": (W - LR * W.grad).detach().numpy(),
             "b": (b - LR * b.grad).detach().numpy()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    prob = _problem()
    np.savez(tmp / "problem.npz", **prob)
    port, jax_out = run_fleets([("pipe", _WORKER, S, tmp)],
                               lambda: _jax_side(prob), PROC_TIMEOUT_S)
    return port["pipe"], jax_out, _sequential_step(prob)


def test_stage_params_sharded_one_stage_a_rank(runs):
    port, _, _ = runs
    for res, _ in port:
        assert res["shard_shape"] == [1, F, F]


def test_forward_matches_the_jax_package_and_sequential(runs):
    port, (jy, _, _), (seq_y, _) = runs
    for rank, (_, arrays) in enumerate(port):
        np.testing.assert_allclose(arrays["y"], jy, **FWD,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(arrays["y"].reshape(seq_y.shape), seq_y,
                                   **FWD, err_msg=f"rank {rank}")


@pytest.mark.parametrize("against", ["jax_step", "sequential"])
def test_sgd_step_matches(runs, against):
    port, (_, jnew, jloss), (_, seq_new) = runs
    want = jnew if against == "jax_step" else seq_new
    for rank, (res, arrays) in enumerate(port):
        assert np.isfinite(res["loss"])
        np.testing.assert_allclose(res["loss"], jloss, rtol=1e-5)
        for k in ("W", "b"):
            np.testing.assert_allclose(arrays[f"new_{k}"], want[k][rank],
                                       **STEP, err_msg=f"s{rank}.{k}")


def test_stage_count_must_match_mesh_axis(runs):
    port, _, _ = runs
    for res, _ in port:
        assert res["eight_stages"] is not None
        assert "one stage per device" in res["eight_stages"]


def test_microbatch_split_validates():
    with pytest.raises(ValueError, match="divisible"):
        split_microbatches(torch.zeros((10, 4)), 3)
    with pytest.raises(ValueError, match="divisible"):
        jpipe.split_microbatches(jnp.zeros((10, 4)), 3)


@pytest.mark.parametrize("what", ["forward", "sgd_step"])
def test_gpt_shaped_two_blocks_a_stage(runs, what):
    port, _, _ = runs
    for rank, (res, _) in enumerate(port):
        if what == "forward":
            assert res["gpt_bit_equal"], (rank, res["gpt_max_abs"])
        else:
            assert res["gpt_step_rel_err"] <= 1e-5, (rank, res)
