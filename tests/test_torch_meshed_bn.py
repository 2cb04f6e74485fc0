"""Meshed batch norm (ops/normalization.py, ops/fused_block.py,
parallel/data_parallel.py) against the JAX package's sharded step, on the
CPU.

Over a data axis of more than one rank the port's step takes batch
norm's statistics over the GLOBAL batch, as the JAX package's sharded
step does over the whole sharded x: the forward's column sums of (x-K)
and (x-K)^2, and the backward's sums a and b, are all-reduced with the
row count. Two nets are held: a BN MLN (Dense, BatchNorm, Output) and a
small graph whose one bottleneck tail fuses (a 1 x 1 conv from 128 to 128
channels, K % 64 == 0 and N % 128 == 0, BN, the residual add and relu;
DL4J_TPU_FUSE_BLOCKS=1), whose sums sit between K4 and K5 and between K6
and K7.

Two gloo rank processes (module-scoped, bounded, killed in ``finally``)
each step on their half of every global batch; a third process is a
group of one. The JAX package's meshed step runs on its 8 virtual CPU
devices over the whole batch (tests/conftest.py), with f32 set
explicitly.

- A batch that divides (16 rows) and a padded one (14 rows: the JAX
  package pads it to 16 with zero rows that its BN counts, masked out of
  the loss; the port's ranks take the same rows, the padding on rank 1
  with label mask 0, and count them too).
- Tolerances: the two ranks' params and BN state bit for bit to each
  other; a group of one bit for bit to the unmeshed step. Against the
  JAX package's meshed step and against one process on the whole batch
  (where the batch divides): params and BN running statistics after 3
  Sgd steps 2e-4 relative and 2e-5 absolute (the same f32 sums in another
  order and over two partial sums, through batch norm's 1/sigma over 16
  rows).
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import DataSet as JDS
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.conf.layers_conv import BatchNorm as JBatchNorm
from deeplearning4j_tpu.nn.conf.layers_conv import (
    GlobalPooling as JGlobalPooling)
from deeplearning4j_tpu.nn.conf.vertices import ElementWiseVertex as JEW
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Sgd as JSgd
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu.zoo import models as jmodels
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.utils import serialization as tser

ROOT = Path(__file__).resolve().parents[1]
STEPS, N, N_PAD, C = 3, 16, 14, 128
PROC_TIMEOUT_S = 150
F32J = JDtypePolicy(param_dtype="float32", compute_dtype="float32")


def _jax_mln():
    conf = (JNNC.builder().seed(5).updater(JSgd(0.1)).dtype(F32J).list()
            .layer(JDense(n_in=6, n_out=16, activation="tanh"))
            .layer(JBatchNorm(activation="relu"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return JMLN(conf).init()


def _jax_graph():
    """One fusable tail: 1 x 1 conv 128 -> 128, BN, add the input, relu."""
    g = (JNNC.builder().seed(6).updater(JSgd(0.05)).dtype(F32J)
         .graph_builder().add_inputs("img"))
    x = jmodels._conv_bn(g, "t", C, (1, 1), (1, 1), "img",
                         activation="identity")
    g.add_vertex("t_add", JEW(op="add"), x, "img")
    g.add_layer("t_out", jmodels.ActivationLayer(activation="relu"),
                "t_add")
    g.add_layer("pool", JGlobalPooling(pooling="avg"), "t_out")
    g.add_layer("fc", JOutput(n_out=3, loss="mcxent", activation="softmax"),
                "pool")
    return JGraph(g.set_outputs("fc").set_input_types(
        JInputType.convolutional(2, 2, C)).build()).init()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(net, tree="params"):
    return {f"{k}/{p}": (v.detach().numpy() if isinstance(v, torch.Tensor)
                         else np.asarray(v))
            for k, sub in getattr(net, tree).items() for p, v in sub.items()}


_WORKER = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.parallel import distributed as D
from deeplearning4j_tpu_torch.parallel import make_mesh
from deeplearning4j_tpu_torch.parallel.data_parallel import _pad_batch
from deeplearning4j_tpu_torch.utils import serialization as tser

root, port, world, rank, mzip, gzip_, data, out = sys.argv[1:9]
world, rank = int(world), int(rank)
D.initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=60)
d = np.load(data)
arrays, res = {}, {"info": D.process_info()}

def flat(net, name, tree):
    for k, s in getattr(net, tree).items():
        for p, v in s.items():
            arrays[f"{name}/{tree}/{k}/{p}"] = v.detach().numpy()

def half(a, n):
    return a[rank * n:(rank + 1) * n]

# the BN MLN, each rank on its half of every 16-row batch
net = tser.restore_multi_layer_network(mzip, device="cpu")
net.use_mesh(make_mesh())
n = d["x"].shape[1] // world
for s in range(d["x"].shape[0]):
    net.fit_batch(DataSet(half(d["x"][s], n), half(d["y"][s], n)))
res["mln_state_sync"] = D.sync_check(net.state)
flat(net, "mln", "params"); flat(net, "mln", "state")

# the padded batch: 14 rows padded to 16 as the JAX package's 8-device
# mesh pads them (zero rows, label mask 0), then halved
net = tser.restore_multi_layer_network(mzip, device="cpu")
net.use_mesh(make_mesh())
for s in range(d["xp"].shape[0]):
    x, y, _, m = _pad_batch(torch.from_numpy(d["xp"][s]),
                            torch.from_numpy(d["yp"][s]), None, None, 8)
    net.fit_batch(DataSet(half(x, n).numpy(), half(y, n).numpy(), None,
                          half(m, n).numpy()))
res["pad_state_sync"] = D.sync_check(net.state)
flat(net, "pad", "params"); flat(net, "pad", "state")

# the graph with its fused tail
g = tser.restore_computation_graph(gzip_, device="cpu")
assert len(g._fusion_plans) == 1
g.use_mesh(make_mesh())
for s in range(d["g"].shape[0]):
    g.fit_batch(DataSet(half(d["g"][s], n), half(d["gy"][s], n)))
res["graph_state_sync"] = D.sync_check(g.state)
flat(g, "graph", "params"); flat(g, "graph", "state")

if world == 1:
    # a group of one: the meshed step is the unmeshed step, bit for bit
    for name, load, xs, ys in (
            ("mln", tser.restore_multi_layer_network, d["x"], d["y"]),
            ("graph", tser.restore_computation_graph, d["g"], d["gy"])):
        a, b = load(mzip if name == "mln" else gzip_, device="cpu"), \
            load(mzip if name == "mln" else gzip_, device="cpu")
        b.use_mesh(make_mesh())
        for s in range(xs.shape[0]):
            a.fit_batch(DataSet(xs[s], ys[s]))
            b.fit_batch(DataSet(xs[s], ys[s]))
        res[f"bit_equal_{name}"] = all(
            p.detach().numpy().tobytes() == q.detach().numpy().tobytes()
            for tree in ("params", "state")
            for k in getattr(a, tree) for p, q in zip(
                getattr(a, tree)[k].values(), getattr(b, tree)[k].values()))
np.savez(out + ".npz", **arrays)
with open(out + ".json", "w") as f:
    json.dump(res, f)
D.shutdown()
"""


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meshed_bn")
    rng = np.random.default_rng(11)
    x = rng.normal(size=(STEPS, N, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (STEPS, N))]
    xp = rng.normal(size=(STEPS, N_PAD, 6)).astype(np.float32)
    yp = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (STEPS, N_PAD))]
    gx = rng.normal(size=(STEPS, N, 2, 2, C)).astype(np.float32)
    gy = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (STEPS, N))]
    np.savez(tmp / "data.npz", x=x, y=y, xp=xp, yp=yp, g=gx, gy=gy)
    prev = os.environ.get("DL4J_TPU_FUSE_BLOCKS")
    os.environ["DL4J_TPU_FUSE_BLOCKS"] = "1"
    try:
        jmln, jgraph = _jax_mln(), _jax_graph()
        assert len(jgraph._fusion_plans) == 1
        jser.write_model(jmln, str(tmp / "mln.zip"))
        jser.write_computation_graph(jgraph, str(tmp / "graph.zip"))
        env = dict(os.environ)
        runs = [(2, 0), (2, 1), (1, 0)]
        ports = {2: _free_port(), 1: _free_port()}
        procs = {}
        try:
            for world, rank in runs:
                procs[(world, rank)] = subprocess.Popen(
                    [sys.executable, "-c", _WORKER, str(ROOT),
                     str(ports[world]), str(world), str(rank),
                     str(tmp / "mln.zip"), str(tmp / "graph.zip"),
                     str(tmp / "data.npz"), str(tmp / f"w{world}r{rank}")],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, cwd=str(ROOT), env=env)
            # the JAX package's meshed steps on its 8 virtual devices, and
            # the port's one process on the whole batch, while they run
            mesh = jmake_mesh({"data": 8})
            jax_runs = {}
            for name, make, xs, ys in (("mln", _jax_mln, x, y),
                                       ("pad", _jax_mln, xp, yp),
                                       ("graph", None, gx, gy)):
                jnet = jgraph if make is None else jmln if name == "mln" \
                    else make()
                jnet.use_mesh(mesh)
                for s in range(STEPS):
                    jnet.fit_batch(JDS(xs[s], ys[s]))
                jax_runs[name] = {f"{t}/{k}": v for t in ("params", "state")
                                  for k, v in _flat(jnet, t).items()}
            one = {}
            for name, load, path, xs, ys in (
                    ("mln", tser.restore_multi_layer_network, "mln.zip", x,
                     y),
                    ("graph", tser.restore_computation_graph, "graph.zip",
                     gx, gy)):
                tnet = load(str(tmp / path), device="cpu")
                for s in range(STEPS):
                    tnet.fit_batch(DataSet(xs[s], ys[s]))
                one[name] = {f"{t}/{k}": v for t in ("params", "state")
                             for k, v in _flat(tnet, t).items()}
            deadline = time.monotonic() + PROC_TIMEOUT_S
            logs = {}
            for key, p in procs.items():
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                logs[key] = (p.returncode, err[-3000:])
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
    finally:
        if prev is None:
            os.environ.pop("DL4J_TPU_FUSE_BLOCKS", None)
        else:
            os.environ["DL4J_TPU_FUSE_BLOCKS"] = prev
    for key, (rc, err) in logs.items():
        assert rc == 0, f"rank {key} exited {rc}:\n{err}"
    out = {}
    for world, rank in runs:
        base = tmp / f"w{world}r{rank}"
        out[(world, rank)] = (json.loads(Path(f"{base}.json").read_text()),
                              dict(np.load(f"{base}.npz")))
    return {"runs": out, "jax": jax_runs, "one": one}


def _arm(arrays, name):
    p = name + "/"
    return {k[len(p):]: v for k, v in arrays.items() if k.startswith(p)}


ARMS = ["mln", "pad", "graph"]


@pytest.mark.parametrize("arm", ARMS)
def test_the_ranks_hold_equal_state_bit_for_bit(meshed, arm):
    (r0, a0), (r1, a1) = meshed["runs"][(2, 0)], meshed["runs"][(2, 1)]
    assert r0["info"]["backend"] == "gloo"
    assert r0[f"{arm}_state_sync"] and r1[f"{arm}_state_sync"]
    m0, m1 = _arm(a0, arm), _arm(a1, arm)
    assert sorted(m0) == sorted(m1) and any(k.startswith("state/")
                                            for k in m0)
    for k in m0:
        assert m0[k].tobytes() == m1[k].tobytes(), k


@pytest.mark.parametrize("arm", ARMS)
def test_two_ranks_match_the_jax_meshed_step(meshed, arm):
    got = _arm(meshed["runs"][(2, 0)][1], arm)
    want = meshed["jax"][arm]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=f"{arm} {k}")


@pytest.mark.parametrize("arm", ["mln", "graph"])
def test_two_ranks_match_one_process_on_the_whole_batch(meshed, arm):
    got = _arm(meshed["runs"][(2, 0)][1], arm)
    want = meshed["one"][arm]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=f"{arm} {k}")


@pytest.mark.parametrize("arm", ["mln", "graph"])
def test_a_group_of_one_is_the_unmeshed_step_bit_for_bit(meshed, arm):
    res = meshed["runs"][(1, 0)][0]
    assert res[f"bit_equal_{arm}"]
