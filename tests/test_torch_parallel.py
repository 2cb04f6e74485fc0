"""The port's data-parallel tier (deeplearning4j_tpu_torch/parallel) against
the JAX package's, on the CPU.

- ``ParallelWrapper`` runs in this process beside the JAX package's on a
  model transplanted through the zip.
- The meshed step runs in two gloo processes (a module-scoped pair started
  with ``subprocess``, each rank on its half of every batch) and in a
  group of one; the JAX package's meshed step runs on its 8 virtual CPU
  devices (tests/conftest.py) over the whole batch.

Tolerances: the two ranks are held bit for bit to each other, and a
group of one bit for bit to the unmeshed step. Against the JAX package
and against one process on the whole batch, parameters after Sgd steps
agree to 2e-4 relative and 1e-5 absolute (the JAX package's own bound
between its sharded and single-device steps: the same f32 gradient
summed in another order, moved by lr 0.1 over 3 steps). ParallelWrapper
against the JAX package: 1e-5 relative, 1e-6 absolute (f32 gradients of
~1e-6 relative difference averaged over the same workers).
"""

import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JArrayIt
from deeplearning4j_tpu.datasets import DataSet as JDS
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam, Sgd as JSgd
from deeplearning4j_tpu.parallel import ParallelWrapper as JParallelWrapper
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel import stats as jstats
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import multistep
from deeplearning4j_tpu_torch.nn.updater import _leaves, _map
from deeplearning4j_tpu_torch.parallel import (ParallelWrapper, distributed,
                                               make_mesh, stats)
from deeplearning4j_tpu_torch.parallel.data_parallel import (_pad_batch,
                                                             mean_leaf)
from deeplearning4j_tpu_torch.utils import serialization as tser
from tests.test_multilayer import build_mlp, make_blobs

ROOT = Path(__file__).resolve().parents[1]
STEPS, N = 3, 16
PROC_TIMEOUT_S = 120


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _flat(params):
    return {f"{k}/{p}": _np(v) for k, sub in params.items()
            for p, v in sub.items()}


def _transplant(jnet, path):
    jser.write_model(jnet, str(path))
    return tser.restore_multi_layer_network(str(path), device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --------------------------------------------------- the rank processes
_WORKER = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import multistep
from deeplearning4j_tpu_torch.parallel import distributed as D
from deeplearning4j_tpu_torch.parallel import make_mesh, shard_step
from deeplearning4j_tpu_torch.parallel.stats import (
    TrainingStatsCollector, export_timeline_html)
from deeplearning4j_tpu_torch.utils import serialization as tser

root, port, world, rank, zipp, data, out = sys.argv[1:8]
world, rank = int(world), int(rank)
D.initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
             timeout_s=60)
d = np.load(data)
x, y = d["x"], d["y"]
res = {"info": D.process_info()}
flat = lambda net: {f"{k}/{p}": v.numpy() for k, s in net.params.items()
                    for p, v in s.items()}

# the meshed fit_batch, each rank on its half of every batch
net = tser.restore_multi_layer_network(zipp, device="cpu")
net.use_mesh(make_mesh())
st = TrainingStatsCollector(worker_id=f"worker_{rank}")
n = x.shape[1] // world
for s in range(x.shape[0]):
    with st.time_phase("fit"):
        score = net.fit_batch(DataSet(x[s, rank * n:(rank + 1) * n],
                                      y[s, rank * n:(rank + 1) * n]))
res["score"] = float(score)
res["sync"] = D.sync_check(net.params)
arrays = {"mesh/" + k: v for k, v in flat(net).items()}

# shard_step on uneven local slices: rank 0 takes 11 rows of 16 a batch
net2 = tser.restore_multi_layer_network(zipp, device="cpu")
step = shard_step(net2, multistep.train_step, make_mesh())
cut = [0, 11, x.shape[1]] if world == 2 else [0, x.shape[1]]
for s in range(x.shape[0]):
    lo, hi = cut[rank], cut[rank + 1]
    step(torch.from_numpy(x[s, lo:hi]), torch.from_numpy(y[s, lo:hi]))
    net2.iteration += 1
arrays.update({"uneven/" + k: v for k, v in flat(net2).items()})

if world == 1:
    # a group of one: the meshed step is the unmeshed step, bit for bit,
    # eager and through the step graph
    for repeated in (False, True):
        a = tser.restore_multi_layer_network(zipp, device="cpu")
        b = tser.restore_multi_layer_network(zipp, device="cpu")
        b.use_mesh(make_mesh())
        for s in range(x.shape[0]):
            ds = DataSet(x[s], y[s])
            if repeated:
                a.fit_batch_repeated(ds, 2); b.fit_batch_repeated(ds, 2)
            else:
                a.fit_batch(ds); b.fit_batch(ds)
        res[f"bit_equal_{repeated}"] = all(
            p.tobytes() == q.tobytes()
            for p, q in zip(flat(a).values(), flat(b).values()))

res["agree"] = D.agree_decision(rank + 10, name="t")
res["any"] = D.any_process(rank == world - 1)
D.barrier("b1", timeout_s=30)
if world > 1 and rank == 0:
    try:
        D.agree_decision(7, name="lost", timeout_s=1.0)
        res["lost"] = None
    except D.PeerLostError as e:
        res["lost"] = e.lost_ranks
D.barrier("b2", timeout_s=30)
events = st.gather_across_processes()
res["workers"] = sorted({e.worker_id for e in events})
res["phases"] = sorted({e.phase for e in events})
if rank == 0:
    export_timeline_html(events, out + ".html")
np.savez(out + ".npz", **arrays)
with open(out + ".json", "w") as f:
    json.dump(res, f)
D.shutdown()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks and a group of one, started together, bounded, and
    stopped in ``finally``: {(world, rank): (json, arrays)}, plus the
    JAX package's meshed run and the inputs."""
    tmp = tmp_path_factory.mktemp("ranks")
    x, y = make_blobs(n=STEPS * N, seed=3)
    x = x.reshape(STEPS, N, -1)
    y = y.reshape(STEPS, N, -1)
    np.savez(tmp / "data.npz", x=x, y=y)
    jnet = JMLN(build_mlp(updater=JSgd(0.1))).init()
    jser.write_model(jnet, str(tmp / "start.zip"))
    runs = [(2, 0), (2, 1), (1, 0)]
    ports = {2: _free_port(), 1: _free_port()}
    procs = {}
    try:
        for world, rank in runs:
            out = str(tmp / f"w{world}r{rank}")
            procs[(world, rank)] = subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(ROOT),
                 str(ports[world]), str(world), str(rank),
                 str(tmp / "start.zip"), str(tmp / "data.npz"), out],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=str(ROOT))
        # the JAX package's meshed step over its 8 virtual devices, while
        # the ranks run
        jnet.use_mesh(jmake_mesh({"data": 8}))
        for s in range(STEPS):
            jnet.fit_batch(JDS(x[s], y[s]))
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
    for key, (rc, err) in logs.items():
        assert rc == 0, f"rank {key} exited {rc}:\n{err}"
    out = {}
    for world, rank in runs:
        base = tmp / f"w{world}r{rank}"
        with open(f"{base}.json") as f:
            res = json.load(f)
        out[(world, rank)] = (res, dict(np.load(f"{base}.npz")))
    return {"runs": out, "jax": {k: np.asarray(v) for k, v in
                                 _flat(jnet.params).items()},
            "tmp": tmp, "x": x, "y": y}


def _arm(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def test_two_ranks_are_bit_equal_and_match_the_jax_meshed_step(ranks):
    (r0, a0), (r1, a1) = ranks["runs"][(2, 0)], ranks["runs"][(2, 1)]
    assert r0["info"]["process_count"] == 2 and r0["info"]["backend"] == \
        "gloo"
    assert r0["sync"] and r1["sync"]
    assert r0["score"] == r1["score"]
    for arm in ("mesh/", "uneven/"):
        m0, m1 = _arm(a0, arm), _arm(a1, arm)
        for k in m0:
            assert m0[k].tobytes() == m1[k].tobytes(), (arm, k)
            np.testing.assert_allclose(m0[k], ranks["jax"][k], rtol=2e-4,
                                       atol=1e-5, err_msg=arm + k)


def test_two_ranks_match_one_process_on_the_whole_batch(ranks):
    a0 = ranks["runs"][(2, 0)][1]
    one = ranks["runs"][(1, 0)][1]
    for arm in ("mesh/", "uneven/"):
        got, want = _arm(a0, arm), _arm(one, arm)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4,
                                       atol=1e-5, err_msg=arm + k)


def test_a_group_of_one_is_the_unmeshed_step_bit_for_bit(ranks):
    res = ranks["runs"][(1, 0)][0]
    assert res["bit_equal_False"] and res["bit_equal_True"]
    assert res["agree"] == [10] and res["any"] is True


def test_consensus_stats_and_a_lost_peer(ranks):
    r0, r1 = ranks["runs"][(2, 0)][0], ranks["runs"][(2, 1)][0]
    assert r0["agree"] == r1["agree"] == [10, 11]
    assert r0["any"] is True and r1["any"] is True
    assert r0["lost"] == [1]
    assert r0["workers"] == ["worker_0", "worker_1"] == r1["workers"]
    assert r0["phases"] == ["fit"]
    html = (ranks["tmp"] / "w2r0.html").read_text()
    assert "worker_0" in html and "worker_1" in html


def _pw_nets(tmp_path, updater, n=128, seed=5):
    x, y = make_blobs(n=n, seed=seed)
    jnet = JMLN(build_mlp(updater=updater)).init()
    tnet = _transplant(jnet, tmp_path / "pw.zip")
    return x, y, jnet, tnet


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_parallel_wrapper_matches_the_jax_package(tmp_path, updater):
    jup = JSgd(0.1) if updater == "sgd" else JAdam(1e-2)
    x, y, jnet, tnet = _pw_nets(tmp_path, jup)
    JParallelWrapper(jnet, workers=4, averaging_frequency=2).fit(
        JArrayIt(x, y, batch_size=16), epochs=2)
    ParallelWrapper(tnet, workers=4, averaging_frequency=2).fit(
        ArrayDataSetIterator(x, y, batch_size=16), epochs=2)
    assert tnet.iteration == jnet.iteration == 2
    got, want = _flat(tnet.params), _flat(jnet.params)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if updater == "adam":
        # the integer step count takes the furthest worker's count
        ts = [t for t in _leaves(tnet.opt_state)
              if not t.dtype.is_floating_point]
        assert ts and all(int(t.max()) == 4 for t in ts)


def test_parallel_wrapper_is_the_explicit_average_of_train_steps(tmp_path):
    x, y, _, tnet = _pw_nets(tmp_path, JSgd(0.1), n=64)
    ref = tnet.clone()
    ParallelWrapper(tnet, workers=4, averaging_frequency=1).fit(
        ArrayDataSetIterator(x, y, batch_size=16), epochs=1)
    copies = []
    for w in range(4):
        c = ref.clone()
        multistep.train_step(c, c._step_batch(DataSet(
            x[16 * w:16 * (w + 1)], y[16 * w:16 * (w + 1)])), advance=False)
        copies.append(c.params)
    want = _map(lambda *xs: sum(xs) / len(xs), *copies)
    for g, w in zip(_leaves(tnet.params), _leaves(want)):
        assert torch.equal(g, w)


def test_parallel_wrapper_short_data_is_not_diluted(tmp_path):
    x, y, _, tnet = _pw_nets(tmp_path, JSgd(0.1), n=16, seed=12)
    ref = tnet.clone()
    ParallelWrapper(tnet, workers=2, averaging_frequency=1).fit(
        ArrayDataSetIterator(x, y, batch_size=16), epochs=1)
    ref.fit_batch(DataSet(x, y))
    for g, w in zip(_leaves(tnet.params), _leaves(ref.params)):
        assert torch.equal(g, w)


def test_mean_leaf_keeps_integers_integral():
    a = torch.tensor([1, 5], dtype=torch.int32)
    b = torch.tensor([3, 2], dtype=torch.int32)
    assert mean_leaf(a, b).tolist() == [3, 5]
    assert mean_leaf(a, b).dtype == torch.int32
    assert mean_leaf(torch.tensor([1.0]), torch.tensor([2.0])).item() == 1.5


def test_pad_batch_masks_the_padded_rows():
    x, y = torch.ones(5, 3), torch.ones(5, 2)
    px, py, pf, pm = _pad_batch(x, y, None, None, 4)
    assert px.shape == (8, 3) and py.shape == (8, 2) and pf is None
    assert pm.tolist() == [1.0] * 5 + [0.0] * 3
    assert _pad_batch(x, y, None, None, 5)[3] is None


def test_group_rules_need_no_card():
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh()
    with pytest.raises(ValueError, match="nccl"):
        distributed.initialize("127.0.0.1:1", 1, 0, backend="nccl",
                               device="cpu")
    assert distributed.agree_decision(4) == [4]
    assert distributed.any_process(False) is False
    distributed.barrier("alone")
    assert distributed.process_info()["process_count"] == 1


def test_collective_timeout_reads_the_env(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_COLLECTIVE_TIMEOUT_S", "2.5")
    assert distributed.collective_timeout_s() == 2.5
    monkeypatch.setenv("DL4J_TPU_COLLECTIVE_TIMEOUT_S", "nope")
    assert distributed.collective_timeout_s() == \
        distributed.DEFAULT_COLLECTIVE_TIMEOUT_S
    err = distributed.PeerLostError("x", lost_ranks=(1,), round_name="r")
    assert isinstance(err, distributed.CollectiveTimeoutError)
    assert err.lost_ranks == [1]


def test_use_mesh_refuses_tensor_parallelism(tmp_path):
    """A MultiLayerNetwork takes model_axis= (its fleets run in
    tests/test_torch_tensor_parallel.py), checking its rules before any
    collective; a ComputationGraph still refuses it, naming its queue
    item."""
    from tests.test_torch_checkpoint import _bn_graph
    _, _, _, tnet = _pw_nets(tmp_path, JSgd(0.1), n=16)
    with pytest.raises(ValueError, match="layer_9"):
        tnet.use_mesh(None, model_axis="model",
                      tp_rules={"['layer_9']['W']": None})
    with pytest.raises(NotImplementedError,
                       match="ComputationGraph tensor parallelism"):
        _bn_graph().use_mesh(None, model_axis="model")


def test_stats_export_equals_the_jax_package(tmp_path):
    rows = [("worker_0", "fit", 0.0, 12.5), ("worker_0", "average", 0.0125,
                                              3.25),
            ("worker_1", "fit", 0.001, 11.0)]
    jev = [jstats.EventStats(*r) for r in rows]
    tev = [stats.EventStats(*r) for r in rows]
    jstats.export_timeline_html(jev, str(tmp_path / "j.html"))
    stats.export_timeline_html(tev, str(tmp_path / "t.html"))
    assert (tmp_path / "t.html").read_text() == \
        (tmp_path / "j.html").read_text()
    col = stats.TrainingStatsCollector("worker_3")
    with col.time_phase("fit"):
        pass
    assert [e.worker_id for e in col.gather_across_processes()] == \
        ["worker_3"]
    assert set(col.phase_totals_ms()) == {"fit"}
    assert stats.EventStats.from_dict(tev[1].to_dict()) == tev[1]
