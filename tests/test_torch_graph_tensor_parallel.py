"""The port's ComputationGraph tensor parallelism
(deeplearning4j_tpu_torch/parallel/tensor.py on a graph's vertices,
nn/fusion.py's tails on column shards) against the JAX package's, on the
CPU.

- Placement: the port's ``param_specs`` and ``opt_state_specs`` equal the
  JAX package's as tuples on ``resnet18`` and ResNet-50, with and without
  an exact-key override. No processes.
- Fleets: gloo rank processes on the CPU, one module-scoped run, at
  ``{"model": 2}`` (2 ranks), ``{"data": 2, "model": 2}`` (4 ranks) and
  ``{"model": 1}`` (1 rank). Each takes one fit step of an F32
  ``resnet18`` at 16 x 16 (b = 8, each rank on its data-axis rows),
  transplanted from the JAX package; the ``{"model": 2}`` fleet also
  steps a fused F32 ResNet-50 (``DL4J_TPU_FUSE_BLOCKS=1``: its 13 tails
  on their plain versions, on column shards) and ResNet-18 with remat
  spans, and saves and restores a checkpoint. The JAX package's TP step
  runs on its forced-host devices (tests/conftest.py) at mesh (1, 2) and
  (2, 2), and its single-device step, while the ranks run.

Tolerances: ResNet-18 against the JAX TP and single-device steps is held
to the JAX package's own bounds between those two (score 1e-4, params
rtol and atol 1e-4; tests/test_parallel.py:246-251), and so is every
meshed arm against the port's unmeshed step (the same f32 arithmetic,
with dx summed over the model axis in another order). Replicated leaves
and BN state are held bit for bit across the ranks, ``{"model": 1}`` bit
for bit to the unmeshed step, and a checkpoint's next step to 1e-5
relative on the score (the second step's, against the port's unmeshed
second step, to 1e-4 relative: after a step at the zoo's Nesterovs(0.1)
the score is ~27 and the first step's differences have grown).
"""

import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.parallel import tensor as jtensor
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.updater import Nesterovs
from deeplearning4j_tpu_torch.parallel import tensor as ttensor
from deeplearning4j_tpu_torch.utils import checkpoint as tck
from deeplearning4j_tpu_torch.utils import serialization as tser

ROOT = Path(__file__).resolve().parents[1]
PROC_TIMEOUT_S = 240
IMG, B = 16, 8
TOL = dict(score=1e-4, rtol=1e-4, atol=1e-4)
FLEETS = {"m2": (2, {"model": 2}), "d2m2": (4, {"data": 2, "model": 2}),
          "m1": (1, {"model": 1})}


def _data():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, B, IMG, IMG, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (2, B))]
    return x, y


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree):
    """{layer/param: a copy in f32} (a later step updates in place)."""
    return {f"{k}/{p}": np.array(v.detach() if isinstance(v, torch.Tensor)
                                 else v, np.float32)
            for k, sub in tree.items() for p, v in sub.items()}


def _r50(device="cpu"):
    """ResNet-50 at 16 x 16, 10 classes, F32, Nesterovs(0.01, 0.9) (at
    the zoo's 0.1 a small graph diverges within steps)."""
    return zoo.resnet50(image_size=IMG, n_classes=10, dtype=zoo.F32,
                        updater=Nesterovs(0.01, 0.9), device=device)


# --------------------------------------------------- the rank processes
_WORKER = r"""
import json, os, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
root, port, world, rank, axes, tmp = sys.argv[1:7]
world, rank, axes = int(world), int(rank), json.loads(axes)
os.environ["DL4J_TPU_FUSE_BLOCKS"] = "1"
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.updater import Nesterovs
from deeplearning4j_tpu_torch.ops import registry
from deeplearning4j_tpu_torch.parallel import distributed as D, make_mesh
from deeplearning4j_tpu_torch.utils import checkpoint as tck
from deeplearning4j_tpu_torch.utils import serialization as tser

D.initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=120)
d = np.load(f"{tmp}/data.npz")
res, arrays = {}, {}
data_parts = axes.get("data", 1)
di = rank // (world // data_parts)

def rows(a):
    k = a.shape[0] // data_parts
    return torch.from_numpy(a[di * k:(di + 1) * k])

def whole(net):
    tp = net._tp
    return tp.gathered(net.params, tp.specs) if tp is not None else net.params

def keep(prefix, tree):
    for k, sub in tree.items():
        for p, v in sub.items():
            arrays[f"{prefix}/{k}/{p}"] = v.detach().numpy().copy()

def r50():
    return zoo.resnet50(image_size=16, n_classes=10, dtype=zoo.F32,
                        updater=Nesterovs(0.01, 0.9), device="cpu")

def step(net, arm, x, y):
    registry.reset_launches()
    t0 = time.perf_counter()
    score = float(net.fit_batch(DataSet(rows(x), rows(y))))
    tp = net._tp
    res[arm] = {"score": score, "routes": registry.routes(),
                "step_s": time.perf_counter() - t0,
                "collectives": tp.mg.calls if tp is not None else 0}
    keep(arm, whole(net))
    keep(arm + "_state", net.state)
    return score

mesh = make_mesh(axes)
x, y = d["x"][0], d["y"][0]
try:
    net = tser.restore_computation_graph(f"{tmp}/r18.zip", device="cpu")
    net.use_mesh(mesh, model_axis="model")
    res["stem_shape"] = list(net.params["stem_conv"]["W"].shape)
    step(net, "r18", x, y)
    if world == 1:
        ref = tser.restore_computation_graph(f"{tmp}/r18.zip", device="cpu")
        s2 = float(ref.fit_batch(DataSet(rows(x), rows(y))))
        res["bit_equal"] = (s2 == res["r18"]["score"] and all(
            torch.equal(a, b) for tree in ("params", "state", "opt_state")
            for a, b in zip(
                [t for s in getattr(ref, tree).values()
                 for t in (s.values() if isinstance(s, dict) else [s])
                 if isinstance(t, torch.Tensor)],
                [t for s in getattr(net, tree).values()
                 for t in (s.values() if isinstance(s, dict) else [s])
                 if isinstance(t, torch.Tensor)])))
    if world > 1:
        ck = f"{tmp}/ck_{world}/step_1"
        tck.save_checkpoint(net, ck)
        nx, ny = d["x"][1], d["y"][1]
        res["next_score"] = float(net.fit_batch(DataSet(rows(nx), rows(ny))))
        back = tck.restore_computation_graph(ck, mesh=mesh,
                                             model_axis="model",
                                             device="cpu")
        res["restored_stem_shape"] = list(back.params["stem_conv"]["W"].shape)
        res["restored_score"] = float(back.fit_batch(DataSet(rows(nx),
                                                             rows(ny))))
    if world == 2:
        f = r50()
        f.use_mesh(mesh, model_axis="model")
        res["tails"] = len(f._fusion_plans)
        step(f, "r50f", x, y)
        rm = tser.restore_computation_graph(f"{tmp}/r18.zip", device="cpu")
        rm.remat_prefixes = ("s1", "s2")
        rm.use_mesh(mesh, model_axis="model")
        step(rm, "r18_remat", x, y)
finally:
    np.savez(f"{tmp}/w{world}r{rank}.npz", **arrays)
    with open(f"{tmp}/w{world}r{rank}.json", "w") as fh:
        json.dump(res, fh)
    D.shutdown()
"""


def _jax_mesh(data, model):
    devs = np.array(jax.devices()[:data * model]).reshape(data, model)
    return Mesh(devs, ("data", "model"))


def _jr18():
    return jzoo.resnet18(seed=11, image_size=IMG, dtype=jzoo.F32)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """The three fleets, started together, bounded and stopped in
    ``finally``; the JAX package's TP and single-device steps, and the
    port's unmeshed steps, run in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("gtp")
    x, y = _data()
    np.savez(tmp / "data.npz", x=x, y=y)
    jser.write_computation_graph(_jr18(), str(tmp / "r18.zip"))
    procs, logs = {}, {}
    try:
        for name, (world, axes) in FLEETS.items():
            port = _free_port()
            for rank in range(world):
                procs[(world, rank)] = subprocess.Popen(
                    [sys.executable, "-c", _WORKER, str(ROOT), str(port),
                     str(world), str(rank), json.dumps(axes), str(tmp)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                    cwd=str(ROOT))
        jax_out = {}
        for key, mesh in (("single", None), ("tp12", (1, 2)),
                          ("tp22", (2, 2))):
            jnet = _jr18()
            if mesh is not None:
                jnet.use_mesh(_jax_mesh(*mesh), model_axis="model")
            score = float(jnet.fit_batch(JMDS([x[0]], [y[0]])))
            jax_out[key] = (score, _flat(jax.tree_util.tree_map(
                np.asarray, jnet.params)))
        port_out = {}
        net = tser.restore_computation_graph(str(tmp / "r18.zip"),
                                             device="cpu")
        port_out["r18"] = (float(net.fit_batch(DataSet(
            torch.from_numpy(x[0]), torch.from_numpy(y[0])))),
            _flat(net.params), _flat(net.state))
        port_out["next"] = float(net.fit_batch(DataSet(
            torch.from_numpy(x[1]), torch.from_numpy(y[1]))))
        deadline = time.monotonic() + PROC_TIMEOUT_S
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
    runs = {}
    for name, (world, _) in FLEETS.items():
        runs[name] = []
        for rank in range(world):
            base = tmp / f"w{world}r{rank}"
            with open(f"{base}.json") as f:
                res = json.load(f)
            runs[name].append((res, dict(np.load(f"{base}.npz"))))
    return {"runs": runs, "jax": jax_out, "port": port_out, "tmp": tmp,
            "data": (x, y)}


@pytest.fixture(scope="module")
def fused_unmeshed(monkeypatch_module):
    """The port's unmeshed fused ResNet-50 step (its tails on their plain
    versions)."""
    monkeypatch_module.setenv("DL4J_TPU_FUSE_BLOCKS", "1")
    x, y = _data()
    net = _r50()
    assert len(net._fusion_plans) == 13
    score = float(net.fit_batch(DataSet(torch.from_numpy(x[0]),
                                        torch.from_numpy(y[0]))))
    return score, _flat(net.params), _flat(net.state)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _arm(arrays, prefix):
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def _close(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol["rtol"],
                                   atol=tol["atol"], err_msg=f"{what} {k}")


# ---------------------------------------------------------- placement
def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _port_tree(jnet):
    conv = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa
    to = lambda tree: {k: to(v) if isinstance(v, dict) else conv(v)  # noqa
                       for k, v in tree.items()}
    return to(jnet.params), to(jax.tree_util.tree_map(
        np.asarray, jnet.opt_state))


_NETS = {}


def _jnet(kind):
    if kind not in _NETS:
        _NETS[kind] = (jzoo.resnet18(seed=11, image_size=IMG)
                       if kind == "resnet18"
                       else jzoo.resnet50(image_size=32, n_classes=10))
    return _NETS[kind]


@pytest.mark.parametrize("override", [False, True])
@pytest.mark.parametrize("kind", ["resnet18", "resnet50"])
@pytest.mark.parametrize("m", [2, 4])
def test_placement_equals_the_jax_package(kind, override, m):
    jnet = _jnet(kind)
    params, opt = _port_tree(jnet)
    trules = {"['stem_conv']['W']": ttensor.P()} if override else None
    jrules = {"['stem_conv']['W']": JP()} if override else None
    jspecs = jtensor.param_specs(jnet.params, _jax_mesh(1, m), "model",
                                 jrules)
    tspecs = ttensor.param_specs(params, {"data": 1, "model": m}, "model",
                                 trules)
    is_spec = lambda s: isinstance(s, JP)  # noqa: E731
    assert _tuples(tspecs) == jax.tree_util.tree_map(tuple, jspecs,
                                                     is_leaf=is_spec)
    assert _tuples(ttensor.opt_state_specs(opt, tspecs)) == \
        jax.tree_util.tree_map(tuple, jtensor.opt_state_specs(
            jnet.opt_state, jspecs), is_leaf=is_spec)
    assert tspecs["stem_conv"]["W"] == ((() if override else
                                         (None, None, None, "model")))
    assert tspecs["stem_bn"]["gamma"] == ()


# ------------------------------------------------------------- fleets
@pytest.mark.parametrize("fleet", ["m2", "d2m2"])
def test_tp_step_matches_the_jax_tp_and_single_device_steps(fleets, fleet):
    res, arrays = fleets["runs"][fleet][0]
    got = _arm(arrays, "r18")
    for key in ("single", "tp12" if fleet == "m2" else "tp22"):
        jscore, jparams = fleets["jax"][key]
        assert abs(res["r18"]["score"] - jscore) < TOL["score"], key
        _close(got, jparams, TOL, f"r18 vs JAX {key}")
    pscore, pparams, pstate = fleets["port"]["r18"]
    assert abs(res["r18"]["score"] - pscore) < TOL["score"]
    _close(got, pparams, TOL, "r18 vs the port unmeshed")
    _close(_arm(arrays, "r18_state"), pstate, TOL, "r18 BN state")
    # every conv, and the head, computed on its shards: no gather route
    assert res["r18"]["routes"] == {}
    assert res["stem_shape"] == [7, 7, 3, 32]
    # a step's model-axis collectives: a gather a conv's forward (20) and
    # an all-reduce of its dx (the stem's input takes none: 19); the
    # head's gather in the walk and in the loss, its f's all-reduce and
    # its bias's gather; no all-reduce of a zero L2 term at l2 = 0
    assert res["r18"]["collectives"] == 20 + 19 + 2 + 2


@pytest.mark.parametrize("fleet", ["m2", "d2m2"])
def test_every_rank_holds_the_same_bits(fleets, fleet):
    """Gathered params (replicated leaves as each rank holds them,
    sharded ones whole), BN state and scores: bit-equal across ranks."""
    runs = fleets["runs"][fleet]
    r0, a0 = runs[0]
    for res, arrays in runs[1:]:
        assert set(arrays) == set(a0)
        for k in a0:
            assert arrays[k].tobytes() == a0[k].tobytes(), k
        for arm in ("r18", "r50f", "r18_remat"):
            if arm in r0:
                assert res[arm]["score"] == r0[arm]["score"], arm


def test_a_model_axis_of_one_is_the_unmeshed_step_bit_for_bit(fleets):
    (res, _), = fleets["runs"]["m1"]
    assert res["bit_equal"]
    assert res["r18"]["routes"] == {}
    assert res["stem_shape"] == [7, 7, 3, 64]


def test_fused_tails_on_column_shards_match_the_unmeshed_step(
        fleets, fused_unmeshed):
    res, arrays = fleets["runs"]["m2"][0]
    assert res["tails"] == 13
    assert res["r50f"]["routes"] == {}
    score, params, state = fused_unmeshed
    assert abs(res["r50f"]["score"] - score) < TOL["score"]
    _close(_arm(arrays, "r50f"), params, TOL, "fused r50 vs unmeshed")
    _close(_arm(arrays, "r50f_state"), state, TOL, "fused r50 BN state")


def test_remat_spans_run_the_same_renderings(fleets):
    res, arrays = fleets["runs"]["m2"][0]
    pscore, pparams, _ = fleets["port"]["r18"]
    assert abs(res["r18_remat"]["score"] - pscore) < TOL["score"]
    _close(_arm(arrays, "r18_remat"), pparams, TOL, "r18 remat")


@pytest.mark.parametrize("fleet", ["m2", "d2m2"])
def test_a_checkpoint_at_m2_restores_at_m2_and_unmeshed(fleets, fleet):
    world = FLEETS[fleet][0]
    res, _ = fleets["runs"][fleet][0]
    assert res["restored_stem_shape"] == [7, 7, 3, 32]
    assert abs(res["restored_score"] - res["next_score"]) <= \
        1e-5 * abs(res["next_score"])
    assert abs(res["next_score"] - fleets["port"]["next"]) <= \
        TOL["score"] * abs(fleets["port"]["next"])
    ck = fleets["tmp"] / f"ck_{world}" / "step_1"
    net = tck.restore_computation_graph(str(ck), device="cpu")
    assert tuple(net.params["stem_conv"]["W"].shape) == (7, 7, 3, 64)
    x, y = fleets["data"]
    score = float(net.fit_batch(DataSet(torch.from_numpy(x[1]),
                                        torch.from_numpy(y[1]))))
    assert abs(score - res["next_score"]) <= 1e-5 * abs(res["next_score"])
    layout = tck.read_checkpoint_layout(str(ck))
    assert layout["mesh"]["model_axis"] == "model"
    assert layout["mesh_detail"] == {"model_axis": "model",
                                     "tp_rules": None}
    assert layout["param_specs"]["['stem_conv']['W']"] == [
        None, None, None, "model"]
    assert layout["param_specs"]["['stem_bn']['gamma']"] == []
