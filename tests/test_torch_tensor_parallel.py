"""The port's tensor parallelism (deeplearning4j_tpu_torch/parallel/tensor.py)
against the JAX package's, on the CPU.

- Placement: the port's ``param_specs``, ``opt_state_specs`` and
  ``unmatched_rules`` equal the JAX package's as tuples, on the 12-32-16-3
  MLP of tests/test_parallel.py, a small gpt_mini with and without
  ``gpt_mini_tp_rules``, and the exact-key override. No processes.
- Fleets: gloo rank processes on the CPU, one module-scoped run each, at
  ``{"model": 2}`` (2 ranks), ``{"data": 2, "model": 2}`` (4 ranks) and
  ``{"model": 1}`` (1 rank). Each takes one SGD and one Adam fit step on
  the MLP and on a small F32 gpt_mini (``gpt_mini_tp_rules``), each rank
  on its data slice of the batch. The JAX package's TP step runs on its
  forced-host devices (tests/conftest.py) at mesh (1, 2) and (2, 2), and
  its single-device step, while the ranks run.

Tolerances are the JAX package's own between its TP and single-device
steps: the MLP's score 1e-5 and params rtol 1e-5, atol 1e-6
(tests/test_parallel.py:151-169); gpt_mini's score 1e-4 and params rtol
2e-4, atol 1e-5 (tests/test_transformer.py:730-750): the same f32
arithmetic summed in another order (partial sums over the model axis).
Replicated leaves are held bit for bit across the ranks, ``{"model": 1}``
bit for bit to the unmeshed step, and a checkpoint's next step to 1e-5
relative on the score (tests/test_parallel.py:181-199).
"""

import dataclasses
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
from deeplearning4j_tpu.datasets import DataSet as JDS
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam, Sgd as JSgd
from deeplearning4j_tpu.parallel import tensor as jtensor
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.parallel import tensor as ttensor
from deeplearning4j_tpu_torch.utils import checkpoint as tck
from deeplearning4j_tpu_torch.utils import serialization as tser

ROOT = Path(__file__).resolve().parents[1]
PROC_TIMEOUT_S = 150
V, T, B = 12, 8, 8
MLP_TOL = dict(score=1e-5, rtol=1e-5, atol=1e-6)
GPT_TOL = dict(score=1e-4, rtol=2e-4, atol=1e-5)
F32 = JDtypePolicy(param_dtype="float32", compute_dtype="float32")


def _jmlp(updater, seed=5, clip=False):
    b = JNNC.builder().seed(seed).updater(updater).dtype(F32)
    if clip:
        b = (b.l2(1e-3).gradient_normalization("clip_l2_per_layer")
             .gradient_normalization_threshold(0.05))
    conf = (b.list()
            .layer(JDense(n_in=12, n_out=32, activation="tanh"))
            .layer(JDense(n_out=16, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return JMLN(conf).init()


def _jgpt(updater, n_heads=4, width=32):
    """A small F32 gpt_mini; its zoo updater (Adam) or ``updater``."""
    net = jzoo.gpt_mini(vocab_size=V, width=width, n_layers=2,
                        n_heads=n_heads, max_len=16, dtype=jzoo.F32, seed=7)
    if updater is None:
        return net
    conf = dataclasses.replace(net.conf, global_conf=dataclasses.replace(
        net.conf.global_conf, updater=updater))
    return JMLN(conf).init()


# arm -> (JAX net maker, rules on the port's side, rules on the JAX
# side, tolerances)
ARMS = {
    "mlp_sgd": (lambda: _jmlp(JSgd(0.1)), None, None, MLP_TOL),
    "mlp_adam": (lambda: _jmlp(JAdam(1e-2)), None, None, MLP_TOL),
    "gpt_sgd": (lambda: _jgpt(JSgd(0.1)), "gpt", jzoo.gpt_mini_tp_rules,
                GPT_TOL),
    "gpt_adam": (lambda: _jgpt(None), "gpt", jzoo.gpt_mini_tp_rules,
                 GPT_TOL),
}
# arms held against the port's unmeshed step only: clipping and an L2
# term, an attention layer whose heads do not divide m = 2 and a
# GravesLSTM (both on the gather route)
LOCAL_ARMS = {
    "mlp_clip": lambda: _jmlp(JSgd(0.1), clip=True),
    "gpt_heads3": lambda: _jgpt(JSgd(0.1), n_heads=3, width=24),
    "rnn": lambda: jzoo.char_rnn(vocab_size=V, hidden=16, n_layers=1,
                                 dtype=jzoo.F32, seed=9),
}
FLEETS = {"m2": (2, {"model": 2}), "d2m2": (4, {"data": 2, "model": 2}),
          "m1": (1, {"model": 1})}


def _data():
    rng = np.random.default_rng(11)
    eye = np.eye(V, dtype=np.float32)
    ids = rng.integers(0, V, (2, B, T + 1))
    seq = [(eye[i[:, :-1]], eye[i[:, 1:]]) for i in ids]
    x = rng.normal(size=(B, 12)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]
    return {"mlp": (x, y), "seq": seq[0], "seq_next": seq[1]}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(params):
    """{layer/param: a copy in f32} (a later step updates in place)."""
    return {f"{k}/{p}": np.array(v.detach() if isinstance(v, torch.Tensor)
                                 else v, np.float32)
            for k, sub in params.items() for p, v in sub.items()}


# --------------------------------------------------- the rank processes
_WORKER = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.ops import registry
from deeplearning4j_tpu_torch.parallel import distributed as D, make_mesh
from deeplearning4j_tpu_torch.utils import checkpoint as tck
from deeplearning4j_tpu_torch.utils import serialization as tser

root, port, world, rank, axes, tmp = sys.argv[1:7]
world, rank, axes = int(world), int(rank), json.loads(axes)
D.initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=60)
d = np.load(f"{tmp}/data.npz")
arms = json.loads(open(f"{tmp}/arms.json").read())
res, arrays = {}, {}
data_parts = axes.get("data", 1)
di = rank // (world // data_parts)

def rows(a):
    k = a.shape[0] // data_parts
    return torch.from_numpy(a[di * k:(di + 1) * k])

def whole(net):
    tp = net._tp
    return tp.gathered(net.params, tp.specs) if tp is not None else net.params

def flat(prefix, params):
    for k, sub in params.items():
        for p, v in sub.items():
            # a copy: a later step updates the params in place
            arrays[f"{prefix}/{k}/{p}"] = v.detach().numpy().copy()

mesh = make_mesh(axes)
try:
    for arm, (kind, rules) in arms.items():
        x, y = (d["mlp_x"], d["mlp_y"]) if kind == "mlp" else (d["seq_x"],
                                                               d["seq_y"])
        net = tser.restore_multi_layer_network(f"{tmp}/{arm}.zip",
                                               device="cpu")
        tp_rules = zoo.gpt_mini_tp_rules() if rules == "gpt" else None
        net.use_mesh(mesh, model_axis="model", tp_rules=tp_rules)
        registry.reset_launches()
        score = net.fit_batch(DataSet(rows(x), rows(y)))
        res[arm] = {"score": float(score), "routes": registry.routes()}
        flat(arm, whole(net))
        if world == 1:
            ref = tser.restore_multi_layer_network(f"{tmp}/{arm}.zip",
                                                   device="cpu")
            s2 = ref.fit_batch(DataSet(rows(x), rows(y)))
            res[arm]["bit_equal"] = (float(s2) == float(score) and all(
                torch.equal(a, b) for ln in ref.params
                for a, b in zip(ref.params[ln].values(),
                                net.params[ln].values())))
        if arm == "gpt_adam" and world > 1:
            ck = f"{tmp}/ck_{world}/step_1"
            tck.save_checkpoint(net, ck)
            nx, ny = rows(d["next_x"]), rows(d["next_y"])
            res["next_score"] = float(net.fit_batch(DataSet(nx, ny)))
            back = tck.restore_multi_layer_network(
                ck, mesh=mesh, model_axis="model", tp_rules=tp_rules,
                device="cpu")
            local_shape = {k: tuple(v.shape)
                           for k, v in back.params["layer_1"].items()}
            res["restored_shapes"] = local_shape
            res["restored_score"] = float(back.fit_batch(DataSet(nx, ny)))
            flat("restored", whole(back))
    # the meshed net's batch placement: this rank's data-axis rows
    from deeplearning4j_tpu_torch.datasets import (DevicePrefetchIterator,
                                                   ListDataSetIterator)
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        BatchSharding)
    it = DevicePrefetchIterator(ListDataSetIterator([DataSet(
        d["seq_x"], d["seq_y"])]), device="cpu",
        sharding=BatchSharding(mesh))
    placed = next(iter(it))
    res["sharded_rows"] = bool(
        torch.equal(placed.features, rows(d["seq_x"]))
        and torch.equal(placed.labels, rows(d["seq_y"])))
    if world > 1:
        # ranks of one model group on different rows: refused by hash
        net = tser.restore_multi_layer_network(f"{tmp}/mlp_sgd.zip",
                                               device="cpu")
        net.use_mesh(mesh, model_axis="model")
        x = torch.from_numpy(d["mlp_x"]) + rank
        try:
            net.fit_batch(DataSet(x, torch.from_numpy(d["mlp_y"])))
            res["rows_error"] = None
        except ValueError as e:
            res["rows_error"] = str(e)
finally:
    np.savez(f"{tmp}/w{world}r{rank}.npz", **arrays)
    with open(f"{tmp}/w{world}r{rank}.json", "w") as f:
        json.dump(res, f)
    D.shutdown()
"""


def _jax_mesh(data, model):
    devs = np.array(jax.devices()[:data * model]).reshape(data, model)
    return Mesh(devs, ("data", "model"))


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """The three fleets, started together, bounded and stopped in
    ``finally``; the JAX package's TP and single-device steps run while
    they do; the port's unmeshed step of every arm in this process."""
    tmp = tmp_path_factory.mktemp("tp")
    d = _data()
    np.savez(tmp / "data.npz", mlp_x=d["mlp"][0], mlp_y=d["mlp"][1],
             seq_x=d["seq"][0], seq_y=d["seq"][1], next_x=d["seq_next"][0],
             next_y=d["seq_next"][1])
    arms = {}
    jnets = {}
    for arm, spec in {**ARMS, **LOCAL_ARMS}.items():
        make = spec[0] if arm in ARMS else spec
        kind = "mlp" if arm.startswith("mlp") else "seq"
        rules = ARMS[arm][1] if arm in ARMS else None
        jnets[arm] = make
        jser.write_model(make(), str(tmp / f"{arm}.zip"))
        arms[arm] = (kind, rules)
    (tmp / "arms.json").write_text(json.dumps(arms))
    procs = {}
    logs = {}
    try:
        for name, (world, axes) in FLEETS.items():
            port = _free_port()
            for rank in range(world):
                procs[(world, rank)] = subprocess.Popen(
                    [sys.executable, "-c", _WORKER, str(ROOT), str(port),
                     str(world), str(rank), json.dumps(axes), str(tmp)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                    cwd=str(ROOT))
        # the JAX package's steps over the whole batch, meanwhile
        jax_out = {}
        for arm, (make, _, jrules, _) in ARMS.items():
            kind = arms[arm][0]
            x, y = d["mlp"] if kind == "mlp" else d["seq"]
            for key, mesh in (("single", None), ("tp12", (1, 2)),
                              ("tp22", (2, 2))):
                jnet = make()
                if mesh is not None:
                    jnet.use_mesh(_jax_mesh(*mesh), model_axis="model",
                                  tp_rules=jrules() if jrules else None)
                score = float(jnet.fit_batch(JDS(x, y)))
                jax_out[(arm, key)] = (score, _flat(
                    jax.tree_util.tree_map(np.asarray, jnet.params)))
        # the port's unmeshed step of every arm, and the checkpoint arm's
        # next step
        port_out = {}
        for arm in arms:
            kind = arms[arm][0]
            x, y = d["mlp"] if kind == "mlp" else d["seq"]
            net = tser.restore_multi_layer_network(str(tmp / f"{arm}.zip"),
                                                   device="cpu")
            score = float(net.fit_batch(DataSet(torch.from_numpy(x),
                                                torch.from_numpy(y))))
            port_out[arm] = (score, _flat(net.params))
            if arm == "gpt_adam":
                nx, ny = d["seq_next"]
                port_out["next"] = float(net.fit_batch(DataSet(
                    torch.from_numpy(nx), torch.from_numpy(ny))))
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
            "data": d}


def _arm(arrays, prefix):
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def _close(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol["rtol"],
                                   atol=tol["atol"], err_msg=f"{what} {k}")


# ---------------------------------------------------------- placement
def _port_tree(jnet):
    """The JAX net's params as the port holds them (the same paths and
    shapes), and its opt_state."""
    conv = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa
    to = lambda tree: {k: to(v) if isinstance(v, dict) else conv(v)  # noqa
                       for k, v in tree.items()}
    return to(jnet.params), to(jax.tree_util.tree_map(
        lambda a: np.asarray(a), jnet.opt_state))


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


PLACEMENTS = {
    "mlp": (lambda: _jmlp(JSgd(0.1)), None, None),
    "mlp_adam_override": (lambda: _jmlp(JAdam(1e-2)),
                          {"['layer_0']['W']": ttensor.P()},
                          {"['layer_0']['W']": JP()}),
    "gpt": (lambda: _jgpt(None), None, None),
    "gpt_rules": (lambda: _jgpt(None), zoo.gpt_mini_tp_rules(),
                  jzoo.gpt_mini_tp_rules()),
}


@pytest.mark.parametrize("case", list(PLACEMENTS))
def test_placement_equals_the_jax_package(case):
    make, trules, jrules = PLACEMENTS[case]
    jnet = make()
    params, opt = _port_tree(jnet)
    jmesh = _jax_mesh(1, 2)
    jspecs = jtensor.param_specs(jnet.params, jmesh, "model", jrules)
    tspecs = ttensor.param_specs(params, {"data": 1, "model": 2}, "model",
                                 trules)
    is_spec = lambda x: isinstance(x, JP)  # noqa: E731
    want = jax.tree_util.tree_map(tuple, jspecs, is_leaf=is_spec)
    assert _tuples(tspecs) == want
    jo = jax.tree_util.tree_map(tuple, jtensor.opt_state_specs(
        jnet.opt_state, jspecs), is_leaf=is_spec)
    assert _tuples(ttensor.opt_state_specs(opt, tspecs)) == jo
    if trules:
        assert ttensor.unmatched_rules(trules, params) == \
            jtensor.unmatched_rules(jrules, jnet.params) == []


def test_unmatched_rules_and_match_partition_rules_equal_the_jax_package():
    jnet = _jgpt(None)
    params, _ = _port_tree(jnet)
    bad_t = [(r"\['Wz'\]", ttensor.P(None, "model"))] + \
        zoo.gpt_mini_tp_rules()
    bad_j = [(r"\['Wz'\]", JP(None, "model"))] + jzoo.gpt_mini_tp_rules()
    assert ttensor.unmatched_rules(bad_t, params) == \
        jtensor.unmatched_rules(bad_j, jnet.params) == [r"\['Wz'\]"]
    assert ttensor.unmatched_rules({"['layer_9']['W']": ttensor.P()},
                                   params) == ["['layer_9']['W']"]
    rules = zoo.gpt_mini_tp_rules() + [(r".*", ttensor.P())]
    jr = jzoo.gpt_mini_tp_rules() + [(r".*", JP())]
    got = ttensor.match_partition_rules(rules, params)
    want = jax.tree_util.tree_map(
        tuple, jtensor.match_partition_rules(jr, jnet.params),
        is_leaf=lambda x: isinstance(x, JP))
    assert _tuples(got) == want
    with pytest.raises(ValueError, match="partition rule not found"):
        ttensor.match_partition_rules(zoo.gpt_mini_tp_rules(), params)


def test_collectives_are_the_identity_on_a_group_of_one():
    class One:
        size, rank = 1, 0
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    for fn in (ttensor.copy_to_model, ttensor.reduce_from_model):
        assert fn(x, One()) is x
    for fn in (ttensor.gather_from_model, ttensor.scatter_to_model):
        assert fn(x, One(), -1) is x


# ------------------------------------------------------------- fleets
@pytest.mark.parametrize("fleet", ["m2", "d2m2"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_tp_step_matches_the_jax_tp_and_single_device_steps(fleets, arm,
                                                            fleet):
    tol = ARMS[arm][3]
    res, arrays = fleets["runs"][fleet][0]
    got = _arm(arrays, arm)
    jkey = "tp12" if fleet == "m2" else "tp22"
    for key in ("single", jkey):
        jscore, jparams = fleets["jax"][(arm, key)]
        assert abs(res[arm]["score"] - jscore) < tol["score"], key
        _close(got, jparams, tol, f"{arm} vs JAX {key}")
    pscore, pparams = fleets["port"][arm]
    assert abs(res[arm]["score"] - pscore) < tol["score"]
    _close(got, pparams, tol, f"{arm} vs the port unmeshed")


@pytest.mark.parametrize("fleet", ["m2", "d2m2"])
def test_every_rank_holds_the_same_bits(fleets, fleet):
    """Gathered parameters (replicated leaves as each rank holds them,
    sharded ones whole) and scores: bit-equal across every rank."""
    runs = fleets["runs"][fleet]
    (r0, a0) = runs[0]
    for res, arrays in runs[1:]:
        assert set(arrays) == set(a0)
        for k in a0:
            assert arrays[k].tobytes() == a0[k].tobytes(), k
        for arm in ARMS:
            assert res[arm]["score"] == r0[arm]["score"], arm


def test_a_model_axis_of_one_is_the_unmeshed_step_bit_for_bit(fleets):
    (res, _), = fleets["runs"]["m1"]
    for arm in {**ARMS, **LOCAL_ARMS}:
        assert res[arm]["bit_equal"], arm
        assert res[arm]["routes"] == {}, arm


@pytest.mark.parametrize("fleet", ["m2", "d2m2"])
def test_clipping_and_l2_under_tp_match_the_unmeshed_step(fleets, fleet):
    res, arrays = fleets["runs"][fleet][0]
    pscore, pparams = fleets["port"]["mlp_clip"]
    assert abs(res["mlp_clip"]["score"] - pscore) < MLP_TOL["score"]
    _close(_arm(arrays, "mlp_clip"), pparams, MLP_TOL, "mlp_clip")


@pytest.mark.parametrize("fleet", ["m2", "d2m2"])
def test_layers_no_rendering_covers_take_the_counted_gather_route(
        fleets, fleet):
    res, arrays = fleets["runs"][fleet][0]
    assert res["rnn"]["routes"] == {
        "tensor_parallel:composed[gather:graves_lstm]": 1}
    heads = res["gpt_heads3"]["routes"]
    assert heads == {"tensor_parallel:composed[gather:transformer_block:"
                     "n_heads%2]": 2}
    assert res["gpt_adam"]["routes"] == {} == res["mlp_sgd"]["routes"]
    for arm in ("rnn", "gpt_heads3"):
        pscore, pparams = fleets["port"][arm]
        assert abs(res[arm]["score"] - pscore) < GPT_TOL["score"], arm
        _close(_arm(arrays, arm), pparams, GPT_TOL, arm)


def test_ranks_of_a_model_group_on_other_rows_are_refused(fleets):
    for res, _ in fleets["runs"]["m2"]:
        assert "same batch rows" in res["rows_error"]


@pytest.mark.parametrize("fleet", list(FLEETS))
def test_device_prefetch_places_each_ranks_data_axis_rows(fleets, fleet):
    """DevicePrefetchIterator(sharding=BatchSharding(mesh)) hands every
    rank its data-axis slice of the global batch (the whole batch on a
    mesh without a data axis)."""
    assert all(res["sharded_rows"] for res, _ in fleets["runs"][fleet])


@pytest.mark.parametrize("fleet", ["m2", "d2m2"])
def test_a_checkpoint_at_m2_restores_at_m2_and_unmeshed(fleets, fleet):
    world = FLEETS[fleet][0]
    res, arrays = fleets["runs"][fleet][0]
    ck = fleets["tmp"] / f"ck_{world}" / "step_1"
    # restored onto the mesh: each rank holds its shard
    assert res["restored_shapes"]["Wq"] == [32, 16]
    assert res["restored_shapes"]["Wo"] == [16, 32]
    assert res["restored_shapes"]["bq"] == [32]
    assert abs(res["restored_score"] - res["next_score"]) <= \
        1e-5 * abs(res["next_score"])
    assert abs(res["next_score"] - fleets["port"]["next"]) <= \
        1e-4 * abs(fleets["port"]["next"])
    # the checkpoint holds whole arrays: it restores unmeshed in one
    # process and its next step matches the mesh's
    net = tck.restore_multi_layer_network(str(ck), device="cpu")
    assert tuple(net.params["layer_1"]["Wq"].shape) == (32, 32)
    nx, ny = fleets["data"]["seq_next"]
    score = float(net.fit_batch(DataSet(torch.from_numpy(nx),
                                        torch.from_numpy(ny))))
    assert abs(score - res["next_score"]) <= 1e-5 * abs(res["next_score"])
    _close(_arm(arrays, "restored"), _flat(net.params), GPT_TOL,
           "restored at m2 vs unmeshed")
    layout = tck.read_checkpoint_layout(str(ck))
    assert layout["mesh"]["model_axis"] == "model"
    assert layout["mesh_detail"]["model_axis"] == "model"
    assert [p for p, _ in layout["mesh_detail"]["tp_rules"]] == [
        p for p, _ in zoo.gpt_mini_tp_rules()]
    assert layout["param_specs"]["['layer_1']['Wo']"] == ["model", None]
    assert layout["param_specs"]["['layer_1']['ln1_g']"] == []
