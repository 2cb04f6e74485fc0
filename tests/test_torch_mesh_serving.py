"""The port's mesh serving (deeplearning4j_tpu_torch/parallel/inference.py,
``ModelServer(mesh=)`` with follower ranks, ``load_net(mesh=)``,
``precompile_serving(mesh=)``) and streaming on a model axis, on the CPU.

- Placement: the port's ``serving_param_specs`` equals the JAX package's
  as tuples on the 16-64-4 softmax MLP of tests/test_serving_fleet.py,
  with and without rules. No processes.
- Fleets: gloo rank processes, one module-scoped run, at ``{"model": 2}``
  (2 ranks) and ``{"data": 2, "model": 2}`` (4 ranks). Every rank builds
  the server over the same MLP; this process sends the JAX test's bucket
  slices (rows 0:1, 1:4, 4:11, 11:40) through HTTP to the leader, and
  each reply is held bit for bit against the port's unmeshed
  ``net.output`` of all 40 rows, sliced, as the JAX test holds its
  replies (the JAX package's own mesh-serving
  tests fail on this sandbox's XLA:CPU, ROADMAP.md C.2). The ranks then
  restore the MLP with ``load_net(mesh=)``, precompile the meshed ladder
  and boot from that manifest; run the JAX package's refusals; and, at
  ``{"model": 2}``, stream a char-RNN with ``rnn_time_step`` on the
  model axis and decode it through ``DecodeEngine`` (its shards gathered
  at construction), held bit for bit against the unmeshed stream and
  tokens.
- A third fleet of 2 ranks kills its leader after the follower is up:
  the follower raises ``CollectiveTimeoutError`` within its timeout.
"""

import inspect
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import inference as jinference
from deeplearning4j_tpu_torch.parallel import inference as tinference
from deeplearning4j_tpu_torch.parallel import tensor as ttensor
from deeplearning4j_tpu_torch.utils import checkpoint as tck

ROOT = Path(__file__).resolve().parents[1]
PROC_TIMEOUT_S = 180
SLICES = ((0, 1), (1, 4), (4, 11), (11, 40))
FLEETS = {"m2": (2, {"model": 2}, None),
          "d2m2": (4, {"data": 2, "model": 2}, "data")}
LOST_TIMEOUT_S = 6.0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jmlp(seed=3):
    conf = (JNNC.builder().seed(seed).list()
            .layer(JDense(n_in=16, n_out=64, activation="relu"))
            .layer(JOutput(n_in=64, n_out=4, activation="softmax",
                           loss="mcxent"))
            .build())
    return JMLN(conf).init()


def mlp(seed=3, device="cpu"):
    """The port's 16-64-4 softmax MLP (the JAX test's ``_mlp``); the rank
    processes build it from this source."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(Dense(n_in=16, n_out=64, activation="relu"))
            .layer(Output(n_in=64, n_out=4, activation="softmax",
                          loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


_MLP = inspect.getsource(mlp)


# --------------------------------------------------- the rank processes
_WORKER = _MLP + r"""
import json, os, sys, time, warnings
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
root, port, world, rank, axes, tmp, data_axis = sys.argv[1:8]
world, rank, axes = int(world), int(rank), json.loads(axes)
data_axis = None if data_axis == "-" else data_axis
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.compilecache import manifest as man
from deeplearning4j_tpu_torch.compilecache import precompile as pre
from deeplearning4j_tpu_torch.parallel import distributed as D, make_mesh
from deeplearning4j_tpu_torch.serving.publish import load_net
from deeplearning4j_tpu_torch.serving.server import ModelServer

D.initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=60)
mesh = make_mesh(axes)
res = {}

def refused(fn):
    try:
        fn()
    except Exception as e:
        return [type(e).__name__, str(e)]
    return None

def until(path, limit=120):
    t_end = time.monotonic() + limit
    while not os.path.exists(path):
        if time.monotonic() > t_end:
            raise TimeoutError(path)
        time.sleep(0.05)

try:
    net = mlp()
    server = ModelServer(net, port=0, max_batch=32, mesh=mesh,
                         data_axis=data_axis).start()
    res["follower"] = server.is_follower
    res["min_batch"] = server._batcher.min_batch
    res["hot_swap"] = refused(lambda: server.hot_swap(net=net))
    if not server.is_follower:
        with open(f"{tmp}/url_{world}.tmp", "w") as fh:
            fh.write(server.url)
        os.replace(f"{tmp}/url_{world}.tmp", f"{tmp}/url_{world}")
        until(f"{tmp}/done_{world}")
        res["forwards"] = server._group.forwards
        server.stop()
    else:
        res["stopped"] = server.wait(timeout=150)
        res["forwards"] = server._group.forwards
    res["gathers"] = server._group.forward.model_group.calls

    # a publication restored onto the mesh, precompiled, then booted
    ck = f"{tmp}/ck"
    back = load_net(ck, mesh=mesh)
    cache = f"{tmp}/cache_{world}"
    entry = pre.precompile_serving(back, cache_dir=cache, max_batch=8,
                                   mesh=mesh, data_axis=data_axis)
    res["mesh_axes"] = entry["mesh_axes"]
    if rank == 0:
        man.save(man.build(back, serving=entry), cache)
    D.barrier("manifest")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # a mismatch
        s2 = ModelServer(back, port=0, max_batch=8, mesh=mesh,
                         data_axis=data_axis, compile_cache_dir=cache,
                         aot_manifest=True).start()
    res["aot_manifest_ok"] = s2.aot_manifest_ok
    if not s2.is_follower:
        x = np.random.default_rng(5).normal(size=(3, 16)).astype(np.float32)
        res["restored_bits"] = bool(np.array_equal(
            s2.predict(x), back.output(torch.from_numpy(x)).numpy()))
    s2.stop()

    # the JAX package's refusals, before any collective
    graph = zoo.resnet18(image_size=16, dtype=zoo.F32, device="cpu")
    res["graph"] = refused(lambda: ModelServer(graph, port=0, mesh=mesh))
    res["compute_dtype"] = refused(lambda: ModelServer(
        mlp(), port=0, mesh=mesh, compute_dtype="bfloat16"))
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.conf.layers_conv import BatchNorm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.tensor import P
    bn = MultiLayerNetwork((NeuralNetConfiguration.builder().list()
          .layer(Dense(n_in=16, n_out=16)).layer(BatchNorm())
          .layer(Output(n_out=4, activation="softmax"))
          .set_input_type(InputType.feed_forward(16)).build()),
          device="cpu").init()
    res["stateful"] = refused(lambda: ModelServer(bn, port=0, mesh=mesh))
    gpt = zoo.gpt_mini(vocab_size=12, width=32, n_layers=1, n_heads=4,
                       max_len=8, dtype=zoo.F32, device="cpu")
    # the embedding replicated by a rule: the block is the first refused
    res["transformer"] = refused(lambda: ModelServer(
        gpt, port=0, mesh=mesh, tp_rules=[(r"\['layer_0'\]", P())]))
    res["no_axis"] = refused(lambda: ModelServer(mlp(), port=0, mesh=mesh,
                                                 model_axis="tensor"))

    if world == 2:
        # streaming on the model axis: the gather route, bit for bit
        rnn = zoo.char_rnn(vocab_size=12, hidden=16, n_layers=1,
                           dtype=zoo.F32, device="cpu", seed=9)
        ref = zoo.char_rnn(vocab_size=12, hidden=16, n_layers=1,
                           dtype=zoo.F32, device="cpu", seed=9)
        rnn.use_mesh(mesh, model_axis="model")
        eye = np.eye(12, dtype=np.float32)
        ids = np.random.default_rng(2).integers(0, 12, (4, 6))
        from deeplearning4j_tpu_torch.ops import registry
        registry.reset_launches()
        same = True
        for t in range(6):
            a = rnn.rnn_time_step(torch.from_numpy(eye[ids[:, t]]))
            b = ref.rnn_time_step(torch.from_numpy(eye[ids[:, t]]))
            same = same and torch.equal(a, b)
        chunk = torch.from_numpy(eye[ids])
        same = same and torch.equal(rnn.rnn_time_step(chunk),
                                    ref.rnn_time_step(chunk))
        res["rnn_bits"] = bool(same)
        res["rnn_routes"] = registry.routes()
        from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
        # decode on the model axis: the engine gathers the shards whole
        # once (both ranks build it), then decodes as the unmeshed one
        engines = [DecodeEngine(n, batch_window_ms=1.0) for n in (rnn, ref)]
        try:
            prompt = [int(i) for i in ids[0]]
            res["decode"] = [e.generate("s", prompt, 4) for e in engines]
        finally:
            for e in engines:
                e.stop()
finally:
    with open(f"{tmp}/w{world}r{rank}.json", "w") as fh:
        json.dump(res, fh)
    D.shutdown()
"""

_LOST = _MLP + r"""
import os, sys, time
sys.path.insert(0, sys.argv[1])
root, port, rank, tmp = sys.argv[1:5]
rank = int(rank)
from deeplearning4j_tpu_torch.parallel import distributed as D, make_mesh
from deeplearning4j_tpu_torch.serving.server import ModelServer
D.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
server = ModelServer(mlp(), port=0, max_batch=8, mesh=make_mesh(
    {"model": 2})).start()
if rank == 0:
    server.predict([[0.0] * 16])
    os._exit(0)        # the leader dies with its follower in the loop
t0 = time.monotonic()
try:
    server.wait(timeout=60)
    print("NO ERROR")
except Exception as e:
    print(type(e).__name__, round(time.monotonic() - t0, 3),
          getattr(e, "lost_ranks", None), e)
os._exit(0)
"""


def _post(url, rows):
    req = urllib.request.Request(
        url + "/predict", data=json.dumps({"features": rows.tolist()})
        .encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.asarray(json.loads(r.read())["predictions"], np.float32)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serving")
    net = mlp()
    tck.save_checkpoint(net, str(tmp / "ck"))
    x = np.random.default_rng(0).normal(size=(40, 16)).astype(np.float32)
    procs, logs, replies = {}, {}, {}
    try:
        for name, (world, axes, data_axis) in FLEETS.items():
            port = _free_port()
            for rank in range(world):
                procs[(world, rank)] = subprocess.Popen(
                    [sys.executable, "-c", _WORKER, str(ROOT), str(port),
                     str(world), str(rank), json.dumps(axes), str(tmp),
                     data_axis or "-"],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                    cwd=str(ROOT))
        port = _free_port()
        for rank in range(2):
            procs[("lost", rank)] = subprocess.Popen(
                [sys.executable, "-c", _LOST, str(ROOT), str(port),
                 str(rank), str(tmp)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=str(ROOT),
                env={**os.environ,
                     "DL4J_TPU_COLLECTIVE_TIMEOUT_S": str(LOST_TIMEOUT_S)})
        deadline = time.monotonic() + PROC_TIMEOUT_S
        for name, (world, _, _) in FLEETS.items():
            url_file = tmp / f"url_{world}"
            while not url_file.exists():
                assert time.monotonic() < deadline, f"no leader url {name}"
                assert all(p.poll() is None for k, p in procs.items()
                           if k[0] == world), f"a rank of {name} exited"
                time.sleep(0.05)
            url = url_file.read_text()
            replies[name] = [_post(url, x[lo:hi]) for lo, hi in SLICES]
            (tmp / f"done_{world}").write_text("1")
        for key, p in procs.items():
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs[key] = (p.returncode, out, err[-3000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for key, (rc, _, err) in logs.items():
        assert rc == 0, f"rank {key} exited {rc}:\n{err}"
    runs = {name: [json.loads((tmp / f"w{world}r{r}.json").read_text())
                   for r in range(world)]
            for name, (world, _, _) in FLEETS.items()}
    # the JAX test's reference: the unmeshed output of all 40 rows,
    # sliced (a one-row output takes another CPU GEMM path than the
    # served two-row bucket)
    with torch.inference_mode():
        reference = net.output(torch.from_numpy(x)).numpy()
    want = [reference[lo:hi] for lo, hi in SLICES]
    return {"runs": runs, "replies": replies, "want": want,
            "lost": logs[("lost", 1)][1]}


# ---------------------------------------------------------- placement
def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("rules", [None, "exact", "regex"])
def test_serving_param_specs_equal_the_jax_package(rules, m):
    jnet = _jmlp()
    net = mlp()
    trules = jrules = None
    if rules == "exact":
        trules = {"['layer_1']['W']": ttensor.P(None, "model"),
                  "['layer_0']['b']": ttensor.P()}
        jrules = {"['layer_1']['W']": JP(None, "model"),
                  "['layer_0']['b']": JP()}
    elif rules == "regex":
        trules = [(r"layer_0.*W", ttensor.P())]
        jrules = [(r"layer_0.*W", JP())]
    devs = np.array(jax.devices()[:m]).reshape(1, m)
    jspecs = jinference.serving_param_specs(
        jnet.params, Mesh(devs, ("data", "model")), "model", jrules,
        layers=jnet.layers)
    tspecs = tinference.serving_param_specs(
        net.params, {"data": 1, "model": m}, "model", trules,
        layers=net.layers)
    assert _tuples(tspecs) == jax.tree_util.tree_map(
        tuple, jspecs, is_leaf=lambda s: isinstance(s, JP))
    if rules is None:   # the head's softmax keeps it whole; the bias
        assert tspecs["layer_1"] == {"W": (), "b": ()}     # co-shards
        assert tspecs["layer_0"] == {"W": (None, "model"), "b": ("model",)}


# ------------------------------------------------------------- fleets
@pytest.mark.parametrize("fleet", list(FLEETS))
@pytest.mark.parametrize("i", range(len(SLICES)))
def test_mesh_served_rows_are_the_unmeshed_output_bit_for_bit(fleets,
                                                              fleet, i):
    got = fleets["replies"][fleet][i]
    want = fleets["want"][i]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), SLICES[i]


@pytest.mark.parametrize("fleet", list(FLEETS))
def test_every_rank_ran_every_bucket_and_the_followers_stopped(fleets,
                                                               fleet):
    runs = fleets["runs"][fleet]
    assert [r["follower"] for r in runs] == [False] + [True] * (
        len(runs) - 1)
    assert len({r["forwards"] for r in runs}) == 1
    assert runs[0]["forwards"] >= len(SLICES)
    assert all(r["stopped"] for r in runs[1:])
    # one gather a sharded layer a forward (the hidden layer; the head
    # stays whole)
    assert all(r["gathers"] == r["forwards"] for r in runs)
    data = FLEETS[fleet][1].get("data", 1)
    assert all(r["min_batch"] == 2 * data for r in runs)


@pytest.mark.parametrize("fleet", list(FLEETS))
def test_load_net_and_precompile_serving_on_the_mesh(fleets, fleet):
    runs = fleets["runs"][fleet]
    axes = FLEETS[fleet][1]
    assert all(r["mesh_axes"] == axes for r in runs)
    assert runs[0]["aot_manifest_ok"] is True
    assert runs[0]["restored_bits"] is True


@pytest.mark.parametrize("case,kind,text", [
    ("graph", "ValueError", "serve ComputationGraph models replicated"),
    ("compute_dtype", "ValueError", "bit-identity"),
    ("hot_swap", "ValueError", "mesh serving shards params"),
    ("stateful", "ValueError", "stateless inference"),
    ("transformer", "ValueError", "transformer_block"),
    ("no_axis", "ValueError", "no 'tensor' axis"),
])
def test_refusals_carry_the_jax_packages_types(fleets, case, kind, text):
    for fleet in FLEETS:
        for res in fleets["runs"][fleet]:
            got = res[case]
            assert got is not None and got[0] == kind, (fleet, got)
            assert text in got[1], (fleet, got)


def test_streaming_on_a_model_axis_is_the_unmeshed_stream(fleets):
    for res in fleets["runs"]["m2"]:
        assert res["rnn_bits"] is True
        # every call's layers gathered whole: the LSTM and the head
        assert res["rnn_routes"] == {
            "tensor_parallel:composed[gather:graves_lstm]": 7,
            "tensor_parallel:composed[gather:rnn_output]": 7}
        meshed, unmeshed = res["decode"]
        assert len(meshed) == 4 and meshed == unmeshed


def test_a_follower_whose_leader_dies_raises_within_its_timeout(fleets):
    kind, seconds, *_ = fleets["lost"].split()
    assert kind in ("CollectiveTimeoutError", "PeerLostError"), \
        fleets["lost"]
    assert float(seconds) <= 2 * LOST_TIMEOUT_S
    # the consensus round names the leader, or the message does
    assert "[0]" in fleets["lost"] or "rank 0" in fleets["lost"]
