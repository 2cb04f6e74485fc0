"""Live reload in the port (deeplearning4j_tpu_torch/serving/publish.py,
``ModelServer.hot_swap``, compilecache/manifest.py), held against the JAX
package on the CPU.

- The port's ``model_fingerprint`` equals the JAX package's on the same
  configuration (carried across as its JSON): the 8 -> 16 -> 4 MLP of the
  JAX package's live-reload tests, a small graph with batch norm, a
  one-block gpt_mini and a narrow char-RNN.
- A JAX MLP carried into the port (the zip), saved as a port checkpoint,
  published and restored by ``load_net`` gives the JAX ``output`` within
  f32 tolerance.
- Ports of the JAX package's tests of the publication store, of an
  incomplete checkpoint, of a hot swap under load (two replicas, no
  kernel built) and of its refusals and the NaN sentinel (read through
  ``metrics()`` and ``health()``, and through the heartbeat push's
  ``serving`` counters).

The JAX side runs once per module (``jax_side``); every thread join has
a timeout.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.compilecache import model_fingerprint
from deeplearning4j_tpu_torch.nn.conf.core import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import metrics as obs
from deeplearning4j_tpu_torch.serving import (ModelServer, Publication,
                                              WeightStore, load_net)
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu_torch.utils.checkpoint import save_checkpoint

F32_TOL = 1e-6     # one f32 MLP forward, the same weights, two libraries


def _jax_mlp(seed=1, hidden=16):
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    conf = (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(Dense(n_in=8, n_out=hidden, activation="relu"))
            .layer(Output(n_in=hidden, n_out=4, activation="softmax",
                          loss="mcxent"))
            .build())
    return JMLN(conf).init()


def _jax_graph():
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu.nn.conf.layers_conv import BatchNorm
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    conf = (NeuralNetConfiguration.builder().seed(5).graph_builder()
            .add_inputs("in")
            .add_layer("d1", Dense(n_out=8, activation="relu"), "in")
            .add_layer("bn", BatchNorm(activation="identity"), "d1")
            .add_layer("out", Output(n_out=3, activation="softmax",
                                     loss="mcxent"), "bn")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(6))
            .build())
    return JCG(conf).init()


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's nets and fingerprints, computed once: the MLP,
    the graph, a one-block gpt_mini, a narrow char-RNN, and the MLP's
    output on a fixed input."""
    from deeplearning4j_tpu import zoo as jzoo
    from deeplearning4j_tpu.compilecache.manifest import (
        model_fingerprint as jfp)
    nets = {"mlp": _jax_mlp(1), "graph": _jax_graph(),
            "gpt_mini": jzoo.gpt_mini(width=32, n_layers=1, n_heads=2,
                                      max_len=16),
            "char_rnn": jzoo.char_rnn(hidden=16, n_layers=1)}
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    return {"nets": nets,
            "fingerprints": {k: jfp(n) for k, n in nets.items()},
            "x": x, "mlp_out": np.asarray(nets["mlp"].output(x))}


def _port_from_conf(jnet):
    """A port net of the JAX net's configuration (its JSON), on the CPU."""
    if type(jnet).__name__ == "ComputationGraph":
        conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
        return ComputationGraph(conf, device="cpu")
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return MultiLayerNetwork(conf, device="cpu")


# ------------------------------------------------------------ fingerprints
@pytest.mark.parametrize("kind", ["mlp", "graph", "gpt_mini", "char_rnn"])
def test_fingerprint_equals_the_jax_packages(jax_side, kind):
    net = _port_from_conf(jax_side["nets"][kind])
    want = jax_side["fingerprints"][kind]
    assert model_fingerprint(net.init()) == want
    # it reads metadata only: a structure-only net has the same
    assert model_fingerprint(net.init(structure_only=True)) == want


def test_fingerprint_is_structure_not_values():
    a, b, c = _mlp(1), _mlp(2), _mlp(3, hidden=32)
    assert model_fingerprint(a) == model_fingerprint(b)
    assert model_fingerprint(a) != model_fingerprint(c)
    assert len(model_fingerprint(a)) == 16


# ------------------------------------------------------------- the MLP
def _mlp(seed=1, hidden=16):
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    conf = (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(Dense(n_in=8, n_out=hidden, activation="relu"))
            .layer(Output(n_in=hidden, n_out=4, activation="softmax",
                          loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _out(net, x):
    return net.output(torch.from_numpy(x)).numpy()


def test_jax_mlp_published_and_loaded_gives_the_jax_output(jax_side,
                                                           tmp_path):
    from deeplearning4j_tpu.utils import serialization as jser
    zip_path = str(tmp_path / "jax_mlp.zip")
    jser.write_model(jax_side["nets"]["mlp"], zip_path)
    net = tser.restore_multi_layer_network(zip_path, device="cpu")
    ckpt = str(tmp_path / "train" / "step_5")
    save_checkpoint(net, ckpt)
    pub = WeightStore(str(tmp_path / "store")).publish(ckpt)
    assert pub.fingerprint == jax_side["fingerprints"]["mlp"]
    loaded = load_net(pub.path, device="cpu")
    np.testing.assert_allclose(_out(loaded, jax_side["x"]),
                               jax_side["mlp_out"], atol=F32_TOL,
                               rtol=F32_TOL)


# ------------------------------------------------------------ weight store
def test_publish_store_versions_fingerprint_rollback_retention(tmp_path):
    netA, netB = _mlp(1), _mlp(2)
    cpA = str(tmp_path / "train" / "step_10")
    cpB = str(tmp_path / "train" / "step_20")
    save_checkpoint(netA, cpA)
    save_checkpoint(netB, cpB)

    store = WeightStore(str(tmp_path / "store"), keep=2)
    assert store.latest() is None
    p1 = store.publish(cpA, source=cpA)
    p2 = store.publish(cpB)
    assert (p1.version, p2.version) == (1, 2)
    assert store.latest().version == 2
    # same configuration, different seeds: one fingerprint
    assert p1.fingerprint and p1.fingerprint == p2.fingerprint
    assert p1.meta["source"] == cpA and p1.meta["kind"] == "multilayer"
    # publications are the checkpoint, copied verbatim
    for name in ("meta.json", "layout.json"):
        with open(os.path.join(cpB, name)) as f, \
                open(os.path.join(p2.path, name)) as g:
            assert f.read() == g.read()
    # atomic landing left no staging debris
    assert not [n for n in os.listdir(store.root) if n.startswith(".")]

    # retention: keep=2, a third publication removes v1
    store.publish(cpA)
    assert [p.version for p in store.versions()] == [2, 3]

    # rollback is a verb: v3 rejected (with the reason), LATEST -> v2
    back = store.rollback("canary failed: nan rows")
    assert back.version == 2 and store.latest().version == 2
    v3 = store.get(3)
    assert v3.rejected and v3.meta["rejected_reason"].startswith("canary")
    assert [p.version for p in store.versions(include_rejected=False)] \
        == [2]
    # no earlier good version left: the verb refuses
    with pytest.raises(RuntimeError):
        store.rollback("again")
    assert isinstance(store.describe()["versions"][0], dict)

    # a publication restores to bit-identical outputs
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    assert np.array_equal(_out(load_net(p2.path, device="cpu"), x),
                          _out(netB, x))
    # with mesh= (every rank of a serving mesh), whole on this rank's
    # device: the CPU here, where no process group is up
    on_mesh = load_net(p2.path, mesh=object())
    assert on_mesh.device.type == "cpu"
    assert np.array_equal(_out(on_mesh, x), _out(netB, x))


def test_publish_rejects_incomplete_checkpoint(tmp_path):
    os.makedirs(str(tmp_path / "half"))
    store = WeightStore(str(tmp_path / "store"))
    with pytest.raises(ValueError):
        store.publish(str(tmp_path / "half"))
    with pytest.raises(FileNotFoundError):
        store.publish_latest(str(tmp_path))
    with pytest.raises(ValueError):
        WeightStore(str(tmp_path / "s2"), keep=0)


def test_publish_latest_takes_the_newest_step(tmp_path):
    save_checkpoint(_mlp(1), str(tmp_path / "run" / "step_3"))
    save_checkpoint(_mlp(2), str(tmp_path / "run" / "step_7"))
    pub = WeightStore(str(tmp_path / "store")).publish_latest(
        str(tmp_path / "run"))
    assert pub.meta["source"].endswith("step_7")
    assert isinstance(pub, Publication) and "v1" in repr(pub)


# ------------------------------------------------------ hot swap under load
def test_hot_swap_under_load_zero_loss_zero_compiles(tmp_path):
    """Concurrent clients across a rolling hot swap see no error, no lost
    or doubled reply, every reply bit-identical to the old or the new
    weights' output, and the swap builds nothing."""
    netA, netB = _mlp(1), _mlp(2)
    save_checkpoint(netB, str(tmp_path / "train" / "step_2"))
    pub = WeightStore(str(tmp_path / "store")).publish(
        str(tmp_path / "train" / "step_2"))
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    ref_a, ref_b = _out(netA, x), _out(netB, x)
    assert not np.array_equal(ref_a, ref_b)

    srv = ModelServer(netA, replicas=2, batch_window_ms=1.0)
    srv._fleet.warm([(8,)])
    srv._fleet.start()
    try:
        assert np.array_equal(srv.predict(x), ref_a)
        results, errors = [], []
        lock = threading.Lock()

        def client(n=40):
            for _ in range(n):
                try:
                    out = srv.predict(x)
                    with lock:
                        results.append("a" if np.array_equal(out, ref_a)
                                       else "b" if np.array_equal(out, ref_b)
                                       else "?")
                except Exception as e:  # noqa: BLE001 — asserted below
                    with lock:
                        errors.append(repr(e))

        base = obs.compile_snapshot()
        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.05)          # some old-weight replies land first
        rec = srv.hot_swap(publication=pub)
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        delta = obs.compile_delta(base)

        assert errors == []
        assert len(results) == 6 * 40          # none lost, none doubled
        assert "?" not in results
        assert "a" in results and "b" in results
        assert np.array_equal(srv.predict(x), ref_b)
        assert rec["fresh_compiles"] == 0
        assert delta["count"] == 0 and delta["cache_misses"] == 0, delta
        assert rec["replicas_swapped"] == 2
        assert rec["fingerprint"] == pub.fingerprint
        assert srv.model_version == 1 and srv.swaps_total == 1
        assert srv.metrics()["model_version"] == 1
        assert srv.metrics()["weight_swaps_total"] == 1
        # the live net was not assigned to: its weights are still A's
        assert np.array_equal(_out(srv.net, x), ref_a)
    finally:
        srv._fleet.stop()


def test_hot_swap_rejects_structure_mismatch_and_nan_sentinel_counts():
    other = _mlp(3, hidden=32)
    srv = ModelServer(_mlp(1), replicas=1, batch_window_ms=0.0)
    srv._fleet.start()
    try:
        with pytest.raises(ValueError, match="fingerprint"):
            srv.hot_swap(net=other)
        with pytest.raises(ValueError, match="publication or"):
            srv.hot_swap()
        # the serving NaN sentinel: poisoned weights -> counted rows
        poisoned = _mlp(2)
        poisoned.params = {ln: {k: torch.full_like(t, float("nan"))
                                for k, t in lp.items()}
                           for ln, lp in poisoned.params.items()}
        srv.hot_swap(net=poisoned, version=7)
        out = srv.predict(np.ones((3, 8), np.float32))
        assert not np.isfinite(out).all()
        assert srv.stats.snapshot()["nan_rows_total"] == 3
        assert srv.metrics()["nan_rows_total"] == 3
        assert srv.metrics()["model_version"] == 7
        code, body = srv.health()
        assert code == 200 and body["model_version"] == 7
    finally:
        srv._fleet.stop()


def test_hot_swap_refuses_a_decode_server():
    srv = ModelServer(_mlp(1), replicas=1, decode_engine=object())
    with pytest.raises(ValueError, match="decode sessions"):
        srv.hot_swap(net=_mlp(2))


def test_swap_families_render_after_a_swap():
    srv = ModelServer(_mlp(1), replicas=1, batch_window_ms=0.0, port=0)
    srv.start()
    try:
        srv.hot_swap(net=_mlp(2), version=4)
        text = obs.get_registry().render_prometheus()
        assert "dl4j_serving_model_version" in text
        assert "dl4j_serving_weight_swaps_total" in text
        line = [ln for ln in text.splitlines()
                if ln.startswith("dl4j_serving_model_version{")]
        assert line and line[0].rstrip().endswith(" 4")
    finally:
        srv.stop()


@pytest.mark.parametrize("name", ["push_url", "slos"])
def test_remaining_refusals_name_their_roadmap_item(name):
    """push_url and slos are ported (no longer refused), and no refusal
    of a server parameter remains: mesh serving is ported too
    (tests/test_torch_mesh_serving.py)."""
    from deeplearning4j_tpu_torch.observability.slo import SLO
    from deeplearning4j_tpu_torch.serving import server as server_mod
    assert not hasattr(server_mod, "NOT_PORTED")
    value = ("http://localhost:1" if name == "push_url" else
             [SLO("p99", metric="latency_p99_ms", objective=0.9, bound=1.0)])
    srv = ModelServer(_mlp(1), port=0, warmup=False, **{name: value})
    if name == "push_url":
        assert srv.push_url == value and srv._pusher is None
    else:
        assert srv.slo_engine.slos == value
