"""The port's training dashboard (deeplearning4j_tpu_torch/ui/) on the
CPU, held against the JAX package's: StatsReport and both storages, the
JSONL files each package writes read in the other (a torn tail too), the
listener's statistics on a small char-RNN transplanted through the zip,
the activation probe, the UI server's JSON against the JAX server's for
equal storage contents on every GET endpoint, two workers through the
remote router and its retry queue, the CLI, and heartbeats pushed by the
port's HeartbeatPusher in ``/api/fleet``.

Tolerances: the first report's mean, std, min, max and mean magnitude
within 1e-5 of the larger of the JAX value and the tensor's largest
magnitude (the two packages' f32 steps round differently, by a few ulps
of a parameter); histogram counts sum equally and move by at most 1 a
bin (a value on a bin edge may fall either side). Every server, router
and pusher stops in ``finally``; every wait is bounded.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.ui import stats as jstats
from deeplearning4j_tpu.ui import storage as jstorage
from deeplearning4j_tpu.ui.server import UIServer as JUIServer
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.observability.distributed import \
    HeartbeatPusher
from deeplearning4j_tpu_torch.ui import (FileStatsStorage,
                                         InMemoryStatsStorage,
                                         RemoteStatsStorageRouter,
                                         StatsListener, StatsReport,
                                         UIServer)
from deeplearning4j_tpu_torch.ui.embedding import EMBEDDING_KEY
from deeplearning4j_tpu_torch.ui import storage as tstorage
from deeplearning4j_tpu_torch.utils import serialization as tser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_RTOL = 1e-5
V, H, T, B = 12, 16, 6, 4


def _report(i, session="s", worker="w0", score=1.0, cls=StatsReport):
    stats = {"mean": 0.5 * i, "std": 1.0, "mean_magnitude": 0.7,
             "min": -1.0, "max": 2.0,
             "histogram": {"counts": [1, 2, 3], "min": -1.0, "max": 2.0}}
    return cls(session_id=session, worker_id=worker, timestamp=100.0 + i,
               iteration=i, epoch=0, score=score / (i + 1),
               iteration_ms=5.0 + i, examples_per_sec=100.0,
               memory_rss_mb=10.0,
               param_stats={"['layer_0']['W']": stats},
               update_stats={"['layer_0']['W']": dict(stats, mean=0.1)},
               activation_stats={"layer_0": stats})


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


# ------------------------------------------------------ report, storages
def test_stats_report_round_trips_like_the_jax_one():
    r = _report(3)
    assert StatsReport.from_dict(r.to_dict()) == r
    assert r.to_dict() == _report(3, cls=jstats.StatsReport).to_dict()
    assert list(StatsReport.__dataclass_fields__) == list(
        jstats.StatsReport.__dataclass_fields__)


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_storage_sessions_workers_static_and_events(tmp_path, kind):
    st = InMemoryStatsStorage() if kind == "memory" else \
        FileStatsStorage(str(tmp_path / "s.jsonl"))
    events = []
    st.register_listener(lambda *e: events.append(e))
    st.put_update(_report(1))
    st.put_update(_report(2, worker="w1"))
    st.put_update(_report(3))
    st.put_static_info("s", "w0", {"model": {"layers": []}})
    st.put_static_info("s", "w0", {"phase_stats": {"fit": []}})
    assert st.list_session_ids() == ["s"]
    assert st.list_worker_ids_for_session("s") == ["w0", "w1"]
    assert [r.iteration for r in st.get_all_updates("s")] == [1, 2, 3]
    assert [r.iteration for r in st.get_all_updates_after("s", 101.5)] \
        == [2, 3]
    assert st.get_latest_update("s", "w0").iteration == 3
    assert st.num_updates("s", "w1") == 1
    assert st.get_static_info("s", "w0") == {"model": {"layers": []},
                                             "phase_stats": {"fit": []}}
    assert [e[0] for e in events] == [
        tstorage.NEW_SESSION, tstorage.NEW_WORKER, tstorage.POST_UPDATE,
        tstorage.NEW_WORKER, tstorage.POST_UPDATE, tstorage.POST_UPDATE,
        tstorage.POST_STATIC, tstorage.POST_STATIC]
    st.close()
    if kind == "file":
        back = FileStatsStorage(str(tmp_path / "s.jsonl"))
        assert [r.to_dict() for r in back.get_all_updates("s")] == [
            r.to_dict() for r in (_report(1), _report(2, worker="w1"),
                                  _report(3))]
        assert back.get_static_info("s", "w0")["phase_stats"] == {"fit": []}
        back.close()


def _fill(st, cls):
    for i in (1, 2):
        st.put_update(_report(i, cls=cls))
    st.put_static_info("s", "w0", {"model": {"layers": [
        {"name": "layer_0", "type": "DenseLayer", "params": 8,
         "inputs": []}], "network_inputs": []}})
    st.put_static_info("s", "w0", {"phase_stats": {"fit": [1, 2]}})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_jsonl_written_by_one_package_reads_in_the_other(tmp_path, writer):
    path = str(tmp_path / "run.jsonl")
    if writer == "jax":
        w = jstorage.FileStatsStorage(path)
        _fill(w, jstats.StatsReport)
        reader = FileStatsStorage
    else:
        w = FileStatsStorage(path)
        _fill(w, StatsReport)
        reader = jstorage.FileStatsStorage
    w.close()
    r = reader(path)
    try:
        assert [x.to_dict() for x in r.get_all_updates("s")] == [
            _report(i).to_dict() for i in (1, 2)]
        assert r.get_static_info("s", "w0")["phase_stats"] == {"fit": [1, 2]}
        assert r.get_static_info("s", "w0")["model"]["layers"][0][
            "type"] == "DenseLayer"
    finally:
        r.close()
    # the bytes on disk are the same either way
    other = str(tmp_path / "other.jsonl")
    w2 = (FileStatsStorage if writer == "jax"
          else jstorage.FileStatsStorage)(other)
    _fill(w2, StatsReport if writer == "jax" else jstats.StatsReport)
    w2.close()
    assert open(path).read() == open(other).read()


def test_a_torn_tail_is_tolerated(tmp_path):
    path = str(tmp_path / "torn.jsonl")
    w = FileStatsStorage(path)
    for i in (1, 2):
        w.put_update(_report(i))
    w.close()
    with open(path, "a") as f:
        f.write(json.dumps({"kind": "update",
                            "report": _report(3).to_dict()})[:57])
    back = FileStatsStorage(path)
    try:
        assert [r.iteration for r in back.get_all_updates("s")] == [1, 2]
        back.put_update(_report(4))
    finally:
        back.close()
    again = FileStatsStorage(path)
    try:
        # the next record lands on the torn line and is lost with it, as
        # in the JAX package; the file still reads
        assert [r.iteration for r in again.get_all_updates("s")] == [1, 2]
    finally:
        again.close()


# ---------------------------------------------------------- the listener
@pytest.fixture(scope="module")
def rnn_pair(tmp_path_factory):
    """A small char-RNN (2 GravesLSTM, hidden 16) in both packages through
    the zip, and seeded one-hot batches."""
    jnet = jzoo.char_rnn(vocab_size=V, hidden=H, n_layers=2,
                         dtype=jzoo.F32, seed=3)
    path = tmp_path_factory.mktemp("ui") / "rnn.zip"
    jser.write_model(jnet, str(path))
    rng = np.random.default_rng(5)
    eye = np.eye(V, dtype=np.float32)
    batches = []
    for _ in range(2):
        seq = rng.integers(0, V, (B, T + 1))
        batches.append((eye[seq[:, :-1]], eye[seq[:, 1:]]))
    return jnet, str(path), batches


def _close(got, want, scale, what):
    if want is None:
        assert got is None, what
        return
    assert abs(got - want) <= STAT_RTOL * max(abs(want), scale), \
        (what, got, want)


def _hold_stats(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        g, w = got[k], want[k]
        scale = max(abs(w["min"]), abs(w["max"]))
        for s in ("mean", "std", "min", "max", "mean_magnitude"):
            _close(g[s], w[s], scale, f"{what} {k} {s}")
        gc, wc = g["histogram"]["counts"], w["histogram"]["counts"]
        assert sum(gc) == sum(wc), (what, k)
        assert max(abs(a - b) for a, b in zip(gc, wc)) <= 1, (what, k, gc,
                                                             wc)


def test_listener_statistics_agree_with_the_jax_listener(rnn_pair):
    jnet, path, batches = rnn_pair
    net = tser.restore_multi_layer_network(path, device="cpu")
    jnet2 = jser.restore_multi_layer_network(path)
    jst, tst = jstorage.InMemoryStatsStorage(), InMemoryStatsStorage()
    probe = batches[0][0][:2]
    jnet2.set_listeners(jstats.StatsListener(
        jst, frequency=2, session_id="s", activation_probe=probe))
    net.set_listeners(StatsListener(tst, frequency=2, session_id="s",
                                    activation_probe=probe))
    for x, y in batches:
        jnet2.fit_batch(JDataSet(x, y))
        net.fit_batch(DataSet(x, y))
    (jr,), (tr,) = jst.get_all_updates("s"), tst.get_all_updates("s")
    assert (tr.iteration, tr.epoch) == (jr.iteration, jr.epoch) == (2, 0)
    assert abs(tr.score - jr.score) <= 1e-5 * abs(jr.score)
    assert list(tr.param_stats) == list(jr.param_stats)
    _hold_stats(tr.param_stats, jr.param_stats, "params")
    _hold_stats(tr.update_stats, jr.update_stats, "updates")
    _hold_stats(tr.activation_stats, jr.activation_stats, "activations")
    assert tst.get_static_info("s", "worker_0") == \
        jst.get_static_info("s", "worker_0")


def test_update_statistics_are_one_steps_delta(rnn_pair):
    """The update statistics are those of params(i) - params(i - 1)."""
    from deeplearning4j_tpu_torch.ui.stats import _array_stats, host_params
    _, path, batches = rnn_pair
    net = tser.restore_multi_layer_network(path, device="cpu")
    st = InMemoryStatsStorage()
    net.set_listeners(StatsListener(st, frequency=2, session_id="s"))
    ref = tser.restore_multi_layer_network(path, device="cpu")
    ref.fit_batch(DataSet(*batches[0]))
    before = host_params(ref.params)
    ref.fit_batch(DataSet(*batches[1]))
    after = host_params(ref.params)
    for x, y in batches:
        net.fit_batch(DataSet(x, y))
    (r,) = st.get_all_updates("s")
    assert r.update_stats == {k: _array_stats(after[k] - before[k], True, 20)
                              for k in after}
    assert r.param_stats == {k: _array_stats(a, True, 20)
                             for k, a in after.items()}
    # the listener only reads: the params equal the run without it
    assert all(np.array_equal(a, host_params(net.params)[k])
               for k, a in after.items())


def test_activation_probe_of_a_graph_leaves_out_its_inputs():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = (NeuralNetConfiguration.builder().seed(1).graph_builder()
            .add_inputs("in")
            .add_layer("h", Dense(n_in=4, n_out=5, activation="tanh"), "in")
            .add_layer("out", Output(n_in=5, n_out=3, activation="softmax",
                                     loss="mcxent"), "h")
            .set_outputs("out").build())
    net = ComputationGraph(conf, device="cpu").init()
    st = InMemoryStatsStorage()
    x = np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(6) % 3]
    net.set_listeners(StatsListener(st, frequency=1, session_id="g",
                                    activation_probe=[x[:2]]))
    net.fit_batch(DataSet(x, y))
    (r,) = st.get_all_updates("g")
    assert sorted(r.activation_stats) == ["h", "out"]
    assert r.activation_stats["out"]["max"] <= 1.0
    flow = st.get_static_info("g", "worker_0")["model"]
    assert flow["network_inputs"] == ["in"]
    assert [l["name"] for l in flow["layers"]] == ["h", "out"]
    # a probe of the wrong width warns once and reports no activations
    bad = StatsListener(st, frequency=1, session_id="b",
                        activation_probe=[x[:2, :3]])
    net.set_listeners(bad)
    with pytest.warns(UserWarning, match="activation_probe"):
        net.fit_batch(DataSet(x, y))
    assert st.get_latest_update("b").activation_stats == {}


# ------------------------------------------------------------- UI server
GET_ENDPOINTS = ["/api/sessions", "/api/updates?session=s",
                 "/api/updates?session=s&after=101.5",
                 "/api/updates?session=nope", "/api/model?session=s",
                 "/api/model?session=nope", "/api/embedding?session=s",
                 "/api/flow?session=s", "/api/phases?session=s",
                 "/api/fleet", "/api/traces", "/api/trace/none"]


@pytest.fixture(scope="module")
def two_servers():
    jst, tst = jstorage.InMemoryStatsStorage(), InMemoryStatsStorage()
    _fill(jst, jstats.StatsReport)
    _fill(tst, StatsReport)
    for st in (jst, tst):
        st.put_static_info("s", EMBEDDING_KEY, {
            "labels": ["a", "b"], "xy": [[0.0, 1.0], [2.0, 3.0]],
            "version": 5.0})
    j = t = None
    try:
        j, t = JUIServer(port=0), UIServer(port=0)
        j.attach(jst)
        t.attach(tst)
        yield j, t
    finally:
        for s in (j, t):
            if s is not None:
                s.stop()


@pytest.mark.parametrize("endpoint", GET_ENDPOINTS)
def test_ui_server_json_equals_the_jax_servers(two_servers, endpoint):
    j, t = two_servers
    (jc, jb), (tc, tb) = (_get_any(j.url + endpoint[1:]),
                          _get_any(t.url + endpoint[1:]))
    assert jc == tc
    jo, to = json.loads(jb), json.loads(tb)
    if endpoint == "/api/fleet":
        jo.pop("time"), to.pop("time")
    assert to == jo


def _get_any(url):
    try:
        return _get(url)
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_ui_server_page_and_process_endpoints(two_servers):
    """The page is the JAX server's, byte for byte; /metrics (JSON and
    Prometheus), /api/trace and /api/goodput serve this process's own
    registry, tracer and ledger in the JAX package's shapes."""
    j, t = two_servers
    assert _get(t.url)[1] == _get(j.url)[1]
    _, m = _get(t.url + "metrics")
    assert "dl4j_xla_cache_hits_total" in json.loads(m)
    _, prom = _get(t.url + "metrics?format=prometheus")
    assert b"# TYPE dl4j_xla_cache_hits_total counter" in prom
    _, tr = _get(t.url + "api/trace")
    assert "traceEvents" in json.loads(tr)
    _, gp = _get(t.url + "api/goodput")
    assert set(json.loads(gp)) >= {"source"}
    assert _get_any(t.url + "api/nope")[0] == 404


def test_two_workers_through_the_router_and_a_bad_post():
    srv = UIServer(port=0)
    try:
        routers = [RemoteStatsStorageRouter(srv.url) for _ in range(2)]
        for w, r in enumerate(routers):
            for i in (1, 2):
                r.put_update(_report(i, worker=f"w{w}"))
            r.put_static_info("s", f"w{w}", {"model": {"layers": []}})
            assert r.flush() == 0 and r.pending == 0 and r.posted == 3
        _, body = _get(srv.url + "api/updates?session=s")
        up = json.loads(body)
        assert sorted(up["workers"]) == ["w0", "w1"]
        assert up["iterations"] == [1, 1, 2, 2]
        req = urllib.request.Request(srv.url + "api/post",
                                     data=b'{"type": "nope"}')
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
    finally:
        srv.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_retry_queue_drains_once_the_dashboard_is_up():
    port = _free_port()
    router = RemoteStatsStorageRouter(f"http://127.0.0.1:{port}",
                                      timeout=0.5, retry_interval=0.2,
                                      max_pending=3)
    for i in range(5):
        router.put_update(_report(i))
    assert router.pending == 3 and router.dropped == 2 and router.posted == 0
    srv = UIServer(port=port)
    try:
        # the background retry the failure armed drains the queue
        assert _wait(lambda: router.pending == 0, timeout=10)
        assert router.posted == 3
        _, body = _get(srv.url + "api/updates?session=s")
        assert json.loads(body)["iterations"] == [2, 3, 4]
    finally:
        srv.stop()


def test_cli_serves_a_file(tmp_path):
    path = str(tmp_path / "run.jsonl")
    w = FileStatsStorage(path)
    _fill(w, StatsReport)
    w.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.ui", "--port", "0",
         "--file", path], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT)
    try:
        line = []
        reader = threading.Thread(
            target=lambda: line.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(timeout=60)
        assert line and line[0].startswith("dashboard: http://"), line
        url = line[0].split()[1]
        _, body = _get(url + "api/sessions")
        assert json.loads(body) == {"sessions": ["s"]}
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0, proc.stderr.read()[-2000:]


def test_heartbeats_from_the_ports_pusher_show_in_fleet():
    srv = UIServer(port=0)
    pusher = None
    try:
        pusher = HeartbeatPusher(srv.url + "api/metrics_push", 0.1,
                                 health_fn=lambda: {"batcher_healthy": True})
        pusher.start()
        assert _wait(lambda: json.loads(_get(srv.url + "api/fleet")[1])[
            "instances"], timeout=10)
        fleet = json.loads(_get(srv.url + "api/fleet")[1])
        assert fleet["live"] == 1 and len(fleet["instances"]) == 1
        _, prom = _get(srv.url + "metrics?format=prometheus")
        assert b"dl4j_heartbeat_timestamp_seconds" in prom
    finally:
        if pusher is not None:
            pusher.stop()
        srv.stop()


def test_get_instance_is_a_singleton_until_stopped():
    a = UIServer.get_instance(port=0)
    try:
        assert UIServer.get_instance(port=0) is a
        st = InMemoryStatsStorage()
        a.attach(st)
        a.attach(st)
        assert a.storages.count(st) == 1
        a.detach(st)
        assert st not in a.storages
    finally:
        a.stop()
    assert UIServer._instance is None
