"""The port's serving runtime (deeplearning4j_tpu_torch/serving) on the CPU:
``ModelServer`` answers concurrent ``/predict`` requests with the rows
``net.output`` gives, reports ``/healthz`` and ``/metrics``, sheds load with
503 + Retry-After, and drains on ``stop()``; the batcher's bucket rules and
stats match the JAX package's.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import batcher as jbatcher
from deeplearning4j_tpu.serving.metrics import ServingStats as JStats
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.serving import batcher as tbatcher
from deeplearning4j_tpu_torch.serving import ModelServer
from deeplearning4j_tpu_torch.serving.metrics import ServingStats

V, T = 12, 5


@pytest.fixture(scope="module")
def net():
    return zoo.char_rnn(vocab_size=V, hidden=16, n_layers=2, seed=3,
                        dtype=zoo.F32, device="cpu")


def _rows(k, seed):
    rng = np.random.default_rng(seed)
    return np.eye(V, dtype=np.float32)[rng.integers(0, V, (k, T))]


def _post(url, obj):
    req = urllib.request.Request(url + "/predict",
                                 data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_concurrent_predict_returns_net_output_rows(net):
    srv = ModelServer(net, port=0, max_batch=8, batch_window_ms=5.0,
                      input_shapes=[(T, V)]).start()
    assert srv.shapes_seen == {2, 4, 8}  # warm-up walked the ladder
    replies, errors = {}, []

    def client(c):
        try:
            for j in range(3):
                x = _rows(1 + (c + j) % 3, seed=10 * c + j)
                status, body = _post(srv.url, {"features": x.tolist()})
                assert status == 200
                replies[(c, j)] = (x, np.asarray(body["predictions"],
                                                 np.float32))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    # more clients than cores, and frequent thread switches, so a lost
    # update in the batcher or the stats would show
    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(12)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        status, health = _get(srv.url, "/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["params"] == net.num_params()
        status, m = _get(srv.url, "/metrics")
    finally:
        sys.setswitchinterval(interval)
        srv.stop()
    assert status == 200
    assert m["requests_total"] == 36 and m["errors_total"] == 0
    assert m["rows_total"] == sum(x.shape[0] for x, _ in replies.values())
    assert m["latency_ms"]["p50"] is not None
    assert set(m["shapes_seen"]) <= {2, 4, 8}
    assert sum(m["batch_size_hist"].values()) == m["batches_total"]
    assert m["batcher_healthy"] is True
    for x, y in replies.values():
        want = net.output(x).numpy()
        assert y.shape == want.shape
        # the same rows through torch's CPU matmul at another batch size
        np.testing.assert_allclose(y, want, atol=1e-6, rtol=1e-6)


def test_bad_request_is_400_and_unknown_path_404(net):
    srv = ModelServer(net, port=0, max_batch=4, warmup=False).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.url, {"features": np.zeros((1, T, V + 1)).tolist()})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url, "/nope")
        assert e.value.code == 404
        status, m = _get(srv.url, "/metrics")
        assert m["errors_total"] == 1
    finally:
        srv.stop()


def test_full_queue_answers_503_with_retry_after(net):
    srv = ModelServer(net, port=0, max_batch=2, max_queue=1,
                      batch_window_ms=0.0, warmup=False)
    release = threading.Event()
    entered = threading.Event()

    def slow_forward(feats):
        entered.set()
        release.wait(30)
        return np.zeros((feats[0].shape[0], T, V), np.float32)

    srv._batcher._forward = slow_forward
    srv.start()
    results = []
    try:
        x = _rows(1, seed=1).tolist()
        first = threading.Thread(
            target=lambda: results.append(_post(srv.url, {"features": x})),
            daemon=True)
        first.start()
        assert entered.wait(30)   # the device thread holds ticket 1
        second = threading.Thread(
            target=lambda: results.append(_post(srv.url, {"features": x})),
            daemon=True)
        second.start()
        deadline = time.monotonic() + 30
        while srv._batcher.depth < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.url, {"features": x})
        assert e.value.code == 503
        assert float(e.value.headers["Retry-After"]) > 0
        release.set()
        first.join(30)
        second.join(30)
    finally:
        release.set()
        srv.stop()
    assert [r[0] for r in results] == [200, 200]
    assert srv.stats.rejected == 1


def test_stop_drains_accepted_tickets(net):
    srv = ModelServer(net, port=0, max_batch=4, batch_window_ms=50.0,
                      warmup=False).start()
    futures = [srv._batcher.submit([_rows(1, seed=s)]) for s in range(6)]
    srv.stop()
    for s, f in enumerate(futures):
        assert f.done()
        np.testing.assert_allclose(f.result(timeout=30), net.output(_rows(1, s)).numpy(),
                                   atol=1e-6, rtol=1e-6)
    with pytest.raises(RuntimeError, match="stopped"):
        srv._batcher.submit([_rows(1, seed=0)])


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dead_device_thread_fails_tickets_and_health(net):
    b = tbatcher.MicroBatcher(lambda feats: np.zeros(1), max_batch=4,
                              batch_window_ms=0.0)

    def die(feats):
        raise SystemExit("device gone")

    b._forward = die
    b._execute = lambda batch, rows: die(None)
    b.start()
    f = b.submit([_rows(1, seed=0)])
    with pytest.raises(tbatcher.BatcherDeadError):
        f.result(timeout=30)
    b._thread.join(30)
    assert not b.healthy
    with pytest.raises(tbatcher.BatcherDeadError):
        b.submit([_rows(1, seed=0)])


@pytest.mark.parametrize("n,max_batch,min_batch", [
    (1, 32, 2), (2, 32, 2), (3, 32, 2), (17, 32, 2), (40, 32, 2),
    (1, 32, 1), (5, 8, 1), (1, 1, 2)])
def test_next_bucket_matches_jax(n, max_batch, min_batch):
    assert tbatcher.next_bucket(n, max_batch, min_batch) == \
        jbatcher.next_bucket(n, max_batch, min_batch)
    assert tbatcher.bucket_ladder(min_batch, max_batch) == \
        jbatcher.bucket_ladder(min_batch, max_batch)


def test_stats_snapshot_matches_jax():
    t, j = ServingStats(), JStats()
    clock = iter(np.arange(0.0, 100.0, 0.5))
    now = {"t": 0.0}

    def tick():
        return now["t"]

    t._clock = j._clock = tick
    for k in range(7):
        now["t"] = next(clock)
        for s in (t, j):
            s.record_request(k + 1, 0.001 * (k + 3))
            s.record_batch(2 ** (k % 3 + 1), k % 3 + 1, 1, device_s=0.002)
    for s in (t, j):
        s.record_rejected()
        s.record_error()
        s.record_timeout()
    a, b = t.snapshot({2, 4, 8}), j.snapshot({2, 4, 8})
    for key in ("requests_total", "rows_total", "batches_total",
                "rejected_total", "errors_total", "timeouts_total",
                "latency_ms", "latency_window", "batch_size_hist",
                "device_ms_by_bucket", "coalesce_rows_per_batch",
                "coalesce_requests_per_batch", "padded_rows_total",
                "shapes_seen", "drain_rate_rows_per_s", "retry_after_s"):
        assert a[key] == b[key], key
    assert t.retry_after_s(5) == j.retry_after_s(5)


def test_server_output_is_float32_numpy(net):
    srv = ModelServer(net, port=0, warmup=False)
    out = srv._device_forward([_rows(2, seed=4)])
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    assert torch.equal(torch.from_numpy(out), net.output(_rows(2, seed=4)))


def test_request_larger_than_max_batch_is_chunked(net):
    srv = ModelServer(net, port=0, max_batch=2, warmup=False)
    try:
        x = _rows(5, seed=9)
        out = srv.predict(x)
    finally:
        srv.stop()
    np.testing.assert_allclose(out, net.output(x).numpy(), atol=1e-6,
                               rtol=1e-6)
    assert srv.stats.batches == 3 and srv.shapes_seen == {2}
