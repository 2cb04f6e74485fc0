"""The port's server with decode serving (deeplearning4j_tpu_torch/serving/
server.py) on the CPU: the ``/decode`` ops answer what the engine and the
sequential ``rnn_time_step`` reference give, bit for bit; an unknown
session answers 404, or is recovered by re-prefill when its step carries
the history; ``X-DL4J-Trace-Id`` is echoed and rides the batcher's spans;
``compute_dtype=`` serves through a shadow over the same parameters and
agrees with the JAX package's shadow; the Prometheus exposition carries
the JAX package's serving, KV-pool and decode family names; ``serve()``
starts a replica set; the parameters whose modules are not ported are
refused by name, and the traffic engine's (``push_url``, ``slos``,
``scheduler``) are accepted.

Tolerance: the BF16 shadow's log-probabilities against the JAX package's
shadow, 2**-2 abs. The two packages round the bf16 stream at other places
(tests/test_torch_transformer.py holds activations to 4 bf16 ulps); this
model's logits, centred, reach 4.3, below 8, where a bf16 ulp is 2**-5, so
each logit may move by d = 4 * 2**-5, and log p = z - logsumexp(z) by at
most 2d (measured: 0.072).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import ModelServer as JServer
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.observability.trace import get_tracer
from deeplearning4j_tpu_torch.serving import (DecodeEngine, ModelServer,
                                              UnknownSessionError, serve)
from deeplearning4j_tpu_torch.utils import serialization as tser

V = 23
BF16_LOGP_TOL = 2.0 ** -2
SIZE = dict(vocab_size=V, width=32, n_layers=2, n_heads=4, max_len=48,
            seed=7)
TRACE = "X-DL4J-Trace-Id"


def _ids(n, seed=0):
    return [int(i) for i in np.random.default_rng(seed).integers(0, V, n)]


def _onehot(ids):
    return np.eye(V, dtype=np.float32)[np.asarray(ids)]


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    jnet = jzoo.gpt_mini(dtype=jzoo.F32, **SIZE)
    path = tmp_path_factory.mktemp("serving_decode") / "g.zip"
    jser.write_model(jnet, str(path))
    return jnet, tser.restore_multi_layer_network(str(path), device="cpu")


def _post(url, path, obj, headers=None):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


def _get_text(url, path, headers=None):
    req = urllib.request.Request(url + path, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read().decode(), dict(r.headers)


def _reference(net, ids, n):
    net.rnn_clear_previous_state()
    try:
        rows = [net.rnn_time_step(_onehot(ids)[None]).numpy()[0, -1]]
        toks = []
        for _ in range(n):
            toks.append(int(np.argmax(rows[-1])))
            rows.append(net.rnn_time_step(_onehot([toks[-1]])).numpy()[0])
        return toks, rows
    finally:
        net.rnn_clear_previous_state()


@pytest.fixture(scope="module")
def server(nets):
    net = nets[1]
    srv = serve(net, port=0, warmup=False, replicas=2,
                decode_engine=DecodeEngine(net, replicas=2,
                                           batch_window_ms=1.0))
    yield srv
    srv.stop()


def test_decode_ops_answer_the_sequential_reference(nets, server):
    ids = _ids(9, seed=1)
    toks, rows = _reference(nets[1], ids, 4)
    status, body, hdr = _post(server.url, "/decode",
                              {"op": "prefill", "sid": "a", "ids": ids},
                              headers={TRACE: "trace-a"})
    assert status == 200 and hdr[TRACE] == "trace-a"
    assert np.array_equal(np.asarray(body["logits"], np.float32), rows[0])
    for k, tok in enumerate(toks[:3]):
        status, body, _ = _post(server.url, "/decode",
                                {"op": "step", "sid": "a", "token": tok,
                                 "ids": ids + toks[:k]})
        assert status == 200 and body["recovered"] is False
        assert np.array_equal(np.asarray(body["logits"], np.float32),
                              rows[k + 1])
    status, body, _ = _post(server.url, "/decode",
                            {"op": "generate", "sid": "g", "ids": ids,
                             "n_tokens": 4})
    assert body == {"tokens": toks, "speculative": False}
    assert _post(server.url, "/decode",
                 {"op": "close", "sid": "a"})[1] == {"closed": True}
    assert _post(server.url, "/decode",
                 {"op": "close", "sid": "a"})[1] == {"closed": False}
    # the trace id rode the handler span and the batcher's spans
    spans = get_tracer().spans()
    assert any(s.name == "decode_op" and s.attrs.get("trace_id")
               == "trace-a" for s in spans)
    assert any(s.name == "device_compute"
               and "trace-a" in s.attrs.get("trace_ids", ()) for s in spans)


def test_unknown_session_is_404_or_recovered_by_reprefill(nets, server):
    ids = _ids(7, seed=2)
    toks, rows = _reference(nets[1], ids, 2)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.url, "/decode", {"op": "step", "sid": "ghost",
                                      "token": 1})
    assert e.value.code == 404
    assert "ghost" in json.loads(e.value.read())["error"]
    # another host's session arrives with its history: re-prefilled here
    status, body, _ = _post(server.url, "/decode",
                            {"op": "step", "sid": "moved", "ids": ids,
                             "token": toks[0]})
    assert status == 200 and body["recovered"] is True
    assert np.array_equal(np.asarray(body["logits"], np.float32), rows[1])
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.url, "/decode", {"op": "rewind", "sid": "moved"})
    assert e.value.code == 400
    with pytest.raises(UnknownSessionError):
        server.decode_op({"op": "step", "sid": "nobody", "token": 0})


def test_health_and_metrics_carry_decode(server):
    _post(server.url, "/decode", {"op": "generate", "sid": "m",
                                  "ids": _ids(5, seed=3), "n_tokens": 3})
    status, text, _ = _get_text(server.url, "/healthz")
    health = json.loads(text)
    assert status == 200 and health["status"] == "ok"
    assert len(health["replicas"]) == 2
    assert health["decode"]["prefills"] >= 1
    status, text, _ = _get_text(server.url, "/metrics")
    m = json.loads(text)
    assert m["decode"]["decode_steps"] >= 3
    assert m["decode"]["inter_token_hist"]["count"] >= 3
    assert len(m["replicas"]) == 2 and m["requeued_total"] == 0
    status, text, hdr = _get_text(server.url, "/metrics?format=prometheus")
    assert hdr["Content-Type"].startswith("text/plain")
    assert "dl4j_decode_inter_token_seconds_bucket" in text
    status, text2, _ = _get_text(server.url, "/metrics",
                                 headers={"Accept": "text/plain"})
    assert "# TYPE dl4j_kv_pool_pages_used gauge" in text2


def _families(text, prefixes=("dl4j_serving_", "dl4j_kv_pool_",
                              "dl4j_decode_")):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")
            and line.split()[2].startswith(prefixes)}


def test_prometheus_family_names_equal_jax(nets):
    """The same traffic on both packages' servers: the serving, KV-pool
    and decode families of the exposition are the same names."""
    texts = []
    for Server, Engine, net in ((JServer, JEngine, nets[0]),
                                (ModelServer, DecodeEngine, nets[1])):
        eng = Engine(net, replicas=1, batch_window_ms=1.0)
        srv = Server(net, port=0, warmup=False, decode_engine=eng).start()
        try:
            _post(srv.url, "/decode", {"op": "generate", "sid": "p",
                                       "ids": _ids(6, seed=4),
                                       "n_tokens": 2})
            _post(srv.url, "/predict",
                  {"features": _onehot(_ids(5, seed=5))[None].tolist()})
            texts.append(_get_text(srv.url, "/metrics?format=prometheus")[1])
        finally:
            srv.stop()
    jnames, tnames = (_families(t) for t in texts)
    assert "dl4j_decode_inter_token_seconds" in tnames
    assert tnames == jnames


def test_compute_dtype_shadow_matches_jax_shadow(nets):
    x = _onehot(_ids(4 * 6, seed=6)).reshape(4, 6, V)
    jsrv = JServer(nets[0], port=0, warmup=False, compute_dtype="bfloat16")
    tsrv = ModelServer(nets[1], port=0, warmup=False,
                       compute_dtype="bfloat16")
    f32 = ModelServer(nets[1], port=0, warmup=False)
    try:
        want = np.asarray(jsrv.predict(x))
        got = tsrv.predict(x)
        plain = f32.predict(x)
    finally:
        for s in (jsrv, tsrv, f32):
            s.stop()
    assert tsrv.serving_compute_dtype == "bfloat16"
    # the shadow holds no parameters of its own
    assert tsrv._serving_net.params is nets[1].params
    np.testing.assert_allclose(np.log(got), np.log(want), atol=BF16_LOGP_TOL,
                               rtol=0)
    assert not np.array_equal(got, plain)   # it did compute in bf16
    with pytest.raises(ValueError):
        ModelServer(nets[1], port=0, warmup=False, compute_dtype="int4")


def test_serve_replicas_padding_and_run_report(nets):
    net = nets[1]
    srv = serve(net, port=0, warmup=False, replicas=3, max_batch=4)
    try:
        x = _onehot(_ids(3 * 5, seed=7)).reshape(3, 5, V)
        status, body, hdr = _post(srv.url, "/predict",
                                  {"features": x.tolist()})
        assert status == 200 and TRACE in hdr
        np.testing.assert_allclose(np.asarray(body["predictions"]),
                                   net.output(x).numpy(), atol=1e-6,
                                   rtol=1e-6)
        health = json.loads(_get_text(srv.url, "/healthz")[1])
        assert [r["replica"] for r in health["replicas"]] == [0, 1, 2]
    finally:
        srv.stop()
    # 3 rows in a bucket of 4: one padded row reached the ledger
    pad = srv.run_report.padding["serving_bucket"]
    assert pad["real"] == 3 and pad["padded"] == 1


def _ported_kw(name):
    from deeplearning4j_tpu_torch.observability.slo import SLO
    from deeplearning4j_tpu_torch.scheduling import SchedulingCore
    return {"push_url": "http://localhost:1",
            "slos": [SLO("availability", metric="availability",
                         objective=0.99)],
            "scheduler": SchedulingCore()}[name]


@pytest.mark.parametrize("kw", [
    {"mesh": object()}, {"push_url": None},
    {"slos": None}, {"compile_cache_dir": "cache"},
    {"aot_manifest": "m.json"}, {"tuning_report": "t.json"},
    {"scheduler": None}], ids=lambda kw: next(iter(kw)))
def test_unported_parameters_are_refused_by_name(nets, kw, tmp_path):
    """Every parameter is ported: mesh (mesh serving, whose fleets run in
    tests/test_torch_mesh_serving.py) is held here to the JAX package's
    refusal of compute_dtype= beside it, before any collective; the
    compile cache's three, push_url, slos and scheduler build a server
    that holds what was given (nothing starts: no push is made)."""
    (name, value), = kw.items()
    if name == "mesh":
        with pytest.raises(ValueError, match="bit-identity"):
            ModelServer(nets[1], port=0, warmup=False,
                        compute_dtype="bfloat16", **kw)
        return
    if name in ("compile_cache_dir", "aot_manifest", "tuning_report"):
        _held_cold_start_parameter(nets[1], name, tmp_path)
        return
    value = _ported_kw(name)
    srv = ModelServer(nets[1], port=0, warmup=False, **{name: value})
    held = {"push_url": srv.push_url, "scheduler": srv.scheduler,
            "slos": srv.slo_engine and srv.slo_engine.slos}[name]
    assert held == value


def _held_cold_start_parameter(net, name, tmp_path):
    """The compile cache's parameters (compilecache/): the cache dir is
    configured, a manifest is validated at start() (here: a missing one
    reads unreadable, and the server still serves), a tuning report sets
    max_batch and the linger window."""
    from deeplearning4j_tpu_torch.compilecache import autotune, cache
    try:
        if name == "compile_cache_dir":
            srv = ModelServer(net, port=0, warmup=False,
                              compile_cache_dir=str(tmp_path / "cache"))
            assert srv.compile_cache_dir == str(tmp_path / "cache")
            assert cache.cache_dir() == srv.compile_cache_dir
        elif name == "aot_manifest":
            srv = ModelServer(net, port=0, max_batch=4,
                              input_shapes=[(8, V)],
                              aot_manifest=str(tmp_path / "m.json"))
            with pytest.warns(RuntimeWarning, match="unreadable manifest"):
                srv.start()
            try:
                assert srv.aot_manifest_ok is False
                assert srv.predict(_onehot(_ids(8))[None]).shape == (1, 8, V)
            finally:
                srv.stop()
        else:
            rep = {"tuned": {"max_batch": 8, "batch_window_ms": 0.5}}
            (tmp_path / "t.json").write_text(json.dumps(rep))
            srv = ModelServer(net, port=0, warmup=False,
                              tuning_report=str(tmp_path / "t.json"))
            assert srv.tuned_config == autotune.load_tuned(rep)
            assert (srv._batcher.max_batch,
                    srv._batcher.batch_window_ms) == (8, 0.5)
    finally:
        cache.deactivate()


def test_hot_swap_is_refused_by_name(nets):
    """hot_swap is ported (tests/test_torch_publish.py); what it still
    refuses, with the reason named, is a server holding decode sessions,
    whose KV caches carry the old weights' state."""
    srv = ModelServer(nets[1], port=0, warmup=False,
                      decode_engine=DecodeEngine(nets[1], replicas=1))
    with pytest.raises(ValueError, match="hot_swap cannot re-weight live "
                       "decode sessions"):
        srv.hot_swap(net=nets[1])
    assert srv.model_version == 0 and srv.swaps_total == 0
    srv.decode_engine.stop()
