"""The port's SLO engine (deeplearning4j_tpu_torch/observability/slo.py)
held against the JAX package's on the CPU, and the server's SLO half.

- One sequence of ``ServingStats``-shaped snapshots and federation rows
  goes into both ``SLOEngine``s on one fake clock (availability and
  threshold SLOs, several windows, counter resets, per-source state, an
  objective of 1.0); ``evaluate()``, ``report()`` and ``families()`` must
  be equal after every ingest.
- The declaration checks raise the same errors.
- A default ``ModelServer`` builds the default SLO pair
  (``DL4J_TPU_SLO_P99_MS``), renders the ``dl4j_slo_*`` families, and
  ``stop()`` stamps ``RunReport.slo``; ``slos=[]`` has none.

Host-only logic: results are held exactly. Every server is stopped in
``finally``; every HTTP call has a timeout.
"""

import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.observability import slo as jslo
from deeplearning4j_tpu_torch.observability import slo as tslo
from deeplearning4j_tpu_torch.serving.server import ModelServer

MODS = {"jax": jslo, "torch": tslo}


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _snap(requests, errors=0, timeouts=0, p99=None, **extra):
    s = {"requests_total": requests, "errors_total": errors,
         "timeouts_total": timeouts, **extra}
    if p99 is not None:
        s["latency_ms"] = {"p50": p99 / 2, "p99": p99}
    return s


# (clock advance, kind, payload, source)
SEQUENCE = [
    (0.0, "snap", _snap(0, p99=100.0), "local"),
    (10.0, "snap", _snap(99, errors=1, p99=300.0), "local"),
    (10.0, "snap", _snap(150, errors=1, timeouts=2, p99=700.0), "local"),
    (5.0, "snap", _snap(10, p99=20.0), "local"),          # counter reset
    (5.0, "snap", _snap(10, p99=20.0), "local"),          # idle interval
    (0.0, "snap", _snap(5, errors=5, queue=3.5), "h1"),
    (30.0, "snap", _snap(25, errors=5, queue=9.0), "h1"),
    (0.0, "rows", [{"instance": "h2", "health": {"serving": _snap(
        0, latency_p99_ms=40.0)}},
        {"instance": "h3", "serving": _snap(7, latency_p99_ms=900.0)},
        "junk", {"tag": "h4", **_snap(3)}], None),
    (20.0, "rows", [{"instance": "h2", "health": {"serving": _snap(
        50, errors=2, latency_p99_ms=600.0)}},
        {"instance": "h3", "serving": _snap(9, latency_p99_ms=100.0)},
        {"tag": "h4", **_snap(4)}], None),
    (100.0, "snap", _snap(40, errors=0, p99=50.0), "local"),
    (400.0, "snap", _snap(80, errors=1, p99=80.0), "local"),
    (3000.0, "snap", _snap(100, p99=10.0), "local"),
    (0.0, "snap", "not a dict", "local"),
]


def _engine(mod, clock):
    slos = [
        mod.SLO("availability", metric="availability", objective=0.99,
                window_s=60.0),
        mod.SLO("strict", metric="availability", objective=1.0,
                window_s=300.0),
        mod.SLO("p99", metric="latency_p99_ms", objective=0.9,
                window_s=3600.0, bound=500.0),
        mod.SLO("fed_p99", metric="latency_p99_ms", objective=0.5,
                bound=500.0),
        mod.SLO("queue", metric="queue", objective=0.75, bound=5.0),
        mod.SLO("dotted", metric="latency_ms.p50", objective=0.99,
                bound=100.0, window_s=200.0),
    ]
    return mod.SLOEngine(slos, windows=(60.0, 300.0, 3600.0), clock=clock,
                         capacity=8)


def _families(fams):
    return [(f.name, f.kind, f.help,
             [(s.suffix, dict(s.labels), s.value) for s in f.samples])
            for f in fams]


def _run(mod):
    clock = FakeClock()
    eng = _engine(mod, clock)
    trail = []
    for dt, kind, payload, source in SEQUENCE:
        clock.t += dt
        if kind == "snap":
            eng.ingest(payload, source)
        else:
            eng.ingest_fed_rows(payload)
        trail.append((eng.evaluate(), eng.report(),
                      _families(eng.families())))
    return trail


@pytest.fixture(scope="module")
def jax_trail():
    return _run(jslo)


def test_engine_equals_the_jax_engine_step_by_step(jax_trail):
    port = _run(tslo)
    assert len(port) == len(jax_trail) == len(SEQUENCE)
    for i, (p, j) in enumerate(zip(port, jax_trail)):
        assert p == j, f"after ingest {i}"
    # the sequence reached every branch: a burn above 1, an infinite
    # burn under objective 1.0, and a window with no data
    ev = port[2][0]
    assert ev["availability"]["60s"]["burn_rate"] > 1.0
    assert ev["strict"]["60s"]["burn_rate"] == float("inf")
    assert port[0][0]["availability"]["60s"]["attainment"] is None


def test_default_slos_and_constants_equal_the_jax_package():
    for bound in (500.0, 12.5):
        assert [vars(s) for s in tslo.default_serving_slos(bound)] == \
            [vars(s) for s in jslo.default_serving_slos(bound)]
    assert tslo.DEFAULT_WINDOWS_S == jslo.DEFAULT_WINDOWS_S
    assert tslo.__all__ == jslo.__all__


@pytest.mark.parametrize("build", [
    lambda m: m.SLO("x", metric="availability", objective=0.0),
    lambda m: m.SLO("x", metric="availability", objective=1.5),
    lambda m: m.SLO("x", metric="latency_p99_ms", objective=0.9),
    lambda m: m.SLOEngine([m.SLO("a", "availability", 0.9)] * 2),
    lambda m: m.SLOEngine([], windows=()),
], ids=["zero", "above_one", "no_bound", "duplicate", "no_window"])
def test_declaration_errors_equal_the_jax_package(build):
    msgs = {}
    for name, mod in MODS.items():
        with pytest.raises(ValueError) as ei:
            build(mod)
        msgs[name] = str(ei.value)
    assert msgs["torch"] == msgs["jax"]


def test_attach_and_detach_on_a_registry():
    from deeplearning4j_tpu_torch.observability.metrics import \
        MetricsRegistry
    clock = FakeClock()
    eng = tslo.SLOEngine(tslo.default_serving_slos(), clock=clock)
    reg = MetricsRegistry()
    eng.attach(reg)
    eng.ingest(_snap(0, p99=1.0))
    clock.t += 1.0
    eng.ingest(_snap(10, p99=1.0))
    text = reg.render_prometheus()
    assert 'dl4j_slo_attainment{slo="availability",window="60s"} 1' in text
    eng.detach()
    assert "dl4j_slo_" not in reg.render_prometheus()


def _mlp():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(3).list()
            .layer(Dense(n_in=4, n_out=8, activation="relu"))
            .layer(Output(n_in=8, n_out=2, activation="softmax",
                          loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_default_server_slos_and_run_report(monkeypatch):
    """The default server's SLOs are the JAX package's default pair with
    the p99 bound from DL4J_TPU_SLO_P99_MS; its families render on the
    registry; stop() stamps RunReport.slo; slos=[] has none."""
    monkeypatch.setenv("DL4J_TPU_SLO_P99_MS", "250")
    srv = ModelServer(_mlp(), port=0, warmup=False, max_batch=4).start()
    try:
        assert [vars(s) for s in srv.slo_engine.slos] == \
            [vars(s) for s in jslo.default_serving_slos(250.0)]
        x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
        for _ in range(3):
            srv.predict(x)
        with urllib.request.urlopen(srv.url + "/metrics?format=prometheus",
                                    timeout=30) as r:
            text = r.read().decode()
        assert "# TYPE dl4j_slo_attainment gauge" in text
        srv.predict(x)
    finally:
        srv.stop()
    rep = srv.run_report.slo
    assert rep is not None and set(rep["slos"]) == {"availability",
                                                    "predict_p99"}
    assert rep["slos"]["predict_p99"]["bound"] == 250.0
    assert rep["slos"]["availability"]["attainment"] == 1.0
    srv = ModelServer(_mlp(), port=0, warmup=False, max_batch=4,
                      slos=[]).start()
    try:
        srv.predict(np.zeros((1, 4), np.float32))
    finally:
        srv.stop()
    assert srv.slo_engine is None and srv.run_report.slo is None
