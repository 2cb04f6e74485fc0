"""The port's goodput ledger (deeplearning4j_tpu_torch/observability/
goodput.py) on the CPU.

- ``RunReport`` has the JAX package's keys and fields, and round-trips
  through its JSON artifact.
- The ledger invariant the JAX package's CI holds: on a fit run the
  exclusive phases (``data_wait``, ``host_dispatch``, ``device_step``,
  ``score_sync``, ``flops_derive``) account for the run's wall time
  within 5%, eagerly and chunked (``multi_step``), both network kinds.
- FLOPs are derived while a ledger is open, without a listener asking,
  and equal ``step_cost_analysis``.
- Padding waste from ``bucket_batch`` is counted into the run's report
  as the JAX package counts it for the same pipeline.
"""

import numpy as np
import pytest

from deeplearning4j_tpu import datapipe as jpipe
from deeplearning4j_tpu.observability import goodput as jgoodput
from deeplearning4j_tpu_torch import datapipe as tpipe
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Sgd
from deeplearning4j_tpu_torch.observability import goodput as tgoodput
from deeplearning4j_tpu_torch.observability import metrics as tmetrics

F32 = DtypePolicy(param_dtype="float32", compute_dtype="float32")
#: the JAX package's ledger invariant: attributed within 5% of wall
ATTRIBUTED_SHARE = 0.95


def test_run_report_keys_equal_jax(tmp_path):
    j, t = jgoodput.RunReport(kind="fit"), tgoodput.RunReport(kind="fit")
    assert list(t.to_dict()) == list(j.to_dict())
    assert t.to_dict() == j.to_dict()
    assert set(t.__dataclass_fields__) == set(j.__dataclass_fields__)
    assert tgoodput.SCHEMA_VERSION == jgoodput.SCHEMA_VERSION
    assert tgoodput.FIT_EXCLUSIVE == jgoodput.FIT_EXCLUSIVE
    assert tgoodput.SUPERVISOR_EXCLUSIVE == jgoodput.SUPERVISOR_EXCLUSIVE
    t.steps, t.phases = 3, {"device_step": {"seconds": 0.5, "count": 3}}
    path = t.save(str(tmp_path / "run_report.json"))
    back = tgoodput.RunReport.load(path)
    assert back == t
    # a file the JAX package wrote loads here, and the other way round
    assert tgoodput.RunReport.from_json(j.to_json()).to_dict() == \
        j.to_dict()
    assert jgoodput.RunReport.load(path).to_dict() == t.to_dict()


# wide enough that the step (a few ms on the CPU) dominates the
# per-step Python around it, 80 steps so that one-time start-up
# amortizes (the JAX package's invariant test's design)
N_IN, HIDDEN, ROWS, BATCH, EPOCHS = 256, 2048, 10240, 512, 4


def _mln():
    conf = (NeuralNetConfiguration.builder().seed(2).updater(Sgd(0.05))
            .dtype(F32).list()
            .layer(Dense(n_in=N_IN, n_out=HIDDEN, activation="tanh"))
            .layer(Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _graph():
    conf = (NeuralNetConfiguration.builder().seed(2).updater(Sgd(0.05))
            .dtype(F32).graph_builder().add_inputs("in")
            .add_layer("d", Dense(n_out=HIDDEN, activation="tanh"), "in")
            .add_layer("out", Output(n_out=3, activation="softmax",
                                     loss="mcxent"), "d")
            .set_outputs("out").set_input_types(InputType.feed_forward(N_IN))
            .build())
    return ComputationGraph(conf, device="cpu").init()


def _arrays(n=ROWS, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, N_IN)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _assert_attributed(report, steps):
    assert report.kind == "fit" and report.status == "completed"
    assert report.steps == steps
    assert report.attributed_s >= ATTRIBUTED_SHARE * report.wall_s, (
        report.attributed_s, report.wall_s, report.phases)
    assert report.attributed_s <= report.wall_s
    for name in ("data_wait", "host_dispatch", "device_step",
                 "flops_derive"):
        assert name in report.phases, name
    assert report.goodput_fraction is not None
    assert 0.0 < report.goodput_fraction <= 1.0


@pytest.mark.parametrize("multi_step", [1, 4], ids=["eager", "chunked"])
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_fit_ledger_attributes_the_wall_time(kind, multi_step):
    x, y = _arrays()
    net = _mln() if kind == "mln" else _graph()
    it = ArrayDataSetIterator(x, y, batch_size=BATCH)
    net.fit(it, epochs=EPOCHS, multi_step=multi_step)
    report = net.last_run_report
    steps = EPOCHS * ROWS // BATCH
    _assert_attributed(report, steps)
    assert tgoodput.last_report() is report
    if multi_step > 1:
        chunked = report.phases["device_step"]["count"]
        assert chunked == steps // multi_step
    # FLOPs were derived with no listener asking: step_cost_analysis's
    want = net.step_cost_analysis(DataSet(x[:BATCH], y[:BATCH]))["flops"]
    assert report.flops_per_step == want == net.flops_per_step


def test_fit_over_a_pipeline_attributes_the_wall_time():
    x, y = _arrays()
    pipe = (tpipe.from_arrays(x, y).shuffle(window=64, seed=3)
            .batch(BATCH, drop_last=True).prefetch(2))
    net = _mln()
    net.fit(pipe, epochs=EPOCHS)
    _assert_attributed(net.last_run_report, EPOCHS * ROWS // BATCH)


def test_auto_flops_switch_and_kill_switch(monkeypatch):
    x, y = _arrays(64)
    monkeypatch.setenv("DL4J_TPU_AUTO_FLOPS", "0")
    net = _mln()
    net.fit(x, y, batch_size=16)
    assert net.flops_per_step is None
    assert "flops_derive" not in net.last_run_report.phases
    monkeypatch.delenv("DL4J_TPU_AUTO_FLOPS")
    tgoodput.set_enabled(False)
    try:
        net.fit(x, y, batch_size=16)
        assert net.last_run_report is None
    finally:
        tgoodput.set_enabled(True)


def test_failed_fit_closes_its_ledger():
    from deeplearning4j_tpu_torch.datasets import DataSetIterator

    class Broken(DataSetIterator):
        auto_epochs = True

        def __iter__(self):
            raise RuntimeError("source died")

    net = _mln()
    with pytest.raises(RuntimeError, match="source died"):
        net.fit(Broken(), async_prefetch=False)
    assert tgoodput.current_ledger() is None
    assert net.last_run_report.status == "failed"


def _sequences(seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(int(t), 4)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, int(t))])
            for t in rng.integers(1, 17, 40)]


def _padding(mod, goodput):
    ledger = goodput.start_run("fit")
    try:
        list(mod.from_records(_sequences()).bucket_batch(4))
    finally:
        report = goodput.end_run(ledger)
    return report.padding


def test_padding_waste_from_bucket_batch_equals_jax():
    got = _padding(tpipe, tgoodput)
    want = _padding(jpipe, jgoodput)
    assert got == want
    ent = got["datapipe_bucket_batch"]
    assert ent["real"] == sum(s.shape[0] for s, _ in _sequences())
    assert ent["padded"] > 0 and 0 < ent["waste_fraction"] < 1


def test_padding_lands_on_the_fit_report():
    net = zoo.char_rnn(vocab_size=4, hidden=8, n_layers=1, dtype=zoo.F32,
                       device="cpu")
    rng = np.random.default_rng(2)
    recs = [(np.eye(4, dtype=np.float32)[rng.integers(0, 4, int(t))],
             np.eye(4, dtype=np.float32)[rng.integers(0, 4, int(t))])
            for t in rng.integers(2, 9, 24)]
    net.fit(tpipe.from_records(recs).bucket_batch(4, drop_last=True))
    ent = net.last_run_report.padding["datapipe_bucket_batch"]
    assert ent["padded"] > 0


def test_goodput_gauges_render_after_a_fit():
    reg = tmetrics.MetricsRegistry()
    reg.register_collector(tgoodput.goodput_collector)
    x, y = _arrays(64)
    _mln().fit(x, y, batch_size=16)
    snap = reg.snapshot()
    assert snap["dl4j_run_wall_seconds"][0]["labels"] == {"run": "fit"}
    phases = {s["labels"]["phase"]
              for s in snap["dl4j_goodput_phase_seconds"]}
    assert {"host_dispatch", "device_step", "data_wait"} <= phases
    live = tgoodput.live_snapshot()
    assert live["source"] == "last_report" and live["steps"] == 4


def test_fit_batch_repeated_counts_its_steps():
    x, y = _arrays(32)
    net = _mln()
    ledger = tgoodput.start_run("fit", net=net)
    try:
        net.fit_batch_repeated(DataSet(x, y), 5)
    finally:
        report = tgoodput.end_run(ledger)
    assert report.steps == 5 and net.iteration == 5
