"""Early stopping and training listeners in the port
(deeplearning4j_tpu_torch/optimize) on the CPU.

Against the JAX package (deeplearning4j_tpu/optimize), on the same seeded
inputs and a net carried from the JAX package through the zip, F32 set
explicitly (tests/conftest.py turns on JAX's x64):

- every termination condition, fed the same score sequences: exact;
- EarlyStoppingTrainer with each score calculator, the score-improvement
  condition and the iteration conditions: the termination reason, the
  epoch counts and the best epoch exactly, ``score_vs_epoch`` and the best
  score to 1e-5 relative (the same f32 loss over the same data, summed in
  another order; an accuracy is a count over 256 examples and must agree
  exactly), and the best model's output to 1e-5 absolute;
- the listeners over the same 3 F32 SGD steps: ScoreIterationListener's
  and CollectScoresIterationListener's iterations exactly and scores to
  1e-5 relative; ParamAndGradientIterationListener's header exactly and
  each row's columns to 1e-5 of the column's largest magnitude plus 1e-7
  (means, extremes and steps of f32 parameters).

On the port alone: the counterparts of tests/test_earlystopping_solvers.py's
termination, trainer and saver tests (the solvers are not ported), the
trainer on a ComputationGraph through both savers, and each listener's
cadence. The nets are small (5 -> 16 tanh -> 3 softmax, 256 examples from
three Gaussian blobs). A restored best model's score equals the recorded
best to 1e-5 (the same f32 loss over the same data), and a model read back
from the zip gives the same output exactly.
"""

import io

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JIterator
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.nn.updater import Sgd as JSgd
from deeplearning4j_tpu.optimize import earlystopping as jes
from deeplearning4j_tpu.optimize import listeners as jlst
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.optimize import earlystopping as tes
from deeplearning4j_tpu_torch.optimize import listeners as tlst
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, Sgd
from deeplearning4j_tpu_torch.optimize.earlystopping import (
    BestScoreEpochTermination,
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingGraphTrainer,
    EarlyStoppingTrainer,
    EvaluationScoreCalculator,
    InMemoryModelSaver,
    InvalidScoreEpochTermination,
    InvalidScoreIterationTermination,
    LocalFileModelSaver,
    MaxEpochsTermination,
    MaxScoreEpochTermination,
    MaxScoreIterationTermination,
    MaxTimeIterationTermination,
    ScoreImprovementEpochTermination,
)
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener,
    ComposableIterationListener,
    ParamAndGradientIterationListener,
    PerformanceListener,
    ScoreIterationListener,
    TrainingListener,
)

F32 = DtypePolicy(param_dtype="float32", compute_dtype="float32")


def make_problem(seed=0, n=256):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 2, (3, 5))
    idx = rng.integers(0, 3, n)
    x = (centers[idx] + rng.normal(0, 0.6, (n, 5))).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[idx]
    return x, y


def make_net(lr=1e-2, updater=None):
    conf = (NeuralNetConfiguration.builder()
            .seed(7).updater(updater or Adam(lr)).dtype(F32).list()
            .layer(Dense(n_in=5, n_out=16, activation="tanh"))
            .layer(Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def make_graph(lr=1e-2):
    conf = (NeuralNetConfiguration.builder().seed(7).updater(Adam(lr))
            .dtype(F32).graph_builder().add_inputs("in")
            .add_layer("h", Dense(n_out=16, activation="tanh"), "in")
            .add_layer("out", Output(n_out=3, activation="softmax",
                                     loss="mcxent"), "h")
            .set_outputs("out").set_input_types(InputType.feed_forward(5))
            .build())
    return ComputationGraph(conf, device="cpu").init()


# ------------------------------------------------------------ terminations
def test_termination_conditions():
    assert MaxEpochsTermination(3).terminate(2, 1.0)
    assert not MaxEpochsTermination(3).terminate(1, 1.0)
    assert MaxScoreEpochTermination(5.0).terminate(0, 6.0)
    assert InvalidScoreEpochTermination().terminate(0, float("nan"))
    assert InvalidScoreEpochTermination().terminate(0, float("inf"))
    c = ScoreImprovementEpochTermination(2)
    c.initialize()
    assert not c.terminate(0, 1.0)
    assert not c.terminate(1, 0.9)   # improved
    assert not c.terminate(2, 0.95)  # 1 without improvement
    assert not c.terminate(3, 0.92)  # 2 without improvement
    assert c.terminate(4, 0.91)      # 3 > max of 2
    t = MaxTimeIterationTermination(max_seconds=0.0)
    t.initialize()
    assert t.terminate(0, 1.0)
    assert BestScoreEpochTermination(0.5).terminate(0, 0.4)
    assert not BestScoreEpochTermination(0.5).terminate(0, 0.6)
    assert MaxScoreIterationTermination(2.0).terminate(0, 3.0)
    assert InvalidScoreIterationTermination().terminate(0, float("nan"))
    assert not InvalidScoreIterationTermination().terminate(0, 1.0)


# ----------------------------------------------------------------- trainer
def test_early_stopping_trainer_max_epochs_and_best_model():
    x, y = make_problem()
    net = make_net()
    saver = InMemoryModelSaver()
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(
            ArrayDataSetIterator(x, y, batch_size=128)),
        epoch_terminations=[MaxEpochsTermination(8)],
        model_saver=saver,
    )
    trainer = EarlyStoppingTrainer(
        cfg, net, ArrayDataSetIterator(x, y, batch_size=64))
    result = trainer.fit()
    assert result.termination_reason == "MaxEpochsTermination"
    assert result.total_epochs == 8
    assert result.best_model is not None
    assert result.best_model_score <= min(result.score_vs_epoch.values()) + 1e-9
    # the best model scores what was recorded
    calc = DataSetLossCalculator(ArrayDataSetIterator(x, y, batch_size=128))
    assert abs(calc.calculate_score(result.best_model)
               - result.best_model_score) < 1e-5


def test_early_stopping_stops_on_no_improvement():
    x, y = make_problem()
    net = make_net(updater=Sgd(1e-6))  # a rate so small nothing improves
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(
            ArrayDataSetIterator(x, y, batch_size=128)),
        epoch_terminations=[
            ScoreImprovementEpochTermination(2, min_improvement=1e-3),
            MaxEpochsTermination(50),
        ],
    )
    result = EarlyStoppingTrainer(
        cfg, net, ArrayDataSetIterator(x, y, batch_size=64)).fit()
    assert result.termination_reason == "ScoreImprovementEpochTermination"
    assert result.total_epochs < 50


def test_iteration_termination_stops_mid_epoch():
    x, y = make_problem()
    net = make_net()
    cfg = EarlyStoppingConfiguration(
        epoch_terminations=[MaxEpochsTermination(5)],
        iteration_terminations=[MaxScoreIterationTermination(-1.0)])
    result = EarlyStoppingTrainer(
        cfg, net, ArrayDataSetIterator(x, y, batch_size=64)).fit()
    assert result.termination_reason == "MaxScoreIterationTermination"
    assert net.iteration == 1 and result.best_model is None


def test_evaluation_score_calculator_and_off_schedule_epochs():
    x, y = make_problem()
    net = make_net(lr=5e-2)
    cfg = EarlyStoppingConfiguration(
        score_calculator=EvaluationScoreCalculator(
            ArrayDataSetIterator(x, y, batch_size=100)),
        epoch_terminations=[MaxEpochsTermination(5)],
        evaluate_every_n_epochs=2, save_last_model=True)
    result = EarlyStoppingTrainer(
        cfg, net, ArrayDataSetIterator(x, y, batch_size=64)).fit()
    assert sorted(result.score_vs_epoch) == [0, 2, 4]
    acc = net.evaluate(DataSet(x, y)).accuracy()
    assert result.score_vs_epoch[4] == pytest.approx(1.0 - acc, abs=1e-12)
    assert result.best_model_score < 0.1
    assert cfg.model_saver.get_latest().iteration == net.iteration


def test_local_file_saver_round_trip(tmp_path):
    x, y = make_problem()
    net = make_net()
    saver = LocalFileModelSaver(str(tmp_path))
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(
            ArrayDataSetIterator(x, y, batch_size=128)),
        epoch_terminations=[MaxEpochsTermination(2)],
        model_saver=saver,
    )
    result = EarlyStoppingTrainer(
        cfg, net, ArrayDataSetIterator(x, y, batch_size=64)).fit()
    best = saver.get_best()
    assert best.device.type == "cpu"
    assert tuple(best.output(x[:4]).shape) == (4, 3)
    assert isinstance(result.best_model, MultiLayerNetwork)
    # the loss falls in both epochs, so the best model is the last one
    assert result.best_model_epoch == 1
    assert torch.equal(best.output(x), net.output(x))


def test_local_file_saver_crash_mid_save_keeps_previous(tmp_path,
                                                        monkeypatch):
    """Write-then-rename: a crash mid-save leaves the existing
    bestModel.zip whole, and the previous model still loads."""
    x, y = make_problem()
    net = make_net()
    net.fit_batch(DataSet(x, y))
    saver = LocalFileModelSaver(str(tmp_path))
    saver.save_best(net)
    expect = saver.get_best().output(x[:4])

    def crashing_write(n, path, *a, **kw):
        with open(path, "wb") as f:
            f.write(b"partial garbage")  # a half-written zip...
        raise RuntimeError("injected crash mid-serialization")

    monkeypatch.setattr(
        "deeplearning4j_tpu_torch.utils.serialization.write_model",
        crashing_write)
    net.fit_batch(DataSet(x, y))
    with pytest.raises(RuntimeError, match="injected crash"):
        saver.save_best(net)
    # the garbage went to the temporary file (removed); the previous
    # complete model is untouched and still loads
    assert sorted(p.name for p in tmp_path.iterdir()) == ["bestModel.zip"]
    assert torch.equal(saver.get_best().output(x[:4]), expect)


@pytest.mark.parametrize("saver", ["memory", "file"])
def test_graph_trainer_through_both_savers(tmp_path, saver):
    x, y = make_problem()
    net = make_graph()
    ms = (InMemoryModelSaver() if saver == "memory"
          else LocalFileModelSaver(str(tmp_path)))
    cfg = EarlyStoppingConfiguration(
        score_calculator=EvaluationScoreCalculator(
            ArrayDataSetIterator(x, y, batch_size=128)),
        epoch_terminations=[MaxEpochsTermination(4)], model_saver=ms,
        save_last_model=True)
    assert EarlyStoppingGraphTrainer is EarlyStoppingTrainer
    result = EarlyStoppingGraphTrainer(
        cfg, net, ArrayDataSetIterator(x, y, batch_size=64)).fit()
    assert result.total_epochs == 4 and net.iteration == 16
    best = result.best_model
    assert isinstance(best, ComputationGraph)
    ev = best.evaluate(DataSet(x, y))
    assert 1.0 - ev.accuracy() == pytest.approx(result.best_model_score,
                                                abs=1e-12)
    latest = ms.get_latest()
    assert torch.equal(latest.output(x), net.output(x))
    assert latest.iteration == net.iteration


def test_early_stopping_listener_hooks():
    calls = []

    class Hooks:
        def on_start(self, cfg, net):
            calls.append("start")

        def on_epoch(self, epoch, score, cfg, net):
            calls.append(("epoch", epoch))

        def on_completion(self, result):
            calls.append(("done", result.total_epochs))

    x, y = make_problem()
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(
            ArrayDataSetIterator(x, y, batch_size=128)),
        epoch_terminations=[MaxEpochsTermination(2)])
    EarlyStoppingTrainer(cfg, make_net(),
                         ArrayDataSetIterator(x, y, batch_size=64),
                         listener=Hooks()).fit()
    assert calls == ["start", ("epoch", 0), ("epoch", 1), ("done", 2)]


# ---------------------------------------------------------------- listeners
class _Score:
    """A stand-in for ``net.score_value`` that counts host reads."""

    def __init__(self):
        self.reads = 0

    def __float__(self):
        self.reads += 1
        return 0.5


class _Net:
    def __init__(self):
        self.score_value = _Score()
        self.last_batch_examples = 4


@pytest.mark.parametrize("freq", [1, 3, 10])
def test_score_listeners_read_the_score_only_at_their_cadence(freq):
    out = io.StringIO()
    for lst in (ScoreIterationListener(freq, out=out),
                CollectScoresIterationListener(freq)):
        net = _Net()
        for i in range(1, 26):
            lst.iteration_done(net, i, 0)
        assert net.score_value.reads == 25 // freq
    assert out.getvalue().count("Score at iteration") == 25 // freq
    assert [i for i, _ in lst.scores] == list(range(freq, 26, freq))


def test_performance_listener_reads_no_score_and_refuses_mfu(monkeypatch):
    """MFU is reported since the training runtime's port: only with a
    FLOP count and a peak (none for the CPU unless DL4J_TPU_PEAK_FLOPS
    names one), and still without reading the score."""
    net = _Net()
    lst = PerformanceListener(frequency=5)
    for i in range(1, 21):
        lst.iteration_done(net, i, 0)
    assert net.score_value.reads == 0
    assert [r["iteration"] for r in lst.records] == [5, 10, 15, 20]
    assert all(r["examples_per_sec"] > 0 for r in lst.records)
    monkeypatch.delenv("DL4J_TPU_PEAK_FLOPS", raising=False)
    no_count = PerformanceListener(frequency=5, report_mfu=True)
    no_peak = PerformanceListener(frequency=5, flops_per_step=1e3)
    for i in range(1, 11):
        no_count.iteration_done(net, i, 0)
        no_peak.iteration_done(net, i, 0)
    assert all("mfu" not in r for r in no_count.records + no_peak.records)
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "1e12")
    mfu = PerformanceListener(frequency=5, flops_per_step=1e3)
    for i in range(1, 11):
        mfu.iteration_done(net, i, 0)
    assert [r["iteration"] for r in mfu.records] == [5, 10]
    assert all(0.0 < r["mfu"] <= 1.0 for r in mfu.records)
    assert net.score_value.reads == 0


def test_listeners_on_a_network_fit():
    x, y = make_problem()
    net = make_net()
    hooks = []

    class Epochs(TrainingListener):
        def on_epoch_start(self, n):
            hooks.append(("start", n.epoch))

        def on_epoch_end(self, n):
            hooks.append(("end", n.epoch))

    collect = CollectScoresIterationListener(2)
    perf = PerformanceListener(frequency=2)
    net.set_listeners(ComposableIterationListener(collect, Epochs()))
    net.add_listener(perf)
    net.fit(ArrayDataSetIterator(x, y, batch_size=64), epochs=2)
    assert [i for i, _ in collect.scores] == [2, 4, 6, 8]
    assert hooks == [("start", 0), ("end", 0), ("start", 1), ("end", 1)]
    assert net.last_batch_examples == 64
    assert [r["iteration"] for r in perf.records] == [2, 4, 6, 8]
    assert perf.records[-1]["examples_per_sec"] > 0
    # the graph calls the same hooks
    g = make_graph()
    gc = CollectScoresIterationListener(1)
    g.set_listeners(gc, Epochs())
    hooks.clear()
    g.fit(ArrayDataSetIterator(x, y, batch_size=128), epochs=1)
    assert [i for i, _ in gc.scores] == [1, 2]
    assert hooks == [("start", 0), ("end", 0)]


def test_listener_fires_after_a_tbptt_batch():
    from deeplearning4j_tpu_torch import zoo
    import dataclasses
    net = zoo.char_rnn(device="cpu", hidden=8, vocab_size=6, dtype=zoo.F32)
    net.conf = dataclasses.replace(net.conf, backprop_type="tbptt",
                                   tbptt_fwd_length=4, tbptt_bwd_length=4)
    collect = CollectScoresIterationListener(1)
    net.set_listeners(collect)
    rng = np.random.default_rng(0)
    eye = np.eye(6, dtype=np.float32)
    ids = rng.integers(0, 6, (2, 13))
    score = net.fit_batch(DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]]))
    assert collect.scores == [(1, float(score))]


def test_param_and_gradient_listener_rows():
    x, y = make_problem()
    net = make_net()
    out = io.StringIO()
    lst = ParamAndGradientIterationListener(iterations=2, file=out)
    net.set_listeners(lst)
    net.fit(ArrayDataSetIterator(x, y, batch_size=64), epochs=1)
    lines = out.getvalue().splitlines()
    header = lines[0].split("\t")
    assert header[:3] == ["n", "score", "layer_0_W_mean"]
    assert len(lines) == 3 and [ln.split("\t")[0] for ln in lines[1:]] == \
        ["2", "4"]
    assert all(len(ln.split("\t")) == len(header) for ln in lines[1:])
    # 2 layers x (W, b) x 8 columns, after n and score
    assert len(header) == 2 + 4 * 8


# ------------------------------------------------------ against the JAX package
def make_jax_net(updater):
    conf = (JNNC.builder().seed(7).updater(updater)
            .dtype(JDtypePolicy(param_dtype="float32",
                                compute_dtype="float32")).list()
            .layer(JDense(n_in=5, n_out=16, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return JMLN(conf).init()


def jax_and_port_nets(tmp_path, updater):
    """A JAX net and its zip transplant into the port, on the CPU."""
    jnet = make_jax_net(updater)
    path = tmp_path / "transplant.zip"
    jser.write_model(jnet, str(path))
    return jnet, tser.restore_multi_layer_network(str(path), device="cpu")


def _rel_close(got, want, rel, what):
    assert abs(got - want) <= rel * abs(want), (what, got, want)


SCORES = [1.0, 0.9, 0.95, 0.92, 0.91, 0.5, 0.5, 0.4999, 3.0, float("nan"),
          float("inf"), -1.0, 7.0, 0.2]

# (class name, positional arguments, keyword arguments)
CONDITIONS = [
    ("MaxEpochsTermination", (3,), {}),
    ("MaxEpochsTermination", (1,), {}),
    ("BestScoreEpochTermination", (0.5,), {}),
    ("ScoreImprovementEpochTermination", (2,), {}),
    ("ScoreImprovementEpochTermination", (1,), {"min_improvement": 0.05}),
    ("MaxScoreEpochTermination", (2.0,), {}),
    ("InvalidScoreEpochTermination", (), {}),
    ("MaxTimeIterationTermination", (), {"max_seconds": 0.0}),
    ("MaxTimeIterationTermination", (), {"max_seconds": 3600.0}),
    ("MaxScoreIterationTermination", (2.0,), {}),
    ("InvalidScoreIterationTermination", (), {}),
]


@pytest.mark.parametrize(
    "name,args,kw", CONDITIONS,
    ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(CONDITIONS)])
def test_termination_condition_matches_jax(name, args, kw):
    jc, tc = getattr(jes, name)(*args, **kw), getattr(tes, name)(*args, **kw)
    assert getattr(tc, "uses_validation_score", None) == \
        getattr(jc, "uses_validation_score", None)
    jc.initialize()
    tc.initialize()
    for i, s in enumerate(SCORES):
        assert tc.terminate(i, s) == jc.terminate(i, s), (name, i, s)


# (score calculator, epoch conditions, iteration conditions, updater,
#  evaluate_every_n_epochs)
TRAINER_CASES = {
    "loss_max_epochs": ("loss", [("MaxEpochsTermination", (6,))], [],
                        ("adam", 1e-2), 1),
    "accuracy_every_2": ("accuracy", [("MaxEpochsTermination", (5,))], [],
                         ("adam", 5e-2), 2),
    "no_improvement": ("loss",
                       [("ScoreImprovementEpochTermination", (2, 1e-3)),
                        ("MaxEpochsTermination", (50,))], [],
                       ("sgd", 1e-6), 1),
    "iteration_quiet": ("loss", [("MaxEpochsTermination", (3,))],
                        [("InvalidScoreIterationTermination", ()),
                         ("MaxScoreIterationTermination", (1e9,))],
                        ("adam", 1e-2), 1),
    "iteration_fires": ("accuracy", [("MaxEpochsTermination", (5,))],
                        [("MaxScoreIterationTermination", (0.5,))],
                        ("adam", 1e-2), 1),
}


def _trainer_config(pkg, case, data, saver):
    mod, it = (jes, JIterator) if pkg == "jax" else (tes, ArrayDataSetIterator)
    calc, epochs, iters, _, every = TRAINER_CASES[case]
    x, y = data
    held = it(x, y, batch_size=128)
    return mod.EarlyStoppingConfiguration(
        score_calculator=(mod.DataSetLossCalculator(held) if calc == "loss"
                          else mod.EvaluationScoreCalculator(held)),
        epoch_terminations=[getattr(mod, n)(*a) for n, a in epochs],
        iteration_terminations=[getattr(mod, n)(*a) for n, a in iters],
        model_saver=saver, evaluate_every_n_epochs=every,
        save_last_model=True)


def _saver(mod, kind, directory):
    return (mod.InMemoryModelSaver() if kind == "memory"
            else mod.LocalFileModelSaver(str(directory)))


@pytest.mark.parametrize("saver", ["memory", "file"])
@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_trainer_matches_jax(tmp_path, case, saver):
    _, _, _, (kind, lr), _ = TRAINER_CASES[case]
    jnet, tnet = jax_and_port_nets(
        tmp_path, JAdam(lr) if kind == "adam" else JSgd(lr))
    x, y = make_problem()
    jx, jy = x.astype(np.float64), y.astype(np.float64)
    jcfg = _trainer_config("jax", case, (jx, jy),
                           _saver(jes, saver, tmp_path / "jax"))
    tcfg = _trainer_config("port", case, (x, y),
                           _saver(tes, saver, tmp_path / "port"))
    jtrainer = jes.EarlyStoppingTrainer(
        jcfg, jnet, JIterator(jx, jy, batch_size=64))
    ttrainer = tes.EarlyStoppingTrainer(
        tcfg, tnet, ArrayDataSetIterator(x, y, batch_size=64))
    if case == "iteration_fires" and saver == "file":
        # no epoch ends, so no bestModel.zip is written: both refuse alike
        with pytest.raises(FileNotFoundError):
            jtrainer.fit()
        with pytest.raises(FileNotFoundError):
            ttrainer.fit()
        assert tnet.iteration == jnet.iteration == 1
        return
    jr, tr = jtrainer.fit(), ttrainer.fit()
    assert tr.termination_reason == jr.termination_reason
    assert (tr.total_epochs, tr.best_model_epoch) == \
        (jr.total_epochs, jr.best_model_epoch)
    assert tnet.iteration == jnet.iteration
    assert sorted(tr.score_vs_epoch) == sorted(jr.score_vs_epoch)
    for e, js in jr.score_vs_epoch.items():
        _rel_close(tr.score_vs_epoch[e], js, 1e-5, f"score of epoch {e}")
    if jr.best_model is None:
        assert tr.best_model is None and case == "iteration_fires"
        return
    _rel_close(tr.best_model_score, jr.best_model_score, 1e-5, "best score")
    np.testing.assert_allclose(
        tr.best_model.output(x).numpy(),
        np.asarray(jr.best_model.output(x), dtype=np.float32),
        atol=1e-5, rtol=0)


def _attach(mod, out_score, out_pg):
    return (mod.ScoreIterationListener(1, out=out_score),
            mod.CollectScoresIterationListener(1),
            mod.ParamAndGradientIterationListener(iterations=1, file=out_pg))


def test_listeners_match_jax_over_three_steps(tmp_path):
    jnet, tnet = jax_and_port_nets(tmp_path, JSgd(0.1))
    x, y = make_problem(n=192)
    outs = {}
    for pkg, mod, net, it in (
            ("jax", jlst, jnet, JIterator(x.astype(np.float64),
                                          y.astype(np.float64),
                                          batch_size=64)),
            ("port", tlst, tnet, ArrayDataSetIterator(x, y, batch_size=64))):
        score_out, pg_out = io.StringIO(), io.StringIO()
        lst = _attach(mod, score_out, pg_out)
        net.set_listeners(*lst)
        net.fit(it, epochs=1)
        outs[pkg] = (score_out.getvalue().splitlines(), lst[1].scores,
                     [ln.split("\t") for ln in pg_out.getvalue().splitlines()])
    (js_lines, j_scores, j_rows), (ts_lines, t_scores, t_rows) = \
        outs["jax"], outs["port"]
    assert tnet.iteration == jnet.iteration == 3
    # ScoreIterationListener: "Score at iteration i is s" for i = 1, 2, 3
    assert len(ts_lines) == len(js_lines) == 3
    for tl, jl in zip(ts_lines, js_lines):
        assert tl.rsplit(" ", 1)[0] == jl.rsplit(" ", 1)[0]
        _rel_close(float(tl.rsplit(" ", 1)[1]), float(jl.rsplit(" ", 1)[1]),
                   1e-5, tl)
    assert [i for i, _ in t_scores] == [i for i, _ in j_scores] == [1, 2, 3]
    for (i, ts), (_, js) in zip(t_scores, j_scores):
        _rel_close(ts, js, 1e-5, f"collected score {i}")
    # ParamAndGradientIterationListener: the header, then one row a step
    assert t_rows[0] == j_rows[0] and len(t_rows) == len(j_rows) == 4
    assert [r[0] for r in t_rows[1:]] == [r[0] for r in j_rows[1:]] == \
        ["1", "2", "3"]
    t_vals = np.array([[float(v) for v in r[1:]] for r in t_rows[1:]])
    j_vals = np.array([[float(v) for v in r[1:]] for r in j_rows[1:]])
    tol = 1e-5 * np.abs(j_vals).max(axis=0) + 1e-7
    bad = np.abs(t_vals - j_vals) > tol
    assert not bad.any(), [j_rows[0][1 + c] for c in np.nonzero(bad)[1]]
