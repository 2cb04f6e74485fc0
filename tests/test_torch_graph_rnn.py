"""The port's ComputationGraph on its recurrent path: truncated BPTT
(``_fit_tbptt``), ``rnn_time_step`` and ``rnn_clear_previous_state``,
against the JAX package on the CPU, on graphs transplanted through the
zip.

The graph is the skip-connected char-RNN of DL4J's CompGraphLSTMExample at
a small width: two GravesLSTMs ("first" feeds "second"), both merged
(MergeVertex) into an RnnOutput, hidden 8, over 5 one-hot symbols, F32.

Tolerances, each with its reason:

- F32 scores, parameters and Adam slots after tBPTT batches: 1e-5
  (F32_TOL) of each tensor's largest magnitude. The same f32 LSTM
  arithmetic; sums in another order, carried through 8 updates.
- Streaming against one-shot and against the JAX package, F32: 1e-6
  absolute on probabilities (the same f32 arithmetic; a carry handed
  from call to call is the same tensor the one-shot loop keeps).
- F64 (the multi-input static + sequence graph, the JAX package's own
  test at 1e-8): 1e-10 absolute.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JPolicy
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.conf import layers_recurrent as jrec
from deeplearning4j_tpu.nn.conf import vertices as jvert
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.nn.updater import Exponential as JExp
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets import MultiDataSet as TMDS
from deeplearning4j_tpu_torch.nn import multistep
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy as TPolicy
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT
from deeplearning4j_tpu_torch.nn.conf import layers_recurrent as trec
from deeplearning4j_tpu_torch.nn.conf import vertices as tvert
from deeplearning4j_tpu_torch.nn.updater import Adam as TAdam
from deeplearning4j_tpu_torch.nn.updater import Exponential as TExp
from deeplearning4j_tpu_torch.ops import lstm as tlstm
from deeplearning4j_tpu_torch.utils import serialization as tser

F32_TOL = 1e-5
PROB_TOL = 1e-6
V, H, T, L = 5, 8, 16, 4


def _skip_rnn(jax_side, tbptt=L, static=False, dtype="float32"):
    """in -> first -> second; merge(first, second) -> out. Adam(1e-2) with
    an exponential schedule of rate 0.5 a step, so an update at the wrong
    iteration shows at once. ``static`` adds a 2-D input ("ctx", 3
    features) repeated over time (DuplicateToTimeSeriesVertex) and merged
    in too."""
    nnc, R, Vx, it, pol, adam, exp = (
        (JNNC, jrec, jvert, JIT, JPolicy, JAdam, JExp) if jax_side else
        (TNNC, trec, tvert, TIT, TPolicy, TAdam, TExp))
    g = (nnc.builder().seed(3).updater(adam(1e-2))
         .lr_schedule(exp(decay_rate=0.5))
         .dtype(pol(param_dtype=dtype, compute_dtype=dtype))
         .graph_builder())
    g = g.add_inputs("in", "ctx") if static else g.add_inputs("in")
    g.add_layer("first", R.GravesLSTM(n_out=H, activation="tanh"), "in")
    g.add_layer("second", R.GravesLSTM(n_out=H, activation="tanh"), "first")
    merged = ["first", "second"]
    if static:
        g.add_vertex("dup", Vx.DuplicateToTimeSeriesVertex(seq_input="in"),
                     "ctx")
        merged.append("dup")
    g.add_vertex("merge", Vx.MergeVertex(), *merged)
    g.add_layer("out", R.RnnOutput(n_out=V, activation="softmax",
                                   loss="mcxent"), "merge")
    types = [it.recurrent(V)] + ([it.feed_forward(3)] if static else [])
    g = g.set_outputs("out").set_input_types(*types)
    if tbptt:
        g = g.backprop_type("tbptt", tbptt, tbptt)
    return g.build()


def _pair(tmp_path, **kw):
    jnet = JGraph(_skip_rnn(True, **kw)).init()
    path = tmp_path / "skip.zip"
    jser.write_computation_graph(jnet, str(path))
    return jnet, tser.restore_computation_graph(str(path), device="cpu")


def _batch(seed, t=T, b=3, static=False, masked=False):
    rng = np.random.default_rng(seed)
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (b, t))]
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (b, t))]
    feats = [x] + ([rng.normal(size=(b, 3)).astype(np.float32)]
                   if static else [])
    fm = lm = None
    if masked:
        m = np.ones((b, t), np.float32)
        m[1, t - 5:] = 0.0
        fm = [m] + ([None] if static else [])
        lm = [m]
    return feats, [y], fm, lm


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a, np.float64)


def _close_max(got, want, rel, what):
    got, want = _np(got), _np(want)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), f"{what}: {err:.3e}"


def _trees_close(tnet, jnet, rel=F32_TOL):
    for ln, lp in tnet.params.items():
        for k, t in lp.items():
            _close_max(t, jnet.params[ln][k], rel, f"param {ln}.{k}")
    for ln, st in tnet.opt_state.items():
        if not isinstance(st, dict):
            continue
        for slot in ("m", "v"):
            for k, t in st.get(slot, {}).items():
                _close_max(t, jnet.opt_state[ln][slot][k], rel,
                           f"{slot} {ln}.{k}")
        assert int(st["t"]) == int(jnet.opt_state[ln]["t"]), ln


# ------------------------------------------------------------ tBPTT
@pytest.mark.parametrize("case", ["plain", "masked", "static_input"])
def test_graph_tbptt_two_batches_match_jax(tmp_path, case):
    """Parameters, Adam slots and counters, and scores after 2 batches of
    4 windows each, against the JAX package's ``_fit_tbptt``."""
    static = case == "static_input"
    jnet, tnet = _pair(tmp_path, static=static)
    for seed in (0, 1):
        feats, labels, fm, lm = _batch(seed, static=static,
                                       masked=case == "masked")
        js = float(jnet.fit_batch(JMDS(feats, labels, fm, lm)))
        ts = float(tnet.fit_batch(TMDS(feats, labels, fm, lm)))
        assert abs(ts - js) <= F32_TOL * abs(js), (ts, js)
    assert tnet.iteration == jnet.iteration == 2
    assert int(tnet.opt_state["first"]["t"]) == 2 * T // L
    _trees_close(tnet, jnet)
    assert tnet.state == {} and not jax.tree_util.tree_leaves(jnet.state)


def test_every_window_reads_the_batch_iteration(tmp_path, monkeypatch):
    """The schedule halves the rate each iteration: each of a batch's 4
    windows is updated at the batch's iteration (0, then 1), never at a
    window count."""
    _, tnet = _pair(tmp_path)
    seen = []
    real = multistep.train_step

    def spy(net, batch, advance=True):
        seen.append((int(multistep.device_iteration(net)), advance))
        return real(net, batch, advance)

    monkeypatch.setattr(multistep, "train_step", spy)
    for seed in (0, 1):
        tnet.fit_batch(TMDS(*_batch(seed)[:2]))
    assert seen == [(0, False)] * 4 + [(1, False)] * 4


def test_windows_carry_h_and_restart_each_batch(tmp_path, monkeypatch):
    """The LSTMs' first window starts from zeros, the others from the
    previous window's carry, and no carry is left in the state."""
    _, tnet = _pair(tmp_path)
    seen = []
    apply = tlstm.LstmSequenceFn.apply

    def spy(xz_t, h0, c0, *args):
        seen.append(float(h0.abs().sum()))
        return apply(xz_t, h0, c0, *args)

    monkeypatch.setattr(tlstm.LstmSequenceFn, "apply", spy)
    for seed in (0, 1):
        tnet.fit_batch(TMDS(*_batch(seed)[:2]))
        assert tnet.state == {}
    windows = T // L
    assert len(seen) == 2 * 2 * windows
    for b in range(2):
        got = seen[b * 2 * windows:(b + 1) * 2 * windows]
        assert got[:2] == [0.0, 0.0]
        assert all(v > 0.0 for v in got[2:])


def test_single_window_batch_equals_standard_backprop(tmp_path):
    """A batch within one window takes the standard step, as a graph
    without tBPTT does (the JAX package's property)."""
    jnet = JGraph(_skip_rnn(True)).init()
    path = tmp_path / "one.zip"
    jser.write_computation_graph(jnet, str(path))
    a = tser.restore_computation_graph(str(path), device="cpu")
    b = tser.restore_computation_graph(str(path), device="cpu")
    b.conf = dataclasses.replace(b.conf, backprop_type="standard")
    feats, labels, _, _ = _batch(2, t=L)
    assert torch.equal(a.fit_batch(TMDS(feats, labels)),
                       b.fit_batch(TMDS(feats, labels)))
    for ln, lp in a.params.items():
        for k, t in lp.items():
            assert torch.equal(t, b.params[ln][k]), (ln, k)


def test_tbptt_refuses_2d_labels_and_unequal_lengths_as_jax(tmp_path):
    jnet, tnet = _pair(tmp_path, static=True)
    feats, labels, _, _ = _batch(3, static=True)
    msgs = []
    for bad in ([labels[0][:, 0, :]], [labels[0][:, :T - 2, :]]):
        for net, mds in ((jnet, JMDS), (tnet, TMDS)):
            with pytest.raises(ValueError) as e:
                net.fit_batch(mds(feats, bad))
            msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "2d (sequence-classification)" in msgs[0]
    assert msgs[2] == msgs[3] and "share one time length" in msgs[2]
    assert tnet.iteration == 0


def test_fit_batch_repeated_and_fit_run_tbptt_per_batch(tmp_path):
    """fit_batch_repeated(n) is n fit_batch calls, and fit runs one batch
    at a time (multi_step resolves to 1), as in the JAX package."""
    _, a = _pair(tmp_path)
    b = a.clone()
    feats, labels, _, _ = _batch(4)
    a.fit_batch_repeated(TMDS(feats, labels), 2)
    b.fit_batch(TMDS(feats, labels))
    b.fit_batch(TMDS(feats, labels))
    assert a.iteration == b.iteration == 2
    for ln, lp in a.params.items():
        for k, t in lp.items():
            assert torch.equal(t, b.params[ln][k]), (ln, k)
    assert multistep.resolve_multi_step(a, 8) == 1
    a.fit([TMDS(feats, labels)] * 2, multi_step=8)
    assert a.iteration == 4 and a.state == {}


# ------------------------------------------------------------ streaming
def test_rnn_time_step_chunked_and_single_step_match_jax(tmp_path):
    jnet, tnet = _pair(tmp_path, tbptt=None)
    rng = np.random.default_rng(5)
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (3, 7))]
    full = _np(tnet.output(x))
    _close_max(full, jnet.output(x), PROB_TOL, "one-shot vs JAX")
    tnet.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    parts = []
    for sl in (slice(0, 3), slice(3, 4), slice(4, 7)):
        got = tnet.rnn_time_step(x[:, sl])
        _close_max(got, jnet.rnn_time_step(x[:, sl]), PROB_TOL,
                   f"chunk {sl} vs JAX")
        parts.append(_np(got))
    np.testing.assert_allclose(np.concatenate(parts, 1), full, atol=PROB_TOL,
                               rtol=0)
    tnet.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    for t in range(3):
        s = tnet.rnn_time_step(x[:, t])
        assert tuple(s.shape) == (3, V)
        _close_max(s, jnet.rnn_time_step(x[:, t]), PROB_TOL, f"step {t}")
        np.testing.assert_allclose(_np(s), full[:, t], atol=PROB_TOL, rtol=0)


def test_rnn_clear_previous_state_restarts_the_stream(tmp_path):
    _, tnet = _pair(tmp_path, tbptt=None)
    x = _batch(6, t=4)[0][0]
    first = tnet.rnn_time_step(x)
    second = tnet.rnn_time_step(x)
    assert not torch.equal(first, second)
    assert "h" in tnet._rnn_state["first"]
    tnet.rnn_clear_previous_state()
    assert tnet._rnn_state is None
    assert torch.equal(tnet.rnn_time_step(x), first)
    assert "h" not in tnet.state.get("first", {})


def test_rnn_time_step_static_plus_sequence_matches_jax(tmp_path):
    """The JAX package's multi-input case (tests/test_graph.py): a static
    2-D input beside the sequence, fed whole to every single step, F64."""
    jnet = JGraph(_skip_rnn(True, tbptt=None, static=True,
                            dtype="float64")).init()
    path = tmp_path / "static.zip"
    jser.write_computation_graph(jnet, str(path))
    tnet = tser.restore_computation_graph(str(path), device="cpu")
    rng = np.random.default_rng(7)
    ctx = rng.normal(size=(2, 3))
    seq = rng.normal(size=(2, 6, V))
    full = _np(tnet.output(seq, ctx))
    np.testing.assert_allclose(full, _np(jnet.output(seq, ctx)), atol=1e-10,
                               rtol=0)
    tnet.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    for i in range(6):
        s = tnet.rnn_time_step(seq[:, i, :], ctx)
        assert tuple(s.shape) == (2, V)
        np.testing.assert_allclose(_np(s), full[:, i], atol=1e-10, rtol=0)
        np.testing.assert_allclose(_np(s), _np(jnet.rnn_time_step(
            seq[:, i, :], ctx)), atol=1e-10, rtol=0)
