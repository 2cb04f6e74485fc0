"""The port's fault-tolerant training runtime (deeplearning4j_tpu_torch/
resilience) on the CPU.

Every recovery path is driven through the deterministic fault injector,
as tests/test_resilience.py drives the JAX package's: a crash between the
tree commit and the meta rename, transient step failures, poisoned
parameters, preemption (requested, by SIGTERM, and by SIGKILL of a child
process). Each of that file's single-process scenarios has its
counterpart here on the same small F64 nets (5 -> 7 tanh -> 3 softmax,
Adam), where the survivor's parameters must equal an uninterrupted
``fit_batch`` run's bit for bit.

Against the JAX package, on a zip-transplanted F32 net and the same fault
schedule through both supervisors: the same recovery events (kind,
step), the same retained ``step_<n>`` directories, the same ``meta.json``
keys and counters, and final parameters within 1e-5 (f32 Adam over 12
steps, the same arithmetic in another order).

Restoring into a net whose step was captured: capture needs the card, so
here the captured step's ``_rebind`` runs on the CPU after the restore
replaced the trees, and the eager steps that follow continue the
uninterrupted trajectory bit for bit.
"""

import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import resilience as jres
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import datapipe
from deeplearning4j_tpu_torch import resilience as tres
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import multistep
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam
from deeplearning4j_tpu_torch.observability.goodput import RunReport
from deeplearning4j_tpu_torch.optimize.listeners import RecoveryEventListener
from deeplearning4j_tpu_torch.resilience import (
    FaultInjector,
    InjectedCrash,
    SupervisorConfig,
    TrainingDivergedError,
    TrainingSupervisor,
    TransientStepError,
    resilient_fit,
)
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu_torch.utils.checkpoint import (
    IncompleteCheckpointError,
    find_latest_checkpoint,
    is_valid_checkpoint,
    read_checkpoint_meta,
    restore_multi_layer_network,
    save_checkpoint,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = DtypePolicy(param_dtype="float64", compute_dtype="float64")


def _mln(seed=3):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
            .dtype(F64).list()
            .layer(Dense(n_in=5, n_out=7, activation="tanh"))
            .layer(Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(32, 5))
    y = np.eye(3)[rng.integers(0, 3, 32)]
    return DataSet(x, y)


def _params(net):
    return {(n, k): v.detach().cpu().numpy() for n, sub in net.params.items()
            for k, v in sub.items()}


def _assert_params_equal(a, b):
    pa, pb = _params(a), _params(b)
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=str(k))


def _reference(steps, ds=None, seed=3):
    net = _mln(seed)
    ds = ds or _data()
    for _ in range(steps):
        net.fit_batch(ds)
    return net


def _steps_on_disk(d):
    return sorted(n for n in os.listdir(str(d)) if n.startswith("step_"))


# ---------------------------------------------------------------------------
# Checkpoint discovery and partial saves
# ---------------------------------------------------------------------------

def test_find_latest_checkpoint_skips_partial(tmp_path):
    ds = _data()
    net = _mln()
    net.fit_batch(ds)
    save_checkpoint(net, str(tmp_path / "step_1"))
    net.fit_batch(ds)
    save_checkpoint(net, str(tmp_path / "step_2"))
    os.remove(str(tmp_path / "step_2" / "meta.json"))
    assert not is_valid_checkpoint(str(tmp_path / "step_2"))
    assert find_latest_checkpoint(str(tmp_path)).endswith("step_1")
    (tmp_path / "not_a_step").mkdir()
    (tmp_path / "step_x").mkdir()
    assert find_latest_checkpoint(str(tmp_path)).endswith("step_1")
    assert find_latest_checkpoint(str(tmp_path / "missing")) is None


def test_restore_partial_checkpoint_names_directory(tmp_path):
    net = _mln()
    net.fit_batch(_data())
    path = str(tmp_path / "step_1")
    save_checkpoint(net, path)
    os.remove(os.path.join(path, "meta.json"))
    with pytest.raises(IncompleteCheckpointError, match="step_1"):
        restore_multi_layer_network(path, device="cpu")


# ---------------------------------------------------------------------------
# Periodic checkpoints, the latest pointer, retention GC, bit identity
# ---------------------------------------------------------------------------

def test_supervised_fit_matches_plain_fit_and_retains_k(tmp_path):
    ds = _data()
    ref = _reference(10, ds)
    net = _mln()
    res = resilient_fit(net, ds, checkpoint_dir=str(tmp_path), epochs=10,
                        checkpoint_every_steps=3, keep_checkpoints=2)
    assert res.status == "completed" and res.final_step == 10
    # the run's goodput report, returned and written beside the steps
    assert isinstance(res.report, RunReport)
    assert res.report.kind == "resilient_fit" and res.report.steps == 10
    assert RunReport.load(str(tmp_path / "run_report.json")).steps == 10
    _assert_params_equal(ref, net)
    assert _steps_on_disk(tmp_path) == ["step_10", "step_9"]
    with open(tmp_path / "LATEST") as f:
        assert f.read() == "step_10"
    assert res.stats["checkpoints_total"] >= 4
    assert res.stats["checkpoints_gc_total"] >= 1


def test_resume_after_kill_reaches_same_final_params(tmp_path):
    ds = _data()
    ref = _reference(10, ds)
    inj = FaultInjector().crash_during_save(2)  # 0=baseline, 1=step3, 2=step6
    net = _mln()
    with pytest.raises(InjectedCrash), inj.installed():
        resilient_fit(net, ds, checkpoint_dir=str(tmp_path), epochs=10,
                      checkpoint_every_steps=3, injector=inj)
    assert not is_valid_checkpoint(str(tmp_path / "step_6"))
    assert find_latest_checkpoint(str(tmp_path)).endswith("step_3")

    relaunched = _mln()  # a new process: fresh net, same config
    res = resilient_fit(relaunched, ds, checkpoint_dir=str(tmp_path),
                        epochs=10, checkpoint_every_steps=3)
    assert res.resumed_from.endswith("step_3")
    assert res.status == "completed" and res.final_step == 10
    assert res.stats["resumes_total"] == 1
    _assert_params_equal(ref, relaunched)


def test_transient_step_failures_retried_with_backoff(tmp_path):
    ds = _data()
    ref = _reference(6, ds)
    sleeps = []
    inj = FaultInjector().fail_step(2, times=2)
    net = _mln()
    cfg = SupervisorConfig(checkpoint_dir=str(tmp_path),
                           checkpoint_every_steps=100,
                           backoff_initial_s=0.01, backoff_factor=2.0,
                           sleep_fn=sleeps.append)
    res = TrainingSupervisor(net, cfg, injector=inj).run(lambda step: ds, 6)
    assert res.status == "completed" and res.final_step == 6
    assert res.stats["retries_total"] == 2
    assert sleeps == [0.01, 0.02]
    _assert_params_equal(ref, net)


def test_retry_exhaustion_propagates(tmp_path):
    inj = FaultInjector().fail_step(1, times=10)
    net = _mln()
    cfg = SupervisorConfig(checkpoint_dir=str(tmp_path), max_step_retries=2,
                           sleep_fn=lambda s: None)
    sup = TrainingSupervisor(net, cfg, injector=inj)
    with pytest.raises(TransientStepError):
        sup.run(lambda step: _data(), 4)
    assert sup.stats.retries == 2


# ---------------------------------------------------------------------------
# The NaN sentinel: rollback and LR backoff; poison never checkpointed
# ---------------------------------------------------------------------------

def _assert_no_poison_on_disk(d):
    for name in _steps_on_disk(d):
        restored = restore_multi_layer_network(str(d / name), device="cpu")
        for arr in _params(restored).values():
            assert np.isfinite(arr).all(), f"poison saved in {name}"


def test_nan_sentinel_rolls_back_and_backs_off_lr(tmp_path):
    ds = _data()
    inj = FaultInjector().poison_step(5)
    net = _mln()
    listener = RecoveryEventListener(log=False)
    net.add_listener(listener)
    res = resilient_fit(net, ds, checkpoint_dir=str(tmp_path), epochs=10,
                        checkpoint_every_steps=2, injector=inj,
                        nan_lr_backoff=0.5)
    assert res.status == "completed" and res.final_step == 10
    assert res.stats["rollbacks_total"] == 1
    assert net._lr_scale == pytest.approx(0.5)
    for arr in _params(net).values():
        assert np.isfinite(arr).all()
    _assert_no_poison_on_disk(tmp_path)
    assert listener.counts().get("rollback") == 1
    assert "non-finite" in [e for e in listener.events
                            if e.kind == "rollback"][0].detail


def test_nan_sentinel_gives_up_after_max_rollbacks(tmp_path):
    inj = FaultInjector().poison_step(2, times=100)
    net = _mln()
    with pytest.raises(TrainingDivergedError, match="non-finite"):
        resilient_fit(net, _data(), checkpoint_dir=str(tmp_path), epochs=10,
                      checkpoint_every_steps=2, injector=inj,
                      max_nan_rollbacks=2)


def test_lazy_nan_sentinel_detects_late_and_rolls_back_clean(tmp_path):
    ds = _data()
    inj = FaultInjector().poison_step(5)
    net = _mln()
    listener = RecoveryEventListener(log=False)
    net.add_listener(listener)
    res = resilient_fit(net, ds, checkpoint_dir=str(tmp_path), epochs=10,
                        checkpoint_every_steps=4, injector=inj,
                        nan_check_every=4, nan_lr_backoff=0.5)
    assert res.status == "completed" and res.final_step == 10
    assert res.stats["rollbacks_total"] == 1
    assert res.stats["nan_check_lag_max"] == 3
    assert net._lr_scale == pytest.approx(0.5)
    rollback = [e for e in listener.events if e.kind == "rollback"][0]
    assert "step 5" in rollback.detail and "step_4" in rollback.detail
    _assert_no_poison_on_disk(tmp_path)


def test_lazy_sentinel_catches_poison_in_final_window(tmp_path):
    inj = FaultInjector().poison_step(9)
    net = _mln()
    res = resilient_fit(net, _data(), checkpoint_dir=str(tmp_path),
                        epochs=10, checkpoint_every_steps=100, injector=inj,
                        nan_check_every=4)
    assert res.status == "completed" and res.final_step == 10
    assert res.stats["rollbacks_total"] == 1
    for arr in _params(net).values():
        assert np.isfinite(arr).all()


def test_lazy_sentinel_reads_no_score_between_checks(tmp_path):
    """With nan_check_every=4 the step path converts no score to a host
    number: only the flushes at iterations 4 and 8 and the tail flush
    read them (one read per step, in windows)."""
    reads = []
    real_float = torch.Tensor.__float__

    def counting(self):
        reads.append(1)
        return real_float(self)

    net = _mln()
    sup = TrainingSupervisor(net, SupervisorConfig(
        checkpoint_dir=str(tmp_path), checkpoint_every_steps=100,
        nan_check_every=4))
    seen = []
    ds = _data()

    def batch_fn(step):
        seen.append((step, len(reads)))
        return ds

    torch.Tensor.__float__ = counting
    try:
        sup.run(batch_fn, 10)
    finally:
        torch.Tensor.__float__ = real_float
    assert [r for _, r in seen] == [0, 0, 0, 0, 4, 4, 4, 4, 8, 8]
    assert len(reads) == 10


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------

def test_preemption_checkpoints_and_resumes(tmp_path):
    ds = _data()
    ref = _reference(10, ds)
    inj = FaultInjector().preempt_at_step(4)
    net = _mln()
    res = resilient_fit(net, ds, checkpoint_dir=str(tmp_path), epochs=10,
                        checkpoint_every_steps=100, injector=inj)
    assert res.status == "preempted"
    assert res.stats["preemptions_total"] == 1
    assert res.final_step == 5
    assert find_latest_checkpoint(str(tmp_path)).endswith("step_5")

    relaunched = _mln()
    res2 = resilient_fit(relaunched, ds, checkpoint_dir=str(tmp_path),
                         epochs=10, checkpoint_every_steps=100)
    assert res2.status == "completed" and res2.final_step == 10
    assert res2.resumed_from.endswith("step_5")
    _assert_params_equal(ref, relaunched)


def test_sigterm_handler_triggers_clean_preemption(tmp_path):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal delivery requires the main thread")
    inj = FaultInjector().sigterm_at_step(3)
    net = _mln()
    prev = signal.getsignal(signal.SIGTERM)
    res = resilient_fit(net, _data(), checkpoint_dir=str(tmp_path),
                        epochs=10, checkpoint_every_steps=100, injector=inj)
    assert res.status == "preempted"
    assert res.final_step >= 3
    assert find_latest_checkpoint(str(tmp_path)) is not None
    assert signal.getsignal(signal.SIGTERM) is prev


_CHILD = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam
from deeplearning4j_tpu_torch.resilience import FaultInjector, resilient_fit
F64 = DtypePolicy(param_dtype="float64", compute_dtype="float64")
conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2))
        .dtype(F64).list()
        .layer(Dense(n_in=5, n_out=7, activation="tanh"))
        .layer(Output(n_out=3, activation="softmax", loss="mcxent")).build())
net = MultiLayerNetwork(conf, device="cpu").init()
rng = np.random.default_rng(0)
ds = DataSet(rng.normal(size=(32, 5)), np.eye(3)[rng.integers(0, 3, 32)])
inj = FaultInjector()
if {kill} is not None:
    inj.kill_at_step({kill})
res = resilient_fit(net, ds, checkpoint_dir={ckpt!r}, epochs=10,
                    checkpoint_every_steps=3, injector=inj,
                    async_checkpoints=False)
print("DONE", res.status, res.final_step, res.resumed_from)
np.savez({out!r}, **{{f"{{n}}/{{k}}": v.numpy() for n, sub in
                      net.params.items() for k, v in sub.items()}})
"""


def _child(tmp_path, kill, out):
    code = _CHILD.format(root=ROOT, kill=kill, ckpt=str(tmp_path / "ckpt"),
                         out=str(out))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)


def test_sigkill_mid_run_then_a_second_process_resumes(tmp_path):
    """kill_at_step(7) SIGKILLs a child process (no handler, no cleanup);
    a second child resumes from the step-6 checkpoint and lands on the
    uninterrupted run's parameters bit for bit."""
    first = _child(tmp_path, 7, tmp_path / "a.npz")
    assert first.returncode == -signal.SIGKILL, first.stderr[-2000:]
    assert "DONE" not in first.stdout
    assert find_latest_checkpoint(str(tmp_path / "ckpt")).endswith("step_6")
    second = _child(tmp_path, None, tmp_path / "b.npz")
    assert second.returncode == 0, second.stderr[-2000:]
    assert "DONE completed 10" in second.stdout and "step_6" in second.stdout
    got = np.load(tmp_path / "b.npz")
    for (n, k), want in _params(_reference(10)).items():
        np.testing.assert_array_equal(got[f"{n}/{k}"], want)


# ---------------------------------------------------------------------------
# ComputationGraph, the facades, lr scale
# ---------------------------------------------------------------------------

def _graph():
    g = (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2))
         .dtype(F64).graph_builder().add_inputs("in")
         .add_layer("d", Dense(n_in=4, n_out=6, activation="relu"), "in")
         .add_layer("out", Output(n_out=2, activation="softmax",
                                  loss="mcxent"), "d")
         .set_outputs("out").build())
    return ComputationGraph(g, device="cpu").init()


def test_graph_supervised_resume(tmp_path):
    rng = np.random.default_rng(2)
    mds = MultiDataSet([rng.normal(size=(8, 4))],
                       [np.eye(2)[rng.integers(0, 2, 8)]])
    ref = _graph()
    for _ in range(8):
        ref.fit_batch(mds)

    inj = FaultInjector().preempt_at_step(3)
    net = _graph()
    res = net.resilient_fit(mds, checkpoint_dir=str(tmp_path), epochs=8,
                            checkpoint_every_steps=2, injector=inj)
    assert res.status == "preempted"
    assert read_checkpoint_meta(find_latest_checkpoint(
        str(tmp_path)))["kind"] == "graph"

    relaunched = _graph()
    res2 = relaunched.resilient_fit(mds, checkpoint_dir=str(tmp_path),
                                    epochs=8, checkpoint_every_steps=2)
    assert res2.status == "completed" and res2.final_step == 8
    _assert_params_equal(ref, relaunched)


def test_multilayer_resilient_fit_method(tmp_path):
    net = _mln()
    res = net.resilient_fit(_data(), checkpoint_dir=str(tmp_path), epochs=3)
    assert res.status == "completed" and res.final_step == 3
    assert net.iteration == 3


def test_resilient_fit_on_arrays_batches_like_fit(tmp_path):
    ds = _data()
    ref = _mln()
    ref.fit(ds.features, ds.labels, epochs=2, batch_size=8)
    net = _mln()
    res = net.resilient_fit(ds.features, ds.labels,
                            checkpoint_dir=str(tmp_path), epochs=2,
                            batch_size=8)
    assert res.final_step == 8
    _assert_params_equal(ref, net)


def test_set_lr_scale_changes_step_size():
    ds = _data()
    a, b = _mln(), _mln()
    a.fit_batch(ds)
    b.set_lr_scale(0.5)
    b.fit_batch(ds)
    pa, pb = _params(a), _params(b)
    assert any(not np.array_equal(pa[k], pb[k]) for k in pa)
    with pytest.raises(ValueError):
        a.set_lr_scale(0.0)


def test_composite_chaos_run(tmp_path):
    """Crash + transient + preemption in one plan, relaunching until
    completed: the final params equal the uninterrupted run's."""
    ds = _data()
    steps = 12
    ref = _reference(steps, ds)
    inj = (FaultInjector()
           .crash_during_save(1)
           .fail_step(4, times=1)
           .preempt_at_step(8))
    final = None
    for _ in range(6):
        net = _mln()
        try:
            with inj.installed():
                res = resilient_fit(net, ds, checkpoint_dir=str(tmp_path),
                                    epochs=steps, checkpoint_every_steps=3,
                                    injector=inj, sleep_fn=lambda s: None)
        except InjectedCrash:
            continue
        if res.status == "completed":
            final = net
            break
    assert final is not None, "chaos run never completed"
    assert final.iteration == steps
    _assert_params_equal(ref, final)


# ---------------------------------------------------------------------------
# Asynchronous checkpoints
# ---------------------------------------------------------------------------

def test_async_checkpoint_crash_surfaces_at_barrier_and_resumes(tmp_path):
    ds = _data()
    ref = _reference(10, ds)
    inj = FaultInjector().crash_during_save(2)
    net = _mln()
    with pytest.raises(InjectedCrash), inj.installed():
        resilient_fit(net, ds, checkpoint_dir=str(tmp_path), epochs=10,
                      checkpoint_every_steps=3, injector=inj)
    assert net.iteration == 9  # held until the step-9 save drained it
    assert not is_valid_checkpoint(str(tmp_path / "step_6"))
    assert find_latest_checkpoint(str(tmp_path)).endswith("step_3")
    restored = restore_multi_layer_network(str(tmp_path / "step_3"),
                                           device="cpu")
    _assert_params_equal(_reference(3, ds), restored)

    relaunched = _mln()
    res = resilient_fit(relaunched, ds, checkpoint_dir=str(tmp_path),
                        epochs=10, checkpoint_every_steps=3)
    assert res.status == "completed" and res.final_step == 10
    assert res.resumed_from.endswith("step_3")
    _assert_params_equal(ref, relaunched)


def test_sync_checkpoint_mode_crashes_in_place(tmp_path):
    inj = FaultInjector().crash_during_save(2)
    net = _mln()
    with pytest.raises(InjectedCrash), inj.installed():
        resilient_fit(net, _data(), checkpoint_dir=str(tmp_path), epochs=10,
                      checkpoint_every_steps=3, injector=inj,
                      async_checkpoints=False)
    assert net.iteration == 6


def test_async_checkpoint_bit_identical_to_sync(tmp_path):
    ds = _data()
    a, b = _mln(), _mln()
    resilient_fit(a, ds, checkpoint_dir=str(tmp_path / "sync"), epochs=8,
                  checkpoint_every_steps=3, async_checkpoints=False)
    resilient_fit(b, ds, checkpoint_dir=str(tmp_path / "async"), epochs=8,
                  checkpoint_every_steps=3, async_checkpoints=True)
    _assert_params_equal(a, b)
    for d in ("sync", "async"):
        assert find_latest_checkpoint(str(tmp_path / d)).endswith("step_8")
    for step in ("step_6", "step_8"):
        x = restore_multi_layer_network(str(tmp_path / "sync" / step),
                                        device="cpu")
        y = restore_multi_layer_network(str(tmp_path / "async" / step),
                                        device="cpu")
        _assert_params_equal(x, y)


# ---------------------------------------------------------------------------
# Restore into a net with a captured step
# ---------------------------------------------------------------------------

def test_restore_into_live_net_rebinds_a_captured_step(tmp_path):
    """``_load_into`` replaces the trees; a captured step's ``_rebind``
    copies the replaced leaves into the tensors it was captured over and
    points the trees back at them; the device iteration refills; the
    steps that follow continue the uninterrupted trajectory exactly."""
    ds = _data()
    ref = _reference(6, ds)
    net = _mln()
    sg = multistep.StepGraph(net, net._step_batch(ds))
    for _ in range(3):
        net.fit_batch(ds)
    save_checkpoint(net, str(tmp_path / "step_3"))
    for _ in range(2):
        net.fit_batch(ds)
    sg._bound = multistep._tree_paths(net)   # what a capture holds
    bound = [t for _, _, t in sg._bound]
    sup = TrainingSupervisor(net, SupervisorConfig(
        checkpoint_dir=str(tmp_path)))
    sup._load_into(str(tmp_path / "step_3"))
    now = [t for _, _, t in multistep._tree_paths(net)]
    assert all(t is not b for t, b in zip(now, bound))
    assert net.iteration == 3
    assert sg._rebind()
    assert all(t is b for (_, _, t), b in zip(multistep._tree_paths(net),
                                                bound))
    _assert_params_equal(_reference(3, ds), net)
    for _ in range(3):
        net.fit_batch(ds)
    assert int(net._it_twin.tensor) == 6
    _assert_params_equal(ref, net)
    assert int(net.opt_state["layer_0"]["t"]) == 6


# ---------------------------------------------------------------------------
# What is not ported is refused by name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,item", [
    ({"coordinate": True}, "A.5"),
    ({"collective_timeout_s": 5.0}, "A.5"),
    ({"flight_recorder": True}, None),
    ({"compile_cache_dir": "cache"}, "A.4"),
], ids=["coordinate", "collective_timeout_s", "flight_recorder",
        "compile_cache_dir"])
def test_unported_config_options_refused_by_name(tmp_path, kw, item):
    if item is None:
        # ported (the flight recorder): accepted, and a preempted run
        # leaves its flight file in the checkpoint directory
        inj = FaultInjector()
        inj.preempt_at_step(2)
        with inj.installed():
            res = resilient_fit(_mln(), _data(), checkpoint_dir=str(tmp_path),
                                epochs=4, injector=inj, **kw)
        assert res.status == "preempted"
        flights = [n for n in os.listdir(str(tmp_path))
                   if n.startswith("flight_")]
        assert len(flights) == 1
        doc = json.load(open(str(tmp_path / flights[0])))
        assert doc["schema"] == 1 and doc["reason"] == "preemption"
        last = doc["events"][-1]
        assert (last["kind"], last["step"]) == ("preempt", res.final_step)
        return
    with pytest.raises(NotImplementedError, match=item):
        SupervisorConfig(checkpoint_dir=str(tmp_path), **kw)
    with pytest.raises(NotImplementedError, match=item):
        resilient_fit(_mln(), _data(), checkpoint_dir=str(tmp_path), **kw)


def test_stats_collector_and_fit_pipeline_refused_by_name(tmp_path):
    """The statistics collector is still refused (A.5); fit_pipeline is
    ported (it trains on the pipeline's batches, epoch after epoch), and
    the flight recorder is on by default, as in the JAX package."""
    cfg = SupervisorConfig(checkpoint_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="A.5"):
        TrainingSupervisor(_mln(), cfg, stats_collector=object())
    ds = _data()

    def pipe():
        return datapipe.from_arrays(ds.features, ds.labels).shuffle(
            window=8, seed=5).batch(8)

    net = _mln()
    res = TrainingSupervisor(net, cfg).fit_pipeline(pipe(), epochs=2)
    assert res.status == "completed" and res.final_step == 8
    ref, p = _mln(), pipe()
    for _ in range(2):
        for b in p:
            ref.fit_batch(b)
    _assert_params_equal(ref, net)
    assert SupervisorConfig(checkpoint_dir=str(tmp_path),
                            coordinate="auto").flight_recorder is True


# ---------------------------------------------------------------------------
# The same fault schedule through both supervisors
# ---------------------------------------------------------------------------

F32J = JDtypePolicy(param_dtype="float32", compute_dtype="float32")


def _jax_mln():
    conf = (JNNC.builder().seed(3).updater(JAdam(1e-2)).dtype(F32J).list()
            .layer(JDense(n_in=5, n_out=7, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return JMLN(conf).init()


def _data32(seed=0):
    ds = _data(seed)
    return ds.features.astype(np.float32), ds.labels.astype(np.float32)


# launches; each arms its faults (the chaos schedule: a crash during a
# save, a transient then a preemption, a crash again, a clean launch),
# then a poison with the lazy sentinel and retention 2
SCHEDULES = {
    "chaos": dict(steps=12, every=3, keep=3, nan_every=1, launches=[
        [("crash_save", 1)],
        [("transient", 4), ("preempt", 6)],
        [("crash_save", 1)],
        []]),
    "poison": dict(steps=12, every=4, keep=2, nan_every=4, launches=[
        [("poison", 5)], []]),
}


def _arm(mod, faults):
    inj = mod.FaultInjector()
    for fault, at in faults:
        if fault == "crash_save":
            inj.crash_during_save(at)
        elif fault == "transient":
            inj.fail_step(at, times=2)
        elif fault == "preempt":
            inj.preempt_at_step(at)
        elif fault == "poison":
            inj.poison_step(at)
    return inj


def _supervise(mod, make_net, make_ds, ckpt, plan):
    """Runs the plan's launches until one completes; returns (net,
    [(kind, step)], [statuses])."""
    events, outcome, net = [], [], None
    for faults in plan["launches"]:
        net = make_net()
        inj = _arm(mod, faults)
        cfg = mod.SupervisorConfig(
            checkpoint_dir=ckpt, checkpoint_every_steps=plan["every"],
            keep_checkpoints=plan["keep"], nan_check_every=plan["nan_every"],
            backoff_initial_s=0.0, handle_sigterm=False,
            sleep_fn=lambda s: None)
        sup = mod.TrainingSupervisor(net, cfg, injector=inj)
        ds = make_ds()
        try:
            with inj.installed():
                res = sup.run(lambda step: ds, plan["steps"])
            outcome.append(res.status)
        except mod.InjectedCrash:
            outcome.append("crashed")
        events += [(e.kind, e.step) for e in sup.events]
        if outcome[-1] == "completed":
            break
    return net, events, outcome


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_same_fault_schedule_as_the_jax_supervisor(tmp_path, name):
    plan = SCHEDULES[name]
    jnet0 = _jax_mln()
    zpath = str(tmp_path / "init.zip")
    jser.write_model(jnet0, zpath)
    x, y = _data32()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jnet, jev, jout = _supervise(jres, _jax_mln, lambda: JDataSet(x, y),
                                 jdir, plan)
    tnet, tev, tout = _supervise(
        tres, lambda: tser.restore_multi_layer_network(zpath, device="cpu"),
        lambda: DataSet(x, y), tdir, plan)
    assert tout == jout and tout[-1] == "completed"
    assert tev == jev
    assert _steps_on_disk(tmp_path / "port") == \
        _steps_on_disk(tmp_path / "jax")
    for step in _steps_on_disk(tmp_path / "port"):
        jm = json.load(open(os.path.join(jdir, step, "meta.json")))
        tm = json.load(open(os.path.join(tdir, step, "meta.json")))
        assert sorted(jm) == sorted(tm)
        for key in ("kind", "iteration", "epoch", "format_version"):
            assert jm[key] == tm[key], (step, key)
        assert json.loads(jm["config"]) == json.loads(tm["config"])
    assert open(os.path.join(tdir, "LATEST")).read() == \
        open(os.path.join(jdir, "LATEST")).read()
    assert tnet.iteration == jnet.iteration == plan["steps"]
    assert tnet._lr_scale == jnet._lr_scale
    for n, sub in jnet.params.items():
        for k, v in sub.items():
            np.testing.assert_allclose(
                tnet.params[n][k].numpy(), np.asarray(v), rtol=1e-5,
                atol=1e-5, err_msg=f"{n}/{k}")


# ---------------------------------------------------------------------------
# fit_pipeline: a shuffled, prefetched token stream resumed mid-epoch
# ---------------------------------------------------------------------------

PIPE_V, PIPE_T, PIPE_B = 12, 8, 4
PIPE_ALPHABET = "abcdefghijkl"
# the chaos schedule over a 3-epoch pipeline of 6 batches an epoch: a
# crash mid-epoch 1 (a step that keeps failing past its retries), a
# crash inside a save, a preemption mid-epoch 2, a clean relaunch
PIPE_EPOCHS, PIPE_EVERY = 3, 4
PIPE_PLAN = [[("crash_step", 8)], [("crash_save", 1)], [("preempt", 14)], []]


def _corpus():
    rng = np.random.default_rng(17)
    return "".join(rng.choice(list(PIPE_ALPHABET), 6 * PIPE_B * PIPE_T + 1))


def _token_pipe(mod):
    """from_text -> tokenize -> window -> shuffle -> batch -> prefetch, in
    either package (``mod`` is a ``datapipe`` module)."""
    tok = mod.CharTokenizer.fit(PIPE_ALPHABET)
    return (mod.from_text(_corpus()).tokenize(tok)
            .window(PIPE_T, vocab_size=PIPE_V)
            .shuffle(window=16, seed=9)
            .batch(PIPE_B, drop_last=True).prefetch(2))


def _small_char_rnn(pkg):
    if pkg == "jax":
        from deeplearning4j_tpu import zoo as jzoo
        return jzoo.char_rnn(vocab_size=PIPE_V, hidden=16, n_layers=1,
                             seed=5, dtype=jzoo.models.F32)
    from deeplearning4j_tpu_torch import zoo as tzoo
    return tzoo.char_rnn(vocab_size=PIPE_V, hidden=16, n_layers=1, seed=5,
                         dtype=tzoo.F32, device="cpu")


def _record_batches(net, seen):
    """Wraps ``net.fit_batch`` so each batch it trains on leaves a hash of
    its features and labels in ``seen``."""
    import hashlib
    step = net.fit_batch

    def fit_batch(ds):
        h = hashlib.sha256(np.ascontiguousarray(ds.features).tobytes())
        h.update(np.ascontiguousarray(ds.labels).tobytes())
        seen.append(h.hexdigest()[:16])
        return step(ds)

    net.fit_batch = fit_batch
    return net


def _arm_pipe(mod, faults):
    inj = mod.FaultInjector()
    for fault, at in faults:
        if fault == "crash_step":
            inj.fail_step(at, times=4)       # past max_step_retries = 3
        elif fault == "crash_save":
            inj.crash_during_save(at)
        elif fault == "preempt":
            inj.preempt_at_step(at)
    return inj


def _supervise_pipe(mod, pipe_mod, make_net, ckpt, plan=PIPE_PLAN):
    """Each launch on a fresh net and a fresh pipeline, resumed from disk
    only, until one completes: (net, per-launch [(kind, step)],
    outcomes, per-launch hashes of the batches trained on)."""
    events, outcomes, seen, net = [], [], [], None
    for faults in plan:
        seen.append([])
        net = _record_batches(make_net(), seen[-1])
        inj = _arm_pipe(mod, faults)
        cfg = mod.SupervisorConfig(
            checkpoint_dir=ckpt, checkpoint_every_steps=PIPE_EVERY,
            keep_checkpoints=3, backoff_initial_s=0.0, handle_sigterm=False,
            sleep_fn=lambda s: None)
        sup = mod.TrainingSupervisor(net, cfg, injector=inj)
        try:
            with inj.installed():
                res = sup.fit_pipeline(_token_pipe(pipe_mod),
                                       epochs=PIPE_EPOCHS)
            outcomes.append(res.status)
        except (mod.InjectedCrash, mod.TransientStepError):
            outcomes.append("crashed")
        events.append([(e.kind, e.step) for e in sup.events])
        if outcomes[-1] == "completed":
            break
    return net, events, outcomes, seen


def test_fit_pipeline_resumes_mid_epoch_bit_identical(tmp_path):
    """The chaos schedule through fit_pipeline: the survivor's params and
    Adam slots equal an uninterrupted fit_pipeline run's bit for bit, and
    the batches trained on after each restore continue the uninterrupted
    sequence (a batch trained before a crash is trained again only when
    the checkpoint the relaunch restored predates it)."""
    ref_seen = []
    ref = _record_batches(_small_char_rnn("port"), ref_seen)
    ref_res = TrainingSupervisor(ref, SupervisorConfig(
        checkpoint_dir=str(tmp_path / "ref"),
        checkpoint_every_steps=PIPE_EVERY)).fit_pipeline(
            _token_pipe(datapipe), epochs=PIPE_EPOCHS)
    steps = PIPE_EPOCHS * 6
    assert ref_res.final_step == steps == len(ref_seen)
    assert len(set(ref_seen[:6])) == 6
    assert ref_seen[:6] != ref_seen[6:12]   # each epoch its own order

    net, events, outcomes, seen = _supervise_pipe(
        tres, datapipe, lambda: _small_char_rnn("port"),
        str(tmp_path / "chaos"))
    assert outcomes == ["crashed", "crashed", "preempted", "completed"]
    assert net.iteration == steps
    # each launch trains on the uninterrupted run's batches from the step
    # it resumed at, and reaches at least the step the next one resumes
    # at: no batch skipped, none out of order
    resumes = [dict(ev).get("resume", 0) for ev in events]
    assert resumes[0] == 0 and 0 < resumes[1] <= resumes[2] <= resumes[3]
    for i, got in enumerate(seen):
        start = resumes[i]
        assert got == ref_seen[start:start + len(got)], i
        end = resumes[i + 1] if i + 1 < len(seen) else steps
        assert start + len(got) >= end, i
    assert resumes[-1] + len(seen[-1]) == steps
    for t_ref, t_got in zip(multistep._tree_paths(ref),
                            multistep._tree_paths(net)):
        assert t_ref[:2] == t_got[:2]
        assert torch.equal(t_ref[2], t_got[2]), t_ref[:2]
    meta = read_checkpoint_meta(find_latest_checkpoint(
        str(tmp_path / "chaos")))
    assert meta["datapipe"]["epoch"] == PIPE_EPOCHS


def test_fit_pipeline_same_schedule_as_the_jax_supervisor(tmp_path):
    """The same chaos schedule through both supervisors' fit_pipeline,
    over the same token pipeline built in each package, on a char-RNN
    (hidden 16, T = 8, F32) transplanted from the JAX package: the same
    outcomes, recovery events (kind, step), batches trained on and
    pipeline state in the final checkpoint; params within 1e-5 (f32 Adam
    over 18 LSTM steps, the same arithmetic in another order)."""
    from deeplearning4j_tpu import datapipe as jpipe
    jnet0 = _small_char_rnn("jax")
    zpath = str(tmp_path / "init.zip")
    jser.write_model(jnet0, zpath)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jnet, jev, jout, jseen = _supervise_pipe(
        jres, jpipe, lambda: _small_char_rnn("jax"), jdir)
    tnet, tev, tout, tseen = _supervise_pipe(
        tres, datapipe,
        lambda: tser.restore_multi_layer_network(zpath, device="cpu"), tdir)
    assert tout == jout == ["crashed", "crashed", "preempted", "completed"]
    assert tev == jev
    assert tseen == jseen
    assert _steps_on_disk(tmp_path / "port") == \
        _steps_on_disk(tmp_path / "jax")
    jm = read_checkpoint_meta(find_latest_checkpoint(jdir))
    tm = read_checkpoint_meta(find_latest_checkpoint(tdir))
    assert tm["datapipe"] == jm["datapipe"]
    assert tnet.iteration == jnet.iteration == PIPE_EPOCHS * 6
    for n, sub in jnet.params.items():
        for k, v in sub.items():
            np.testing.assert_allclose(
                tnet.params[n][k].numpy(), np.asarray(v), rtol=1e-5,
                atol=1e-5, err_msg=f"{n}/{k}")
