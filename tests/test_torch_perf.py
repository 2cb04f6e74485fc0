"""Step FLOPs and MFU (deeplearning4j_tpu_torch/utils/perf.py, the nets'
``step_cost_analysis``, ``PerformanceListener(report_mfu=True)``) and
``ProfilerListener``, on the CPU.

- Each kernel's analytic FLOP formula (what its wrapper reports on the
  card, where FlopCounterMode cannot see a ``ctypes`` launch) equals
  FlopCounterMode's count of its plain version at a small shape: exact.
- ``step_cost_analysis`` of a dense net and of LeNet equals the analytic
  count of their products and convolutions (forward, and the backward's
  weight and input gradients where autograd needs them): exact.
- Its ratio to the JAX package's ``step_cost_analysis`` (XLA's cost
  model, which counts elementwise work too) lies in (0, 1].
"""

import json
import logging

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, _leaves
from deeplearning4j_tpu_torch.ops import attention, fused_block, lstm, registry
from deeplearning4j_tpu_torch.optimize import listeners as tlst
from deeplearning4j_tpu_torch.utils import perf
from deeplearning4j_tpu_torch.utils import serialization as tser

F32 = DtypePolicy(param_dtype="float32", compute_dtype="float32")


def _counted(fn, *args, **kw):
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return fc.get_total_flops()


def _r(*shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _lstm_fwd():
    T, b, n = 3, 4, 8
    args = (_r(T, b, 4 * n), _r(b, n), _r(b, n), _r(n, 4 * n), _r(3, n),
            torch.ones(T, b))
    return (_counted(lstm.lstm_sequence_torch, *args, save_residuals=True),
            lstm.fwd_flops(T, b, n))


def _lstm_bwd():
    T, b, n = 3, 4, 8
    fwd = lstm.lstm_sequence_torch(_r(T, b, 4 * n), _r(b, n), _r(b, n),
                                   _r(n, 4 * n), _r(3, n), torch.ones(T, b),
                                   save_residuals=True)
    res = (fwd.G, fwd.h_prev, fwd.c_prev)
    got = _counted(lstm.lstm_sequence_bwd_torch, res, torch.ones(T, b),
                   _r(n, 4 * n), _r(3, n), _r(T, b, n), _r(b, n), _r(b, n))
    return got, lstm.bwd_flops(T, b, n)


def _flash():
    b, T, h, dh = 2, 16, 2, 64
    q, k, v = (_r(b, T, h, dh, seed=s) for s in range(3))
    return (_counted(attention.flash_attn_fwd_torch, q, k, v),
            attention.flash_flops(b, T, h, dh))


M, K, N = 24, 8, 16


def _fused(name):
    x2, W = _r(M, K), _r(K, N, seed=1)
    vec = lambda s: _r(N, seed=s).abs() + 0.5  # noqa: E731
    dy, y = _r(M, N, seed=2), _r(M, N, seed=3)
    call = {
        fused_block.STATS: lambda: fused_block.fused_stats_torch(
            x2, W, vec(4)),
        fused_block.APPLY: lambda: fused_block.fused_apply_torch(
            x2, W, vec(4), vec(5), y, True),
        fused_block.BWD_STATS: lambda: fused_block.fused_bwd_stats_torch(
            x2, W, vec(4), vec(5), dy, y, True),
        fused_block.BWD_APPLY: lambda: fused_block.fused_bwd_apply_torch(
            x2, W, vec(4), vec(5), vec(6), vec(7), vec(8), dy, y, True),
    }[name]
    return _counted(call), fused_block.flops(name, M, K, N)


KERNELS = {"K1 lstm_fwd": _lstm_fwd, "K2 lstm_bwd": _lstm_bwd,
           "K3 flash_attn_fwd": _flash,
           "K4 fused_stats": lambda: _fused(fused_block.STATS),
           "K5 fused_apply": lambda: _fused(fused_block.APPLY),
           "K6 fused_bwd_stats": lambda: _fused(fused_block.BWD_STATS),
           "K7 fused_bwd_apply": lambda: _fused(fused_block.BWD_APPLY)}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernel_flop_formula_is_flopcounters_count_of_its_plain_version(
        kernel):
    counted, formula = KERNELS[kernel]()
    assert counted == formula > 0


def _dense_net():
    conf = (NeuralNetConfiguration.builder().seed(7).updater(Adam(1e-2))
            .dtype(F32).list()
            .layer(Dense(n_in=5, n_out=16, activation="tanh"))
            .layer(Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _dense_data(b=8):
    rng = np.random.default_rng(0)
    return DataSet(rng.normal(size=(b, 5)).astype(np.float32),
                   np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)])


def _lenet_data(b=4):
    rng = np.random.default_rng(1)
    return DataSet(rng.normal(size=(b, 28, 28, 1)).astype(np.float32),
                   np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)])


def _analytic(kind, b):
    """Products and convolutions of one step: forward 2·m·k·n each; the
    backward adds the weight gradient, and the input gradient below the
    first layer."""
    if kind == "dense":
        return 2 * b * (5 * 16 * 2 + 16 * 3 * 3)
    conv1 = 24 * 24 * 20 * (1 * 25)       # 28 -> 24, 1 -> 20 channels
    conv2 = 8 * 8 * 50 * (20 * 25)        # 12 -> 8, 20 -> 50 channels
    return 2 * b * (conv1 * 2 + conv2 * 3 + 800 * 500 * 3 + 500 * 10 * 3)


NETS = {"dense": (_dense_net, _dense_data),
        "lenet": (lambda: tzoo.lenet(device="cpu", dtype=tzoo.F32),
                  _lenet_data)}


@pytest.mark.parametrize("kind", sorted(NETS))
def test_step_cost_analysis_counts_products_and_convolutions(kind):
    make, data = NETS[kind]
    net, ds = make(), data()
    before = [t.clone() for t in _leaves(net.params)]
    gen = net._gen.get_state()
    registry.reset_launches()
    cost = net.step_cost_analysis(ds)
    assert cost["flops"] == _analytic(kind, ds.num_examples)
    assert cost["kernel_flops"] == {}          # no kernel on the CPU
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(net.params)))
    assert torch.equal(gen, net._gen.get_state())
    assert registry.launches() == {} and net.iteration == 0


def test_step_flop_count_includes_what_the_kernels_report():
    """On the card the kernels' counts join FlopCounterMode's; here a
    stand-in kernel shows the sum and that it adds no launch."""
    net, ds = _dense_net(), _dense_data()
    plain = net.step_cost_analysis(ds)["flops"]
    real_loss = net._loss

    def loss_with_kernel(*a, **k):
        registry.count_launch("k")
        registry.count_flops("k", 1000.0)
        return real_loss(*a, **k)

    net._loss = loss_with_kernel
    registry.reset_launches()
    cost = net.step_cost_analysis(ds)
    assert cost["flops"] == plain + 1000.0
    assert cost["kernel_flops"] == {"k": 1000.0}
    assert registry.launches() == {}


@pytest.mark.parametrize("kind", ["dense", "lenet"])
def test_step_flops_ratio_to_jax_cost_model(kind, tmp_path):
    """XLA's cost model counts elementwise work as well, so the port's
    count is at most the JAX package's; the ratio is printed (PERF.md)."""
    make, data = NETS[kind]
    tnet, ds = make(), data()
    path = str(tmp_path / "net.zip")
    tser.write_model(tnet, path)
    jnet = jser.restore_multi_layer_network(path)
    ours = tnet.step_cost_analysis(ds)["flops"]
    xla = jnet.step_cost_analysis(JDataSet(ds.features, ds.labels))["flops"]
    print(f"{kind}: port {ours:.0f} / XLA {xla:.0f} = {ours / xla:.4f}")
    assert 0.0 < ours <= xla


def test_peak_flops_by_card_name_and_override(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_PEAK_FLOPS", raising=False)
    assert perf.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert perf.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert perf.peak_flops("cpu") is None
    assert perf.peak_flops(torch.device("cpu")) is None
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "2e12")
    assert perf.peak_flops("cpu") == 2e12
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "not a number")
    assert perf.peak_flops("NVIDIA H100 PCIe") == 756e12


def test_performance_listener_reports_mfu_from_the_derived_count(
        monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "1e15")
    net, ds = _dense_net(), _dense_data()
    lst = tlst.PerformanceListener(frequency=1, report_mfu=True)
    net.set_listeners(lst)
    for _ in range(4):
        net.fit_batch(ds)
    assert net.flops_per_step == net.step_cost_analysis(ds)["flops"]
    assert len(lst.records) == 3
    assert all(0.0 < r["mfu"] <= 1.0 for r in lst.records)


def test_profiler_listener_writes_a_chrome_trace(tmp_path):
    net = _dense_net()
    lst = tlst.ProfilerListener(str(tmp_path), start_iteration=2,
                                num_iterations=2)
    net.set_listeners(lst)
    ds = _dense_data(64)
    net.fit(ArrayDataSetIterator(ds.features, ds.labels, 8), epochs=1)
    assert lst.captured and lst.trace_path.endswith("trace_2_4.json")
    with open(lst.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    assert net.iteration == 8


def test_profiler_listener_failure_turns_profiling_off(tmp_path,
                                                       monkeypatch, caplog):
    """The reference's rule: log, then profile no more; training goes
    on."""
    import torch.profiler as tp

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(tp, "profile", broken)
    net = _dense_net()
    lst = tlst.ProfilerListener(str(tmp_path), start_iteration=1,
                                num_iterations=2)
    net.set_listeners(lst)
    with caplog.at_level(logging.WARNING):
        for _ in range(5):
            net.fit_batch(_dense_data())
    assert lst.captured and lst.trace_path is None and net.iteration == 5
    assert sum("ProfilerListener" in r.message for r in caplog.records) == 1
