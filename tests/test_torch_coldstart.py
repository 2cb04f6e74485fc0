"""The port's cold start (deeplearning4j_tpu_torch/compilecache/ and the
build cache of ops/_build.py) on the CPU: the cache knob and its shared-
dir marker under threads and processes, the library key (the build dir
in use, the nvcc release) and the builders' unique temp names, the AOT
manifest and its one-message-per-field validation, a server booted
against a matching and a mismatched manifest or with a tuning report,
precompile against the JAX package's entries, precompile_fit leaving
every tensor as it was, the autotuner against the JAX package's on the
same trace (winner and objective to 1e-12), and a warm boot in a second
process that builds nothing.

There is no nvcc here: the build tests stand in a script for it that
writes the library file it is asked for (``_fake_nvcc``), and load a
stand-in for ``ctypes.CDLL``; the library key's nvcc release is
monkeypatched.
"""

import json
import os
import stat
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.compilecache import autotune as jat
from deeplearning4j_tpu.compilecache import cache as jcache
from deeplearning4j_tpu.compilecache import precompile as jpre
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.compilecache import autotune as at
from deeplearning4j_tpu_torch.compilecache import cache as ccache
from deeplearning4j_tpu_torch.compilecache import manifest as man
from deeplearning4j_tpu_torch.compilecache import precompile as pre
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import metrics as obs
from deeplearning4j_tpu_torch.observability.goodput import RunReport
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.serving import ModelServer
from deeplearning4j_tpu_torch.serving.batcher import bucket_ladder
from deeplearning4j_tpu_torch.utils import serialization as tser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cache_off_after_each_test(monkeypatch):
    """configure() is process-global (it moves _build's build dir): turn
    it back off after every test, and keep the env var out. The JAX
    entry's configure() is process-global too (jax's persistent cache
    dir and zeroed floors): left on, every later JAX compile in this
    process runs through a cache in a pytest tmp dir, so it goes off
    here as well."""
    monkeypatch.delenv(ccache.ENV_VAR, raising=False)
    yield
    ccache.deactivate()
    jcache.deactivate()
    assert _build.build_dir() == _build.BUILD_DIR


def _mlp(seed=7):
    conf = (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(Dense(n_in=4, n_out=8, activation="tanh"))
            .layer(Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    """The same MLP in both packages (the zip transplant)."""
    conf = (JConf.builder().seed(13).list()
            .layer(JDense(n_in=4, n_out=8, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    jnet = JMLN(conf).init()
    path = tmp_path_factory.mktemp("coldstart") / "m.zip"
    jser.write_model(jnet, str(path))
    return jnet, tser.restore_multi_layer_network(str(path), device="cpu")


def _fake_nvcc(tmp_path, fail=False):
    """A stand-in for nvcc: writes the ``-o`` file it is given (or fails
    with a message), so _build's build path runs without a toolkit."""
    script = tmp_path / "nvcc"
    body = ('echo "nvcc: planted failure" >&2; exit 3' if fail else
            'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"')
    script.write_text(f"#!/bin/bash\n{body}\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


# ------------------------------------------------------------------ cache
def test_configure_env_var_and_idempotence(tmp_path, monkeypatch):
    target = str(tmp_path / "kernel-cache")
    monkeypatch.setenv(ccache.ENV_VAR, target)
    got = ccache.configure(None)
    assert got == os.path.abspath(target) and os.path.isdir(got)
    assert ccache.cache_dir() == got == str(_build.build_dir())
    assert ccache.ensure_configured() == got
    # the explicit argument beats the env var; reconfiguring is allowed
    other = str(tmp_path / "other")
    assert ccache.configure(other) == os.path.abspath(other)
    assert ccache.configure(other) == os.path.abspath(other)  # idempotent
    assert ccache.shared_meta(other)["schema"] == ccache.META_SCHEMA_VERSION
    ccache.deactivate()
    assert ccache.cache_dir() is None
    assert _build.build_dir() == _build.BUILD_DIR


def test_marker_under_threads_and_processes(tmp_path):
    """8 threads configuring one dir at once, each then publishing its
    marker again, and 2 processes configuring a fresh dir at once: one
    valid marker each time, no temp file left."""
    d = str(tmp_path / "threads")
    barrier = threading.Barrier(8)
    errors = []

    def configure():
        try:
            barrier.wait(timeout=30)
            assert ccache.configure(d) == os.path.abspath(d)
            ccache.atomic_publish(d, ccache.META_NAME,
                                  {"schema": 1, "created_by": "t"})
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=configure, daemon=True) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert os.listdir(d) == [ccache.META_NAME]
    assert ccache.shared_meta(d)["schema"] == 1

    shared = str(tmp_path / "procs")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from deeplearning4j_tpu_torch.compilecache import cache\n"
            "print(cache.configure(%r))\n" % (ROOT, shared))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all(o.strip() == os.path.abspath(shared) for o, _ in outs)
    assert os.listdir(shared) == [ccache.META_NAME]
    with open(os.path.join(shared, ccache.META_NAME)) as f:
        assert json.load(f)["schema"] == ccache.META_SCHEMA_VERSION


def test_library_path_moves_with_configure_and_the_nvcc_release(
        tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_RELEASE", ["release 12.4, V12.4.131"])
    home = _build.library_path("stream_exact")
    assert home.parent == _build.BUILD_DIR
    assert home.name.startswith("libstream_exact_")
    ccache.configure(str(tmp_path / "c"))
    moved = _build.library_path("stream_exact")
    assert moved.parent == tmp_path / "c" and moved.name == home.name
    ccache.deactivate()
    assert _build.library_path("stream_exact") == home
    # another toolkit is another library
    monkeypatch.setattr(_build, "_RELEASE", ["release 12.8, V12.8.61"])
    assert _build.library_path("stream_exact").name != home.name


def test_nvcc_release_is_read_once_and_computable_without_nvcc(
        monkeypatch):
    calls = []

    def no_nvcc():
        calls.append(1)
        raise _build.KernelBuildError("nvcc not found")
    monkeypatch.setattr(_build, "_RELEASE", [])
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    assert _build.nvcc_release() == "nvcc not found"
    assert _build.library_path("lstm_fwd").name.startswith("liblstm_fwd_")
    assert calls == [1]


def test_temp_names_are_unique_per_process_and_thread():
    out = _build.BUILD_DIR / "libx_0123.so"
    names = set()
    lock = threading.Lock()

    def take():
        for _ in range(50):
            p = _build.temp_path(out)
            with lock:
                names.add(p)
    threads = [threading.Thread(target=take, daemon=True) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(names) == 400
    assert all(p.parent == out.parent and p.name.startswith(f".{out.name}.")
               and f".{os.getpid()}." in p.name and p.suffix == ".tmp"
               for p in names)


def test_build_into_the_cache_counts_and_leaves_no_temp(tmp_path,
                                                        monkeypatch):
    """Two threads building the same library into one cache dir: both
    succeed, the library is there, no temp file is left; a failing
    build raises with nvcc's output and leaves no temp file either."""
    monkeypatch.setattr(_build, "_RELEASE", ["release test"])
    # the stand-in is written once: rewritten by each thread's lookup, one
    # thread could run it while another writes it (ETXTBSY)
    nvcc = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    cache = tmp_path / "cache"
    ccache.configure(str(cache))
    before = obs.compile_snapshot()
    errors = []

    def build():
        try:
            _build.build(("flash_attn_fwd", "stream_exact"))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)
    threads = [threading.Thread(target=build, daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    names = sorted(os.listdir(cache))
    assert names == sorted([ccache.META_NAME,
                            _build.library_path("flash_attn_fwd").name,
                            _build.library_path("stream_exact").name])
    d = obs.compile_delta(before)
    assert 2 <= d["count"] == d["cache_misses"] <= 4
    bad = tmp_path / "bad"
    bad.mkdir()
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: _fake_nvcc(bad, fail=True))
    with pytest.raises(_build.KernelBuildError, match="planted failure"):
        _build.build(("lstm_fwd",))
    assert not [n for n in os.listdir(cache) if n.endswith(".tmp")]


def test_load_takes_the_env_var_at_first_use(tmp_path, monkeypatch):
    """A kernel load configures the cache from the env var itself, so a
    process that loads before any server or fit still builds there."""
    monkeypatch.setattr(_build, "_RELEASE", ["release test"])
    monkeypatch.setattr(_build, "nvcc_path", lambda: _fake_nvcc(tmp_path))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_BUILT", set())
    monkeypatch.setenv(ccache.ENV_VAR, str(tmp_path / "env-cache"))
    lib = _build.load("lstm_bwd")
    assert lib[1].startswith(str(tmp_path / "env-cache"))
    assert ccache.cache_dir() == str(tmp_path / "env-cache")


# ---------------------------------------------------------- library helper
def test_libraries_for_names_what_each_path_reaches():
    rnn = zoo.char_rnn(hidden=8, device="cpu")
    assert _build.libraries_for(rnn) == ("lstm_fwd",)
    assert _build.libraries_for(rnn, train=True) == ("lstm_fwd",
                                                     "lstm_bwd")
    gpt = zoo.gpt_mini(width=16, n_layers=1, n_heads=2, max_len=8,
                       device="cpu")
    assert _build.libraries_for(gpt) == ("flash_attn_fwd",)
    assert _build.libraries_for(gpt, decode=True) == ("flash_attn_fwd",
                                                      "stream_exact")
    assert _build.libraries_for(_mlp(), train=True, decode=True) == ()

    class Fused:                      # a graph with fused tails
        layers = ()
        _fusion_plans = {"t": object()}
    assert _build.libraries_for(Fused()) == ()
    assert _build.libraries_for(Fused(), train=True) == ("fused_block",)


def test_every_launch_counter_maps_to_its_library():
    from deeplearning4j_tpu_torch.ops import attention, fused_block, lstm
    from deeplearning4j_tpu_torch.ops import stream_exact as se
    counters = {lstm.KERNEL, lstm.KERNEL + "_sm90", lstm.BWD_KERNEL,
                lstm.BWD_KERNEL + "_sm90", lstm.FWD_WIDE, lstm.BWD_WIDE,
                attention.KERNEL, attention.KERNEL_SM90,
                attention.KERNEL_WIDE, se.KERNEL_DENSE, se.KERNEL_MHA,
                se.KERNEL_NORM, *fused_block.SM90_COUNTER,
                *fused_block.SM90_COUNTER.values()}
    assert counters == set(_build.COUNTER_LIBRARY)
    assert set(_build.COUNTER_LIBRARY.values()) == set(_build.KERNELS)


# --------------------------------------------------------------- manifest
def _entry(net, max_batch=8):
    return {"row_shapes": [[4]], "ladder": bucket_ladder(2, max_batch),
            "max_batch": max_batch, "min_batch": 2,
            "compute_dtype": "float32", "mesh_axes": None, "decode": False,
            "libraries": man.library_files(_build.libraries_for(net))}


def test_manifest_round_trip(tmp_path):
    net = _mlp()
    m = man.build(net, serving=_entry(net))
    assert m["schema_version"] == man.SCHEMA_VERSION
    assert m["model"]["fingerprint"] == man.model_fingerprint(net)
    assert m["device"] == {"name": "cpu", "capability": None}
    assert m["torch_version"] == torch.__version__
    assert m["nvcc_release"] == _build.nvcc_release()
    path = man.save(m, str(tmp_path))
    assert os.path.basename(path) == man.MANIFEST_NAME
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    loaded = man.load(str(tmp_path))
    assert loaded == json.loads(json.dumps(m))
    assert man.validate_serving(
        loaded, net, row_shapes=[(4,)], ladder=[2, 4, 8], max_batch=8,
        min_batch=2, compute_dtype="float32") == []


DRIFTS = {
    "schema_version": lambda m: m.update(schema_version=99),
    "torch_version": lambda m: m.update(torch_version="0.0"),
    "cuda_runtime": lambda m: m.update(cuda_runtime="99.9"),
    "nvcc_release": lambda m: m.update(nvcc_release="release 0.1"),
    "device": lambda m: m.update(device={"name": "NVIDIA H100",
                                         "capability": "sm_90"}),
    "model class": lambda m: m["model"].update({"class": "Other"}),
    "model fingerprint": lambda m: m["model"].update(fingerprint="0" * 16),
    "row_shapes": lambda m: m["serving"].update(row_shapes=[[5]]),
    "ladder": lambda m: m["serving"].update(ladder=[2, 4]),
    "max_batch": lambda m: m["serving"].update(max_batch=16),
    "min_batch": lambda m: m["serving"].update(min_batch=1),
    "serving compute_dtype": lambda m: m["serving"].update(
        compute_dtype="bfloat16"),
    "mesh_axes": lambda m: m["serving"].update(mesh_axes={"model": 2}),
    "libraries": lambda m: m["serving"].update(
        libraries=["libflash_attn_fwd_0000000000000000.so"]),
}


@pytest.mark.parametrize("field", sorted(DRIFTS))
def test_one_mismatch_message_per_field(field):
    net = _mlp()
    m = json.loads(json.dumps(man.build(net, serving=_entry(net))))
    DRIFTS[field](m)
    mis = man.validate_serving(m, net, row_shapes=[(4,)], ladder=[2, 4, 8],
                               max_batch=8, min_batch=2,
                               compute_dtype="float32")
    assert len(mis) == 1 and mis[0].startswith(field), mis


def test_manifest_without_serving_entry_is_named():
    net = _mlp()
    assert man.validate_serving(
        man.build(net), net, row_shapes=[(4,)], ladder=[2, 4, 8],
        max_batch=8, min_batch=2, compute_dtype="float32") == [
        "manifest has no 'serving' entry"]


def test_server_accepts_matching_manifest_and_warns_on_mismatch(tmp_path):
    net = _mlp()
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    man.save(man.build(net, serving=_entry(net)), cache)
    server = ModelServer(net, port=0, max_batch=8, compile_cache_dir=cache,
                         aot_manifest=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a match must NOT warn
        server.start()
    try:
        assert server.aot_manifest_ok is True
        assert server.compile_cache_dir == os.path.abspath(cache)
    finally:
        server.stop()
    # the same manifest, a drifted boot: a warning, and it still serves
    server2 = ModelServer(net, port=0, max_batch=16,
                          aot_manifest=os.path.join(cache,
                                                    man.MANIFEST_NAME))
    with pytest.warns(RuntimeWarning, match="max_batch 8 != 16"):
        server2.start()
    try:
        assert server2.aot_manifest_ok is False
        out = server2.predict(np.zeros((3, 4), np.float32))
        assert np.asarray(out).shape == (3, 3)
    finally:
        server2.stop()
    # no manifest named and no cache: nothing is validated; True with no
    # cache names what is missing
    ccache.deactivate()
    server3 = ModelServer(net, port=0, max_batch=8).start()
    try:
        assert server3.aot_manifest_ok is None
    finally:
        server3.stop()
    server4 = ModelServer(net, port=0, max_batch=8, aot_manifest=True)
    with pytest.warns(RuntimeWarning, match="no.*compile cache dir|none is"):
        server4.start()
    try:
        assert server4.aot_manifest_ok is False
    finally:
        server4.stop()


# ------------------------------------------------------------- precompile
def test_precompile_serving_matches_the_jax_entry(tmp_path, jax_and_port):
    jnet, net = jax_and_port
    want = jpre.precompile_serving(jnet, cache_dir=str(tmp_path / "jax"),
                                   max_batch=8)
    got = pre.precompile_serving(net, cache_dir=str(tmp_path / "port"),
                                 max_batch=8)
    for k in ("row_shapes", "ladder", "max_batch", "min_batch",
              "compute_dtype", "mesh_axes"):
        assert got[k] == want[k], k
    assert got["libraries"] == [] and got["decode"] is False
    assert ccache.cache_dir() == str(tmp_path / "port")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.5 part 2"):
        pre.precompile_serving(net, cache_dir=str(tmp_path), mesh=object())


def test_precompile_fit_leaves_every_tensor_bit_unchanged(tmp_path):
    from deeplearning4j_tpu_torch.nn import multistep
    net = _mlp()
    rng = np.random.default_rng(0)
    net.fit_batch(DataSet(rng.standard_normal((8, 4)).astype(np.float32),
                          np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]))
    before = {(tn,) + p: t.detach().clone()
              for tn, p, t in multistep._tree_paths(net)}
    entry = pre.precompile_fit(net, cache_dir=str(tmp_path), batch=16)
    assert entry == {"kind": "train_step", "net": "MultiLayerNetwork",
                     "batch": 16, "row_shapes": [[4]], "libraries": []}
    after = {(tn,) + p: t for tn, p, t in multistep._tree_paths(net)}
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert net.iteration == 1
    rnn = zoo.char_rnn(hidden=8, device="cpu")
    with pytest.raises(ValueError, match="input_shapes"):
        pre.precompile_fit(rnn, cache_dir=str(tmp_path))
    e = pre.precompile_fit(rnn, cache_dir=str(tmp_path),
                           input_shapes=[(5, 80)])
    assert e["libraries"] == man.library_files(("lstm_fwd", "lstm_bwd"))


# --------------------------------------------------------------- autotune
def _trace_results(arrivals, max_batch=1024, window_ms=2.0):
    return {"trace": {"arrivals": arrivals, "concurrency": 8},
            "metrics": {"device_ms_by_bucket": {"2": 1.0, "4": 1.2,
                                                "8": 1.6},
                        "batch_size_hist": {"2": 50, "4": 30, "8": 20}},
            "max_batch": max_batch, "batch_window_ms": window_ms}


TRACES = {
    "steady": [(i * 0.002, 1) for i in range(400)],
    "bursty": [(0.05 * (i // 8) + 0.0001 * (i % 8), 1 + i % 3)
               for i in range(320)],
    "sparse": [(i * 0.011, 2) for i in range(150)],
}


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_autotune_gives_the_jax_winner_and_objective(trace):
    res = _trace_results(TRACES[trace])
    want, got = jat.autotune(res), at.autotune(res)
    for k in ("tuned", "default"):
        assert {x: got[k][x] for x in ("max_batch", "batch_window_ms")} \
            == {x: want[k][x] for x in ("max_batch", "batch_window_ms")}
        assert abs(got[k]["objective"] - want[k]["objective"]) <= 1e-12
    assert got["objective_ratio"] == want["objective_ratio"] <= 1.0
    drop = lambda r: {k: v for k, v in r.items()  # noqa: E731
                      if k != "created_unix"}
    assert drop(got) == drop(want)
    assert at.load_tuned(got) == jat.load_tuned(want)


def test_service_model_and_simulator_equal_the_jax_module():
    dev = {2: 1.0, 4: 1.2, 8: 1.6, 32: 4.1}
    counts = {2: 50, 4: 30, 8: 20, 32: 3}
    a, c = at.fit_service_model(dev, counts)
    ja, jc = jat.fit_service_model(dev, counts)
    assert abs(a - ja) <= 1e-12 and abs(c - jc) <= 1e-12
    assert at.fit_service_model({4: 2.0}) == jat.fit_service_model({4: 2.0})
    for arrivals in TRACES.values():
        for cap, win in ((8, 0.0), (32, 2.0), (128, 8.0)):
            kw = dict(max_batch=cap, batch_window_ms=win, min_batch=2,
                      service_ms=lambda b: a + c * b)
            assert at.simulate(arrivals, **kw) == jat.simulate(arrivals,
                                                               **kw)


def test_simulator_respects_linger_and_padding_semantics():
    svc = lambda bucket: 1.0  # noqa: E731 — flat 1 ms service
    # two arrivals inside one linger window coalesce into one bucket-2
    # launch AT the deadline (the window is waited out)
    out = at.simulate([(0.0, 1), (0.001, 1)], max_batch=8,
                      batch_window_ms=4.0, min_batch=2, service_ms=svc)
    assert out["padding_waste_fraction"] == 0.0
    assert out["p99_ms"] == pytest.approx(5.0, abs=0.2)  # 4 linger + 1 svc
    # zero window: each arrival pads its own min bucket, no linger wait
    out0 = at.simulate([(0.0, 1), (0.01, 1)], max_batch=8,
                       batch_window_ms=0.0, min_batch=2, service_ms=svc)
    assert out0["padding_waste_fraction"] == 0.5
    assert out0["p99_ms"] == pytest.approx(1.0, abs=0.2)
    # a full bucket launches NOW, not at the window deadline
    full = at.simulate([(0.0, 4), (0.0005, 4)], max_batch=8,
                       batch_window_ms=50.0, min_batch=2, service_ms=svc)
    assert full["p99_ms"] < 10.0
    with pytest.raises(ValueError):
        at.load_tuned({"schema_version": 1})
    with pytest.raises(ValueError, match="rerun"):
        at.extract_trace({"metrics": {}})


def test_bench_results_from_a_served_run_feed_autotune():
    """Open-loop traffic (scheduling/loadgen.py) through a CPU server,
    recorded with ServingStats, in serve_bench's --out shape."""
    from deeplearning4j_tpu_torch.scheduling import (OpenLoopRunner,
                                                     TrafficModel)
    net = _mlp()
    arrivals = TrafficModel(seed=3, duration_s=0.6, base_rps=60.0,
                            max_rows=4).arrivals()
    srv = ModelServer(net, port=0, max_batch=8).start()
    try:
        feats = np.zeros((4, 4), np.float32)

        def submit(a):
            srv.predict(feats[:a.rows])
            return {"status": 200}
        rows = OpenLoopRunner(submit, arrivals, max_workers=8).run()
        snap = srv.stats.snapshot(srv.shapes_seen)
    finally:
        srv.stop()
    assert rows and all(r["status"] == 200 for r in rows)
    res = at.bench_results(arrivals, snap, max_batch=8, batch_window_ms=2.0,
                           concurrency=8)
    assert res["trace"]["arrivals"] == [[round(a.t, 6), a.rows]
                                        for a in arrivals]
    assert set(res) == {"trace", "metrics", "max_batch", "batch_window_ms"}
    assert res["metrics"]["device_ms_by_bucket"]
    trace = at.extract_trace(res)
    assert trace["default"] == {"max_batch": 8, "batch_window_ms": 2.0}
    assert jat.extract_trace(json.loads(json.dumps(res))) == \
        at.extract_trace(json.loads(json.dumps(res)))
    rep = at.autotune(res)
    assert rep["tuned"]["objective"] <= rep["default"]["objective"]


def test_server_boots_with_tuning_report(tmp_path):
    rep = at.autotune(_trace_results(TRACES["steady"][:100]))
    path = tmp_path / "tuning.json"
    path.write_text(json.dumps(rep))
    server = ModelServer(_mlp(), port=0, warmup=False,
                         tuning_report=str(path))
    assert server.tuned_config == at.load_tuned(rep)
    assert server.max_batch == rep["tuned"]["max_batch"]
    assert server._batcher.max_batch == rep["tuned"]["max_batch"]
    assert server._batcher.batch_window_ms == \
        rep["tuned"]["batch_window_ms"]


def test_run_report_carries_cache_and_coldstart_fields():
    fields = RunReport.__dataclass_fields__
    for f in ("xla_cache_hits", "xla_cache_misses", "cold_start_s",
              "warmup_s"):
        assert f in fields
    rep = RunReport(kind="serving", wall_s=1.0)
    d = rep.to_dict()
    assert d["xla_cache_hits"] == 0 and d["cold_start_s"] is None
    rep.cold_start_s = 2.5
    assert rep.to_dict()["cold_start_s"] == 2.5


def test_fit_and_supervisor_configure_the_cache(tmp_path, monkeypatch):
    from deeplearning4j_tpu_torch.resilience import (SupervisorConfig,
                                                     resilient_fit)
    net = _mlp()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    monkeypatch.setenv(ccache.ENV_VAR, str(tmp_path / "fit-cache"))
    net.fit(x, y, epochs=1, batch_size=8)
    assert ccache.cache_dir() == str(tmp_path / "fit-cache")
    ccache.deactivate()
    monkeypatch.delenv(ccache.ENV_VAR)
    cfg = SupervisorConfig(checkpoint_dir=str(tmp_path / "ck"),
                           compile_cache_dir=str(tmp_path / "sup-cache"))
    assert cfg.compile_cache_dir == str(tmp_path / "sup-cache")
    res = resilient_fit(_mlp(), DataSet(x, y),
                        checkpoint_dir=str(tmp_path / "ck2"), epochs=1,
                        batch_size=8,
                        compile_cache_dir=str(tmp_path / "sup-cache"))
    assert res.status == "completed"
    assert ccache.cache_dir() == str(tmp_path / "sup-cache")
    assert ccache.shared_meta()["schema"] == ccache.META_SCHEMA_VERSION


# ---------------------------------------------------------------- warm boot
_BOOT = """
import json, sys
sys.path.insert(0, {root!r})
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.observability import metrics as obs
_build._RELEASE[:] = ["release test"]
_build.nvcc_path = lambda: {nvcc!r}
_build.ctypes.CDLL = lambda path: ("lib", path)
base = obs.compile_snapshot()
libs = [_build.load(n)[1] for n in ("flash_attn_fwd", "stream_exact")]
print(json.dumps(dict(obs.compile_delta(base), libs=libs)))
"""


def test_warm_boot_subprocess_round_trip(tmp_path):
    """Boot A (a fresh process) builds its libraries into the cache the
    env var names; boot B (another process, same dir) loads the same
    files with 0 builds and 0 misses: a hit for each."""
    cache = str(tmp_path / "kernel-cache")
    code = _BOOT.format(root=ROOT, nvcc=_fake_nvcc(tmp_path))
    env = dict(os.environ, **{ccache.ENV_VAR: cache})

    def boot():
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120,
                             env=env, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    a = boot()
    assert a["count"] == a["cache_misses"] == 2 and a["cache_hits"] == 0
    assert all(p.startswith(cache) for p in a["libs"])
    b = boot()
    assert b["count"] == b["cache_misses"] == 0 and b["cache_hits"] == 2
    assert b["libs"] == a["libs"]
    assert sorted(os.listdir(cache)) == sorted(
        [ccache.META_NAME] + [os.path.basename(p) for p in a["libs"]])
