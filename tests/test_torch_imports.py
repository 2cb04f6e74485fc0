"""The port (deeplearning4j_tpu_torch) stands alone: it imports with jax
blocked, no module of it (nor chip_smoke.py) imports jax or the JAX package,
and its entry points refuse to run on the CPU unless asked to.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "deeplearning4j_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_name(path):
    rel = path.relative_to(ROOT).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _forbidden(name):
    return (name == "jax" or name.startswith("jax.")
            or name == "deeplearning4j_tpu"
            or name.startswith("deeplearning4j_tpu."))


def _imports(path):
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(node.module)
    return found


def test_forbidden_name_rule_minds_the_prefix():
    assert _forbidden("deeplearning4j_tpu")
    assert _forbidden("deeplearning4j_tpu.ops.lstm")
    assert _forbidden("jax.numpy")
    assert not _forbidden("deeplearning4j_tpu_torch.ops.lstm")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", [
    "deeplearning4j_tpu_torch.ops.attention",
    "deeplearning4j_tpu_torch.nn.conf.layers_attention",
    "deeplearning4j_tpu_torch.nn.layers.attention",
    "deeplearning4j_tpu_torch.zoo.models",
])
def test_transformer_modules_are_checked(module):
    """The transformer slice's modules are among the sources the two
    tests around this one check."""
    assert module in {_module_name(p) for p in SOURCES}


# the modules of the ResNet-50 slice and of the slices after it
SLICE_MODULES = [
    "deeplearning4j_tpu_torch.nn.graph",
    "deeplearning4j_tpu_torch.nn.fusion",
    "deeplearning4j_tpu_torch.nn.conf.graph_conf",
    "deeplearning4j_tpu_torch.nn.conf.vertices",
    "deeplearning4j_tpu_torch.nn.conf.layers_conv",
    "deeplearning4j_tpu_torch.nn.layers.feedforward",
    "deeplearning4j_tpu_torch.nn.layers.convolution",
    "deeplearning4j_tpu_torch.nn.layers.pooling",
    "deeplearning4j_tpu_torch.nn.layers.normalization",
    "deeplearning4j_tpu_torch.ops.convolution",
    "deeplearning4j_tpu_torch.ops.normalization",
    "deeplearning4j_tpu_torch.ops.fused_block",
    "deeplearning4j_tpu_torch.nn.conf.preprocessors",
    "deeplearning4j_tpu_torch.nn.conf.core",
    "deeplearning4j_tpu_torch.nn.multilayer",
    "deeplearning4j_tpu_torch.ops.sequence",
    "deeplearning4j_tpu_torch.eval",
    "deeplearning4j_tpu_torch.eval.evaluation",
    "deeplearning4j_tpu_torch.eval.regression",
    "deeplearning4j_tpu_torch.eval.roc",
    "deeplearning4j_tpu_torch.eval.binary",
    "deeplearning4j_tpu_torch.eval.meta",
    "deeplearning4j_tpu_torch.optimize",
    "deeplearning4j_tpu_torch.optimize.listeners",
    "deeplearning4j_tpu_torch.optimize.earlystopping",
    "deeplearning4j_tpu_torch.utils.serialization",
    "deeplearning4j_tpu_torch.nn.multistep",
    "deeplearning4j_tpu_torch.utils.perf",
    "deeplearning4j_tpu_torch.datasets.records",
    "deeplearning4j_tpu_torch.datasets.iterator",
]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_resnet_modules_are_checked(module):
    """The modules of the ResNet-50 slice and of the slices after it (the
    conv MLN, evaluation, listeners and early stopping) are among the
    sources the import tests check."""
    assert module in {_module_name(p) for p in SOURCES}


# the modules of the data-fed, observed training slice: the input
# pipeline, the observability core and the lock-guard declaration
PIPELINE_MODULES = [
    "deeplearning4j_tpu_torch.analysis",
    "deeplearning4j_tpu_torch.analysis.guards",
    "deeplearning4j_tpu_torch.observability",
    "deeplearning4j_tpu_torch.observability.trace",
    "deeplearning4j_tpu_torch.observability.metrics",
    "deeplearning4j_tpu_torch.observability.distributed",
    "deeplearning4j_tpu_torch.observability.goodput",
    "deeplearning4j_tpu_torch.observability.flightrec",
    "deeplearning4j_tpu_torch.datapipe",
    "deeplearning4j_tpu_torch.datapipe.core",
    "deeplearning4j_tpu_torch.datapipe.sources",
    "deeplearning4j_tpu_torch.datapipe.stages",
    "deeplearning4j_tpu_torch.datapipe.tokens",
    "deeplearning4j_tpu_torch.datapipe.prefetch",
    "deeplearning4j_tpu_torch.datapipe.reshard",
]


@pytest.mark.parametrize("module", PIPELINE_MODULES)
def test_pipeline_and_observability_modules_are_checked(module):
    """Each module of the pipeline and observability slice is among the
    sources the import tests check (so the test below imports it with
    jax and the JAX package blocked)."""
    assert module in {_module_name(p) for p in SOURCES}


# the modules of the decode-serving slice: the order-fixed streaming ops,
# the paged KV pool, the replica set, the decode engine and the server
DECODE_MODULES = [
    "deeplearning4j_tpu_torch.ops.stream_exact",
    "deeplearning4j_tpu_torch.serving",
    "deeplearning4j_tpu_torch.serving.batcher",
    "deeplearning4j_tpu_torch.serving.kvcache",
    "deeplearning4j_tpu_torch.serving.fleet",
    "deeplearning4j_tpu_torch.serving.metrics",
    "deeplearning4j_tpu_torch.serving.decode",
    "deeplearning4j_tpu_torch.serving.server",
]


@pytest.mark.parametrize("module", DECODE_MODULES)
def test_decode_serving_modules_are_checked(module):
    """Each module of the decode-serving slice is among the sources the
    import tests check."""
    assert module in {_module_name(p) for p in SOURCES}


# the modules of the live-reload slice: the model fingerprint and the
# publication store
LIVE_RELOAD_MODULES = [
    "deeplearning4j_tpu_torch.compilecache",
    "deeplearning4j_tpu_torch.compilecache.manifest",
    "deeplearning4j_tpu_torch.serving.publish",
]


@pytest.mark.parametrize("module", LIVE_RELOAD_MODULES)
def test_live_reload_modules_are_checked(module):
    """Each module of the live-reload slice is among the sources the
    import tests check."""
    assert module in {_module_name(p) for p in SOURCES}


# the modules of the traffic-engine slice: scheduling, the SLO engine,
# the federation's HTTP half and the front-door router
TRAFFIC_MODULES = [
    "deeplearning4j_tpu_torch.scheduling",
    "deeplearning4j_tpu_torch.scheduling.core",
    "deeplearning4j_tpu_torch.scheduling.autoscaler",
    "deeplearning4j_tpu_torch.scheduling.loadgen",
    "deeplearning4j_tpu_torch.observability.slo",
    "deeplearning4j_tpu_torch.observability.distributed",
    "deeplearning4j_tpu_torch.serving.router",
]


@pytest.mark.parametrize("module", TRAFFIC_MODULES)
def test_traffic_engine_modules_are_checked(module):
    """Each module of the traffic-engine slice is among the sources the
    import tests check."""
    assert module in {_module_name(p) for p in SOURCES}


# the modules of the cold-start and dashboard slice: the build cache,
# the AOT manifest, precompile, the autotuner, the UI tier, the report
# tools and the exact t-SNE
COLD_START_UI_MODULES = [
    "deeplearning4j_tpu_torch.compilecache.cache",
    "deeplearning4j_tpu_torch.compilecache.manifest",
    "deeplearning4j_tpu_torch.compilecache.precompile",
    "deeplearning4j_tpu_torch.compilecache.autotune",
    "deeplearning4j_tpu_torch.ui",
    "deeplearning4j_tpu_torch.ui.__main__",
    "deeplearning4j_tpu_torch.ui.components",
    "deeplearning4j_tpu_torch.ui.embedding",
    "deeplearning4j_tpu_torch.ui.router",
    "deeplearning4j_tpu_torch.ui.server",
    "deeplearning4j_tpu_torch.ui.stats",
    "deeplearning4j_tpu_torch.ui.storage",
    "deeplearning4j_tpu_torch.eval.tools",
    "deeplearning4j_tpu_torch.plot",
    "deeplearning4j_tpu_torch.plot.tsne",
]


@pytest.mark.parametrize("module", COLD_START_UI_MODULES)
def test_cold_start_and_ui_modules_are_checked(module):
    """Each module of the cold-start and dashboard slice is among the
    sources the import tests check."""
    assert module in {_module_name(p) for p in SOURCES}


def test_cold_start_and_ui_public_names_match_the_jax_package():
    """The slice's modules import in a fresh interpreter with jax and
    the JAX package blocked, and carry the JAX modules' public names."""
    mods = {"compilecache.cache": ["ENV_VAR", "META_NAME", "configure",
                                   "cache_dir", "deactivate",
                                   "ensure_configured", "atomic_publish",
                                   "shared_meta"],
            "compilecache.manifest": ["SCHEMA_VERSION", "MANIFEST_NAME",
                                      "build", "save", "load",
                                      "validate_serving",
                                      "model_fingerprint"],
            "compilecache.precompile": ["precompile_serving",
                                        "precompile_fit"],
            "compilecache.autotune": [
                "extract_trace", "fit_service_model", "simulate",
                "objective", "autotune", "load_tuned", "SCHEMA_VERSION",
                "DEFAULT_MAX_BATCH_GRID", "DEFAULT_WINDOW_GRID_MS"],
            "ui": ["StatsListener", "StatsReport", "FileStatsStorage",
                   "InMemoryStatsStorage", "UIServer",
                   "RemoteStatsStorageRouter", "publish_embedding"],
            "ui.storage": ["NEW_SESSION", "NEW_WORKER", "POST_UPDATE",
                           "POST_STATIC", "BaseStatsStorage"],
            "ui.embedding": ["EMBEDDING_KEY", "publish_embedding",
                             "get_embedding"],
            "ui.components": ["render_components_to_html",
                              "render_components_to_file", "ChartTimeline"],
            "eval.tools": ["roc_components", "roc_chart_html",
                           "export_roc_charts_to_html_file",
                           "evaluation_components", "evaluation_html",
                           "export_evaluation_to_html_file"],
            "plot": ["Tsne", "BarnesHutTsne"],
            "modelimport": ["KerasImportError", "import_keras_model",
                            "import_keras_model_and_weights",
                            "import_keras_sequential_model",
                            "import_keras_sequential_model_and_weights"],
            "modelimport.hdf5": ["Hdf5Archive"],
            "modelimport.dl4j": ["read_nd4j_array", "write_nd4j_array",
                                 "translate_layer",
                                 "restore_multi_layer_network_from_dl4j",
                                 "write_dl4j_zip"],
            "utils.model_guesser": ["guess_format", "load_model"],
            "clustering": ["KMeansClustering", "KDTree", "VPTree"],
            "clustering.kmeans": ["KMeansClustering"],
            "clustering.trees": ["KDTree", "VPTree"],
            "clustering.sptree": ["SPTree", "QuadTree"],
            "datasets.native_io": ["available", "read_idx",
                                   "NativeBatchLoader"],
            "datasets.iterator": ["NativeDataSetIterator"]}
    code = ("import sys, importlib, json\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['deeplearning4j_tpu'] = None\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"mods = {mods!r}\n"
            "missing = {m: [n for n in names if not hasattr(importlib."
            "import_module('deeplearning4j_tpu_torch.' + m), n)]\n"
            "           for m, names in mods.items()}\n"
            "print(json.dumps({m: v for m, v in missing.items() if v}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "{}"
    import importlib
    for m, names in mods.items():
        jm = importlib.import_module("deeplearning4j_tpu." + m)
        assert all(hasattr(jm, n) for n in names), m


# the modules of the model-import, clustering and native-loader slice
IMPORT_CLUSTERING_MODULES = [
    "deeplearning4j_tpu_torch.modelimport",
    "deeplearning4j_tpu_torch.modelimport.hdf5",
    "deeplearning4j_tpu_torch.modelimport.keras",
    "deeplearning4j_tpu_torch.modelimport.dl4j",
    "deeplearning4j_tpu_torch.utils.model_guesser",
    "deeplearning4j_tpu_torch.clustering",
    "deeplearning4j_tpu_torch.clustering.kmeans",
    "deeplearning4j_tpu_torch.clustering.trees",
    "deeplearning4j_tpu_torch.clustering.sptree",
    "deeplearning4j_tpu_torch.datasets.native_io",
]


@pytest.mark.parametrize("module", IMPORT_CLUSTERING_MODULES)
def test_import_and_clustering_modules_are_checked(module):
    """Each module of the model-import, clustering and native-loader
    slice is among the sources the import tests check."""
    assert module in {_module_name(p) for p in SOURCES}


# the modules of the analysis gate and data-parallel slice
ANALYSIS_PARALLEL_MODULES = [
    "deeplearning4j_tpu_torch.analysis.concurrency",
    "deeplearning4j_tpu_torch.analysis.lockorder",
    "deeplearning4j_tpu_torch.analysis.fx_lint",
    "deeplearning4j_tpu_torch.analysis.__main__",
    "deeplearning4j_tpu_torch.parallel",
    "deeplearning4j_tpu_torch.parallel.mesh",
    "deeplearning4j_tpu_torch.parallel.distributed",
    "deeplearning4j_tpu_torch.parallel.data_parallel",
    "deeplearning4j_tpu_torch.parallel.stats",
]


@pytest.mark.parametrize("module", ANALYSIS_PARALLEL_MODULES)
def test_analysis_and_parallel_modules_are_checked(module):
    """Each module of the analysis and data-parallel slice is among the
    sources the import tests check."""
    assert module in {_module_name(p) for p in SOURCES}


def test_analysis_and_parallel_public_names_match_the_jax_package():
    """The slice's modules import in a fresh interpreter with jax and the
    JAX package blocked, and carry the JAX modules' public names for
    what the slice ports."""
    mods = {"analysis": ["Finding", "guarded_by", "CODES",
                         "sort_findings"],
            "analysis.concurrency": ["lint_source", "lint_file",
                                     "lint_tree", "DEFAULT_ROOTS"],
            "analysis.lockorder": ["LockOrderGraph", "InstrumentedLock",
                                   "instrument", "get_graph", "install",
                                   "uninstall", "installed",
                                   "maybe_install"],
            "analysis.fx_lint": ["list_targets", "lint_target", "lint_all",
                                 "DETERMINISM_ALLOWLIST", "TARGETS"],
            "parallel": ["make_mesh", "apply_mesh", "shard_step",
                         "shard_batch", "ParallelWrapper"],
            "parallel.mesh": ["make_mesh"],
            "parallel.data_parallel": ["apply_mesh", "shard_batch",
                                       "_pad_batch", "shard_step",
                                       "shard_step_multi",
                                       "ParallelWrapper"],
            "parallel.distributed": [
                "initialize", "process_info", "is_multiprocess",
                "sync_check", "agree_decision", "any_process", "barrier",
                "collective_timeout_s", "consensus_available",
                "CollectiveTimeoutError", "PeerLostError",
                "MultiProcessLocalSGD", "DEFAULT_COLLECTIVE_TIMEOUT_S"],
            "parallel.stats": ["EventStats", "TrainingStatsCollector",
                               "timeline_component", "summary_table",
                               "export_timeline_html", "PHASE_COLORS"]}
    code = ("import sys, importlib, json\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['deeplearning4j_tpu'] = None\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"mods = {mods!r}\n"
            "missing = {m: [n for n in names if not hasattr(importlib."
            "import_module('deeplearning4j_tpu_torch.' + m), n)]\n"
            "           for m, names in mods.items()}\n"
            "print(json.dumps({m: v for m, v in missing.items() if v}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "{}"
    import importlib
    for m, names in mods.items():
        jm = importlib.import_module(
            "deeplearning4j_tpu." + m.replace("fx_lint", "jaxpr_lint"))
        assert all(hasattr(jm, n) for n in names), m


COORDINATION_MODULES = [
    "deeplearning4j_tpu_torch.resilience.launcher",
    "deeplearning4j_tpu_torch.resilience.supervisor",
    "deeplearning4j_tpu_torch.parallel.distributed",
]


@pytest.mark.parametrize("module", COORDINATION_MODULES)
def test_coordination_modules_are_checked(module):
    """Each module of the coordination slice is among the sources the
    import tests check."""
    assert module in {_module_name(p) for p in SOURCES}


def test_coordination_and_public_names_match_the_jax_package():
    """The launcher, zoo.F16 and the server's re-exported seed names
    (MicroBatcher, next_bucket, _next_bucket) import in a fresh
    interpreter with jax and the JAX package blocked, and the JAX
    package has every one of them."""
    mods = {"resilience.launcher": ["PEER_LOST_EXIT", "WorkerRecord",
                                    "LaunchRecord", "FleetResult",
                                    "FleetLauncher", "free_port", "main"],
            "resilience": ["PEER_LOST_EXIT", "FleetLauncher", "FleetResult",
                           "LaunchRecord", "WorkerRecord"],
            "zoo.models": ["F16"],
            "serving.server": ["MicroBatcher", "next_bucket",
                               "_next_bucket"]}
    code = ("import sys, importlib, json\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['deeplearning4j_tpu'] = None\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"mods = {mods!r}\n"
            "missing = {m: [n for n in names if not hasattr(importlib."
            "import_module('deeplearning4j_tpu_torch.' + m), n)]\n"
            "           for m, names in mods.items()}\n"
            "print(json.dumps({m: v for m, v in missing.items() if v}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "{}"
    import importlib
    for m, names in mods.items():
        jm = importlib.import_module("deeplearning4j_tpu." + m)
        assert all(hasattr(jm, n) for n in names), m
    from deeplearning4j_tpu.zoo import models as jzoo
    from deeplearning4j_tpu_torch import zoo as tzoo
    assert (tzoo.F16.param_dtype, tzoo.F16.compute_dtype) == \
        (jzoo.F16.param_dtype, jzoo.F16.compute_dtype) == \
        ("float32", "float16")
    from deeplearning4j_tpu_torch.serving import batcher, server
    assert server.MicroBatcher is batcher.MicroBatcher
    assert server.next_bucket is server._next_bucket is batcher.next_bucket
    from deeplearning4j_tpu.resilience import launcher as jl
    from deeplearning4j_tpu_torch.resilience import launcher as tl
    assert tl.PEER_LOST_EXIT == jl.PEER_LOST_EXIT


def test_traffic_engine_imports_with_jax_blocked():
    """The traffic-engine modules import in a fresh interpreter with jax
    and the JAX package blocked, and their names match the JAX
    package's ``__all__``."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['deeplearning4j_tpu'] = None\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import importlib\n"
            f"for m in {TRAFFIC_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import deeplearning4j_tpu_torch.scheduling as s\n"
            "import deeplearning4j_tpu_torch.serving.router as r\n"
            "print(sorted(s.__all__), sorted(r.__all__))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr
    from deeplearning4j_tpu import scheduling as jsched
    from deeplearning4j_tpu.serving import router as jrouter
    assert r.stdout.strip() == (f"{sorted(jsched.__all__)} "
                                f"{sorted(jrouter.__all__)}")


def test_package_imports_with_jax_blocked():
    mods = [_module_name(p) for p in SOURCES if p.parent != ROOT]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['deeplearning4j_tpu'] = None\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]]\n"
            "assert not bad, bad\n"
            "print('ok', len(%r))\n" % (mods,))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_entry_points_raise_without_a_card(no_cuda, tmp_path):
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import serialization

    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.char_rnn(hidden=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.gpt_mini(width=8, n_layers=1, n_heads=2, max_len=4)
    net = zoo.char_rnn(hidden=8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(net.conf)
    path = tmp_path / "m.zip"
    serialization.write_model(net, str(path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serialization.restore_multi_layer_network(str(path))
    assert serialization.restore_multi_layer_network(
        str(path), device="cpu").device.type == "cpu"


def test_graph_entry_points_raise_without_a_card(no_cuda, tmp_path):
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.utils import serialization

    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.resnet50(image_size=32)
    net = zoo.resnet50(image_size=32, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph(net.conf)
    path = tmp_path / "g.zip"
    serialization.write_computation_graph(net, str(path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serialization.restore_computation_graph(str(path))
    back = serialization.restore_computation_graph(str(path), device="cpu")
    assert back.device.type == "cpu" and back.num_params() == 25557032


def test_chip_smoke_refuses_without_a_card(no_cuda):
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(ROOT))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("builder,kw", [
    ("mnist_mlp", {}), ("lenet", {}),
    ("vgg16", dict(image_size=32, n_classes=7)), ("resnet18", {})],
    ids=["mnist_mlp", "lenet", "vgg16", "resnet18"])
def test_conv_zoo_entry_points_raise_without_a_card(no_cuda, builder, kw):
    from deeplearning4j_tpu_torch import zoo

    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(zoo, builder)(**kw)
    net = getattr(zoo, builder)(device="cpu", **kw)
    assert net.clone().device.type == "cpu"


@pytest.mark.parametrize("builder", ["lenet", "resnet18"])
def test_restore_model_and_file_saver_raise_without_a_card(no_cuda,
                                                           tmp_path,
                                                           builder):
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.optimize.earlystopping import (
        LocalFileModelSaver)
    from deeplearning4j_tpu_torch.utils import serialization

    net = getattr(zoo, builder)(device="cpu")
    path = str(tmp_path / "bestModel.zip")
    LocalFileModelSaver(str(tmp_path)).save_best(net)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serialization.restore_model(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalFileModelSaver(str(tmp_path), device=None)._restore(
            "bestModel.zip")
    back = LocalFileModelSaver(str(tmp_path), device="cpu").get_best()
    assert back.device.type == "cpu" and type(back) is type(net)
    assert back.num_params() == net.num_params()


# kernel names of the profiler's listings of conv-net steps on the card
# (chip_smoke.py writes them to profile_out/<net>_kernels.json), each with
# the kind chip_smoke.kernel_kind must count it under
KERNEL_NAMES = [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel"
     "__5x_cudnn", "cudnn_conv"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
     "nhwc_tilesize128x64x64_warpgroupsize1x1x1_g1_execute_split_k_kernel"
     "__5x_cudnn", "splitk"),
    ("void cask_plugin__5x_cudnn::xmma__5x_cudnn::init_device_workspace_"
     "kernel<xmma__5x_cudnn::implicit_gemm::wgrad_indexed::Warp_specialized"
     "_params<", "conv_workspace"),
    ("void at::native::(anonymous namespace)::max_pool_backward_nhwc<c10::"
     "BFloat16, float>(c10::BFloat16 const*, long const*, int)", "pool"),
    ("void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, "
     "(cudnnKernelDataType_t)0>(int, cudnn::reduced_divisor)", "layout"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float>", "splitk"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NTN", "gemm"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<c10::"
     "BFloat16>>", "reduce"),
    ("Memset (Device)", "memset"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>", "elementwise"),
    ("flash_fwd_kernel_sm90", "flash_attn_fwd"),
]


@pytest.mark.parametrize("name,kind", KERNEL_NAMES,
                         ids=[k for _, k in KERNEL_NAMES])
def test_profile_kernel_kinds(name, kind):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.kernel_kind(name) == kind


def test_load_net_raises_without_a_card(no_cuda, tmp_path):
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.serving import load_net
    from deeplearning4j_tpu_torch.utils.checkpoint import save_checkpoint

    save_checkpoint(zoo.char_rnn(hidden=8, device="cpu"),
                    str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_net(str(tmp_path / "c"))
    assert load_net(str(tmp_path / "c"), device="cpu").device.type == "cpu"


# the modules of the NLP, graph-embedding and fetcher slice
NLP_GRAPH_MODULES = [
    "deeplearning4j_tpu_torch.nlp",
    "deeplearning4j_tpu_torch.nlp.tokenization",
    "deeplearning4j_tpu_torch.nlp.vocab",
    "deeplearning4j_tpu_torch.nlp.elements",
    "deeplearning4j_tpu_torch.nlp.lookup",
    "deeplearning4j_tpu_torch.nlp.sequence_vectors",
    "deeplearning4j_tpu_torch.nlp.word2vec",
    "deeplearning4j_tpu_torch.nlp.paragraph_vectors",
    "deeplearning4j_tpu_torch.nlp.glove",
    "deeplearning4j_tpu_torch.nlp.serializers",
    "deeplearning4j_tpu_torch.nlp.vectorizers",
    "deeplearning4j_tpu_torch.nlp.distributed",
    "deeplearning4j_tpu_torch.nlp.cjk",
    "deeplearning4j_tpu_torch.graph",
    "deeplearning4j_tpu_torch.graph.graph",
    "deeplearning4j_tpu_torch.graph.walks",
    "deeplearning4j_tpu_torch.graph.deepwalk",
    "deeplearning4j_tpu_torch.graph.node2vec",
    "deeplearning4j_tpu_torch.datasets.fetchers",
]


@pytest.mark.parametrize("module", NLP_GRAPH_MODULES)
def test_nlp_graph_and_fetcher_modules_are_checked(module):
    """Each module of the NLP, graph-embedding and fetcher slice is among
    the sources the import tests check."""
    assert module in {_module_name(p) for p in SOURCES}


def _public(module):
    """The public names a JAX module defines or re-exports from its own
    package (imported modules and library names left out)."""
    import types
    return sorted(n for n, v in vars(module).items()
                  if not n.startswith("_")
                  and not isinstance(v, types.ModuleType)
                  and getattr(v, "__module__", module.__name__)
                  .startswith(module.__name__.split(".")[0]))


def test_nlp_graph_and_fetcher_public_names_match_the_jax_package():
    """The slice's modules import in a fresh interpreter with jax and the
    JAX package blocked, and each carries every public name its JAX
    module defines or re-exports from the package."""
    import importlib
    mods = {m[len("deeplearning4j_tpu_torch."):]: _public(
        importlib.import_module(m.replace("_torch", "")))
        for m in NLP_GRAPH_MODULES}
    mods["datasets"] = ["CifarDataSetIterator", "CurvesDataSetIterator",
                        "IrisDataSetIterator", "LFWDataSetIterator",
                        "MnistDataSetIterator"]
    assert mods["nlp"] and mods["graph"] and mods["nlp.elements"]
    code = ("import sys, importlib, json\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['deeplearning4j_tpu'] = None\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"mods = {mods!r}\n"
            "missing = {m: [n for n in names if not hasattr(importlib."
            "import_module('deeplearning4j_tpu_torch.' + m), n)]\n"
            "           for m, names in mods.items()}\n"
            "print(json.dumps({m: v for m, v in missing.items() if v}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "{}"


NLP_GRAPH_ENTRY_POINTS = {
    "Word2Vec": lambda d: __import__(
        "deeplearning4j_tpu_torch.nlp", fromlist=["x"]).Word2Vec(device=d),
    "SequenceVectors": lambda d: __import__(
        "deeplearning4j_tpu_torch.nlp", fromlist=["x"]).SequenceVectors(
            device=d),
    "ParagraphVectors": lambda d: __import__(
        "deeplearning4j_tpu_torch.nlp", fromlist=["x"]).ParagraphVectors(
            device=d),
    "Glove": lambda d: __import__(
        "deeplearning4j_tpu_torch.nlp", fromlist=["x"]).Glove(device=d),
    "InMemoryLookupTable": lambda d: __import__(
        "deeplearning4j_tpu_torch.nlp.lookup", fromlist=["x"])
    .InMemoryLookupTable(__import__(
        "deeplearning4j_tpu_torch.nlp.vocab", fromlist=["x"])
        .VocabConstructor().build([["a", "b", "a"]]), 4, device=d),
    "DeepWalk": lambda d: __import__(
        "deeplearning4j_tpu_torch.graph", fromlist=["x"]).DeepWalk(device=d),
    "Node2Vec": lambda d: __import__(
        "deeplearning4j_tpu_torch.graph", fromlist=["x"]).Node2Vec(device=d),
    "MnistDataSetIterator": lambda d: __import__(
        "deeplearning4j_tpu_torch.datasets", fromlist=["x"])
    .MnistDataSetIterator(8, num_examples=16, device=d),
    "IrisDataSetIterator": lambda d: __import__(
        "deeplearning4j_tpu_torch.datasets", fromlist=["x"])
    .IrisDataSetIterator(device=d),
    "CifarDataSetIterator": lambda d: __import__(
        "deeplearning4j_tpu_torch.datasets", fromlist=["x"])
    .CifarDataSetIterator(8, num_examples=16, device=d),
    "CurvesDataSetIterator": lambda d: __import__(
        "deeplearning4j_tpu_torch.datasets", fromlist=["x"])
    .CurvesDataSetIterator(8, num_examples=16, device=d),
    "LFWDataSetIterator": lambda d: __import__(
        "deeplearning4j_tpu_torch.datasets", fromlist=["x"])
    .LFWDataSetIterator(8, num_examples=16, image_size=(8, 8),
                        path="/nonexistent", device=d),
}


@pytest.mark.parametrize("name", list(NLP_GRAPH_ENTRY_POINTS))
def test_nlp_graph_and_fetcher_entry_points_raise_without_a_card(
        no_cuda, monkeypatch, tmp_path, name):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("DL4J_TPU_DATA_DIR", raising=False)
    make = NLP_GRAPH_ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(None)
    assert make("cpu").device.type == "cpu"


@pytest.mark.parametrize("fmt", ["text", "binary"])
def test_word_vector_readers_raise_without_a_card(no_cuda, tmp_path, fmt):
    from deeplearning4j_tpu_torch.nlp import serializers as ser
    from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
    from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor
    lk = InMemoryLookupTable(VocabConstructor().build([["a", "b", "a"]]), 4,
                             device="cpu")
    w, r = (("write_word_vectors", "read_word_vectors") if fmt == "text"
            else ("write_word2vec_binary", "read_word2vec_binary"))
    p = str(tmp_path / "v")
    getattr(ser, w)(lk, p)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(ser, r)(p)
    assert getattr(ser, r)(p, device="cpu").syn0.device.type == "cpu"
