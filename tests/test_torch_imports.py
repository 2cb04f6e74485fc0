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
