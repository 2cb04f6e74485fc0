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
    net = zoo.char_rnn(hidden=8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(net.conf)
    path = tmp_path / "m.zip"
    serialization.write_model(net, str(path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serialization.restore_multi_layer_network(str(path))
    assert serialization.restore_multi_layer_network(
        str(path), device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_card(no_cuda):
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(ROOT))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
