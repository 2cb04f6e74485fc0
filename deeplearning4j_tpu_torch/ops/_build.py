"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. A library
is built at first use into ``deeplearning4j_tpu_torch/build/`` (listed in
``.gitignore``) and its file name carries a hash of the sources and the
flags (and of the headers in ``csrc/``), so a changed source is rebuilt
and an unchanged one is reused.
``build()`` compiles several sources at once, one ``nvcc`` process each.
Each build counts as a compile and a build-cache miss in the metrics
registry (observability/metrics.py), each library loaded as it was
found on disk as a cache hit.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from deeplearning4j_tpu_torch.observability import metrics as _metrics

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
KERNELS = ("lstm_fwd", "lstm_bwd", "flash_attn_fwd", "fused_block",
           "stream_exact")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v", "-ldl")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_BUILT: set = set()     # libraries nvcc built in this process


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every library in ``names`` that is not built yet, all in
    parallel. Returns {name: {"seconds", "log"}} for those compiled here;
    raises KernelBuildError with nvcc's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
        _BUILT.add(name)
        _metrics.note_compile(done[name]["seconds"])
        _metrics.note_cache(hit=False)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            elif name not in _BUILT:
                _metrics.note_cache(hit=True)
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def sass_counts(name: str, opcodes, function: str = "") -> dict:
    """How many times each SASS opcode in ``opcodes`` (e.g. HGMMA,
    UTMALDG) appears in the built library of kernel ``name``, from
    ``cuobjdump -sass``: which instructions the compiler emitted. Only the
    functions whose mangled name holds ``function`` count (all by
    default), so one template instantiation can be read alone."""
    tool = Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library_path(name))],
                          check=True, capture_output=True, text=True).stdout
    if function:  # each function's code follows "Function : <name>"
        sass = "\n".join(f for f in sass.split("Function : ")[1:]
                         if function in f.split(None, 1)[0])
    words = [w.split(".")[0] for line in sass.splitlines()
             for w in line.replace(";", " ").split()]
    return {op: words.count(op) for op in opcodes}
