"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. A library
is built at first use into the build directory and its file name carries
a hash of the sources, the flags, the headers in ``csrc/`` and the
``nvcc`` release, so a changed source or another toolkit is rebuilt and
an unchanged one is reused.

The build directory is ``BUILD_DIR`` (``deeplearning4j_tpu_torch/build/``,
listed in ``.gitignore``) unless the compile cache
(compilecache/cache.py: ``configure(dir)`` or ``$DL4J_TPU_COMPILE_CACHE``)
points it elsewhere, for example at a directory a fleet of hosts shares.
A library is written under a temporary name unique to its process and
thread and renamed into place, so two builders of one library (threads,
or processes on a shared directory) never see each other's partial file.
``build()`` compiles several sources at once, one ``nvcc`` process each.
Each build counts as a compile and a build-cache miss in the metrics
registry (observability/metrics.py), each library loaded as it was
found on disk as a cache hit. ``libraries_for(net)`` names the libraries
a net's forward, train step or decode path reaches.

``load_host(name)`` builds and loads the host libraries the same way
with ``g++`` instead of ``nvcc``: the native data loader
(``native/dataloader.cpp``, datasets/native_io.py), compiled into the
same build directory, never beside its source. A missing ``g++`` or
source raises ``KernelBuildError`` naming it.

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
import uuid
from pathlib import Path

from deeplearning4j_tpu_torch.observability import metrics as _metrics

CSRC = Path(__file__).resolve().parent / "csrc"
#: the default build directory (the compile cache may point elsewhere)
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
KERNELS = ("lstm_fwd", "lstm_bwd", "flash_attn_fwd", "fused_block",
           "stream_exact")

#: the library each launch counter's kernel lives in (ops/registry.py)
COUNTER_LIBRARY = {
    "lstm_fwd": "lstm_fwd", "lstm_fwd_sm90": "lstm_fwd",
    "lstm_fwd_wide": "lstm_fwd",
    "lstm_bwd": "lstm_bwd", "lstm_bwd_sm90": "lstm_bwd",
    "lstm_bwd_wide": "lstm_bwd",
    "flash_attn_fwd": "flash_attn_fwd",
    "flash_attn_fwd_sm90": "flash_attn_fwd",
    "flash_attn_fwd_wide": "flash_attn_fwd",
    "stream_dense": "stream_exact", "stream_mha": "stream_exact",
    "stream_rownorm": "stream_exact",
    **{f"fused_block_{k}{s}": "fused_block"
       for k in ("stats", "apply", "bwd_stats", "bwd_apply")
       for s in ("", "_sm90")},
}

#: the libraries each layer configuration's ops reach, by path: the
#: forward (``output``, served rows), what a train step adds (the
#: backward) and the streaming path (``rnn_time_step``, decode)
LAYER_LIBRARIES = {
    "GravesLSTM": {"forward": ("lstm_fwd",), "train": ("lstm_bwd",),
                   "decode": ("lstm_fwd",)},
    "GravesBidirectionalLSTM": {"forward": ("lstm_fwd",),
                                "train": ("lstm_bwd",),
                                "decode": ("lstm_fwd",)},
    "SelfAttention": {"forward": ("flash_attn_fwd",), "train": (),
                      "decode": ("stream_exact",)},
    "TransformerBlock": {"forward": ("flash_attn_fwd",), "train": (),
                         "decode": ("stream_exact",)},
    "GptOutput": {"forward": (), "train": (), "decode": ("stream_exact",)},
}
#: host libraries built by ``g++`` from C++ sources outside csrc/
HOST_SOURCES = {
    "dl4jtpu_io": Path(__file__).resolve().parents[2] / "native"
    / "dataloader.cpp"}
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
             "-pthread")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v", "-ldl")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_BUILT: set = set()     # libraries nvcc built in this process
_DIR = [BUILD_DIR]      # the build directory in use
_RELEASE: list = []     # nvcc's release line, read once a process
_GXX_RELEASE: list = []  # g++'s version line, read once a process


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


def nvcc_release() -> str:
    """The first line of ``nvcc --version`` that names the release
    ("Cuda compilation tools, release 12.4, V12.4.131"), read once a
    process; "nvcc not found" where there is none (the key stays
    computable on a machine without the toolkit)."""
    if not _RELEASE:
        try:
            out = subprocess.run([nvcc_path(), "--version"],
                                 capture_output=True, text=True,
                                 timeout=60).stdout
            line = next((ln.strip() for ln in out.splitlines()
                         if "release" in ln), out.strip())
        except (KernelBuildError, OSError, subprocess.SubprocessError):
            line = "nvcc not found"
        _RELEASE[:] = [line]
    return _RELEASE[0]


def build_dir() -> Path:
    """The build directory in use: ``BUILD_DIR`` unless the compile
    cache points elsewhere."""
    return _DIR[0]


def set_build_dir(path=None) -> Path:
    """Point builds and loads at ``path`` (``BUILD_DIR`` for None).
    Libraries already loaded stay loaded: their sources are the same."""
    _DIR[0] = BUILD_DIR if path is None else Path(path)
    return _DIR[0]


def _configure_from_env():
    """``$DL4J_TPU_COMPILE_CACHE`` takes effect at the first build or
    load, whichever entry point ran first."""
    from deeplearning4j_tpu_torch.compilecache import cache
    cache.ensure_configured()


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_release().encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def temp_path(out: Path) -> Path:
    """Where ``out`` is written before its rename: a name unique to this
    process and thread, in the same directory."""
    return out.with_name(f".{out.name}.{os.getpid()}."
                         f"{uuid.uuid4().hex[:12]}.tmp")


def libraries_for(net, *, train: bool = False, decode: bool = False
                  ) -> tuple:
    """The libraries ``net``'s forward reaches, with what its train step
    (``train``) and its streaming path (``decode``) add, in ``KERNELS``
    order. Read from the layer configurations (``LAYER_LIBRARIES``); a
    graph's fused bottleneck tails add ``fused_block`` to its train step
    (eval is never fused)."""
    names = set()
    paths = ("forward",) + (("train",) if train else ()) \
        + (("decode",) if decode else ())
    for layer in net.layers or ():
        libs = LAYER_LIBRARIES.get(type(layer.conf).__name__, {})
        for p in paths:
            names.update(libs.get(p, ()))
    if train and getattr(net, "_fusion_plans", None):
        names.add("fused_block")
    return tuple(k for k in KERNELS if k in names)


def build(names=KERNELS) -> dict:
    """Compile every library in ``names`` that is not built yet, all in
    parallel. Returns {name: {"seconds", "log"}} for those compiled here;
    raises KernelBuildError with nvcc's output if any fails."""
    _configure_from_env()
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = temp_path(out)
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
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
    if name not in _LIBS:
        _configure_from_env()
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


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise KernelBuildError(
            "g++ not found (put it on PATH); the native data loader "
            "(native/dataloader.cpp) is built from source at first use")
    return found


def host_library_path(name: str) -> Path:
    """Where host library ``name`` lives in the build directory: its
    file name hashes the flags, the ``g++`` version and the source."""
    source = HOST_SOURCES[name]
    if not source.exists():
        raise KernelBuildError(f"{source} not found: the source of the "
                               f"host library {name}")
    if not _GXX_RELEASE:
        out = subprocess.run([gxx_path(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
        _GXX_RELEASE[:] = [out.splitlines()[0] if out else "g++"]
    h = hashlib.sha256()
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_GXX_RELEASE[0].encode())
    h.update(source.read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` (``HOST_SOURCES``), compiled by
    ``g++`` into the build directory first if it is not there."""
    if name not in _LIBS:
        _configure_from_env()
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            out = host_library_path(name)
            if out.exists():
                _metrics.note_cache(hit=True)
            else:
                build_dir().mkdir(parents=True, exist_ok=True)
                tmp = temp_path(out)
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [gxx_path(), *GXX_FLAGS, str(HOST_SOURCES[name]), "-o",
                     str(tmp)], capture_output=True, text=True, timeout=600)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise KernelBuildError(
                        f"{name}: g++ exited {proc.returncode}\n"
                        f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
                _metrics.note_compile(time.perf_counter() - t0)
                _metrics.note_cache(hit=False)
            lib = ctypes.CDLL(str(out))
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
