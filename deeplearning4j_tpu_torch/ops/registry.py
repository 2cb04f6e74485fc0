"""Op dispatch by tensor device, plus the kernel launch counters.

The JAX package's registry (deeplearning4j_tpu/ops/registry.py) picks a
backend by a preference order and lets a Pallas op fall back to XLA. Here
the device of the tensors decides, and nothing falls back:

- a CPU tensor runs the op's plain PyTorch version;
- a CUDA tensor runs the op's hand-written kernel, or the kernel's wrapper
  raises (unsupported dtype, shape or activation).

Each kernel wrapper adds to its launch counter the device launches it
makes (one, or each launch of a kernel split into several), so a run can
show which kernels its main path went through.

While a train step is captured as a CUDA graph (nn/multistep.py), its
launches are recorded against that graph instead (``recording``), since
capture runs nothing; each replay then adds the graph's recorded counts
(``add_launches``). So ``launches()`` counts a replayed step as it counts
the same step run eagerly, per kernel and per sm90 counter.

Each kernel wrapper also reports the floating-point operations of what
it launched (``count_flops``), counted as FlopCounterMode counts the
kernel's plain version, for ``step_cost_analysis``: FlopCounterMode sees
PyTorch's operators but not a kernel launched through ``ctypes``.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_IMPLS: dict[str, dict[str, callable]] = {}
_LAUNCH_LOCK = threading.Lock()
_LAUNCHES: dict[str, int] = {}
# open recordings (capture, cost analysis): launches go to the innermost
_RECORDINGS: list[dict[str, int]] = []
_FLOP_COUNTS: list[dict[str, float]] = []


def register(name: str, device_type: str):
    """Register ``fn`` as op ``name`` for tensors on ``device_type``
    ("cpu" or "cuda")."""
    def deco(fn):
        _IMPLS.setdefault(name, {})[device_type] = fn
        return fn

    return deco


def get(name: str, device) -> callable:
    impls = _IMPLS.get(name)
    if not impls:
        raise KeyError(f"No implementation registered for op '{name}'")
    dtype = torch.device(device).type
    if dtype not in impls:
        raise NotImplementedError(
            f"op '{name}' has no implementation for {dtype} tensors "
            f"(registered: {sorted(impls)})")
    return impls[dtype]


def count_launch(kernel: str, n: int = 1):
    with _LAUNCH_LOCK:
        into = _RECORDINGS[-1] if _RECORDINGS else _LAUNCHES
        into[kernel] = into.get(kernel, 0) + n


@contextlib.contextmanager
def recording():
    """Launches made while open go to the dict this yields, not to the
    global counters (a step being captured, or one run only to count its
    operations). The autograd engine launches a backward kernel from its
    own thread, so this is process-wide, not per thread."""
    rec: dict[str, int] = {}
    with _LAUNCH_LOCK:
        _RECORDINGS.append(rec)
    try:
        yield rec
    finally:
        with _LAUNCH_LOCK:
            _RECORDINGS.remove(rec)


def add_launches(counts: dict[str, int], times: int = 1):
    """Adds ``counts`` ``times`` over (a replayed graph's launches)."""
    for kernel, n in counts.items():
        count_launch(kernel, n * times)


def launches() -> dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(_LAUNCHES)


def reset_launches():
    with _LAUNCH_LOCK:
        _LAUNCHES.clear()


def count_flops(kernel: str, flops: float):
    """Adds a kernel's operations to every open ``counting_flops``."""
    with _LAUNCH_LOCK:
        for into in _FLOP_COUNTS:
            into[kernel] = into.get(kernel, 0.0) + float(flops)


@contextlib.contextmanager
def counting_flops():
    """{kernel: operations} of the kernels launched while open."""
    rec: dict[str, float] = {}
    with _LAUNCH_LOCK:
        _FLOP_COUNTS.append(rec)
    try:
        yield rec
    finally:
        with _LAUNCH_LOCK:
            _FLOP_COUNTS.remove(rec)
