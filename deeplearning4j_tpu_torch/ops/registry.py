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
"""

from __future__ import annotations

import threading

import torch

_IMPLS: dict[str, dict[str, callable]] = {}
_LAUNCH_LOCK = threading.Lock()
_LAUNCHES: dict[str, int] = {}


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
        _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + n


def launches() -> dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(_LAUNCHES)


def reset_launches():
    with _LAUNCH_LOCK:
        _LAUNCHES.clear()
