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

A call on a CUDA tensor that the JAX package's own predicates send to
XLA, and that the op's kernel does not cover (another activation pair,
a dtype other than f32 and bf16, a decode-shaped attention call), takes
the op's composed route: its plain PyTorch version on the card's
tensors, what the JAX package's XLA route is. Each wrapper decides that
by a pure route function of shapes, dtypes and activations before any
launch, never after a failure, and counts the call under
``<op>:composed[<reason>]`` (``count_route``; ``routes()`` lists them),
logged once per (op, reason); the kernel's own counters do not move.
There is no knob: the kernel runs wherever it covers the call.

For the same reason each kernel wrapper reports its call to the fx lint's
recorder (``note_kernel``, analysis/fx_lint.py): a ``TorchDispatchMode``
sees the ``empty`` that allocates a kernel's output but not the kernel,
so the recorded graph shows each kernel as a node of its own, with its
counters and the dtypes of what it returns.
"""

from __future__ import annotations

import contextlib
import logging
import threading

import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")

_IMPLS: dict[str, dict[str, callable]] = {}
_LAUNCH_LOCK = threading.Lock()
_LAUNCHES: dict[str, int] = {}
# open recordings (capture, cost analysis): launches go to the innermost
_RECORDINGS: list[dict[str, int]] = []
_FLOP_COUNTS: list[dict[str, float]] = []
_KERNEL_SINKS: list = []
# route counters already logged once
_ROUTES_LOGGED: set = set()
COMPOSED = ":composed["


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


def count_route(op: str, reason: str):
    """Counts one call of ``op`` on its composed route for ``reason``
    (e.g. ``lstm_sequence:composed[gate_act=hardsigmoid]``), beside the
    launch counters so a captured step counts it per replay; the first
    such call of each (op, reason) in a process is logged."""
    name = f"{op}{COMPOSED}{reason}]"
    count_launch(name)
    with _LAUNCH_LOCK:
        first = name not in _ROUTES_LOGGED
        _ROUTES_LOGGED.add(name)
    if first:
        logger.info("%s runs its composed route (the plain version on the "
                    "card): %s", op, reason)


def routes() -> dict[str, int]:
    """The composed-route counters among ``launches()``."""
    return {k: n for k, n in launches().items() if COMPOSED in k}


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


def note_kernel(kernel: str, outputs, also=()):
    """Reports one kernel wrapper call to every open ``recording_kernels``:
    ``sink(names, out_dtypes)`` with the counters the call added to
    (``kernel``, then ``also``, such as its sm90 counter) and the dtypes
    of the tensors it returns (``outputs``: a tensor or a sequence)."""
    if not _KERNEL_SINKS:
        return
    outs = [outputs] if isinstance(outputs, torch.Tensor) else outputs
    names = (kernel,) + tuple(also)
    dtypes = tuple(t.dtype for t in outs if isinstance(t, torch.Tensor))
    with _LAUNCH_LOCK:
        sinks = list(_KERNEL_SINKS)
    for sink in sinks:
        sink(names, dtypes)


@contextlib.contextmanager
def recording_kernels(sink):
    """While open, each kernel wrapper call is passed to ``sink`` (see
    ``note_kernel``). Process-wide, as ``recording``: the autograd engine
    runs a backward on a thread of its own."""
    with _LAUNCH_LOCK:
        _KERNEL_SINKS.append(sink)
    try:
        yield sink
    finally:
        with _LAUNCH_LOCK:
            _KERNEL_SINKS.remove(sink)
