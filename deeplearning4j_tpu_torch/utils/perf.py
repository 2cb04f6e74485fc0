"""Peak rates by card and the FLOP count of one train step (counterpart
of deeplearning4j_tpu/utils/perf.py): the MFU denominator and numerator
for ``PerformanceListener(report_mfu=True)`` and ``step_cost_analysis``.

The JAX package reads a step's operations from XLA's cost model, which
counts elementwise work too. Here ``torch.utils.flop_counter``'s
FlopCounterMode counts the products and convolutions PyTorch runs, and
each hand-written kernel adds its own (``registry.count_flops``), counted
as FlopCounterMode counts the kernel's plain version, so a step counts
the same on the card as on the CPU's plain path. Elementwise work (the
update, activations, batch-norm arithmetic) is not counted.
"""

from __future__ import annotations

import os

import torch

# dense bf16 tensor-core peak FLOP/s by torch.cuda.get_device_name()
# prefix, from NVIDIA's H100 data sheet (dense, without sparsity)
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,   # H100 SXM5, 700 W
    "NVIDIA H100 PCIe": 756e12,          # H100 PCIe, 350 W
}


def device_name(device=None) -> str:
    """The card's name, or "cpu"."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(device)


def peak_flops(device=None) -> float | None:
    """Peak FLOP/s for the MFU denominator. ``DL4J_TPU_PEAK_FLOPS`` wins
    over the table (the only way to an MFU on a card the table does not
    list, or against another peak than bf16's); None when neither knows
    the device."""
    override = os.environ.get("DL4J_TPU_PEAK_FLOPS")
    if override:
        try:
            return float(override)
        except ValueError:
            pass
    name = device if isinstance(device, str) else device_name(device)
    for prefix, peak in PEAK_FLOPS.items():
        if name.startswith(prefix):
            return peak
    return None


def step_flops(net, batch) -> dict:
    """The operations of one train step of ``net`` on ``batch`` (its
    ``_step_batch`` tuple): the loss and its gradients under
    FlopCounterMode, plus what the kernels report. Changes nothing in the
    net (no update, no layer state, the generator restored) and adds
    nothing to the launch counters. Returns {"flops", "kernel_flops"
    {kernel: operations}, "bytes_accessed": None (not counted)}."""
    from torch.utils.flop_counter import FlopCounterMode

    from deeplearning4j_tpu_torch.nn.multistep import step_leaves
    from deeplearning4j_tpu_torch.nn.updater import _leaves
    from deeplearning4j_tpu_torch.ops import registry

    gen_state = net._gen.get_state()
    leaves = step_leaves(net)
    wanted = [t for t in _leaves(leaves) if t.requires_grad]
    try:
        with registry.recording(), registry.counting_flops() as kf, \
                FlopCounterMode(display=False) as fc:
            loss, _ = net._loss(leaves, net.state, *batch, net._gen)
            if wanted:
                torch.autograd.grad(loss, wanted, allow_unused=True)
    finally:
        net._gen.set_state(gen_state)
    total = float(fc.get_total_flops()) + sum(kf.values())
    return {"flops": total, "kernel_flops": dict(kf), "bytes_accessed": None}
