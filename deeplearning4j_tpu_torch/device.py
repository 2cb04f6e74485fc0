"""Device resolution for the port's entry points.

Every entry point (``MultiLayerNetwork``, ``zoo.char_rnn``,
``restore_multi_layer_network``) runs on the card unless the caller asks
for another device: ``device=None`` means ``"cuda"``, and without CUDA
that is an error, never a quiet fall back to the CPU. Tests pass
``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deeplearning4j_tpu_torch runs on a CUDA device by default "
                "and none is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
