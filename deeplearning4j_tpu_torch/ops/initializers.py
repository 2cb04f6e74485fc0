"""Weight initialization (counterpart of deeplearning4j_tpu/ops/initializers.py).

Each initializer is ``fn(gen, shape, fan_in, fan_out, dtype, device)`` and
draws from an explicit ``torch.Generator``; on the ``meta`` device it
draws nothing and returns the shape and dtype alone (a structure-only
``init``). The draws are made on the CPU and then moved, so one seed
gives the same weights on every device. They
do not reproduce ``jax.random``'s bits; only the distributions (moments and
bounds) match the JAX package. A model is carried across bit for bit
through the zip format instead (utils/serialization.py).
"""

from __future__ import annotations

import math

import torch

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get(name):
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown weight init '{name}'. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names():
    return sorted(_REGISTRY)


def _structure_only(device):
    """A ``meta`` device asks for shapes and dtypes only: nothing is
    drawn (a structure-only ``init``)."""
    return torch.device(device).type == "meta"


def _normal(gen, shape, std, dtype, device, mean=0.0):
    if _structure_only(device):
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32)
    return (mean + std * x).to(device=device, dtype=dtype)


def _uniform(gen, shape, lo, hi, dtype, device):
    if _structure_only(device):
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (lo + (hi - lo) * x).to(device=device, dtype=dtype)


@register("zero")
def zero(gen, shape, fan_in, fan_out, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


@register("ones")
def ones(gen, shape, fan_in, fan_out, dtype=torch.float32, device="cpu"):
    return torch.ones(shape, dtype=dtype, device=device)


@register("uniform")
def uniform(gen, shape, fan_in, fan_out, dtype=torch.float32, device="cpu"):
    a = 1.0 / math.sqrt(fan_in)
    return _uniform(gen, shape, -a, a, dtype, device)


@register("xavier")
def xavier(gen, shape, fan_in, fan_out, dtype=torch.float32, device="cpu"):
    # Gaussian, var = 2/(fanIn + fanOut)
    return _normal(gen, shape, math.sqrt(2.0 / (fan_in + fan_out)), dtype,
                   device)


@register("xavier_uniform")
def xavier_uniform(gen, shape, fan_in, fan_out, dtype=torch.float32,
                   device="cpu"):
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, -a, a, dtype, device)


@register("xavier_fan_in")
def xavier_fan_in(gen, shape, fan_in, fan_out, dtype=torch.float32,
                  device="cpu"):
    return _normal(gen, shape, math.sqrt(1.0 / fan_in), dtype, device)


@register("xavier_legacy")
def xavier_legacy(gen, shape, fan_in, fan_out, dtype=torch.float32,
                  device="cpu"):
    return _normal(gen, shape, math.sqrt(1.0 / (fan_in + fan_out)), dtype,
                   device)


@register("relu")
def relu(gen, shape, fan_in, fan_out, dtype=torch.float32, device="cpu"):
    # He init: N(0, 2/fanIn)
    return _normal(gen, shape, math.sqrt(2.0 / fan_in), dtype, device)


@register("relu_uniform")
def relu_uniform(gen, shape, fan_in, fan_out, dtype=torch.float32,
                 device="cpu"):
    a = math.sqrt(6.0 / fan_in)
    return _uniform(gen, shape, -a, a, dtype, device)


@register("sigmoid_uniform")
def sigmoid_uniform(gen, shape, fan_in, fan_out, dtype=torch.float32,
                    device="cpu"):
    a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, -a, a, dtype, device)


@register("normal")
def normal(gen, shape, fan_in, fan_out, dtype=torch.float32, device="cpu",
           std=1.0):
    return _normal(gen, shape, std, dtype, device)


def distribution(dist: dict):
    """WeightInit.DISTRIBUTION: {"type": "normal", "mean", "std"},
    {"type": "uniform", "lower", "upper"} or
    {"type": "binomial", "trials", "probability"}."""

    def init(gen, shape, fan_in, fan_out, dtype=torch.float32, device="cpu"):
        t = dist.get("type", "normal")
        if t in ("normal", "gaussian"):
            return _normal(gen, shape, dist.get("std", 1.0), dtype, device,
                           mean=dist.get("mean", 0.0))
        if t == "uniform":
            return _uniform(gen, shape, dist.get("lower", -1.0),
                            dist.get("upper", 1.0), dtype, device)
        if t == "binomial":
            if _structure_only(device):
                return torch.empty(shape, dtype=dtype, device=device)
            probs = torch.full(shape, float(dist.get("probability", 0.5)))
            trials = torch.full(shape, float(dist.get("trials", 1)))
            x = torch.binomial(trials, probs, generator=gen)
            return x.to(device=device, dtype=dtype)
        raise ValueError(f"Unknown distribution type {t}")

    return init


def resolve(spec):
    """A weight-init spec — a name or a distribution dict — to an init fn."""
    return distribution(spec) if isinstance(spec, dict) else get(spec)
