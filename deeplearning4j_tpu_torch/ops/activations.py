"""Activation functions (counterpart of deeplearning4j_tpu/ops/activations.py).

Pure functions on tensors, registered by the same lower-case names that
layer configurations store, so a configuration written by the JAX package
resolves to the same function here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_REGISTRY: dict[str, callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        fn.activation_name = name
        return fn

    return deco


def get(name):
    """Resolve an activation by name (case-insensitive). Callables pass through."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown activation '{name}'. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names():
    return sorted(_REGISTRY)


#: activations that normalize across the feature axis: a layer computed
#: on a slice of its features applies them only after the gather
CROSS_FEATURE = frozenset({"softmax", "logsoftmax"})


def mixes_features(layer) -> bool:
    """Whether ``layer``'s activation mixes its features (softmax)."""
    name = getattr(getattr(layer, "activation_fn", None), "activation_name",
                   None)
    return name in CROSS_FEATURE


@register("identity")
def identity(x):
    return x


@register("relu")
def relu(x):
    return torch.relu(x)


@register("leakyrelu")
def leakyrelu(x, alpha=0.01):
    return F.leaky_relu(x, negative_slope=alpha)


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("softmax")
def softmax(x):
    # row-wise over the feature (last) axis
    return torch.softmax(x, dim=-1)


@register("logsoftmax")
def logsoftmax(x):
    return torch.log_softmax(x, dim=-1)


@register("tanh")
def tanh(x):
    return torch.tanh(x)


@register("softplus")
def softplus(x):
    return F.softplus(x)


@register("softsign")
def softsign(x):
    return F.softsign(x)


@register("elu")
def elu(x, alpha=1.0):
    return F.elu(x, alpha=alpha)


@register("selu")
def selu(x):
    return F.selu(x)


@register("gelu")
def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


@register("swish")
def swish(x):
    return F.silu(x)


@register("hardtanh")
def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


@register("hardsigmoid")
def hardsigmoid(x):
    # DL4J/Keras-1 definition: clip(0.2*x + 0.5, 0, 1)
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


@register("cube")
def cube(x):
    return x * x * x


@register("rationaltanh")
def rationaltanh(x):
    # 1.7159 * sgn(x) * (1 - 1/(1+|a|+a^2+1.41645 a^4)), a = 2x/3
    a = 2.0 * x / 3.0
    f = 1.0 - 1.0 / (1.0 + a.abs() + a * a + 1.41645 * (a ** 4))
    return 1.7159 * torch.sign(x) * f


@register("rectifiedtanh")
def rectifiedtanh(x):
    return torch.clamp(torch.tanh(x), min=0.0)


@register("rrelu")
def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0):
    # inference semantics: the midpoint slope
    mid = (lower + upper) / 2.0
    return torch.where(x >= 0, x, mid * x)


@register("thresholdedrelu")
def thresholdedrelu(x, theta=1.0):
    return torch.where(x > theta, x, torch.zeros_like(x))
