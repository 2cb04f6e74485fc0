"""Loss functions (counterpart of deeplearning4j_tpu/ops/losses.py).

A loss is ``per_example(labels, preout, activation_fn, weights=None)`` ->
the per-example loss summed over the output dims; ``score`` averages it
over the (unmasked) examples, DL4J's "sum over outputs, average over
minibatch" convention. Gradients come from autograd of the whole network.
Masks broadcast against the example axis; ``weights`` are per-output.

The same registry names and the same formulas as the JAX package:
``mcxent`` with a softmax head takes the log-softmax of the pre-output,
``xent`` with a sigmoid head takes the stable logistic form; every other
loss applies the activation and then its elementwise formula.
"""

from __future__ import annotations

import torch

_REGISTRY: dict[str, "Loss"] = {}

_EPS = 1e-7


class Loss:
    """A named loss. ``elementwise(labels, output)`` returns the
    elementwise losses (before the output-dim reduction)."""

    name: str = "base"

    def elementwise(self, labels, output):
        raise NotImplementedError

    def per_example(self, labels, preout, activation_fn, weights=None):
        out = activation_fn(preout)
        l = self.elementwise(labels, out)
        if weights is not None:
            l = l * weights
        return torch.sum(l, dim=-1)

    def __call__(self, labels, preout, activation_fn, mask=None, weights=None):
        return self.score(labels, preout, activation_fn, mask, weights)

    def score(self, labels, preout, activation_fn, mask=None, weights=None):
        per_ex = self.per_example(labels, preout, activation_fn, weights)
        if mask is not None:
            mask = torch.reshape(mask, per_ex.shape).to(per_ex.dtype)
            per_ex = per_ex * mask
            denom = torch.clamp(torch.sum(mask), min=1.0)
        else:
            denom = per_ex.numel()
        return torch.sum(per_ex) / denom


def register(cls):
    inst = cls()
    _REGISTRY[inst.name] = inst
    return cls


def get(name):
    if isinstance(name, Loss):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss '{name}'. Available: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names():
    return sorted(_REGISTRY)


def _clip(x, lo, hi=None):
    return torch.clamp(x, min=lo, max=hi)


@register
class MCXENT(Loss):
    """Multi-class cross entropy, -sum(y * log(p)); with a softmax head the
    pre-output goes through log-softmax."""

    name = "mcxent"

    def elementwise(self, labels, output):
        return -labels * torch.log(_clip(output, _EPS, 1.0 - _EPS))

    def per_example(self, labels, preout, activation_fn, weights=None):
        if getattr(activation_fn, "activation_name", None) == "softmax":
            l = -labels * torch.log_softmax(preout, dim=-1)
        else:
            l = self.elementwise(labels, activation_fn(preout))
        if weights is not None:
            l = l * weights
        return torch.sum(l, dim=-1)


@register
class NegativeLogLikelihood(MCXENT):
    name = "negativeloglikelihood"


@register
class MSE(Loss):
    """Squared error summed over outputs, divided by the output count."""

    name = "mse"

    def elementwise(self, labels, output):
        d = output - labels
        return d * d

    def per_example(self, labels, preout, activation_fn, weights=None):
        l = super().per_example(labels, preout, activation_fn, weights)
        return l / labels.shape[-1]


@register
class L2(Loss):
    name = "l2"

    def elementwise(self, labels, output):
        d = output - labels
        return d * d


@register
class L1(Loss):
    name = "l1"

    def elementwise(self, labels, output):
        return torch.abs(output - labels)


@register
class MAE(Loss):
    name = "mae"

    def elementwise(self, labels, output):
        return torch.abs(output - labels)

    def per_example(self, labels, preout, activation_fn, weights=None):
        l = super().per_example(labels, preout, activation_fn, weights)
        return l / labels.shape[-1]


@register
class XENT(Loss):
    """Binary cross entropy (independent sigmoid outputs)."""

    name = "xent"

    def elementwise(self, labels, output):
        p = _clip(output, _EPS, 1.0 - _EPS)
        return -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))

    def per_example(self, labels, preout, activation_fn, weights=None):
        if getattr(activation_fn, "activation_name", None) == "sigmoid":
            # stable form: max(x, 0) - x*y + log(1 + exp(-|x|))
            x = preout
            l = (torch.clamp(x, min=0.0) - x * labels
                 + torch.log1p(torch.exp(-torch.abs(x))))
        else:
            l = self.elementwise(labels, activation_fn(preout))
        if weights is not None:
            l = l * weights
        return torch.sum(l, dim=-1)


@register
class Hinge(Loss):
    name = "hinge"

    def elementwise(self, labels, output):
        # labels in {-1, +1}
        return torch.clamp(1.0 - labels * output, min=0.0)


@register
class SquaredHinge(Loss):
    name = "squaredhinge"

    def elementwise(self, labels, output):
        h = torch.clamp(1.0 - labels * output, min=0.0)
        return h * h


@register
class KLDivergence(Loss):
    name = "kldivergence"

    def elementwise(self, labels, output):
        y = _clip(labels, _EPS, 1.0)
        p = _clip(output, _EPS, 1.0)
        return y * (torch.log(y) - torch.log(p))


@register
class MAPE(Loss):
    name = "mape"

    def elementwise(self, labels, output):
        return 100.0 * torch.abs((labels - output)
                                 / _clip(torch.abs(labels), _EPS))

    def per_example(self, labels, preout, activation_fn, weights=None):
        l = super().per_example(labels, preout, activation_fn, weights)
        return l / labels.shape[-1]


@register
class MSLE(Loss):
    name = "msle"

    def elementwise(self, labels, output):
        d = torch.log1p(output) - torch.log1p(labels)
        return d * d

    def per_example(self, labels, preout, activation_fn, weights=None):
        l = super().per_example(labels, preout, activation_fn, weights)
        return l / labels.shape[-1]


@register
class Poisson(Loss):
    name = "poisson"

    def elementwise(self, labels, output):
        p = _clip(output, _EPS)
        return p - labels * torch.log(p)


@register
class CosineProximity(Loss):
    name = "cosineproximity"

    def per_example(self, labels, preout, activation_fn, weights=None):
        out = activation_fn(preout)
        if weights is not None:
            out = out * weights
        num = torch.sum(labels * out, dim=-1)
        den = (torch.linalg.vector_norm(labels, dim=-1)
               * torch.linalg.vector_norm(out, dim=-1))
        return -num / _clip(den, _EPS)
