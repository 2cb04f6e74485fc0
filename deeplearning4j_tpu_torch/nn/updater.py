"""Updaters (optimizer rules and state), learning-rate schedules and
gradient normalization (counterpart of deeplearning4j_tpu/nn/updater.py).

Configurations name an updater and a schedule; their fields, kinds and
``to_dict``/``from_dict`` forms match the JAX package's exactly, so
``configuration.json`` crosses between the packages.

An updater is ``init_state(params) -> state`` and
``update(grads, state, lr) -> (deltas, new_state)`` over a layer's dict of
tensors, with ``new_params = params - deltas``: the same rules, in the same
operation order, as the JAX package. Optimizer state is a dict mirroring
the params (plus an int32 step count ``t`` for Adam and AdaMax), keyed as
the JAX package keys it, so ``updaterState.npz`` crosses too.

``apply_layer_updates`` runs the whole update in the master dtype, in
place: each updater's ``update_`` applies the rule with multi-tensor
(``torch._foreach_*``) operations over every tensor of the layers that
share that updater and base rate, one operation of the rule at a time in
the order ``update`` computes it, so the result is ``update``'s bit for
bit (``apply_layer_updates_plain`` keeps the per-tensor path as the plain
version). Parameters and every updater slot are written into the tensors
already there, so a captured train step (nn/multistep.py) updates the
same storage on every replay. The scheduled rate is read from the
iteration as given: a Python int, or the net's int32 device twin of it,
which a captured step advances on the card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch


def _map(fn, *trees):
    """``fn`` over the leaves of same-shaped nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _copy_tree(tree):
    """A copy of a nested dict of tensors that shares no storage."""
    return _map(lambda t: t.detach().clone(), tree)


def _leaves(tree):
    """Leaves in the JAX package's tree order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _fill(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in the order
    of ``_leaves``."""
    if isinstance(tree, dict):
        return {k: _fill(tree[k], it) for k in sorted(tree)}
    return next(it)


def _unzip(pairs, n):
    """A tree of n-tuples -> n trees."""
    if isinstance(pairs, dict):
        parts = {k: _unzip(v, n) for k, v in pairs.items()}
        return tuple({k: parts[k][i] for k in parts} for i in range(n))
    return pairs


def _lr_dtype(lr):
    """The dtype lr arithmetic runs in: the schedule output's own (the
    master dtype under apply_layer_updates), f32 for plain floats."""
    return lr.dtype if isinstance(lr, torch.Tensor) else torch.float32


def _moment_(acc, xs, decay, squared=False):
    """acc = decay * acc + (1 - decay) * x (times x again when
    ``squared``), in place, as ``update`` orders it."""
    torch._foreach_mul_(acc, decay)
    tmp = torch._foreach_mul(xs, 1 - decay)
    if squared:
        torch._foreach_mul_(tmp, xs)
    torch._foreach_add_(acc, tmp)


def _times_layer_alpha(m, ts, spans, alpha_of, lr):
    """alpha * m for every tensor, alpha a 0-d tensor of each layer's own
    step count (``alpha_of(t)``, computed as ``update`` computes it)."""
    out = []
    for (start, stop), t in zip(spans, ts):
        alpha = alpha_of(t.to(_lr_dtype(lr)))
        out += torch._foreach_mul(m[start:stop], alpha)
    return out

_UPDATERS: dict[str, type] = {}
_SCHEDULES: dict[str, type] = {}


def register_updater(cls):
    _UPDATERS[cls.kind] = cls
    return cls


def updater_from_dict(d: dict) -> "Updater":
    d = dict(d)
    kind = d.pop("kind")
    return _UPDATERS[kind](**d)


@dataclass(frozen=True)
class Updater:
    """Base optimizer config. Stateless; per-parameter state is a dict."""

    kind = "base"
    learning_rate: float = 0.1

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["kind"] = self.kind
        return d

    def init_state(self, params):
        return {}

    def update(self, grads, state, lr):
        raise NotImplementedError

    def update_(self, ps, gs, slots, lr, spans):
        """``update`` in place over flat lists: ``ps`` the parameters and
        ``gs`` their gradients (left as they are), ``slots`` {slot: list
        aligned with ``ps``} (the step count ``t``: one tensor a layer),
        ``spans`` each layer's [start, stop) in ``ps``. Writes the new
        parameters and slots into the tensors given, computing each value
        with ``update``'s operations in ``update``'s order."""
        raise NotImplementedError

    @staticmethod
    def _zeros_like(params):
        return _map(torch.zeros_like, params)

    @staticmethod
    def _step_count(params):
        device = next(_leaves(params)).device
        return torch.zeros((), dtype=torch.int32, device=device)


@register_updater
@dataclass(frozen=True)
class Sgd(Updater):
    kind = "sgd"

    def update(self, grads, state, lr):
        return _map(lambda g: lr * g, grads), state

    def update_(self, ps, gs, slots, lr, spans):
        torch._foreach_sub_(ps, torch._foreach_mul(gs, lr))


@register_updater
@dataclass(frozen=True)
class Nesterovs(Updater):
    """ND4J's NesterovsUpdater: v = mu*v - lr*g; the delta subtracted from
    the params is mu*v_prev - (1+mu)*v."""

    kind = "nesterovs"
    learning_rate: float = 0.1
    momentum: float = 0.9

    def init_state(self, params):
        return {"v": self._zeros_like(params)}

    def update(self, grads, state, lr):
        mu = self.momentum

        def upd(g, v):
            v_new = mu * v - lr * g
            return mu * v - (1.0 + mu) * v_new, v_new

        deltas, v = _unzip(_map(upd, grads, state["v"]), 2)
        return deltas, {"v": v}

    def update_(self, ps, gs, slots, lr, spans):
        mu, v = self.momentum, slots["v"]
        lg = torch._foreach_mul(gs, lr)
        torch._foreach_mul_(v, mu)                     # mu * v
        v_new = torch._foreach_sub(v, lg)              # mu * v - lr * g
        del lg
        torch._foreach_sub_(v, torch._foreach_mul(v_new, 1.0 + mu))
        torch._foreach_sub_(ps, v)                     # v holds the delta
        torch._foreach_copy_(v, v_new)


@register_updater
@dataclass(frozen=True)
class Adam(Updater):
    kind = "adam"
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": self._zeros_like(params), "v": self._zeros_like(params),
                "t": self._step_count(params)}

    def update(self, grads, state, lr):
        t = state["t"] + 1
        b1, b2 = self.beta1, self.beta2
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = _map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
        # the bias correction in the master dtype from the integer count
        tf = t.to(_lr_dtype(lr))
        alpha = lr * torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
        deltas = _map(lambda m_, v_: alpha * m_ / (torch.sqrt(v_)
                                                   + self.epsilon), m, v)
        return deltas, {"m": m, "v": v, "t": t}

    def update_(self, ps, gs, slots, lr, spans):
        b1, b2 = self.beta1, self.beta2
        m, v, ts = slots["m"], slots["v"], slots["t"]
        torch._foreach_add_(ts, 1)
        _moment_(m, gs, b1)
        _moment_(v, gs, b2, squared=True)
        x = _times_layer_alpha(m, ts, spans, lambda tf: lr * torch.sqrt(
            1 - b2 ** tf) / (1 - b1 ** tf), lr)
        den = torch._foreach_sqrt(v)
        torch._foreach_add_(den, self.epsilon)
        torch._foreach_div_(x, den)
        torch._foreach_sub_(ps, x)


@register_updater
@dataclass(frozen=True)
class AdaMax(Updater):
    kind = "adamax"
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": self._zeros_like(params), "u": self._zeros_like(params),
                "t": self._step_count(params)}

    def update(self, grads, state, lr):
        t = state["t"] + 1
        b1, b2 = self.beta1, self.beta2
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        u = _map(lambda u_, g: torch.maximum(b2 * u_, torch.abs(g)),
                 state["u"], grads)
        tf = t.to(_lr_dtype(lr))
        alpha = lr / (1 - b1 ** tf)
        deltas = _map(lambda m_, u_: alpha * m_ / (u_ + self.epsilon), m, u)
        return deltas, {"m": m, "u": u, "t": t}

    def update_(self, ps, gs, slots, lr, spans):
        b1, b2 = self.beta1, self.beta2
        m, u, ts = slots["m"], slots["u"], slots["t"]
        torch._foreach_add_(ts, 1)
        _moment_(m, gs, b1)
        torch._foreach_mul_(u, b2)
        torch._foreach_maximum_(u, torch._foreach_abs(gs))
        x = _times_layer_alpha(m, ts, spans,
                               lambda tf: lr / (1 - b1 ** tf), lr)
        torch._foreach_div_(x, torch._foreach_add(u, self.epsilon))
        torch._foreach_sub_(ps, x)


@register_updater
@dataclass(frozen=True)
class AdaGrad(Updater):
    kind = "adagrad"
    learning_rate: float = 1e-1
    epsilon: float = 1e-6

    def init_state(self, params):
        return {"h": self._zeros_like(params)}

    def update(self, grads, state, lr):
        h = _map(lambda h_, g: h_ + g * g, state["h"], grads)
        deltas = _map(lambda g, h_: lr * g / (torch.sqrt(h_) + self.epsilon),
                      grads, h)
        return deltas, {"h": h}

    def update_(self, ps, gs, slots, lr, spans):
        h = slots["h"]
        torch._foreach_add_(h, torch._foreach_mul(gs, gs))
        x = torch._foreach_mul(gs, lr)
        den = torch._foreach_sqrt(h)
        torch._foreach_add_(den, self.epsilon)
        torch._foreach_div_(x, den)
        torch._foreach_sub_(ps, x)


@register_updater
@dataclass(frozen=True)
class AdaDelta(Updater):
    kind = "adadelta"
    rho: float = 0.95
    epsilon: float = 1e-6
    learning_rate: float = 1.0  # unused by the rule; kept for the JSON

    def init_state(self, params):
        return {"eg": self._zeros_like(params), "ex": self._zeros_like(params)}

    def update(self, grads, state, lr):
        rho, eps = self.rho, self.epsilon

        def upd(g, eg, ex):
            eg_new = rho * eg + (1 - rho) * g * g
            delta = torch.sqrt(ex + eps) / torch.sqrt(eg_new + eps) * g
            ex_new = rho * ex + (1 - rho) * delta * delta
            return delta, eg_new, ex_new

        deltas, eg, ex = _unzip(_map(upd, grads, state["eg"], state["ex"]), 3)
        return deltas, {"eg": eg, "ex": ex}

    def update_(self, ps, gs, slots, lr, spans):
        rho, eps = self.rho, self.epsilon
        eg, ex = slots["eg"], slots["ex"]
        _moment_(eg, gs, rho, squared=True)
        delta = torch._foreach_add(ex, eps)
        torch._foreach_sqrt_(delta)
        den = torch._foreach_add(eg, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(delta, den)
        torch._foreach_mul_(delta, gs)
        _moment_(ex, delta, rho, squared=True)
        torch._foreach_sub_(ps, delta)


@register_updater
@dataclass(frozen=True)
class RmsProp(Updater):
    kind = "rmsprop"
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"g2": self._zeros_like(params)}

    def update(self, grads, state, lr):
        d = self.rms_decay
        g2 = _map(lambda a, g: d * a + (1 - d) * g * g, state["g2"], grads)
        deltas = _map(lambda g, a: lr * g / torch.sqrt(a + self.epsilon),
                      grads, g2)
        return deltas, {"g2": g2}

    def update_(self, ps, gs, slots, lr, spans):
        g2 = slots["g2"]
        _moment_(g2, gs, self.rms_decay, squared=True)
        x = torch._foreach_mul(gs, lr)
        den = torch._foreach_add(g2, self.epsilon)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(x, den)
        torch._foreach_sub_(ps, x)


@register_updater
@dataclass(frozen=True)
class NoOp(Updater):
    """For frozen layers: the gradient is discarded."""

    kind = "noop"
    learning_rate: float = 0.0

    def update(self, grads, state, lr):
        return _map(torch.zeros_like, grads), state

    def update_(self, ps, gs, slots, lr, spans):
        pass  # p - 0 is p, bit for bit (-0.0 and NaN included)


# ------------------------------------------------------------- schedules
def register_schedule(cls):
    _SCHEDULES[cls.kind] = cls
    return cls


def schedule_from_dict(d):
    if d is None:
        return NoneSchedule()
    d = dict(d)
    kind = d.pop("kind")
    # JSON turns int dict keys into strings; restore for map schedules
    if "schedule" in d and isinstance(d["schedule"], dict):
        d["schedule"] = {int(k): float(v) for k, v in d["schedule"].items()}
    return _SCHEDULES[kind](**d)


def _const(v, dtype, step=None):
    """``v`` as a 0-d tensor of ``dtype`` on the device of ``step`` (a
    fill, which a CUDA graph can capture; a copy from the host it
    cannot)."""
    device = step.device if isinstance(step, torch.Tensor) else None
    return torch.full((), v, dtype=dtype, device=device)


def _step(step, dtype):
    return torch.as_tensor(step).to(dtype)


@dataclass(frozen=True)
class Schedule:
    """``schedule(base_lr, step, dtype)`` -> the rate at ``step`` as a 0-d
    tensor of ``dtype`` (the master dtype under apply_layer_updates, f32
    by default), computed entirely in that dtype."""

    kind = "base"

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["kind"] = self.kind
        return d

    def __call__(self, base_lr, step, dtype=None):
        raise NotImplementedError


@register_schedule
@dataclass(frozen=True)
class NoneSchedule(Schedule):
    kind = "none"

    def __call__(self, base_lr, step, dtype=None):
        return _const(base_lr, dtype or torch.float32, step)


@register_schedule
@dataclass(frozen=True)
class Exponential(Schedule):
    kind = "exponential"
    decay_rate: float = 0.99

    def __call__(self, base_lr, step, dtype=None):
        dtype = dtype or torch.float32
        return _const(base_lr, dtype, step) * _const(
            self.decay_rate, dtype, step) ** _step(step, dtype)


@register_schedule
@dataclass(frozen=True)
class Inverse(Schedule):
    kind = "inverse"
    gamma: float = 1e-3
    power: float = 1.0

    def __call__(self, base_lr, step, dtype=None):
        dtype = dtype or torch.float32
        return _const(base_lr, dtype, step) / (
            1.0 + self.gamma * _step(step, dtype)) ** self.power


@register_schedule
@dataclass(frozen=True)
class Poly(Schedule):
    kind = "poly"
    power: float = 1.0
    max_iter: int = 10000

    def __call__(self, base_lr, step, dtype=None):
        dtype = dtype or torch.float32
        frac = torch.clamp(_step(step, dtype) / self.max_iter, 0.0, 1.0)
        return _const(base_lr, dtype, step) * (1.0 - frac) ** self.power


@register_schedule
@dataclass(frozen=True)
class Sigmoid(Schedule):
    kind = "sigmoid"
    gamma: float = 1e-2
    steps: int = 1000

    def __call__(self, base_lr, step, dtype=None):
        dtype = dtype or torch.float32
        return _const(base_lr, dtype, step) / (
            1.0 + torch.exp(self.gamma * (_step(step, dtype) - self.steps)))


@register_schedule
@dataclass(frozen=True)
class Step(Schedule):
    kind = "step"
    decay_rate: float = 0.1
    steps: int = 1000

    def __call__(self, base_lr, step, dtype=None):
        dtype = dtype or torch.float32
        return _const(base_lr, dtype, step) * _const(
            self.decay_rate, dtype, step) ** torch.floor(
                _step(step, dtype) / self.steps)


@register_schedule
@dataclass(frozen=True)
class MapSchedule(Schedule):
    """{iteration: lr}; the lr at step t is the value of the largest key
    <= t (base_lr before the first)."""
    kind = "map"
    schedule: dict = field(default_factory=dict)

    def __call__(self, base_lr, step, dtype=None):
        dtype = dtype or torch.float32
        lr = _const(base_lr, dtype, step)
        at = torch.as_tensor(step)
        for it in sorted(self.schedule):
            lr = torch.where(at >= it, _const(self.schedule[it], dtype, step),
                             lr)
        return lr


# ---------------------------------------------------------------------------
# Gradient normalization (the reference's GradientNormalization modes)
# ---------------------------------------------------------------------------

def _l2(leaves):
    return torch.sqrt(sum(torch.sum(g * g) for g in leaves))


def normalize_gradients(grads, mode, threshold: float = 1.0):
    """One layer's gradient dict under a GradientNormalization mode: None,
    "renormalize_l2_per_layer", "renormalize_l2_per_param_type",
    "clip_element_wise_absolute_value", "clip_l2_per_layer",
    "clip_l2_per_param_type"."""
    if mode in (None, "none"):
        return grads
    leaves = list(_leaves(grads))
    if not leaves:
        return grads
    if mode == "renormalize_l2_per_layer":
        scale = 1.0 / torch.clamp(_l2(leaves), min=1e-12)
        return _map(lambda g: g * scale, grads)
    if mode == "renormalize_l2_per_param_type":
        return _map(lambda g: g / torch.clamp(
            torch.linalg.vector_norm(g.reshape(-1)), min=1e-12), grads)
    if mode == "clip_element_wise_absolute_value":
        return _map(lambda g: torch.clamp(g, -threshold, threshold), grads)
    if mode == "clip_l2_per_layer":
        norm = _l2(leaves)
        scale = torch.where(norm > threshold, threshold / (norm + 1e-12), 1.0)
        return _map(lambda g: g * scale, grads)
    if mode == "clip_l2_per_param_type":
        def clip_one(g):
            n = torch.linalg.vector_norm(g.reshape(-1))
            return g * torch.where(n > threshold, threshold / (n + 1e-12),
                                   1.0)
        return _map(clip_one, grads)
    raise ValueError(f"Unknown gradient normalization mode: {mode}")


def _resolve_layer(layer, gc):
    """(gradient normalization mode, threshold, updater, base rate) of
    one layer, each from the layer, else the global config."""
    mode = layer.resolve("gradient_normalization")
    thr = float(layer.resolve("gradient_normalization_threshold", 1.0)
                or 1.0)
    upd = layer.resolve("updater")
    base_lr = layer.conf.learning_rate
    if base_lr is None:
        base_lr = gc.learning_rate
    if base_lr is None:
        base_lr = upd.learning_rate
    return mode, thr, upd, base_lr


def apply_layer_updates(layers, gc, params, grads, opt_state, it,
                        lr_scale: float = 1.0):
    """Per-layer gradient normalization + updater for every layer with
    params (counterpart of the JAX package's apply_layer_updates), as
    multi-tensor operations, in place.

    The update runs in the policy's master dtype: gradients (bf16 under
    BF16, from the LSTM's backward) are cast to each parameter's dtype
    before normalization and the rule, and the scheduled rate is computed
    in the master dtype. ``lr_scale`` multiplies every layer's rate.

    The layers are grouped by (updater, base rate, dtype, device); each
    group's rate is computed once from ``it`` and its rule applied by
    ``Updater.update_`` over all its tensors at once. Unlike the JAX
    package, which returns new trees, this writes the new parameters and
    every updater slot (Adam's ``t`` too) into the tensors ``params`` and
    ``opt_state`` already hold; keys that are not layers (the loss-scale
    state) are left alone, and so is a layer whose updater is ``NoOp``
    (frozen: its gradient may be None, never computed). Bit for bit the
    result of ``apply_layer_updates_plain``."""
    master = getattr(torch, gc.dtype.param_dtype)
    groups: dict = {}
    with torch.no_grad():
        for layer in layers:
            name = layer.name
            if name not in params:
                continue
            mode, thr, upd, base_lr = _resolve_layer(layer, gc)
            if isinstance(upd, NoOp):
                continue  # frozen: no gradient was computed, none applied
            g = _map(lambda gr, p: gr.to(p.dtype), grads[name], params[name])
            g = normalize_gradients(g, mode, thr)
            first = next(_leaves(params[name]))
            key = (upd, base_lr, first.dtype, first.device)
            groups.setdefault(key, []).append((name, g))
        for (upd, base_lr, _, device), members in groups.items():
            lr = gc.lr_schedule(base_lr, it, dtype=master) * lr_scale
            if lr.device != device:
                lr = lr.to(device)
            ps, gs, spans = [], [], []
            slots = {k: [] for k in opt_state[members[0][0]]}
            for name, g in members:
                start = len(ps)
                ps += _leaves(params[name])
                gs += _leaves(g)
                spans.append((start, len(ps)))
                for k, sub in opt_state[name].items():
                    slots[k] += _leaves(sub)
            upd.update_(ps, gs, slots, lr, spans)


def apply_layer_updates_plain(layers, gc, params, grads, opt_state, it,
                              lr_scale: float = 1.0):
    """The per-tensor update, ``apply_layer_updates``'s plain version:
    each layer's rule through ``Updater.update`` (new tensors), the params
    updated in place and each layer's ``opt_state`` entry replaced by its
    new state dict."""
    master = getattr(torch, gc.dtype.param_dtype)
    for layer in layers:
        name = layer.name
        if name not in params:
            continue
        mode, thr, upd, base_lr = _resolve_layer(layer, gc)
        if isinstance(upd, NoOp):
            continue  # frozen: p - 0 is p
        g = _map(lambda gr, p: gr.to(p.dtype), grads[name], params[name])
        g = normalize_gradients(g, mode, thr)
        lr = gc.lr_schedule(base_lr, it, dtype=master) * lr_scale
        deltas, opt_state[name] = upd.update(g, opt_state[name], lr)
        with torch.no_grad():
            _map(lambda p, d: p.sub_(d), params[name], deltas)
