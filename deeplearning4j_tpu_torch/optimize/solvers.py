"""Full-batch optimizers: line gradient descent, conjugate gradient and
L-BFGS, each with Armijo backtracking (counterpart of
deeplearning4j_tpu/optimize/solvers.py).

The parameters are concatenated into ONE flat vector (in the JAX
package's leaf order: layer names, then parameter names, sorted) with
views to unflatten it; the loss, and the loss with its gradient, are one
call each on the net's device, and the host steers the line search, as
in the JAX package. The SGD path is the network's own train step. L-BFGS
keeps its own two-loop history (``torch.optim.LBFGS`` has another
history, line search and stopping rule).

A dropout net optimizes one fixed mask per ``optimize()``: every probe
draws from a generator set to the state the net's generator had when the
problem was built.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.updater import _leaves


@dataclass
class SolverResult:
    score: float
    iterations: int
    converged: bool


class _FlatProblem:
    """The net's loss on one batch as a function of one flat vector."""

    def __init__(self, net, ds):
        self.net = net
        self.leaves = list(_leaves(net.params))
        self.flat0 = torch.cat([t.detach().reshape(-1)
                                for t in self.leaves])
        self.batch = net._step_batch(ds)
        self.gen_state = net._gen.get_state()
        self.gen = torch.Generator(device=net.device)
        self.probes = 0

    def unflatten(self, flat):
        """The params tree with views into ``flat`` as leaves."""
        views, start = [], 0
        for t in self.leaves:
            views.append(flat[start:start + t.numel()].view(t.shape))
            start += t.numel()
        it = iter(views)

        def fill(tree):
            if isinstance(tree, dict):
                return {k: fill(tree[k]) for k in sorted(tree)}
            return next(it)

        return fill(self.net.params)

    def _loss(self, flat):
        self.probes += 1
        self.gen.set_state(self.gen_state)
        loss, _ = self.net._loss(self.unflatten(flat), self.net.state,
                                 *self.batch, gen=self.gen, train=True)
        return loss

    def loss(self, flat) -> torch.Tensor:
        with torch.no_grad():
            return self._loss(flat)

    def value_and_grad(self, flat):
        flat = flat.detach().requires_grad_()
        loss = self._loss(flat)
        (g,) = torch.autograd.grad(loss, flat)
        return loss.detach(), g

    def write_back(self, flat):
        """Copies ``flat`` into the net's parameter tensors, in place."""
        with torch.no_grad():
            start = 0
            for t in self.leaves:
                t.copy_(flat[start:start + t.numel()].view(t.shape))
                start += t.numel()


def backtrack_line_search(loss_fn, x, fx, g, direction, *, step0=1.0,
                          c1=1e-4, rho=0.5, max_steps=30):
    """Armijo backtracking: shrink the step until f(x + a*d) <= f(x) +
    c1*a*g.d.

    Returns (step, f_new, direction); the direction is swapped to -g when
    the given one is not a descent direction, so callers MUST step along
    the returned direction."""
    gd = float(g @ direction)
    if gd >= 0:  # not a descent direction: fall back to -g
        direction = -g
        gd = float(g @ direction)
    a = step0
    for _ in range(max_steps):
        fnew = float(loss_fn(x + a * direction))
        if fnew <= fx + c1 * a * gd and np.isfinite(fnew):
            return a, fnew, direction
        a *= rho
    return 0.0, fx, direction  # no acceptable step


class BaseSolver:
    """The template loop: direction -> line search -> update, until
    ``max_iterations`` or the score tolerance. After ``optimize``,
    ``first_step`` holds the first iteration's (line-search step, f_new)
    and ``probes`` the loss evaluations made."""

    def __init__(self, net, max_iterations: int = 100,
                 tolerance: float = 1e-8):
        self.net = net
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.first_step = None
        self.probes = 0

    def _search(self, loss, flat, fx, g, d):
        a, fnew, d = backtrack_line_search(loss, flat, fx, g, d)
        if self.first_step is None:
            self.first_step = (a, fnew)
        return a, fnew, d

    def _run(self, flat, loss, vg):
        raise NotImplementedError

    def optimize(self, ds) -> SolverResult:
        self.net._require_init()
        problem = _FlatProblem(self.net, ds)
        flat, iters, converged = self._run(problem.flat0, problem.loss,
                                           problem.value_and_grad)
        problem.write_back(flat)
        score = float(problem.loss(flat))
        self.probes = problem.probes
        self.net.score_value = score
        return SolverResult(score=score, iterations=iters,
                            converged=converged)


class LineGradientDescent(BaseSolver):
    """Steepest descent with the line search."""

    def _run(self, flat, loss, vg):
        fx, g = vg(flat)
        fx = float(fx)
        for i in range(self.max_iterations):
            a, fnew, d = self._search(loss, flat, fx, g, -g)
            if a == 0.0:
                return flat, i + 1, False  # line search stalled
            if abs(fx - fnew) < self.tolerance:
                return flat, i + 1, True
            flat = flat + a * d
            fx, g = vg(flat)
            fx = float(fx)
        return flat, self.max_iterations, False


class ConjugateGradient(BaseSolver):
    """Nonlinear CG, Polak-Ribiere+ with automatic restart."""

    def _run(self, flat, loss, vg):
        fx, g = vg(flat)
        fx = float(fx)
        d = -g
        for i in range(self.max_iterations):
            a, fnew, d = self._search(loss, flat, fx, g, d)
            if a == 0.0:
                return flat, i + 1, False  # line search stalled
            if abs(fx - fnew) < self.tolerance:
                return flat, i + 1, True
            flat = flat + a * d
            fx_new, g_new = vg(flat)
            beta = float(g_new @ (g_new - g)) / max(float(g @ g), 1e-20)
            beta = max(beta, 0.0)  # PR+ restart
            d = -g_new + beta * d
            fx, g = float(fx_new), g_new
        return flat, self.max_iterations, False


class LBFGS(BaseSolver):
    """Limited-memory BFGS, the two-loop recursion over the last ``m``
    (s, y) pairs; the recursion runs in float64 on the device, as the JAX
    package runs it in float64 on the host."""

    def __init__(self, net, max_iterations: int = 100,
                 tolerance: float = 1e-8, m: int = 10):
        super().__init__(net, max_iterations, tolerance)
        self.m = m

    def _run(self, flat, loss, vg):
        fx, g = vg(flat)
        fx = float(fx)
        s_hist, y_hist = [], []
        for i in range(self.max_iterations):
            # two-loop recursion
            q = g.double().clone()
            alphas = []
            for s, y in reversed(list(zip(s_hist, y_hist))):
                rho = 1.0 / max(float(y @ s), 1e-20)
                a = rho * float(s.double() @ q)
                alphas.append((a, rho, s, y))
                q -= a * y.double()
            if y_hist:
                s, y = s_hist[-1], y_hist[-1]
                gamma = float(s @ y) / max(float(y @ y), 1e-20)
                q *= gamma
            for a, rho, s, y in reversed(alphas):
                b = rho * float(y.double() @ q)
                q += s.double() * (a - b)
            d = (-q).to(flat.dtype)

            a, fnew, d = self._search(loss, flat, fx, g, d)
            if a == 0.0:
                return flat, i + 1, False  # line search stalled
            if abs(fx - fnew) < self.tolerance:
                return flat, i + 1, True
            new_flat = flat + a * d
            fx_new, g_new = vg(new_flat)
            s_hist.append(new_flat - flat)
            y_hist.append(g_new - g)
            if len(s_hist) > self.m:
                s_hist.pop(0)
                y_hist.pop(0)
            flat, fx, g = new_flat, float(fx_new), g_new
        return flat, self.max_iterations, False


class Solver:
    """Dispatch by algorithm name; 'sgd' is the network's own train
    step."""

    ALGOS = {
        "line_gradient_descent": LineGradientDescent,
        "conjugate_gradient": ConjugateGradient,
        "lbfgs": LBFGS,
    }

    def __init__(self, net):
        self.net = net

    def optimize(self, ds, algo: str = "lbfgs", **kwargs) -> SolverResult:
        if algo in ("sgd", "stochastic_gradient_descent"):
            score = self.net.fit_batch(ds)
            return SolverResult(score=float(score), iterations=1,
                                converged=False)
        cls = self.ALGOS.get(algo)
        if cls is None:
            raise ValueError(f"Unknown optimization algorithm '{algo}'; "
                             f"one of {sorted(self.ALGOS)} or 'sgd'")
        return cls(self.net, **kwargs).optimize(ds)
