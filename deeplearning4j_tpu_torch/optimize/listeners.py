"""Training listeners (counterpart of deeplearning4j_tpu/optimize/listeners.py):
``TrainingListener``, ``ScoreIterationListener``,
``CollectScoresIterationListener``, ``PerformanceListener``,
``ComposableIterationListener``, ``ProfilerListener``,
``ParamAndGradientIterationListener`` and ``RecoveryEventListener``.

A network calls ``iteration_done(net, iteration, epoch)`` after every
``fit_batch`` and ``on_epoch_start``/``on_epoch_end`` around each epoch of
``fit``; the TrainingSupervisor calls ``on_recovery(net, event)`` for
each of its recovery events. ``net.score_value`` is a 0-d tensor on the
net's device: reading it (``float``) waits for the card to finish the
step. Each listener reads it only at its own cadence, so the iterations
it skips cost the host a few Python calls and no wait on the card.

``needs_per_iteration`` (the JAX package's values): True when a
listener must run at the moment each step ends (timings, parameter
pulls). When every attached listener declares False, ``fit`` may run a
chunk of steps through the captured step and replay ``iteration_done``
for each after it, with the same (iteration, score) values.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    """Base listener: every hook does nothing."""

    needs_per_iteration = True

    def iteration_done(self, net, iteration: int, epoch: int):
        pass

    def on_epoch_start(self, net):
        pass

    def on_epoch_end(self, net):
        pass

    def on_recovery(self, net, event):
        """Called by the TrainingSupervisor (resilience/supervisor.py)
        with a ``RecoveryEvent`` for every checkpoint, resume, retry,
        rollback, preemption and retention GC."""
        pass


class ScoreIterationListener(TrainingListener):
    """Logs the score every ``print_iterations`` iterations (to ``out``
    when given, else to the logger)."""

    needs_per_iteration = False  # a cadence-sampled score only

    def __init__(self, print_iterations: int = 10, out=None):
        self.print_iterations = max(1, print_iterations)
        self.out = out

    def iteration_done(self, net, iteration, epoch):
        if iteration % self.print_iterations == 0:
            msg = (f"Score at iteration {iteration} is "
                   f"{float(net.score_value):.6f}")
            if self.out is not None:
                print(msg, file=self.out)
            else:
                logger.info(msg)


class CollectScoresIterationListener(TrainingListener):
    """Keeps (iteration, score) every ``frequency`` iterations."""

    needs_per_iteration = False  # a cadence-sampled score only

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: list[tuple[int, float]] = []

    def iteration_done(self, net, iteration, epoch):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(net.score_value)))


class PerformanceListener(TrainingListener):
    """Iterations/s, examples/s and ms per iteration every ``frequency``
    iterations, on the host's clock between calls (no wait on the card:
    with the card behind the host, the rate is the host's rate of issue
    until the card's queue fills). Records go to ``records`` and the
    logger.

    MFU when ``report_mfu`` (or ``flops_per_step``) is set: a step's
    operations (``flops_per_step``, else the count the net derives from
    ``step_cost_analysis`` at its first step of each batch shape) times
    the iterations over the seconds, over the card's peak
    (utils/perf.py's ``peak_flops``). An MFU outside (0, 1] is not
    published."""

    needs_per_iteration = True  # measures the wall clock of each step

    def __init__(self, frequency: int = 10, report_examples: bool = True,
                 flops_per_step: float | None = None,
                 report_mfu: bool = False):
        self.frequency = max(1, frequency)
        self.report_examples = report_examples
        self.flops_per_step = flops_per_step
        self.report_mfu = bool(report_mfu) or flops_per_step is not None
        self.records: list[dict] = []
        self._last_time = None
        self._last_iter = None
        self._examples = 0

    def iteration_done(self, net, iteration, epoch):
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time, self._last_iter = now, iteration
            self._examples = 0
            return
        self._examples += getattr(net, "last_batch_examples", 0)
        if iteration % self.frequency == 0:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            rec = {
                "iteration": iteration,
                "iterations_per_sec": iters / dt if dt > 0 else float("inf"),
                "ms_per_iteration": 1000.0 * dt / max(iters, 1),
            }
            msg = (f"iteration {iteration}: "
                   f"{rec['iterations_per_sec']:.1f} it/s, "
                   f"{rec['ms_per_iteration']:.2f} ms/it")
            if self.report_examples and self._examples:
                rec["examples_per_sec"] = (
                    self._examples / dt if dt > 0 else float("inf"))
                msg += f", {rec['examples_per_sec']:.1f} examples/s"
            flops = self._resolve_flops(net)
            if flops and dt > 0:
                from deeplearning4j_tpu_torch.utils.perf import peak_flops
                peak = peak_flops(getattr(net, "device", None))
                if peak:
                    mfu = flops * iters / dt / peak
                    if 0.0 < mfu <= 1.0:  # never publish an impossible MFU
                        rec["mfu"] = mfu
                        msg += f", MFU {100 * mfu:.1f}%"
            self.records.append(rec)
            logger.info(msg)
            self._last_time, self._last_iter = now, iteration
            self._examples = 0

    def _resolve_flops(self, net):
        if self.flops_per_step:
            return self.flops_per_step
        if self.report_mfu:
            return getattr(net, "flops_per_step", None)
        return None


class ComposableIterationListener(TrainingListener):
    """Several listeners as one."""

    def __init__(self, *listeners):
        self.listeners = listeners

    @property
    def needs_per_iteration(self):
        return any(getattr(l, "needs_per_iteration", True)
                   for l in self.listeners)

    def iteration_done(self, net, iteration, epoch):
        for l in self.listeners:
            l.iteration_done(net, iteration, epoch)

    def on_epoch_start(self, net):
        for l in self.listeners:
            l.on_epoch_start(net)

    def on_epoch_end(self, net):
        for l in self.listeners:
            l.on_epoch_end(net)

    def on_recovery(self, net, event):
        for l in self.listeners:
            l.on_recovery(net, event)


class RecoveryEventListener(TrainingListener):
    """Collects (and optionally logs) the supervisor's recovery events:
    the listener's view of restarts, rollbacks and retries
    (``ResilienceStats`` keeps the counters)."""

    needs_per_iteration = False  # only observes recovery events

    def __init__(self, log: bool = True):
        self.log = log
        self.events: list = []

    def on_recovery(self, net, event):
        self.events.append(event)
        if self.log:
            logger.warning("recovery: %s", event)

    def counts(self) -> dict:
        out: dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out


class ProfilerListener(TrainingListener):
    """A ``torch.profiler`` trace of a window of iterations, written as a
    Chrome trace (``trace_<first>_<last>.json``) into ``log_dir``
    (counterpart of the JAX package's ProfilerListener): it starts once
    ``start_iteration`` has run and stops ``num_iterations`` iterations
    later (or at the epoch's end). A failure to start or stop is logged
    and turns profiling off; training goes on."""

    def __init__(self, log_dir: str, start_iteration: int = 5,
                 num_iterations: int = 5):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.num_iterations = max(1, num_iterations)
        self.captured = False
        self.trace_path = None
        self._prof = None
        self._warned = False

    def _warn_once(self, what: str, exc: Exception):
        if not self._warned:
            self._warned = True
            logger.warning(
                "ProfilerListener: %s failed (%s: %s); profiling disabled "
                "for this window, training continues",
                what, type(exc).__name__, exc)

    def _stop(self, net, iteration):
        prof, self._prof = self._prof, None
        self.captured = True
        try:
            if net is not None and getattr(net, "score_value", None) \
                    is not None:
                float(net.score_value)   # the step's work into the window
            prof.__exit__(None, None, None)
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(self.log_dir,
                                f"trace_{self._first}_{iteration}.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
        except Exception as e:  # profiling must never stop training
            self._warn_once("stopping the trace", e)

    def close(self, net=None):
        """Stops and writes the trace if it is still recording."""
        if self._prof is not None:
            self._stop(net, getattr(net, "iteration", self._first))

    def iteration_done(self, net, iteration, epoch):
        if (not self.captured and self._prof is None
                and iteration >= self.start_iteration):
            import torch.profiler as tp
            acts = [tp.ProfilerActivity.CPU]
            if getattr(net, "device", None) is not None \
                    and net.device.type == "cuda":
                acts.append(tp.ProfilerActivity.CUDA)
            try:
                prof = tp.profile(activities=acts)
                prof.__enter__()
            except Exception as e:
                self._warn_once("starting the trace", e)
                self.captured = True
                return
            self._prof, self._first = prof, iteration
            self._stop_at = iteration + self.num_iterations
            return
        if self._prof is not None and iteration >= self._stop_at:
            self._stop(net, iteration)

    def on_epoch_end(self, net):
        self.close(net)   # an epoch shorter than the window


def _flat_params(net):
    """``{layer_param: f64 numpy array}`` of the net's parameters (a copy
    from the card, so a wait for it)."""
    out = {}
    for ln, sub in net.params.items():
        for pn, t in sub.items():
            out[f"{ln}_{pn}"] = t.detach().to(torch.float64).cpu().numpy()
    return out


class ParamAndGradientIterationListener(TrainingListener):
    """One delimited row every ``iterations`` iterations: ``n``, ``score``,
    then for every parameter tensor its mean / min / max / mean |value|,
    and the same four of the step's change of it. The change stands in
    for the gradient, as in the JAX package (the applied update is the
    updater-scaled gradient); the columns keep the reference's names
    (``_meanG``, ``_minG``, ``_maxG``, ``_meanAbsValueG``). The parameters
    are copied to the host only for a sampled row and the iteration just
    before it."""

    def __init__(self, iterations: int = 1, *, print_header: bool = True,
                 print_mean: bool = True, print_min_max: bool = True,
                 print_mean_abs: bool = True, file=None,
                 output_to_console: bool = False, delimiter: str = "\t"):
        self.iterations = max(1, iterations)
        self.print_header = print_header
        self.print_mean = print_mean
        self.print_min_max = print_min_max
        self.print_mean_abs = print_mean_abs
        self.file = file
        self.output_to_console = output_to_console
        self.delimiter = delimiter
        self._count = 0
        self._prev = None
        self._wrote_header = False

    def _stat_cols(self, arr):
        cols = []
        if self.print_mean:
            cols.append(float(np.mean(arr)) if arr.size else 0.0)
        if self.print_min_max:
            cols.append(float(np.min(arr)) if arr.size else 0.0)
            cols.append(float(np.max(arr)) if arr.size else 0.0)
        if self.print_mean_abs:
            cols.append(float(np.mean(np.abs(arr))) if arr.size else 0.0)
        return cols

    def _emit(self, line: str):
        if self.file is not None:
            self.file.write(line + "\n")
            self.file.flush()
        if self.output_to_console:
            print(line)
        if self.file is None and not self.output_to_console:
            logger.info(line)

    def on_epoch_start(self, net):
        # the parameters before the first step, so the first sampled row
        # has a real change
        if self._prev is None and net.params is not None:
            self._prev = _flat_params(net)

    def iteration_done(self, net, iteration, epoch):
        self._count += 1
        nxt = self._count + 1
        if not (self._count % self.iterations == 0
                or nxt % self.iterations == 0):
            return
        params = _flat_params(net)
        if self.print_header and not self._wrote_header:
            names = []
            for s in params:
                if self.print_mean:
                    names.append(f"{s}_mean")
                if self.print_min_max:
                    names += [f"{s}_min", f"{s}_max"]
                if self.print_mean_abs:
                    names.append(f"{s}_meanAbsValue")
                if self.print_mean:
                    names.append(f"{s}_meanG")
                if self.print_min_max:
                    names += [f"{s}_minG", f"{s}_maxG"]
                if self.print_mean_abs:
                    names.append(f"{s}_meanAbsValueG")
            self._emit(self.delimiter.join(["n", "score"] + names))
            self._wrote_header = True
        if self._count % self.iterations != 0:
            self._prev = params
            return
        cols = [str(self._count), repr(float(net.score_value))]
        prev = self._prev if self._prev is not None else params
        for s, arr in params.items():
            delta = arr - prev.get(s, arr)
            for v in self._stat_cols(arr) + self._stat_cols(delta):
                cols.append(repr(v))
        self._emit(self.delimiter.join(cols))
        self._prev = params
