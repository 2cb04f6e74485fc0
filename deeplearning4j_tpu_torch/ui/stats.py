"""Stats collection (counterpart of deeplearning4j_tpu/ui/stats.py).

Parity: deeplearning4j-ui-model stats/BaseStatsListener.java (:287
iterationDone gathers score, parameter/update histograms and
mean-magnitudes, memory + timing). As in the JAX package the listener
records parameter UPDATE statistics (the param delta over exactly one
step: what the updater applied). The statistics are numpy's, over host
copies of the card's params taken on the report cadence, keyed by the
JAX package's tree-path strings (``['layer_0']['W']``), so a report
reads the same in both packages. A bf16 tensor is copied as float32
(numpy has no bfloat16); the port's BF16 policy keeps params in float32.
Collection is O(params) host work: use ``frequency`` to sample. The
listener only reads: the params it copies are left as they were.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.compilecache.manifest import _sorted_leaves
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


@dataclass
class StatsReport:
    session_id: str
    worker_id: str
    timestamp: float
    iteration: int
    epoch: int
    score: float
    iteration_ms: Optional[float] = None
    examples_per_sec: Optional[float] = None
    memory_rss_mb: Optional[float] = None
    param_stats: Dict[str, dict] = field(default_factory=dict)
    update_stats: Dict[str, dict] = field(default_factory=dict)
    activation_stats: Dict[str, dict] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "session_id": self.session_id,
            "worker_id": self.worker_id,
            "timestamp": self.timestamp,
            "iteration": self.iteration,
            "epoch": self.epoch,
            "score": self.score,
            "iteration_ms": self.iteration_ms,
            "examples_per_sec": self.examples_per_sec,
            "memory_rss_mb": self.memory_rss_mb,
            "param_stats": self.param_stats,
            "update_stats": self.update_stats,
            "activation_stats": self.activation_stats,
        }

    @staticmethod
    def from_dict(d: dict) -> "StatsReport":
        return StatsReport(**d)


def _host(t) -> np.ndarray:
    """A host numpy copy of a tensor (bf16 as float32) or array."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        # a copy even on the CPU: the step updates params in place
        return t.to("cpu", copy=True).numpy()
    return np.array(t)


def host_params(params) -> Dict[str, np.ndarray]:
    """{tree-path string: host copy} of a params tree, in the JAX
    package's flattening order."""
    return {"".join(f"[{k!r}]" for k in path): _host(leaf)
            for path, leaf in _sorted_leaves(params or {})}


def _array_stats(a: np.ndarray, histograms: bool, bins: int) -> dict:
    if a.size == 0:
        # zero-size tensors must produce a well-formed report, not a
        # ValueError out of a.min()/np.histogram mid-training
        out = {"mean": None, "std": None, "mean_magnitude": None,
               "min": None, "max": None}
        if histograms:
            out["histogram"] = {"counts": [], "min": None, "max": None}
        return out
    out = {
        "mean": float(a.mean()),
        "std": float(a.std()),
        "mean_magnitude": float(np.abs(a).mean()),
        "min": float(a.min()),
        "max": float(a.max()),
    }
    if histograms:
        counts, edges = np.histogram(a, bins=bins)
        out["histogram"] = {"counts": counts.tolist(),
                            "min": float(edges[0]), "max": float(edges[-1])}
    return out


def _rss_mb() -> Optional[float]:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        return None
    return None


class StatsListener(TrainingListener):
    """Collects a StatsReport every ``frequency`` iterations and routes it
    to a StatsStorage (BaseStatsListener parity).

    ``net.score_value`` is only read (a wait on the card) on the report
    cadence; between reports only wall-clock timing is recorded."""

    # real per-step wall-clock (iteration_ms) and the pre-report param
    # copy: the fit loops run one step a chunk for it (nn/multistep.py)
    needs_per_iteration = True

    def __init__(self, storage, frequency: int = 10, histograms: bool = True,
                 bins: int = 20, session_id: Optional[str] = None,
                 worker_id: str = "worker_0", collect_updates: bool = True,
                 activation_probe=None):
        """``activation_probe``: optional features array (or list of
        arrays for graphs); when given, each sampled iteration runs
        ``feed_forward`` on it and records per-layer ACTIVATION
        statistics (keep it small)."""
        self.storage = storage
        self.frequency = max(1, frequency)
        self.histograms = histograms
        self.bins = bins
        self.session_id = session_id or f"session_{int(time.time())}"
        self.worker_id = worker_id
        self.collect_updates = collect_updates
        self.activation_probe = activation_probe
        self._probe_warned = False
        self._model_posted = False
        self._prev_params = None
        self._last_time = None

    def _post_model_info(self, net):
        """Once per run: the model topology for the dashboard's flow view
        (layer boxes with types and param counts, wired by the graph)."""
        if self._model_posted:
            return
        self._model_posted = True
        try:
            layers = []
            params = net.params or {}

            def count(name):
                return int(sum(v.numel() for v in
                               (params.get(name) or {}).values()))
            if hasattr(net, "topo"):
                for name in net.topo:
                    kind = net.vertex_kind.get(name)
                    if kind == "layer":
                        ltype = type(net._layer_by_name[name]).__name__
                    else:
                        ltype = type(net._resolved_confs[name]).__name__
                    layers.append({
                        "name": str(name), "type": ltype,
                        "params": count(name),
                        "inputs": [str(i) for i in
                                   net.conf.vertex_inputs.get(name, [])],
                    })
                inputs = [str(i) for i in net.conf.network_inputs]
            else:
                prev = None
                for layer in net.layers:
                    layers.append({
                        "name": str(layer.name),
                        "type": type(layer).__name__,
                        "params": count(layer.name),
                        "inputs": [prev] if prev else [],
                    })
                    prev = str(layer.name)
                inputs = []
            self.storage.put_static_info(self.session_id, self.worker_id, {
                "model": {"layers": layers, "network_inputs": inputs},
            })
        except Exception as e:
            # must never break training, but must be diagnosable
            import warnings
            warnings.warn(
                f"StatsListener model-topology post failed "
                f"({type(e).__name__}: {e}) — the dashboard flow view "
                f"will be empty for this run", UserWarning)

    def _activation_stats(self, net) -> Dict[str, dict]:
        if self.activation_probe is None:
            return {}
        probe = self.activation_probe
        try:
            if isinstance(probe, (list, tuple)):   # ComputationGraph
                acts = net.feed_forward(*probe)
            else:
                acts = net.feed_forward(probe)
        except Exception as e:
            if not self._probe_warned:
                import warnings
                warnings.warn(
                    f"StatsListener activation_probe forward failed "
                    f"({type(e).__name__}: {e}) — activation stats "
                    f"disabled for this run", UserWarning)
                self._probe_warned = True
            return {}
        if isinstance(acts, dict):
            # a graph's feed_forward holds its INPUTS too: probe data,
            # not layer activations
            inputs = set(getattr(getattr(net, "conf", None),
                                 "network_inputs", ()) or ())
            named = [(k, v) for k, v in acts.items() if k not in inputs]
        else:
            names = [getattr(l, "name", f"layer_{i}")
                     for i, l in enumerate(net.layers)]
            named = list(zip(names, acts))
        return {str(k): _array_stats(_host(v), self.histograms, self.bins)
                for k, v in named}

    def iteration_done(self, net, iteration, epoch):
        self._post_model_info(net)
        now = time.perf_counter()
        iter_ms = None
        if self._last_time is not None:
            iter_ms = 1000.0 * (now - self._last_time)
        self._last_time = now
        if iteration % self.frequency != 0:
            if (self.collect_updates
                    and (iteration + 1) % self.frequency == 0):
                # host-copy params one iteration before the next sample
                # so the update delta spans exactly one step (the step
                # updates the card's params in place)
                self._prev_params = host_params(net.params)
            return
        params = host_params(net.params)
        param_stats = {k: _array_stats(a, self.histograms, self.bins)
                       for k, a in params.items()}
        update_stats = {}
        if self.collect_updates and self._prev_params is not None:
            update_stats = {k: _array_stats(a - self._prev_params[k],
                                            self.histograms, self.bins)
                            for k, a in params.items()}
        self._prev_params = params if (self.collect_updates
                                       and self.frequency == 1) else None
        eps = None
        n = getattr(net, "last_batch_examples", 0)
        if iter_ms and n:
            eps = 1000.0 * n / iter_ms
        report = StatsReport(
            session_id=self.session_id,
            worker_id=self.worker_id,
            timestamp=time.time(),
            iteration=iteration,
            epoch=epoch,
            score=float(net.score_value),
            iteration_ms=iter_ms,
            examples_per_sec=eps,
            memory_rss_mb=_rss_mb(),
            param_stats=param_stats,
            update_stats=update_stats,
            activation_stats=self._activation_stats(net),
        )
        self.storage.put_update(report)
