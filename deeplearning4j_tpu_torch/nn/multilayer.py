"""MultiLayerNetwork — a sequential stack that trains, serves and evaluates
(counterpart of deeplearning4j_tpu/nn/multilayer.py: ``init`` with the
input preprocessors ``set_input_type`` inserts, ``fit``, ``fit_batch``,
truncated BPTT, listeners, ``score``, ``output``, ``feed_forward``,
``evaluate``, ``evaluate_regression``, ``rnn_time_step``,
``rnn_clear_previous_state``, ``summary``, ``clone``, ``resilient_fit``,
``pretrain``, ``pretrain_layer``, the remat spans of ``DL4J_TPU_REMAT``).

Parameters are a dict ``{layer_name: {param_name: tensor}}`` in the JAX
package's layouts, and the optimizer state a dict keyed as the JAX
package keys it, so a model and its updater state cross between the
packages through the zip format unchanged.

A train step is forward → loss → ``autograd`` (the LSTM's backward is
its own kernel on the card) → the multi-tensor update in place
(nn/multistep.py's ``train_step``). ``fit_batch`` runs it eagerly;
``fit(multi_step=k)`` and ``fit_batch_repeated`` replay it as one CUDA
graph per batch signature (nn/multistep.py), the counterpart of the JAX
package's scanned steps. Randomness (dropout) comes from one
``torch.Generator`` on the net's device, seeded from the configuration.
"""

from __future__ import annotations

import functools
import time
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    ArrayDataSetIterator, AsyncDataSetIterator, DataSetIterator,
    DevicePrefetchIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import multistep, precision, remat
from deeplearning4j_tpu_torch.nn.conf import layers as layer_confs
from deeplearning4j_tpu_torch.nn.conf.core import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (CnnToFeedForward,
                                                            FeedForwardToCnn,
                                                            RnnToFeedForward)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (set_streaming,
                                                          strip_carries)
from deeplearning4j_tpu_torch.nn.updater import _copy_tree, _leaves
from deeplearning4j_tpu_torch.observability import distributed as _obs_dist
from deeplearning4j_tpu_torch.observability import goodput as _goodput
from deeplearning4j_tpu_torch.observability import metrics as _obs_metrics
from deeplearning4j_tpu_torch.observability.trace import get_tracer


def _auto_preprocessor(input_type: InputType, conf):
    """The shape adapter ``set_input_type`` puts between two layer
    families that do not fit (conv -> dense, flat -> conv, rnn -> dense),
    or None."""
    kind = input_type.kind
    is_ff = isinstance(conf, layer_confs.FeedForwardLayerConfig)
    wants_cnn = getattr(conf, "expects_cnn_input", False)
    wants_rnn = getattr(conf, "expects_rnn_input", False)
    if kind == "convolutional" and is_ff and not wants_cnn and not wants_rnn:
        return CnnToFeedForward(input_type.height, input_type.width,
                                input_type.channels)
    if kind == "convolutional_flat" and wants_cnn:
        return FeedForwardToCnn(input_type.height, input_type.width,
                                input_type.channels)
    if kind == "recurrent" and is_ff and not wants_rnn and not wants_cnn:
        return RnnToFeedForward()
    return None


def init_trees(layers, policy, gen, device):
    """(params, state, opt_state) of ``layers``: parameters drawn from
    ``gen`` onto ``device``, each layer's state, each updater's state and
    the loss-scale state when ``policy`` scales the loss. On the ``meta``
    device every leaf has its shape and dtype and nothing is drawn."""
    params = {}
    for layer in layers:
        p = layer.init_params(gen, device)
        if p:
            params[layer.name] = p
    return (params, init_state(layers, device),
            init_opt_state(layers, params, policy, device))


def init_opt_state(layers, params, policy, device):
    """Each layer's updater state over ``params``, plus the loss-scale
    state when ``policy`` scales the loss."""
    opt_state = {}
    for layer in layers:
        if layer.name in params:
            opt_state[layer.name] = layer.resolve("updater").init_state(
                params[layer.name])
    ls = precision.init_loss_scale_state(policy, device)
    if ls is not None:
        opt_state[precision.LOSS_SCALE_KEY] = ls
    return opt_state


def init_state(layers, device):
    """Each layer's state (batch norm's running statistics) on
    ``device``."""
    state = {}
    for layer in layers:
        s = layer.init_state(device)
        if s:
            state[layer.name] = s
    return state


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.layers = None
        self.preprocessors = None  # per layer: its input preprocessor or None
        self.params = None     # {layer_name: {param: tensor}}
        self.state = None      # {layer_name: {...}}
        self.opt_state = None  # {layer_name: updater state, "_loss_scale"?}
        self.iteration = 0
        self.epoch = 0
        self.score_value = None
        self.last_batch_examples = 0
        self.listeners: list = []
        self._gen = None
        self._lr_scale = 1.0
        self._rnn_state = None
        # DL4J_TPU_REMAT, read at the first train step (nn/remat.py)
        self.remat_prefixes = None
        self._remat_warned = False
        self._multi_steps = {}     # batch signature -> multistep.StepGraph
        self._grad_reduce = None   # the meshed step's all-reduce
        self._tp = None            # parallel/tensor.py, on a model axis
        self.last_run_report = None  # the last fit's goodput RunReport
        self.flops_per_step = None
        self._flops_key = None

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None, *,
             structure_only: bool = False):
        """Build the runtime layers, draw parameters from a
        ``torch.Generator`` seeded with ``seed`` (default: the config's)
        and start a fresh optimizer state. The draws do not reproduce the
        JAX package's; carry a JAX model across with
        utils/serialization.py instead. With ``structure_only`` the
        params, state and updater state are ``meta`` tensors of the
        shapes and dtypes ``init()`` gives and nothing is drawn: for a
        restore, which overwrites every leaf, and for a fingerprint."""
        gc = self.conf.global_conf
        seed = gc.seed if seed is None else seed
        self._build_layers()
        if structure_only:
            gen, dev = None, torch.device("meta")
        else:
            gen = torch.Generator(device="cpu").manual_seed(int(seed))
            dev = self.device
        self.params, self.state, self.opt_state = init_trees(
            self.layers, gc.dtype, gen, dev)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.iteration = 0
        self._rnn_state = None
        self._multi_steps = {}
        return self

    def materialize_state(self):
        """Concrete layer state on the net's device (batch norm's running
        statistics as ``init()`` starts them): after a structure-only
        init, for a net whose checkpoint holds no state."""
        self.state = init_state(self.layers, self.device)

    def materialize_opt_state(self):
        """A fresh updater state over the (concrete) params on the net's
        device: after a structure-only init, when the updater state is
        not restored."""
        self.opt_state = init_opt_state(self.layers, self.params,
                                        self.conf.global_conf.dtype,
                                        self.device)

    def _build_layers(self):
        """The runtime layers and each one's input preprocessor: an
        explicit one from the configuration, else the one the input type
        calls for."""
        gc = self.conf.global_conf
        input_type = self.conf.input_type
        self.layers = []
        self.preprocessors = []
        for i, lc in enumerate(self.conf.layers):
            prep = self.conf.preprocessors.get(i)
            if prep is None and input_type is not None:
                prep = _auto_preprocessor(input_type, lc)
            if prep is not None and input_type is not None:
                input_type = prep.output_type(input_type)
            self.preprocessors.append(prep)
            if input_type is not None:
                lc = lc.with_n_in(input_type)
            if getattr(lc, "n_in", 1) is None:
                raise ValueError(
                    f"Layer {i} ({lc.layer_type}): n_in not set and no "
                    f"input_type provided for inference")
            if lc.name is None:
                lc = lc.replace(name=f"layer_{i}")
            layer = lc.make_layer(input_type, gc, gc.dtype)
            self.layers.append(layer)
            input_type = layer.output_type

    def set_lr_scale(self, scale: float):
        """Scale every layer's scheduled learning rate by ``scale`` from
        the next step on."""
        scale = float(scale)
        if scale <= 0.0:
            raise ValueError(f"lr scale must be > 0, got {scale}")
        if scale != self._lr_scale:
            self._lr_scale = scale
            self._multi_steps = {}   # the rate is a constant of a graph
        return self

    def use_mesh(self, mesh, data_axis: str = "data",
                 model_axis: str | None = None, tp_rules=None):
        """Training over a mesh (parallel/mesh.py ``make_mesh``): batches
        split on ``data_axis`` (each rank steps on its local batch, one
        gradient all-reduce a step over that axis, on NCCL inside the
        captured step); params replicated (pure data parallelism) or,
        with ``model_axis`` set, sharded over that axis by the default
        rule and ``tp_rules`` (parallel/tensor.py: the layers compute on
        their shards, the collectives over the model axis inside the
        step)."""
        from deeplearning4j_tpu_torch.parallel.data_parallel import \
            use_mesh
        return use_mesh(self, mesh, data_axis, model_axis, tp_rules)

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        self._multi_steps = {}
        return self

    def add_listener(self, listener):
        self.listeners.append(listener)
        self._multi_steps = {}
        return self

    def _require_init(self):
        if self.params is None:
            raise RuntimeError(
                "Network not initialized — call net.init() before "
                "fit()/output()")

    # -------------------------------------------------------------- forward
    def _as_tensor(self, x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _forward(self, params, state, x, *, train=False, gen=None,
                 fmask=None, to_layer=None, collect=False):
        """Walk the stack; returns (final activation or list, new_state).
        A training walk that collects nothing runs each maximal run of
        layers ``DL4J_TPU_REMAT`` names as one remat span."""
        acts = []
        new_state = dict(state)
        n = len(self.layers) if to_layer is None else to_layer
        spans = self._remat_spans(n) if train and not collect else {}
        i = 0
        while i < n:
            end = spans.get(i)
            if end is not None:
                run = functools.partial(self._run_layers, params, state,
                                        lo=i, hi=end, train=train, gen=gen)
                x, fmask, ns = remat.run_span(run, x, fmask)
            else:
                end = i + 1
                x, fmask, ns = self._run_layers(params, state, x, fmask, i,
                                                end, train, gen)
                if collect:
                    acts.append(x)
            new_state.update(ns)
            i = end
        return (acts if collect else x), new_state

    def _run_layers(self, params, state, x, fmask, lo, hi, train, gen):
        """Layers [lo, hi) with their preprocessors: (x, mask, new
        state of those layers)."""
        ns = {}
        for layer, prep in zip(self.layers[lo:hi], self.preprocessors[lo:hi]):
            if prep is not None:
                x = prep(x)
            x, s_new = layer.apply(self._layer_params(layer, params),
                                   state.get(layer.name, {}), x, train=train,
                                   gen=gen, mask=fmask)
            fmask = layer.feed_forward_mask(fmask)
            if s_new:
                ns[layer.name] = s_new
        return x, fmask, ns

    @staticmethod
    def _layer_params(layer, params):
        """``layer``'s params as its apply takes them: on a model axis, a
        layer no rendering covers gets its sharded leaves gathered whole
        (the counted gather route, parallel/tensor.py)."""
        p = params.get(layer.name, {})
        tp = layer.tp
        if tp is None:
            return p
        if getattr(layer, "streaming", False):
            raise NotImplementedError(
                "streaming (rnn_time_step, decode) on a model axis is mesh "
                "serving, which waits for ROADMAP.md A.5 part 2 (mesh "
                "serving); tensor parallelism covers training and output")
        if tp.rendered or not tp.any_sharded():
            return p
        from deeplearning4j_tpu_torch.ops import registry
        from deeplearning4j_tpu_torch.parallel.tensor import GATHER_OP
        reason = f"gather:{layer.conf.layer_type}"
        if tp.reason:
            reason += f":{tp.reason}"
        registry.count_route(GATHER_OP, reason)
        return tp.whole_params(p)

    def _remat_spans(self, n: int) -> dict:
        """start -> end of each maximal run of layers among the first n
        whose names match the remat prefixes, loss heads left out."""
        prefixes = remat.active(self)
        spans, start = {}, None
        for i in range(n):
            ok = (remat.match(self.layers[i].name, prefixes)
                  and not hasattr(self.layers[i], "loss"))
            if ok and start is None:
                start = i
            elif not ok and start is not None:
                spans[start], start = i, None
        if start is not None:
            spans[start] = n
        return spans

    def _loss(self, params, state, x, labels, fmask=None, lmask=None,
              gen=None, train=True):
        """Data loss + regularization (the scalar a train step
        differentiates) and the new layer state."""
        h, new_state = self._forward(params, state, x, train=train, gen=gen,
                                     fmask=fmask,
                                     to_layer=len(self.layers) - 1)
        out_layer = self.layers[-1]
        if not hasattr(out_layer, "loss"):
            raise ValueError(
                f"the last layer ({out_layer.conf.layer_type}) has no loss; "
                f"training needs an output layer")
        # the walk stopped before the output layer, so its preprocessor
        # (conv -> Output) is applied here
        if self.preprocessors[-1] is not None:
            h = self.preprocessors[-1](h)
        p_out = self._layer_params(out_layer, params)
        if getattr(out_layer, "loss_uses_state", False):
            # the center loss: its term reads the centers, which move by
            # their own rule outside the differentiated loss
            s_out = state.get(out_layer.name, {})
            data_loss = out_layer.loss(p_out, h, labels, train=train,
                                       gen=gen, mask=lmask, state=s_out)
            if train:
                new_state[out_layer.name] = out_layer.update_centers(
                    s_out, h.detach(), labels, mask=lmask)
        else:
            data_loss = out_layer.loss(p_out, h, labels, train=train,
                                       gen=gen, mask=lmask)
        reg = torch.zeros((), dtype=data_loss.dtype, device=data_loss.device)
        for layer in self.layers:
            if layer.name in params:
                reg = reg + layer.regularization(params[layer.name])
        return data_loss + reg, new_state

    def output(self, x, train: bool = False, mask=None) -> torch.Tensor:
        """Final layer activations (the JAX package's parameter order).
        ``train`` applies dropout; ``mask`` is the [b, t] per-timestep
        features mask for variable-length sequences."""
        self._require_init()
        with torch.inference_mode():
            out, _ = self._forward(self.params, self.state,
                                   self._as_tensor(x), train=train,
                                   gen=self._gen,
                                   fmask=self._as_tensor(mask))
        return out

    def feed_forward(self, x, train: bool = False, mask=None
                     ) -> List[torch.Tensor]:
        """Every layer's activations."""
        self._require_init()
        with torch.inference_mode():
            acts, _ = self._forward(self.params, self.state,
                                    self._as_tensor(x), train=train,
                                    gen=self._gen,
                                    fmask=self._as_tensor(mask),
                                    collect=True)
        return acts

    # --------------------------------------------------------------- train
    def _batch(self, ds: DataSet):
        return (self._as_tensor(ds.features), self._as_tensor(ds.labels),
                self._as_tensor(ds.features_mask),
                self._as_tensor(ds.labels_mask))

    _step_batch = _batch   # what nn/multistep.py's train_step takes

    @staticmethod
    def _signature(ds: DataSet):
        shape = lambda a: None if a is None else tuple(a.shape)  # noqa: E731
        return (shape(ds.features), shape(ds.labels),
                shape(ds.features_mask), shape(ds.labels_mask))

    def _needs_tbptt(self, features) -> bool:
        return (self.conf.backprop_type == "tbptt"
                and getattr(features, "ndim", 0) == 3
                and features.shape[1] > self.conf.tbptt_fwd_length)

    def fit_batch(self, ds: DataSet):
        """One optimization step on one minibatch (tBPTT when configured
        and the sequence is longer than the chunk). Returns the score as a
        0-d tensor on the net's device."""
        self._require_init()
        if self._needs_tbptt(ds.features):
            return self._fit_tbptt(ds)
        tracer = get_tracer()
        with tracer.span("host_dispatch"):
            batch = self._batch(ds)
        with tracer.span("device_step"):
            score = multistep.train_step(self, batch)
        self.iteration += 1
        self.score_value = score
        _goodput.observe_steps(1)
        multistep.maybe_derive_flops(self, ds)
        self._iteration_done(ds)
        return score

    def fit_batch_repeated(self, ds: DataSet, n_steps: int):
        """``n_steps`` optimization steps on one minibatch: on the card n
        replays of the captured step (nn/multistep.py), one host dispatch
        each instead of hundreds of kernel launches; on the CPU n eager
        steps. tBPTT runs n ``fit_batch`` calls, as in the JAX package.
        Listeners are not called; returns the last score."""
        self._require_init()
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        if self._needs_tbptt(ds.features):
            for _ in range(n_steps):
                score = self.fit_batch(ds)
            return score
        return multistep.fit_batch_repeated(self, ds, n_steps)

    def step_cost_analysis(self, ds: DataSet) -> dict:
        """The operations of ONE train step on this batch:
        {"flops", "kernel_flops", "bytes_accessed"} (utils/perf.py's
        ``step_flops``; feeds ``PerformanceListener(flops_per_step=...)``
        for MFU). The net is left as it was."""
        from deeplearning4j_tpu_torch.utils.perf import step_flops
        self._require_init()
        return step_flops(self, self._batch(ds))


    def _iteration_done(self, ds: DataSet):
        """The listeners' ``iteration_done``, timed as ``score_sync`` (a
        listener that reads the score waits on the card there)."""
        self.last_batch_examples = ds.num_examples
        if self.listeners:
            t0 = time.perf_counter()
            for l in self.listeners:
                l.iteration_done(self, self.iteration, self.epoch)
            t1 = time.perf_counter()
            get_tracer().record("score_sync", t0, t1)
            _obs_metrics.observe_dispatch_lag(t1 - t0)

    def _fit_tbptt(self, ds: DataSet):
        """Truncated BPTT: one step per ``tbptt_fwd_length`` chunk of the
        time axis, each at the batch's iteration; the recurrent carry
        crosses chunks through the layer state (detached: gradients stop
        at a chunk boundary, as in the JAX package) and is reset after the
        batch. The score is the chunk scores' mean weighted by chunk
        length."""
        x, y, fmask, lmask = self._batch(ds)
        if y.dim() != 3 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "tBPTT requires per-timestep labels [batch, time, out] with "
                f"the same time length as the features; got labels shape "
                f"{tuple(y.shape)} vs features {tuple(x.shape)}. For "
                "sequence-classification labels use backprop_type='standard'")
        cut = lambda a, sl: None if a is None else a[:, sl]  # noqa: E731
        score = multistep.fit_windows(
            self, x.shape[1],
            lambda sl: (x[:, sl], y[:, sl], cut(fmask, sl), cut(lmask, sl)))
        self.state = strip_carries(self.state)
        self.iteration += 1
        self.score_value = score
        _goodput.observe_steps(1)
        self._iteration_done(ds)
        return score

    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 32, async_prefetch: bool = True,
            device_prefetch="auto", multi_step="auto"):
        """Train on a DataSetIterator, a DataSet, or (features, labels)
        arrays; the listeners' ``on_epoch_start``/``on_epoch_end`` run
        around each epoch, and the iterator is reset after it unless it
        advances its own epochs (``auto_epochs``: a datapipe Pipeline
        draws epoch e's order from ``seed + e``, and a reset would
        replay epoch 0).

        The JAX package's runtime, each equal bit for bit to the
        per-batch loop: ``async_prefetch`` prepares batches on a
        background thread; ``device_prefetch`` copies batch N+1 to the
        card (pinned memory, a side stream) while step N runs ("auto": on
        for the card, off on the CPU); ``multi_step`` runs chunks of k
        batches through the captured step and replays the listeners
        after each chunk ("auto": 8 on the card when no listener needs
        per-iteration values, 1 on the CPU; an int is honored; tBPTT runs
        per batch).

        The run is a goodput ledger run (observability/goodput.py):
        each pull from the iterator is a ``data_wait`` span, and the
        RunReport lands in ``self.last_run_report``."""
        from deeplearning4j_tpu_torch.compilecache import ensure_configured
        ensure_configured()  # DL4J_TPU_COMPILE_CACHE, if set
        self._require_init()
        if isinstance(data, DataSetIterator):
            it = data
        elif isinstance(data, DataSet):
            it = ListDataSetIterator([data])
        else:
            it = ArrayDataSetIterator(data, labels, batch_size=batch_size)
        chunk = multistep.resolve_multi_step(self, multi_step)
        device_prefetch = multistep.resolve_device_prefetch(self,
                                                            device_prefetch)
        _obs_metrics.install_runtime_metrics()
        tracer = get_tracer()
        ledger = _goodput.start_run("fit", net=self)
        _obs_dist.stamp_run_marker("fit")
        status = "completed"
        try:
            for _ in range(epochs):
                source = AsyncDataSetIterator(it) if async_prefetch else it
                if device_prefetch:
                    source = DevicePrefetchIterator(source,
                                                    device=self.device)
                for l in self.listeners:
                    l.on_epoch_start(self)
                it0, t0 = self.iteration, time.perf_counter()
                if chunk > 1:
                    multistep.fit_epoch_chunked(self, source, chunk,
                                                self._signature)
                else:
                    stream = iter(source)
                    while True:
                        with tracer.span("data_wait"):
                            ds = next(stream, None)
                        if ds is None:
                            break
                        self.fit_batch(ds)
                _obs_metrics.observe_rate(self.iteration - it0,
                                          time.perf_counter() - t0)
                for l in self.listeners:
                    l.on_epoch_end(self)
                self.epoch += 1
                if not getattr(it, "auto_epochs", False):
                    it.reset()
        except BaseException:
            status = "failed"
            raise
        finally:
            self.last_run_report = _goodput.end_run(ledger, status=status)
        return self

    def resilient_fit(self, data, labels=None, *, checkpoint_dir: str,
                      epochs: int = 1, batch_size: int = 32,
                      **supervisor_kw):
        """Supervised ``fit``: periodic checkpoints to fresh step
        directories, auto-resume from the newest valid one, transient-step
        retry, NaN rollback with LR backoff and SIGTERM preemption
        (resilience/supervisor.py). Returns the SupervisorResult."""
        from deeplearning4j_tpu_torch.resilience import resilient_fit
        return resilient_fit(self, data, labels,
                             checkpoint_dir=checkpoint_dir, epochs=epochs,
                             batch_size=batch_size, **supervisor_kw)

    # ------------------------------------------------------------ pretrain
    def pretrain(self, data, *, epochs: int = 1, batch_size: int = 32):
        """Layer-wise unsupervised pretraining: each pretrainable layer
        (VAE, AutoEncoder, RBM) in turn trains on the activations of the
        layers below it. ``data``: an iterator, a DataSet or a features
        array."""
        self._require_init()
        if isinstance(data, DataSetIterator):
            it = data
        elif isinstance(data, DataSet):
            it = ListDataSetIterator([data])
        else:
            it = ArrayDataSetIterator(data, None, batch_size=batch_size)
        for i, layer in enumerate(self.layers):
            if getattr(layer, "is_pretrainable", False):
                self.pretrain_layer(i, it, epochs=epochs)
        return self

    def pretrain_layer(self, idx: int, iterator, *, epochs: int = 1):
        """Pretrain one layer on its (preprocessed) input activations with
        its own unsupervised objective (``pretrain_loss``: -ELBO for a
        VAE, the reconstruction for an AutoEncoder, the CD free-energy
        difference for an RBM) and its updater; each batch is one step and
        one iteration."""
        from deeplearning4j_tpu_torch.nn.layers.pretrain import pretrain_step
        self._require_init()
        layer = self.layers[idx]
        if not getattr(layer, "is_pretrainable", False):
            raise ValueError(f"Layer {idx} ({layer.conf.layer_type}) is not "
                             f"pretrainable")
        if isinstance(iterator, DataSet):
            iterator = ListDataSetIterator([iterator])
        gc = self.conf.global_conf
        last = None
        for _ in range(epochs):
            for ds in iterator:
                with torch.no_grad():
                    x = self._as_tensor(ds.features)
                    if idx > 0:
                        x, _ = self._forward(self.params, self.state, x,
                                             train=False, to_layer=idx)
                    if self.preprocessors[idx] is not None:
                        x = self.preprocessors[idx](x)
                last = pretrain_step(layer, gc, self.params, self.opt_state,
                                     self.iteration, x, self._gen)
                self.iteration += 1
            iterator.reset()
        self.score_value = last
        return self

    def score(self, ds: DataSet, train: bool = False) -> float:
        """The loss (with regularization) on one dataset."""
        self._require_init()
        with torch.no_grad():
            loss, _ = self._loss(self.params, self.state, *self._batch(ds),
                                 gen=self._gen, train=train)
        return float(loss)

    def _evaluate_with(self, ev, iterator):
        if isinstance(iterator, DataSet):
            iterator = ListDataSetIterator([iterator])
        for ds in iterator:
            ev.eval(ds.labels,
                    self.output(ds.features, mask=ds.features_mask),
                    mask=ds.labels_mask)
        return ev

    def evaluate(self, iterator):
        """Classification evaluation (``eval.Evaluation``) of the outputs
        over a DataSet or an iterator of them."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        return self._evaluate_with(Evaluation(), iterator)

    def evaluate_regression(self, iterator):
        """Regression evaluation (``eval.RegressionEvaluation``) of the
        outputs over a DataSet or an iterator of them."""
        from deeplearning4j_tpu_torch.eval.regression import (
            RegressionEvaluation)
        return self._evaluate_with(RegressionEvaluation(), iterator)

    # ------------------------------------------------- streaming inference
    def rnn_clear_previous_state(self):
        self._rnn_state = None

    def rnn_time_step(self, x, mask=None) -> torch.Tensor:
        """Stateful streaming inference: feed one step [b, f] or a chunk
        [b, t, f]; recurrent layers carry (h, c) across calls."""
        self._require_init()
        x = self._as_tensor(x)
        single = x.dim() == 2
        if single:
            x = x[:, None, :]
        set_streaming(self.layers, True)
        try:
            state_in = (self._rnn_state if self._rnn_state is not None
                        else self.state)
            with torch.inference_mode():
                out, new_state = self._forward(
                    self.params, state_in, x, fmask=self._as_tensor(mask))
            self._rnn_state = new_state
        finally:
            set_streaming(self.layers, False)
        return out[:, 0, :] if single else out

    # ---------------------------------------------------------------- misc
    def num_params(self) -> int:
        return sum(t.numel() for t in _leaves(self.params))

    def summary(self) -> str:
        lines = ["=" * 70]
        lines.append(f"{'name':<18}{'type':<16}{'out type':<22}{'params':>10}")
        lines.append("-" * 70)
        for layer in self.layers:
            n = sum(t.numel() for t in _leaves(self.params.get(layer.name,
                                                               {})))
            lines.append(
                f"{layer.name:<18}{layer.conf.layer_type:<16}"
                f"{str(layer.output_type.kind):<22}{n:>10}")
        lines.append("-" * 70)
        lines.append(f"total params: {self.num_params()}")
        lines.append("=" * 70)
        return "\n".join(lines)

    def clone(self) -> "MultiLayerNetwork":
        """A copy on the same device that shares no storage with this
        net: parameters, layer state, optimizer state, the counters and
        the generator's state. Training either net leaves the other as it
        was (the update writes the parameters in place)."""
        self._require_init()
        net = MultiLayerNetwork(self.conf, device=self.device)
        net._build_layers()
        net.params = _copy_tree(self.params)
        net.state = _copy_tree(self.state)
        net.opt_state = _copy_tree(self.opt_state)
        net.iteration = self.iteration
        net.epoch = self.epoch
        net._lr_scale = self._lr_scale
        net._gen = torch.Generator(device=self.device)
        net._gen.set_state(self._gen.get_state())
        return net
