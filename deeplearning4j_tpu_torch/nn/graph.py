"""ComputationGraph — a DAG network that trains and serves (counterpart of
deeplearning4j_tpu/nn/graph.py: ``init``, ``_walk`` with the block-fusion
pass and the remat spans, ``_loss``, ``fit_batch`` with truncated BPTT,
in-memory ``fit``, listeners, ``score``, ``output``, ``feed_forward``,
``rnn_time_step``, ``rnn_clear_previous_state``, ``evaluate``,
``evaluate_regression``, ``num_params``, ``summary``, ``clone``,
``set_lr_scale``, ``resilient_fit``, ``pretrain``, ``pretrain_layer``).

Parameters are ``{vertex_name: {param: tensor}}`` and the layer state
(batch-norm running statistics, a streaming LSTM's carry)
``{vertex_name: {...}}``, in the JAX package's layouts, so a graph
crosses between the packages through the zip (utils/serialization.py). A
train step is the same discipline as ``MultiLayerNetwork``'s
(nn/multistep.py's ``train_step``): the walk, the summed output losses
plus regularization, ``autograd``, then the multi-tensor update in place;
``fit(multi_step=k)`` and ``fit_batch_repeated`` replay it as a CUDA
graph.

The training walk routes every bottleneck tail the fusion pass matched
(nn/fusion.py, ``DL4J_TPU_FUSE_BLOCKS=1`` at ``init``) through the fused
op: K4-K7 on the card. Without fusion plans, the vertices that
``DL4J_TPU_REMAT`` names run in remat spans (nn/remat.py). The eval walk
(``output``) runs vertex by vertex with the running statistics.

Truncated BPTT (``backprop_type="tbptt"``, a batch longer than
``tbptt_fwd_length``) cuts every time series into windows and takes one
update a window, each at the batch's iteration; the recurrent vertices
carry (h, c) from window to window in the layer state, which is cleared
after the batch. ``rnn_time_step`` streams the same carry from call to
call. The LSTM vertices run K1 (forward) and K2 (backward) on the card.

``resilient_fit`` supervises training (resilience/), and ``pretrain``
trains the pretrainable layer vertices. ``use_mesh`` trains over a
mesh's data axis and, with ``model_axis=``, its model axis
(parallel/tensor.py): the walk hands each layer vertex its params
through nn/multilayer.py's ``layer_params``, so a vertex no rendering
covers takes the counted gather route, and the fused tails run on
column shards (nn/fusion.py).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import (AsyncDataSetIterator,
                                                        DevicePrefetchIterator)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import fusion as _fusion
from deeplearning4j_tpu_torch.nn import multilayer as _mln
from deeplearning4j_tpu_torch.nn import multistep, remat
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayerConfig
from deeplearning4j_tpu_torch.nn.conf.vertices import (
    DuplicateToTimeSeriesVertex, LastTimeStepVertex)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (set_streaming,
                                                          strip_carries)
from deeplearning4j_tpu_torch.nn.updater import _copy_tree, _leaves
from deeplearning4j_tpu_torch.observability import distributed as _obs_dist
from deeplearning4j_tpu_torch.observability import goodput as _goodput
from deeplearning4j_tpu_torch.observability import metrics as _obs_metrics
from deeplearning4j_tpu_torch.observability.trace import get_tracer
from deeplearning4j_tpu_torch.parallel.tensor import gather_route


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.topo = conf.topological_order()
        self.layers = None          # runtime layers of the layer vertices
        self.vertex_kind = None     # name -> "layer" | "vertex"
        self.params = None
        self.state = None
        self.opt_state = None
        self.iteration = 0
        self.epoch = 0
        self.score_value = None
        self.last_batch_examples = 0
        self.listeners: list = []
        self._gen = None
        self._lr_scale = 1.0
        self._rnn_state = None     # rnn_time_step's carries between calls
        # DL4J_TPU_REMAT, read at the first train step (nn/remat.py)
        self.remat_prefixes = None
        self._remat_warned = False
        self._fusion_plans = {}
        self._fusion_interior = frozenset()
        self._multi_steps = {}     # batch signature -> multistep.StepGraph
        self._grad_reduce = None   # the meshed step's all-reduce
        self._tp = None            # parallel/tensor.py, on a model axis
        self.last_run_report = None  # the last fit's goodput RunReport
        self.flops_per_step = None
        self._flops_key = None

    def use_mesh(self, mesh, data_axis: str = "data",
                 model_axis: str | None = None, tp_rules=None):
        """Training over a mesh (parallel/mesh.py ``make_mesh``):
        parameters replicated over ``data_axis``, each rank steps on its
        local batch, one gradient all-reduce a step (on NCCL inside the
        captured step). With ``model_axis`` the params are also placed
        over that axis (parallel/tensor.py): a conv's W on its output
        channels, a fused tail's K4-K7 on this rank's column shards, batch
        norm and the element-wise, pooling and merge vertices on whole
        activations; ``tp_rules`` override the placement."""
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

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None, *,
             structure_only: bool = False):
        """Resolve input types through the DAG, build the runtime layers,
        match the fusable tails, draw parameters from a ``torch.Generator``
        seeded with ``seed`` (default: the config's) and start a fresh
        optimizer state. Carry a JAX model across with
        utils/serialization.py instead. With ``structure_only`` the
        params, state and updater state are ``meta`` tensors of the
        shapes and dtypes ``init()`` gives and nothing is drawn."""
        gc = self.conf.global_conf
        seed = gc.seed if seed is None else seed
        self._build_vertices()
        if structure_only:
            gen, dev = None, torch.device("meta")
        else:
            gen = torch.Generator(device="cpu").manual_seed(int(seed))
            dev = self.device
        self.params, self.state, self.opt_state = _mln.init_trees(
            self.layers, gc.dtype, gen, dev)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.iteration = 0
        self._multi_steps = {}
        self._rnn_state = None
        return self

    def materialize_state(self):
        """Concrete layer state on the net's device (batch norm's running
        statistics as ``init()`` starts them): after a structure-only
        init, for a net whose checkpoint holds no state."""
        self.state = _mln.init_state(self.layers, self.device)

    def materialize_opt_state(self):
        """A fresh updater state over the (concrete) params on the net's
        device: after a structure-only init, when the updater state is
        not restored."""
        self.opt_state = _mln.init_opt_state(self.layers, self.params,
                                             self.conf.global_conf.dtype,
                                             self.device)

    def _build_vertices(self):
        """The runtime layers, each vertex's kind and resolved config, and
        the fusion pass's plans."""
        gc = self.conf.global_conf
        input_types: Dict[str, object] = {}
        if self.conf.input_types is not None:
            for name, it in zip(self.conf.network_inputs,
                                self.conf.input_types):
                input_types[name] = it
        self.layers = []
        self._layer_by_name = {}
        self.vertex_kind = {}
        self._resolved_confs = {}
        for name in self.topo:
            conf = self.conf.vertices[name]
            in_names = self.conf.vertex_inputs[name]
            in_types = [input_types.get(i) for i in in_names]
            if isinstance(conf, BaseLayerConfig):
                self.vertex_kind[name] = "layer"
                if len(in_names) != 1:
                    raise ValueError(
                        f"Layer vertex '{name}' must have exactly 1 input, "
                        f"got {in_names}")
                it = in_types[0]
                if it is not None:
                    conf = conf.with_n_in(it)
                if getattr(conf, "n_in", 1) is None:
                    raise ValueError(
                        f"Layer vertex '{name}': n_in not set and no "
                        f"input type available for inference")
                layer = conf.make_layer(it, gc, gc.dtype)
                self.layers.append(layer)
                self._layer_by_name[name] = layer
                self._resolved_confs[name] = conf
                input_types[name] = layer.output_type
            else:
                self.vertex_kind[name] = "vertex"
                self._resolved_confs[name] = conf
                input_types[name] = (conf.output_type(*in_types)
                                     if all(t is not None for t in in_types)
                                     else None)

        # block-fusion pass on the RESOLVED configs; applied in _walk for
        # training walks only
        self._fusion_plans = _fusion.find_fusable_chains(
            self._resolved_confs, self.conf.vertex_inputs,
            self.conf.network_outputs,
            default_activation=gc.activation or "sigmoid")
        self._fusion_interior = frozenset(
            _fusion.interior_vertices(self._fusion_plans))

    def _require_init(self):
        if self.params is None:
            raise RuntimeError(
                "Graph not initialized — call net.init() before "
                "fit()/output()")

    # -------------------------------------------------------------- forward
    def _walk(self, params, state, inputs: Dict, *, train, gen=None,
              fmasks: Optional[Dict] = None, need_inputs_of=()):
        """Walk the DAG in topological order. Returns (activations,
        {vertex: (inputs, input masks)} for ``need_inputs_of``, masks,
        new_state)."""
        acts = dict(inputs)
        masks = dict(fmasks or {})
        saved_inputs = {}
        new_state = dict(state)
        plans = self._fusion_plans if train else {}
        interior = self._fusion_interior if plans else frozenset()
        # remat spans: training walks without fusion plans, and only where
        # no input of the span carries a mask
        prefixes = remat.active(self) if train and not plans else ()
        spans = (self._remat_spans(prefixes, set(need_inputs_of))
                 if prefixes else {})
        i = 0
        while i < len(self.topo):
            name = self.topo[i]
            span = spans.get(name)
            if span is not None and not any(
                    masks.get(e) is not None
                    for e in self._span_ext_inputs(span)):
                self._run_remat_span(span, params, state, acts, masks,
                                     new_state, gen)
                i += len(span)
                continue
            i += 1
            if name in interior:
                continue
            if name in plans:
                fb = plans[name]
                y, bn_state_new = _fusion.execute_fused_tail(
                    fb, self, params, state, acts)
                acts[name] = y
                masks[name] = None
                new_state[fb.bn] = bn_state_new
                continue
            conf = self._resolved_confs[name]
            xs = [acts[src] for src in self.conf.vertex_inputs[name]]
            in_masks = [masks.get(src) for src in self.conf.vertex_inputs[name]]
            # the rnn vertices' named inputs: the named vertex supplies the
            # mask (LastTimeStep) or the time length and mask
            # (DuplicateToTimeSeries)
            if isinstance(conf, LastTimeStepVertex) and conf.mask_input:
                in_masks = [masks.get(conf.mask_input)]
            if (isinstance(conf, DuplicateToTimeSeriesVertex)
                    and conf.seq_input):
                xs = [xs[0], acts[conf.seq_input]]
                in_masks = [in_masks[0], masks.get(conf.seq_input)]
            if name in need_inputs_of:
                saved_inputs[name] = (xs, in_masks)
            if self.vertex_kind[name] == "layer":
                layer = self._layer_by_name[name]
                y, s_new = layer.apply(_mln.layer_params(layer, params),
                                       state.get(name, {}), xs[0],
                                       train=train, gen=gen,
                                       mask=in_masks[0])
                if s_new:
                    new_state[name] = s_new
                acts[name] = y
                masks[name] = layer.feed_forward_mask(in_masks[0])
            else:
                acts[name] = conf.forward(*xs, masks=in_masks)
                masks[name] = conf.feed_forward_mask(*in_masks)
        return acts, saved_inputs, masks, new_state

    # -------------------------------------------------- selective remat
    def _remat_spans(self, prefixes, skip: set) -> Dict[str, list]:
        """Maximal contiguous topological runs of vertices matching the
        prefixes, keyed by their first vertex; loss-bearing layers, the
        vertices whose inputs the caller needs and the rnn vertices with
        named inputs stay outside (the JAX package's rule)."""
        spans: Dict[str, list] = {}
        run: list = []
        for name in self.topo:
            layer = self._layer_by_name.get(name)
            if (remat.match(name, prefixes) and name not in skip
                    and not (layer is not None and hasattr(layer, "loss"))
                    and not isinstance(self._resolved_confs[name],
                                       (LastTimeStepVertex,
                                        DuplicateToTimeSeriesVertex))):
                run.append(name)
            elif run:
                spans[run[0]] = run
                run = []
        if run:
            spans[run[0]] = run
        return spans

    def _span_ext_inputs(self, span: list) -> list:
        inside = set(span)
        ext = []
        for v in span:
            for src in self.conf.vertex_inputs[v]:
                if src not in inside and src not in ext:
                    ext.append(src)
        return ext

    def _run_remat_span(self, span, params, state, acts, masks, new_state,
                        gen):
        """One span under nn/remat.py's ``run_span``: its inputs in, the
        activations consumed outside it (or its last) and its layers' new
        state out. Mutates acts, masks and new_state."""
        inside = set(span)
        ext = self._span_ext_inputs(span)
        consumed_outside = set(self.conf.network_outputs)
        for v, ins in self.conf.vertex_inputs.items():
            if v not in inside:
                consumed_outside.update(ins)
        outs = [v for v in span if v in consumed_outside] or [span[-1]]

        def run(*ext_acts):
            local = dict(zip(ext, ext_acts))
            ns = {}
            for v in span:
                xs = [local[src] for src in self.conf.vertex_inputs[v]]
                if self.vertex_kind[v] == "layer":
                    layer = self._layer_by_name[v]
                    y, s_new = layer.apply(
                        _mln.layer_params(layer, params), state.get(v, {}),
                        xs[0],
                        train=True, gen=gen, mask=None)
                    if s_new:
                        ns[v] = s_new
                    local[v] = y
                else:
                    local[v] = self._resolved_confs[v].forward(
                        *xs, masks=[None] * len(xs))
            return [local[v] for v in outs], ns

        out_acts, ns = remat.run_span(run, *[acts[e] for e in ext])
        acts.update(zip(outs, out_acts))
        for v in span:
            masks[v] = None
        new_state.update(ns)

    def _as_tensor(self, x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _prepare_inputs(self, features, fmasks=None):
        inputs = {n: self._as_tensor(f)
                  for n, f in zip(self.conf.network_inputs, features)}
        md = {}
        if fmasks is not None:
            for n, m in zip(self.conf.network_inputs, fmasks):
                if m is not None:
                    md[n] = self._as_tensor(m)
        return inputs, md

    def _loss(self, params, state, inputs, labels, fmasks=None, lmasks=None,
              gen=None, train=True):
        """Sum of the output layers' losses plus regularization (the
        scalar a train step differentiates) and the new layer state."""
        outs = self.conf.network_outputs
        acts, saved, masks, new_state = self._walk(
            params, state, inputs, train=train, gen=gen, fmasks=fmasks,
            need_inputs_of=set(outs))
        total = None
        for i, name in enumerate(outs):
            layer = self._layer_by_name.get(name)
            if layer is None or not hasattr(layer, "loss"):
                raise ValueError(
                    f"Network output '{name}' is not a loss-bearing layer "
                    f"(Output/RnnOutput/LossLayer)")
            xs, _ = saved[name]
            lm = None if lmasks is None else lmasks[i]
            lp = _mln.layer_params(layer, params)
            if getattr(layer, "loss_uses_state", False):
                s_out = state.get(name, {})
                l = layer.loss(lp, xs[0], labels[i], train=train, gen=gen,
                               mask=lm, state=s_out)
                if train:
                    new_state[name] = layer.update_centers(
                        s_out, xs[0].detach(), labels[i], mask=lm)
            else:
                l = layer.loss(lp, xs[0], labels[i], train=train, gen=gen,
                               mask=lm)
            total = l if total is None else total + l
        for layer in self.layers:
            if layer.name in params:
                total = total + layer.regularization(params[layer.name])
        return total, new_state

    # ---------------------------------------------------------------- train
    @staticmethod
    def _coerce(data) -> MultiDataSet:
        if isinstance(data, MultiDataSet):
            return data
        if isinstance(data, DataSet):
            return MultiDataSet.from_dataset(data)
        raise TypeError(f"Expected DataSet or MultiDataSet, got {type(data)}")

    def _batch(self, mds: MultiDataSet):
        inputs, fmasks = self._prepare_inputs(mds.features,
                                              mds.features_masks)
        labels = [self._as_tensor(l) for l in mds.labels]
        lmasks = [self._as_tensor(m) for m in mds.labels_masks]
        if all(m is None for m in lmasks):
            lmasks = None
        return inputs, labels, fmasks, lmasks

    def _step_batch(self, data):
        """What nn/multistep.py's train_step takes."""
        return self._batch(self._coerce(data))

    @classmethod
    def _signature(cls, data):
        m = cls._coerce(data)
        shape = lambda a: None if a is None else tuple(a.shape)  # noqa: E731
        return (tuple(shape(f) for f in m.features),
                tuple(shape(l) for l in m.labels),
                tuple(shape(x) for x in m.features_masks),
                tuple(shape(x) for x in m.labels_masks))

    def _needs_tbptt(self, mds) -> bool:
        """tBPTT configured and a time series longer than one window."""
        if self.conf.backprop_type != "tbptt":
            return False
        t_dims = {f.shape[1] for f in mds.features
                  if getattr(f, "ndim", 0) == 3}
        return bool(t_dims) and max(t_dims) > self.conf.tbptt_fwd_length

    def _fit_tbptt(self, mds):
        """Truncated BPTT on the DAG: every time series (3-D input,
        per-timestep label, [b, t] mask) cut into ``tbptt_fwd_length``
        windows; a static 2-D input goes whole to every window. One update
        a window, each at the batch's iteration (the JAX package passes
        the same ``it`` to every chunk); the recurrent vertices carry
        (h, c) from window to window through the layer state, cleared
        after the batch. The score is the windows' mean weighted by their
        lengths."""
        inputs, labels, fmasks, lmasks = self._batch(mds)
        if any(l.dim() == 2 for l in labels):
            raise ValueError(
                "tBPTT requires per-timestep labels [batch, time, out]; got "
                "a 2d (sequence-classification) label — use "
                "backprop_type='standard' for sequence classification")
        t_lens = {f.shape[1] for f in inputs.values() if f.dim() == 3}
        t_lens |= {l.shape[1] for l in labels if l.dim() == 3}
        if len(t_lens) != 1:
            raise ValueError(
                "tBPTT requires all time-series inputs AND per-timestep "
                "labels to share one time length; got time lengths "
                f"{sorted(t_lens)} (sequence-classification labels need "
                "backprop_type='standard')")

        def cut(a, sl, dims):
            return a[:, sl] if a is not None and a.dim() == dims else a

        def window(sl):
            return ({n: cut(f, sl, 3) for n, f in inputs.items()},
                    [cut(l, sl, 3) for l in labels],
                    {n: cut(m, sl, 2) for n, m in fmasks.items()},
                    None if lmasks is None else [cut(m, sl, 2)
                                                 for m in lmasks])

        with get_tracer().span("device_step", tbptt=True):
            score = multistep.fit_windows(self, t_lens.pop(), window)
        self.state = strip_carries(self.state)
        self.iteration += 1
        self.score_value = score
        self.last_batch_examples = mds.num_examples
        _goodput.observe_steps(1)
        with get_tracer().span("score_sync"):
            for l in self.listeners:
                l.iteration_done(self, self.iteration, self.epoch)
        return score

    def fit_batch(self, mds):
        """One optimization step on one DataSet or MultiDataSet minibatch.
        Returns the score as a 0-d tensor on the graph's device."""
        self._require_init()
        mds = self._coerce(mds)
        if self._needs_tbptt(mds):
            return self._fit_tbptt(mds)
        tracer = get_tracer()
        with tracer.span("host_dispatch"):
            batch = self._batch(mds)
        with tracer.span("device_step"):
            score = multistep.train_step(self, batch)
        self.iteration += 1
        self.score_value = score
        self.last_batch_examples = mds.num_examples
        _goodput.observe_steps(1)
        multistep.maybe_derive_flops(self, mds)
        if self.listeners:
            t0 = time.perf_counter()
            for l in self.listeners:
                l.iteration_done(self, self.iteration, self.epoch)
            t1 = time.perf_counter()
            tracer.record("score_sync", t0, t1)
            _obs_metrics.observe_dispatch_lag(t1 - t0)
        return score

    def fit_batch_repeated(self, mds, n_steps: int):
        """``n_steps`` optimization steps on one minibatch through the
        captured step (see MultiLayerNetwork.fit_batch_repeated). A graph
        set to tBPTT runs n ``fit_batch`` calls instead, as in the JAX
        package (the window loop is not captured)."""
        self._require_init()
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        mds = self._coerce(mds)
        if self.conf.backprop_type == "tbptt":
            for _ in range(n_steps):
                score = self.fit_batch(mds)
            return score
        return multistep.fit_batch_repeated(self, mds, n_steps)

    def step_cost_analysis(self, mds) -> dict:
        """The operations of ONE train step on this batch (see
        MultiLayerNetwork.step_cost_analysis)."""
        from deeplearning4j_tpu_torch.utils.perf import step_flops
        self._require_init()
        return step_flops(self, self._step_batch(mds))

    def fit(self, data, *, epochs: int = 1, async_prefetch: bool = True,
            device_prefetch="auto", multi_step="auto"):
        """Train on a DataSet, a MultiDataSet, or an iterable of them (a
        list, or an iterator with ``reset()``); the listeners'
        ``on_epoch_start``/``on_epoch_end`` run around each epoch.
        ``async_prefetch`` (iterators with ``reset()``),
        ``device_prefetch`` and ``multi_step`` as in
        ``MultiLayerNetwork.fit``, each equal bit for bit to the
        per-batch loop. An iterator is reset after each epoch unless it
        advances its own epochs (``auto_epochs``: a datapipe Pipeline).
        The run is a goodput ledger run; its RunReport lands in
        ``self.last_run_report``."""
        from deeplearning4j_tpu_torch.compilecache import ensure_configured
        ensure_configured()  # DL4J_TPU_COMPILE_CACHE, if set
        self._require_init()
        items = [data] if isinstance(data, (DataSet, MultiDataSet)) else data
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
                source = items
                if async_prefetch and hasattr(items, "reset"):
                    source = AsyncDataSetIterator(items)
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
                            d = next(stream, None)
                        if d is None:
                            break
                        self.fit_batch(d)
                _obs_metrics.observe_rate(self.iteration - it0,
                                          time.perf_counter() - t0)
                for l in self.listeners:
                    l.on_epoch_end(self)
                self.epoch += 1
                if hasattr(items, "reset") and not getattr(
                        items, "auto_epochs", False):
                    items.reset()
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
    def pretrain(self, data, *, epochs: int = 1):
        """Layer-wise unsupervised pretraining over the DAG: each
        pretrainable layer vertex (VAE, AutoEncoder, RBM), in topological
        order, trains on the activations its input vertex produces under
        the current parameters."""
        self._require_init()
        for name in self.topo:
            layer = self._layer_by_name.get(name)
            if layer is not None and getattr(layer, "is_pretrainable", False):
                self.pretrain_layer(name, data, epochs=epochs)
        return self

    def pretrain_layer(self, name: str, data, *, epochs: int = 1):
        """Pretrain one layer vertex on its input's activations (see
        MultiLayerNetwork.pretrain_layer); ``data`` a DataSet, a
        MultiDataSet or an iterable of them."""
        from deeplearning4j_tpu_torch.nn.layers.pretrain import pretrain_step
        self._require_init()
        layer = self._layer_by_name.get(name)
        if layer is None or not getattr(layer, "is_pretrainable", False):
            raise ValueError(f"Vertex '{name}' is not a pretrainable layer")
        gc = self.conf.global_conf
        items = [data] if isinstance(data, (DataSet, MultiDataSet)) else data
        last = None
        for _ in range(epochs):
            for d in items:
                mds = self._coerce(d)
                inputs, fmasks = self._prepare_inputs(mds.features,
                                                      mds.features_masks)
                with torch.no_grad():
                    _, saved, _, _ = self._walk(
                        self.params, self.state, inputs, train=False,
                        fmasks=fmasks, need_inputs_of=(name,))
                last = pretrain_step(layer, gc, self.params, self.opt_state,
                                     self.iteration, saved[name][0][0],
                                     self._gen)
                self.iteration += 1
            if hasattr(items, "reset"):
                items.reset()
        self.score_value = last
        return self

    def score(self, mds, train: bool = False) -> float:
        """The loss (with regularization) on one dataset."""
        self._require_init()
        with torch.no_grad():
            loss, _ = self._loss(self.params, self.state,
                                 *self._batch(self._coerce(mds)),
                                 gen=self._gen, train=train)
        return float(loss)

    def output(self, *features, masks=None, train: bool = False):
        """The network outputs' activations (one tensor for a one-output
        graph, else a tuple)."""
        self._require_init()
        inputs, fmasks = self._prepare_inputs(features, masks)
        with torch.inference_mode():
            acts, _, _, _ = self._walk(self.params, self.state, inputs,
                                       train=train, gen=self._gen,
                                       fmasks=fmasks)
        outs = tuple(acts[o] for o in self.conf.network_outputs)
        return outs[0] if len(outs) == 1 else outs

    # ------------------------------------------------- streaming inference
    def rnn_clear_previous_state(self):
        """Forget the carries ``rnn_time_step`` keeps between calls."""
        self._rnn_state = None

    def rnn_time_step(self, *features, masks=None):
        """Stateful streaming inference: one step [b, f] or a chunk
        [b, t, f] per network input; the recurrent vertices carry (h, c)
        from call to call. When no input has a time axis, each input is
        taken as one step ([b, 1, f]) unless its input type is explicitly
        non-recurrent (the static side of a DuplicateToTimeSeriesVertex),
        and 3-D outputs come back as [b, f]."""
        self._require_init()
        feats = [self._as_tensor(f) for f in features]
        single = all(f.dim() == 2 for f in feats)
        if single:
            its = self.conf.input_types or [None] * len(feats)
            feats = [f[:, None, :] if it is None or it.kind == "recurrent"
                     else f for f, it in zip(feats, its)]
        inputs, fmasks = self._prepare_inputs(feats, masks)
        state_in = (self._rnn_state if self._rnn_state is not None
                    else self.state)
        set_streaming(self.layers, True)
        try:
            with torch.inference_mode(), gather_route(self):
                acts, _, _, new_state = self._walk(
                    self.params, state_in, inputs, train=False,
                    gen=self._gen, fmasks=fmasks)
            self._rnn_state = new_state
        finally:
            set_streaming(self.layers, False)
        outs = tuple(acts[o] for o in self.conf.network_outputs)
        if single:
            outs = tuple(o[:, 0, :] if o.dim() == 3 else o for o in outs)
        return outs[0] if len(outs) == 1 else outs

    def feed_forward(self, *features, masks=None, train: bool = False):
        """Every vertex's activation, by name."""
        self._require_init()
        inputs, fmasks = self._prepare_inputs(features, masks)
        with torch.inference_mode():
            acts, _, _, _ = self._walk(self.params, self.state, inputs,
                                       train=train, gen=self._gen,
                                       fmasks=fmasks)
        return acts

    def _evaluate_with(self, ev, iterator, what: str):
        """The single-output evaluation loop of evaluate and
        evaluate_regression."""
        if len(self.conf.network_outputs) != 1:
            raise ValueError(f"{what}() requires a single-output graph; this "
                             f"one has outputs {self.conf.network_outputs}")
        if isinstance(iterator, (DataSet, MultiDataSet)):
            iterator = [iterator]
        for d in iterator:
            mds = self._coerce(d)
            out = self.output(*mds.features, masks=(
                mds.features_masks
                if any(m is not None for m in mds.features_masks) else None))
            ev.eval(mds.labels[0], out, mask=mds.labels_masks[0])
        return ev

    def evaluate(self, iterator):
        """Classification evaluation (``eval.Evaluation``) of a
        single-output graph over a DataSet, a MultiDataSet or an iterable
        of them."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        return self._evaluate_with(Evaluation(), iterator, "evaluate")

    def evaluate_regression(self, iterator):
        """Regression evaluation (``eval.RegressionEvaluation``) of a
        single-output graph."""
        from deeplearning4j_tpu_torch.eval.regression import (
            RegressionEvaluation)
        return self._evaluate_with(RegressionEvaluation(), iterator,
                                   "evaluate_regression")

    def num_params(self) -> int:
        return sum(t.numel() for t in _leaves(self.params))

    def summary(self) -> str:
        lines = ["=" * 78]
        lines.append(f"{'name':<20}{'kind':<16}{'inputs':<28}{'params':>10}")
        lines.append("-" * 78)
        for name in self.topo:
            kind = self.vertex_kind[name]
            t = (self._resolved_confs[name].layer_type if kind == "layer"
                 else self._resolved_confs[name].vertex_type)
            n = sum(a.numel() for a in _leaves(self.params.get(name, {})))
            ins = ",".join(self.conf.vertex_inputs[name])
            lines.append(f"{name:<20}{t:<16}{ins:<28}{n:>10}")
        lines.append("-" * 78)
        lines.append(f"total params: {self.num_params()}")
        lines.append("=" * 78)
        return "\n".join(lines)

    def clone(self) -> "ComputationGraph":
        """A copy on the same device that shares no storage with this
        graph: parameters, layer state, optimizer state, the counters and
        the generator's state, and the same fusion plans."""
        self._require_init()
        net = ComputationGraph(self.conf, device=self.device)
        net._build_vertices()
        net._fusion_plans = self._fusion_plans
        net._fusion_interior = self._fusion_interior
        net.params = _copy_tree(self.params)
        net.state = _copy_tree(self.state)
        net.opt_state = _copy_tree(self.opt_state)
        net.iteration = self.iteration
        net.epoch = self.epoch
        net._lr_scale = self._lr_scale
        net._gen = torch.Generator(device=self.device)
        net._gen.set_state(self._gen.get_state())
        return net
