"""The whole train step as one CUDA graph, and the fit runtime around it
(counterpart of deeplearning4j_tpu/nn/multistep.py and of the chunked
fit loop of deeplearning4j_tpu/nn/{multilayer,graph}.py).

The JAX package traces a step once and dispatches many as one XLA
execution (``lax.scan``). Here the counterpart of that execution is a
CUDA graph of one whole step (forward, backward, the multi-tensor update,
the layer-state write-back, the iteration's advance), captured once per
(network, batch signature) and replayed for each step after:

- **Static buffers.** Each batch is copied into the graph's input
  buffers (features, labels, masks) before a replay.
- **No step runs twice, none is skipped.** ``torch.cuda.graph`` wants a
  few eager steps on a side stream before capture (PyTorch's recipe for
  capturing a whole network); here those are the first real steps. The
  capture itself runs nothing, so the batch a graph was captured on is
  replayed once right after.
- **State.** Parameters and updater slots are updated in place
  (nn/updater.py); the new layer state (batch-norm running statistics)
  is copied into the tensors the net holds; the iteration the schedules
  read is an int32 device twin of ``net.iteration`` that the step
  advances. A graph reads and writes the tensors it was captured over:
  before a replay, any tree leaf the net has replaced since is copied in
  and the net's tree pointed back at the graph's tensor. The score goes
  to a static output, cloned after every replay.
- **Dropout.** The net's own ``torch.Generator`` is registered with the
  graph, so each replay draws the bits the same eager step would.
- **No fallback.** An operation that cannot be captured makes capture
  raise ``CaptureError``, with the kernel wrapper's or PyTorch's message
  (a kernel names itself and its route; a host read of a device value
  names the ``Tensor`` method). The step is never run eagerly in its
  place. On the CPU nothing is captured: the same step runs eagerly, the
  JAX package's own CPU behaviour.

Launch counts: a capture records its kernels' launches against the
graph (``registry.recording``) and each replay adds them
(``registry.add_launches``), so ``registry.launches()`` counts a replayed
step as it counts an eager one.

A net keeps its graphs in ``net._multi_steps``, dropped where the JAX
package drops its scanned steps (``init``, ``set_lr_scale``) and when its
listeners are set; a ``clone`` starts with none.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from deeplearning4j_tpu_torch.nn import precision, remat
from deeplearning4j_tpu_torch.nn.updater import NoOp, _map
from deeplearning4j_tpu_torch.observability import goodput as _goodput
from deeplearning4j_tpu_torch.observability import metrics as _obs_metrics
from deeplearning4j_tpu_torch.observability.trace import get_tracer
from deeplearning4j_tpu_torch.ops import registry

#: eager steps on the side stream before a capture (the count
#: ``torch.cuda.make_graphed_callables`` warms up with)
WARMUP_STEPS = 3
#: ``fit(multi_step="auto")``'s chunk on the card (the JAX package's)
FIT_CHUNK_DEFAULT = 8


class CaptureError(RuntimeError):
    """The train step could not be captured as a CUDA graph."""


# ------------------------------------------------------------ the step
class DeviceIteration:
    """An int32 tensor on the net's device holding ``net.iteration``: the
    schedules read it, the step advances it, so a replayed step reads the
    iteration it runs at. ``value`` is the host's record of what it holds;
    ``at`` refills it (one fill, no host read) when ``net.iteration`` was
    set from outside."""

    def __init__(self, device):
        self.tensor = torch.zeros((), dtype=torch.int32, device=device)
        self.value = 0

    def at(self, iteration: int) -> torch.Tensor:
        if self.value != iteration:
            self.tensor.fill_(iteration)
            self.value = iteration
        return self.tensor


def device_iteration(net) -> torch.Tensor:
    """The net's device twin of its iteration, in step with it."""
    twin = getattr(net, "_it_twin", None)
    if twin is None or twin.tensor.device != net.device:
        twin = net._it_twin = DeviceIteration(net.device)
    return twin.at(net.iteration)


def commit_state(dst: dict, src: dict):
    """Writes a step's new layer state into the tensors ``dst`` holds
    (a new entry, or one of another shape, is taken as it is)."""
    with torch.no_grad():
        for name, sub in src.items():
            old = dst.get(name)
            if (isinstance(sub, dict) and isinstance(old, dict)
                    and sorted(sub) == sorted(old)
                    and all(_same_kind(old[k], sub[k]) for k in sub)):
                for k, t in sub.items():
                    if t is not old[k]:
                        old[k].copy_(t)
            else:
                dst[name] = _map(lambda t: t.detach(), sub)


def _same_kind(a, b):
    return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.shape == b.shape and a.dtype == b.dtype
            and a.device == b.device)


def frozen_layers(net) -> frozenset:
    """Names of the layers whose updater is ``NoOp`` (a ``Frozen``
    wrapper's, or one configured so): their update discards the
    gradient, so a step does not compute it."""
    return frozenset(l.name for l in net.layers
                     if isinstance(l.resolve("updater"), NoOp))


def step_leaves(net) -> dict:
    """The parameter leaves a step differentiates and updates in place:
    tensors sharing storage with ``net.params``, each requiring grad but
    a frozen layer's. The JAX package differentiates every parameter and
    lets ``NoOp`` discard the frozen ones (dead code to XLA); here
    autograd is not asked for them, so a frozen prefix costs no weight
    gradient, and no backward at all below the first trained layer."""
    frozen = frozen_layers(net)
    return {name: _map(lambda t: t.detach() if name in frozen
                       else t.detach().requires_grad_(), sub)
            for name, sub in net.params.items()}


def train_step(net, batch, advance: bool = True) -> torch.Tensor:
    """One optimization step on ``batch`` (the net's ``_step_batch``
    tuple of device tensors), everything in place: parameters, updater
    slots, layer state and the device iteration. Returns the score, a
    0-d tensor. Reads nothing back to the host, so it can be captured.
    ``advance=False`` leaves the iteration where it is: a tBPTT window's
    step, every window of a batch at the batch's iteration. The first
    step resolves the net's ``DL4J_TPU_REMAT`` (nn/remat.py)."""
    remat.resolve(net)
    step = precision.build_step_fn(net._loss, net.layers,
                                   net.conf.global_conf, net._lr_scale)
    it = device_iteration(net)
    new_state, score = step(step_leaves(net), net.state, net.opt_state, it,
                            *batch,
                            net._gen)
    commit_state(net.state, new_state)
    if advance:
        it.add_(1)
        net._it_twin.value += 1
    return score


def fit_windows(net, t_total: int, window) -> torch.Tensor:
    """Truncated BPTT's loop over one batch, for either network kind: one
    ``train_step`` a ``tbptt_fwd_length`` window, each at the batch's
    iteration, on ``window(sl)`` (the step batch of time slice ``sl``);
    the recurrent layers stream their carry from window to window through
    the layer state (the caller drops the carries after the batch).
    Returns the windows' scores averaged by window length."""
    from deeplearning4j_tpu_torch.nn.layers.recurrent import set_streaming
    L = net.conf.tbptt_fwd_length
    set_streaming(net.layers, True)
    try:
        score_sum, weight = 0.0, 0
        for start in range(0, t_total, L):
            sl = slice(start, min(start + L, t_total))
            w = sl.stop - sl.start
            score_sum = score_sum + train_step(net, window(sl),
                                               advance=False) * w
            weight += w
    finally:
        set_streaming(net.layers, False)
    return score_sum / max(weight, 1)


# ---------------------------------------------------------- the graph
def _flatten(obj, out):
    """The tensors of a nested batch (tuples, lists, dicts by sorted key,
    None), in order; returns the structure to rebuild it."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        out.append(obj)
        return ("t", tuple(obj.shape), obj.dtype)
    if isinstance(obj, dict):
        return ("d", tuple((k, _flatten(obj[k], out)) for k in sorted(obj)))
    return ("l", type(obj), tuple(_flatten(x, out) for x in obj))


def _rebuild(spec, it):
    if spec is None:
        return None
    if spec[0] == "t":
        return next(it)
    if spec[0] == "d":
        return {k: _rebuild(s, it) for k, s in spec[1]}
    return spec[1](_rebuild(s, it) for s in spec[2])


def _tree_paths(net):
    """[(tree, path, tensor)] over params, state and opt_state."""
    out = []

    def walk(tree_name, node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(tree_name, node[k], path + (k,))
        elif isinstance(node, torch.Tensor):
            out.append((tree_name, path, node))

    for name in ("params", "state", "opt_state"):
        walk(name, getattr(net, name), ())
    return out


@contextlib.contextmanager
def refusing_host_reads():
    """While open, a read of a CUDA tensor's value on the host
    (``item``, ``tolist``, ``bool``, ``float``, ``int``, ``index``)
    raises ``CaptureError`` naming the method: under capture it would
    only invalidate the capture with an error that names nothing."""
    base = torch._C.TensorBase
    names = ("item", "tolist", "__bool__", "__float__", "__int__",
             "__index__")

    def guard(name, orig):
        def read(self, *args, **kwargs):
            if self.is_cuda:
                raise CaptureError(
                    f"Tensor.{name} reads a device value on the host, "
                    f"which a CUDA graph cannot capture")
            return orig(self, *args, **kwargs)
        return read

    for name in names:
        setattr(torch.Tensor, name, guard(name, getattr(base, name)))
    try:
        yield
    finally:
        for name in names:
            delattr(torch.Tensor, name)


class StepGraph:
    """One net's train step for one batch signature: captured as a CUDA
    graph on the card after ``WARMUP_STEPS`` eager steps, run eagerly on
    the CPU. ``load`` copies a batch into the static inputs, ``step``
    runs one step on them and returns its score."""

    def __init__(self, net, batch):
        self.net = net
        flat = []
        self.spec = _flatten(batch, flat)
        self.static = [torch.empty_like(t) for t in flat]
        self.capture = net.device.type == "cuda"
        self.warmups_left = WARMUP_STEPS if self.capture else 0
        self.graph = None
        self.launches: dict[str, int] = {}  # recorded at capture
        self.capture_ms = None
        self.captures = 0
        self.replays = 0
        self._score = None
        self._bound = None
        self._stream = torch.cuda.Stream(net.device) if self.capture else None

    def load(self, batch):
        flat = []
        if _flatten(batch, flat) != self.spec:
            raise ValueError("batch does not match the graph's signature")
        with torch.no_grad():
            for dst, src in zip(self.static, flat):
                dst.copy_(src)

    def _batch(self):
        return _rebuild(self.spec, iter(self.static))

    def step(self) -> torch.Tensor:
        if not self.capture:
            return train_step(self.net, self._batch())
        device_iteration(self.net)
        if self.graph is not None and not self._rebind():
            self.graph = None
            self.warmups_left = WARMUP_STEPS
        if self.graph is None and self.warmups_left:
            self.warmups_left -= 1
            return self._warmup()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        self.net._it_twin.value += 1
        registry.add_launches(self.launches)
        return self._score.clone()

    def _warmup(self):
        cur = torch.cuda.current_stream(self.net.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            score = train_step(self.net, self._batch())
        cur.wait_stream(self._stream)
        score.record_stream(cur)
        return score

    def _capture(self):
        net = self.net
        g = torch.cuda.CUDAGraph()
        # dropout draws from the net's generator; registered, each replay
        # advances it by what the step draws, as an eager step does
        g.register_generator_state(net._gen)
        self._stream.wait_stream(torch.cuda.current_stream(net.device))
        t0 = time.perf_counter()
        # a dead reference cycle holding another CUDA graph (an earlier
        # net's step) must not be collected during the capture: freeing
        # a graph then invalidates the capture. Collect it now, and let
        # no collection run until the capture ends.
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(g, stream=self._stream):
                with registry.recording() as rec, refusing_host_reads():
                    score = train_step(net, self._batch())
        except Exception as e:  # re-raised by name, never run eagerly
            raise CaptureError(
                f"{type(net).__name__}: the train step cannot be captured "
                f"as a CUDA graph: {type(e).__name__}: {e}") from e
        finally:
            if gc_on:
                gc.enable()
        # the capture ran nothing: the step it recorded is still to run
        net._it_twin.value -= 1
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        _obs_metrics.note_compile(self.capture_ms / 1e3)
        self.captures += 1
        self.graph, self._score, self.launches = g, score, dict(rec)
        self._bound = _tree_paths(net)

    def _rebind(self) -> bool:
        """Points the net's trees back at the tensors the graph was
        captured over, copying in any leaf the net replaced since. False
        when the trees changed shape (the graph must be captured anew)."""
        now = _tree_paths(self.net)
        if len(now) != len(self._bound):
            return False
        moved = []
        for (tn, path, t), (bn, bpath, b) in zip(now, self._bound):
            if t is b:
                continue
            if (tn, path) != (bn, bpath) or not _same_kind(t, b):
                return False
            moved.append((tn, path, t, b))
        with torch.no_grad():
            for tn, path, t, b in moved:
                b.copy_(t)
                node = getattr(self.net, tn)
                for k in path[:-1]:
                    node = node[k]
                node[path[-1]] = b
        return True


def step_graph(net, batch) -> StepGraph:
    """The net's StepGraph for ``batch``'s signature, made at first use."""
    flat = []
    key = _flatten(batch, flat)
    sg = net._multi_steps.get(key)
    if sg is None:
        sg = net._multi_steps[key] = StepGraph(net, batch)
    return sg


# ------------------------------------------------------ fit's runtime
def fit_batch_repeated(net, ds, n_steps: int):
    """``n_steps`` steps on one minibatch: copied in once, then n
    replays (n eager steps on the CPU). No listener is called, as in the
    JAX package; returns the last score."""
    net._require_init()
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    batch = net._step_batch(ds)
    sg = step_graph(net, batch)
    sg.load(batch)
    for _ in range(n_steps):
        score = sg.step()
        net.iteration += 1
    net.score_value = score
    net.last_batch_examples = ds.num_examples
    _goodput.observe_steps(n_steps)
    return score


def resolve_multi_step(net, multi_step) -> int:
    """How many steps one chunk of ``fit`` may cover (the JAX package's
    rules): 1 for tBPTT or when a listener needs per-iteration
    boundaries; "auto" is ``FIT_CHUNK_DEFAULT`` on the card and 1 on the
    CPU; an int is honored."""
    if multi_step in (None, False, 0, 1):
        return 1
    if getattr(net.conf, "backprop_type", "standard") == "tbptt":
        return 1
    for l in net.listeners:
        if getattr(l, "needs_per_iteration", True):
            return 1
    if multi_step == "auto":
        return FIT_CHUNK_DEFAULT if net.device.type == "cuda" else 1
    return max(1, int(multi_step))


def resolve_device_prefetch(net, device_prefetch) -> bool:
    """"auto" is on for the card (the copy of batch N+1 rides under step
    N) and off on the CPU, where there is no copy to hide."""
    if device_prefetch == "auto":
        return net.device.type == "cuda"
    return bool(device_prefetch)


def fit_epoch_chunked(net, source, chunk: int, signature):
    """Groups consecutive batches of one signature into chunks of at most
    ``chunk`` and runs each through ``dispatch_chunk``; each pull from
    ``source`` is a ``data_wait`` span."""
    tracer = get_tracer()
    buf, sig = [], None
    stream = iter(source)
    while True:
        with tracer.span("data_wait"):
            ds = next(stream, None)
        if ds is None:
            break
        s = signature(ds)
        if buf and s != sig:
            dispatch_chunk(net, buf)
            buf = []
        sig = s
        buf.append(ds)
        if len(buf) == chunk:
            dispatch_chunk(net, buf)
            buf = []
    if buf:
        dispatch_chunk(net, buf)


def dispatch_chunk(net, batches):
    """The chunk's steps through the captured step (one ``fit_batch``
    when it holds one batch), then the listeners replayed with each
    step's (iteration, score). Spans as the JAX package's chunk: the
    batches' tensors in ``host_dispatch``, the replays in
    ``device_step``, the listeners in ``score_sync``, each with
    ``steps=len(batches)``."""
    if len(batches) == 1:
        net.fit_batch(batches[0])
        return
    tracer = get_tracer()
    k = len(batches)
    with tracer.span("host_dispatch", steps=k):
        tensors = [net._step_batch(ds) for ds in batches]
        sg = step_graph(net, tensors[0])
    start = net.iteration
    scores = []
    with tracer.span("device_step", steps=k):
        for batch in tensors:
            sg.load(batch)
            scores.append(sg.step())
            net.iteration += 1
    net.score_value = scores[-1]
    net.last_batch_examples = batches[-1].num_examples
    _goodput.observe_steps(k)  # one chunk, k real steps
    maybe_derive_flops(net, batches[0])
    with tracer.span("score_sync", steps=k):
        replay_listeners(net, start, scores,
                         [b.num_examples for b in batches])


def maybe_derive_flops(net, ds):
    """Sets ``net.flops_per_step`` from ``step_cost_analysis`` (a
    ``flops_derive`` span) once per batch signature while a goodput
    ledger is open (``DL4J_TPU_AUTO_FLOPS=0`` turns that off), or when a
    listener reports MFU without a count of its own; the JAX package
    derives it from XLA's cost model at every new batch shape. The
    ledgers get the count (``goodput.observe_flops``)."""
    wanted = (_goodput.auto_flops_enabled()
              and _goodput.current_ledger() is not None)
    if not wanted and not any(getattr(l, "report_mfu", False)
                              and not getattr(l, "flops_per_step", None)
                              for l in net.listeners):
        return
    key = net._signature(ds)
    if key != net._flops_key:
        net._flops_key = key
        with get_tracer().span("flops_derive"):
            net.flops_per_step = net.step_cost_analysis(ds)["flops"] or None
        _goodput.observe_flops(net.flops_per_step)


def replay_listeners(net, start: int, scores, examples):
    """``iteration_done`` for each step of a chunk, after it: every
    listener here declared ``needs_per_iteration = False``, so it sees the
    (iteration, score) stream the per-batch loop gives it."""
    if not net.listeners:
        return
    for j in range(len(examples)):
        net.score_value = scores[j]
        net.last_batch_examples = examples[j]
        for l in net.listeners:
            l.iteration_done(net, start + j + 1, net.epoch)
    net.score_value = scores[-1]
    net.last_batch_examples = examples[-1]
