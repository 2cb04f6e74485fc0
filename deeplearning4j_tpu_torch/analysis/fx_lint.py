"""fx hazard lint: record the production train steps and forwards as aten
graphs and walk them (counterpart of deeplearning4j_tpu/analysis/
jaxpr_lint.py, with its target names and finding codes).

The callables are the ones a user's ``fit_batch`` and ``output`` run:
``nn/multistep.py``'s ``train_step`` (followed by the iteration's
advance) and ``net.output``, on the shipped models at tiny sizes. Two
recorders give the same node list:

- **On the CPU**, ``make_fx`` traces the call on the plain versions into
  an aten-level ``torch.fx`` graph (real tensors: the step runs).
- **On the card**, a ``TorchDispatchMode`` records the same call. The
  hand-written kernels are ``ctypes`` launches that neither recorder
  sees, so each kernel wrapper reports its call (``registry.note_kernel``)
  and the record holds it as a node of its own, with its counters and
  output dtypes, where the launch happened.

The checks:

- **DL4J-J001**: an ``mm``/``addmm``/``bmm``/``convolution`` (or a
  ``matmul`` recorded whole) producing
  float32 from f32 master weights (a parameter, or an f32 value computed
  from one) under a bf16/f16 compute policy: a product the policy was
  to halve, upcast. The attention's score and value products are f32 by
  contract (the JAX package's ``preferred_element_type=f32``, K3's
  accumulator) over operands cast from the compute dtype; they read no
  master weight and are not findings.
- **DL4J-J002**: any float64 output.
- **DL4J-J003**: two records of one callable with value-varied,
  shape-identical arguments give different graph code (a value was read
  to the host and baked in); on the card, a ``StepGraph`` that captures
  again for such a batch.
- **DL4J-J004**: a fit step that re-allocates parameters or optimizer
  state: a leaf of ``net.params`` / ``net.opt_state`` whose storage is
  not the one it had before the step (the step updates in place, which
  is what lets a captured graph replay over the same tensors).
- **DL4J-J005**: an aten op or kernel outside
  :data:`DETERMINISM_ALLOWLIST`.

Findings carry ``path="<fx>"`` and ``symbol=<target name>``; a target
that fails to build or record is **DL4J-J000**, never a skip.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.analysis import Finding

__all__ = ["list_targets", "lint_target", "lint_all", "lint_run",
           "lint_on_device", "record_dispatch", "record_fx",
           "DETERMINISM_ALLOWLIST", "TARGETS", "IrNode", "Target"]

#: ops and kernels the bit-identity contract trusts, each with the reason.
#: Written from what the six shipped targets record on the CPU and what
#: gpt_mini's step records on the card; grow it in the change that brings
#: a new op, with its reason.
DETERMINISM_ALLOWLIST: Dict[str, str] = {
    # structure and data movement: no arithmetic
    "arange": "writes an index sequence",
    "clone": "a copy",
    "copy_": "a copy (a step's new layer state into the net's tensors)",
    "detach": "a view without autograd",
    "empty_like": "an allocation (a kernel's output)",
    "expand": "a view",
    "fill_": "writes one value (the device iteration, set from outside)",
    "full": "writes one value",
    "index": "a gather: each output read from one place",
    "new_zeros": "writes zeros",
    "ones_like": "writes ones",
    "permute": "a view",
    "reshape": "a view or a copy",
    "scalar_tensor": "a 0-d tensor of one value",
    "t": "a view",
    "to": "a dtype or device cast, rounded one way",
    "_to_copy": "a dtype or device cast, rounded one way",
    "transpose": "a view",
    "unsqueeze": "a view",
    "view": "a view",
    "_unsafe_view": "a view",
    "where": "a select",
    "zeros": "writes zeros",
    # elementwise arithmetic: one rounding per element, in any order
    "add": "elementwise", "add_": "elementwise", "clamp": "elementwise",
    "div": "elementwise", "eq": "elementwise", "exp": "elementwise",
    "ge": "elementwise", "gelu": "elementwise",
    "gelu_backward": "elementwise", "mul": "elementwise",
    "neg": "elementwise", "pow": "elementwise", "relu": "elementwise",
    "rsqrt": "elementwise", "rsub": "elementwise", "sqrt": "elementwise",
    "sub": "elementwise", "tanh": "elementwise",
    "tanh_backward": "elementwise", "threshold_backward": "elementwise",
    # the updater's multi-tensor steps: elementwise over a list
    "_foreach_add_": "elementwise over a list",
    "_foreach_copy_": "a copy over a list",
    "_foreach_div_": "elementwise over a list",
    "_foreach_mul": "elementwise over a list",
    "_foreach_mul_": "elementwise over a list",
    "_foreach_sqrt": "elementwise over a list",
    "_foreach_sub": "elementwise over a list",
    "_foreach_sub_": "elementwise over a list",
    # products, reductions, windows: one order for one shape on one
    # device (the CPU's kernels and cuBLAS's GEMMs use no atomics)
    "matmul": "mm or bmm (recorded whole under no_grad)",
    "mm": "a GEMM, one order for one shape",
    "bmm": "a batched GEMM, one order for one shape",
    "convolution": "a convolution, one algorithm for one shape",
    "convolution_backward": "a convolution's gradients, one algorithm",
    "sum": "a reduction in one order for one shape",
    "mean": "a reduction in one order for one shape",
    "amax": "a max: exact in any order",
    "argmax": "exact in any order (first index of the max)",
    "softmax": "row reductions in one order (recorded whole under no_grad)",
    "_softmax": "row reductions in one order",
    "_log_softmax": "row reductions in one order",
    "_log_softmax_backward_data": "row reductions in one order",
    "max_pool2d_with_indices": "a window max: exact in any order",
    "max_pool2d_with_indices_backward":
        "each window's gradient written to the one max it came from",
    "index_put": "the position table's gradient: with accumulate, a "
                 "scatter-add PyTorch runs over sorted indices",
    # the hand-written kernel on the shipped targets' path (ops/csrc)
    "kernel:flash_attn_fwd": "K3: one tile order per (row, head), no "
                             "atomics",
}

_HALF = (torch.bfloat16, torch.float16)
_MATMUL_OPS = ("mm", "addmm", "bmm", "matmul", "convolution")


@dataclasses.dataclass(frozen=True)
class IrNode:
    """One node of a recorded graph: an aten op (``op`` its overload
    packet's name, "mm") or a kernel (``op`` "kernel:<counter>", all its
    counters in ``kernels``)."""

    op: str
    out_dtypes: Tuple[torch.dtype, ...]
    master: bool = False   #: reads f32 master weights (or a value of them)
    kernels: Tuple[str, ...] = ()


def histogram(nodes: List[IrNode]) -> Dict[str, int]:
    """{aten op: count}, the kernels left out."""
    return dict(Counter(n.op for n in nodes if not n.kernels))


def kernel_counts(nodes: List[IrNode]) -> Dict[str, int]:
    """{kernel counter: calls}: each kernel node under each counter it
    adds to (K3 under bf16: flash_attn_fwd and flash_attn_fwd_sm90)."""
    out: Counter = Counter()
    for n in nodes:
        out.update(n.kernels)
    return dict(out)


# --------------------------------------------------------------- recorders
def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _skey(t: torch.Tensor):
    return (t.device, t.untyped_storage().data_ptr())


class _Masters:
    """The storages that hold f32 master weights or f32 values computed
    from them, each kept only while a tensor over it lives (so a freed
    storage that the allocator hands out again is not taken for one)."""

    def __init__(self, params):
        self._refs: Dict = {}
        for t in _leaves(params):
            if t.dtype == torch.float32:
                self.add(t)

    def add(self, t):
        self._refs[_skey(t)] = weakref.ref(t)

    def has(self, t) -> bool:
        ref = self._refs.get(_skey(t))
        if ref is None:
            return False
        if ref() is None:
            del self._refs[_skey(t)]
            return False
        return True


def _tensors(obj):
    return [t for t in torch.utils._pytree.tree_leaves(obj)
            if isinstance(t, torch.Tensor)]


class _DispatchRecorder(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self, params):
        super().__init__()
        self.nodes: List[IrNode] = []
        self._masters = _Masters(params)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in _tensors((args, kwargs)) if t.is_floating_point()]
        outs = _tensors(out)
        if not outs and not _tensors((args, kwargs)):
            return out        # promote_types and such: no tensor at all
        master = any(self._masters.has(t) for t in ins)
        dtypes = tuple(t.dtype for t in outs)
        if master:
            for t in outs:
                if t.dtype == torch.float32:
                    self._masters.add(t)
        self.nodes.append(IrNode(func.overloadpacket.__name__, dtypes,
                                 master))
        return out

    def kernel(self, names, dtypes):
        self.nodes.append(IrNode("kernel:" + names[0], tuple(dtypes),
                                 False, tuple(names)))


def record_dispatch(fn: Callable, args, params) -> List[IrNode]:
    """Runs ``fn(*args)`` under a dispatch-mode recorder; the nodes, the
    kernel wrappers' calls among them. ``params`` seeds the master
    weights (J001)."""
    from deeplearning4j_tpu_torch.ops import registry

    rec = _DispatchRecorder(params)
    with registry.recording_kernels(rec.kernel), rec:
        fn(*args)
    return rec.nodes


def record_fx(fn: Callable, args, params):
    """Traces ``fn(*args)`` with ``make_fx`` (real tensors: the call runs).
    -> (GraphModule, nodes)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(fn)(*args)
    masters = _Masters(params)
    derived = set()
    nodes: List[IrNode] = []
    for n in gm.graph.nodes:
        if n.op == "get_attr":
            val = getattr(gm, n.target, None)
            if isinstance(val, torch.Tensor) and masters.has(val):
                derived.add(n)
            continue
        if n.op != "call_function" or not isinstance(
                n.target, torch._ops.OpOverload):
            if n.op == "call_function" and any(
                    a in derived for a in n.all_input_nodes):
                derived.add(n)   # getitem of a derived tuple
            continue
        val = n.meta.get("val")
        dtypes = tuple(t.dtype for t in _tensors(val))
        master = any(a in derived for a in n.all_input_nodes
                     if _is_float(a))
        if master and torch.float32 in dtypes:
            derived.add(n)
        nodes.append(IrNode(n.target.overloadpacket.__name__, dtypes,
                            master))
    return gm, nodes


def _is_float(node) -> bool:
    vals = _tensors(node.meta.get("val"))
    return not vals or any(t.is_floating_point() for t in vals)


# ------------------------------------------------------------------ checks
def check_ir(nodes: List[IrNode], target: str,
             compute_dtype) -> List[Finding]:
    """J001 + J002 + J005 over one recorded graph (deduped messages)."""
    compute = _dtype(compute_dtype)
    findings: Dict[str, Finding] = {}

    def emit(code, message):
        f = Finding(code=code, path="<fx>", line=0, symbol=target,
                    message=message)
        findings.setdefault(f.fingerprint(), f)

    for n in nodes:
        if (compute in _HALF and n.op in _MATMUL_OPS and n.master
                and torch.float32 in n.out_dtypes):
            emit("DL4J-J001",
                 f"{n.op} produces float32 from f32 master weights under "
                 f"a {_name(compute)} compute policy")
        if torch.float64 in n.out_dtypes:
            emit("DL4J-J002", f"{n.op} produces float64")
        if n.op not in DETERMINISM_ALLOWLIST:
            what = "kernel" if n.kernels else "aten op"
            emit("DL4J-J005",
                 f"{what} '{n.op}' outside the determinism allowlist")
    return list(findings.values())


def check_retrace(code_a: str, code_b: str, target: str) -> List[Finding]:
    """J003: two records with value-varied, shape-identical arguments
    must give the same graph code."""
    if code_a != code_b:
        return [Finding(
            code="DL4J-J003", path="<fx>", line=0, symbol=target,
            message="graph differs between value-varied calls of the same "
                    "shape (a value is read to the host and baked into the "
                    "graph; every new value records anew)")]
    return []


def check_captures(captures: int, target: str) -> List[Finding]:
    """J003 on the card: one StepGraph, one capture, whatever the
    batches' values."""
    if captures != 1:
        return [Finding(
            code="DL4J-J003", path="<fx>", line=0, symbol=target,
            message=f"StepGraph captured {captures} times for value-varied "
                    "batches of one signature")]
    return []


def storages(net) -> Dict[str, tuple]:
    """{tree/path: storage key} of every params and opt_state leaf."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
        elif isinstance(node, torch.Tensor):
            out[prefix] = _skey(node)

    walk("params", net.params)
    walk("opt_state", net.opt_state)
    return out


def check_realloc(before: Dict[str, tuple], after: Dict[str, tuple],
                  target: str) -> List[Finding]:
    """J004: every params/opt_state leaf keeps its storage over a step."""
    moved = sorted(k for k in before if after.get(k) != before[k])
    if moved:
        return [Finding(
            code="DL4J-J004", path="<fx>", line=0, symbol=target,
            message=f"fit step re-allocates {len(moved)} params/opt_state "
                    f"leaves (first: {moved[0]}); a captured step cannot "
                    "replay over them")]
    return []


def _dtype(d) -> torch.dtype:
    return getattr(torch, d) if isinstance(d, str) else d


def _name(d: torch.dtype) -> str:
    return str(d).replace("torch.", "")


# ----------------------------------------------------------------- targets
@dataclasses.dataclass
class Target:
    """A production callable on value-varied, shape-identical arguments.
    ``fit``: ``fn`` is one fit step (checked for J004)."""

    net: object
    fn: Callable
    args_a: tuple
    args_b: tuple
    compute_dtype: str
    fit: bool


def _fill(shape, variant, device):
    return torch.full(shape, float(variant) * 0.25, dtype=torch.float32,
                      device=device)


def _output_widths(net) -> List[int]:
    conf = net.conf
    if hasattr(conf, "network_outputs"):
        return [conf.vertices[o].n_out for o in conf.network_outputs]
    return [conf.layers[-1].n_out]


def _row_shapes(net):
    from deeplearning4j_tpu_torch.compilecache.precompile import \
        _infer_row_shapes
    shapes = _infer_row_shapes(net)
    if shapes is None:
        raise ValueError(f"cannot infer input shapes for {type(net)}")
    return shapes


def fit_step(net) -> Callable:
    """What ``fit_batch`` runs for a step batch: ``train_step`` and the
    iteration's advance."""
    from deeplearning4j_tpu_torch.nn import multistep

    def step(batch):
        score = multistep.train_step(net, batch)
        net.iteration += 1
        return score

    return step


def _fit_args(net, variant: int, row=None, label_row=None, batch: int = 2):
    """The step batch ``fit_batch`` builds, every value varied by
    ``variant`` and every shape fixed."""
    dev = net.device
    if hasattr(net.conf, "network_inputs"):          # ComputationGraph
        rows = [row] if row is not None else _row_shapes(net)
        inputs = {n: _fill((batch,) + tuple(s), variant, dev)
                  for n, s in zip(net.conf.network_inputs, rows)}
        labels = [_fill((batch, n), variant, dev)
                  for n in _output_widths(net)]
        return (inputs, labels, {}, None)
    row = row if row is not None else _row_shapes(net)[0]
    label_row = label_row if label_row is not None \
        else (_output_widths(net)[0],)
    return (_fill((batch,) + tuple(row), variant, dev),
            _fill((batch,) + tuple(label_row), variant, dev), None, None)


def _target(make_net: Callable, kind: str, row=None, label_row=None,
            device="cpu") -> Target:
    net = make_net(device)
    compute = net.conf.global_conf.dtype.compute_dtype
    if kind == "fit":
        return Target(net, fit_step(net),
                      (_fit_args(net, 0, row, label_row),),
                      (_fit_args(net, 1, row, label_row),), compute, True)
    row = row if row is not None else _row_shapes(net)[0]
    return Target(net, lambda x: net.output(x),
                  (_fill((2,) + tuple(row), 0, net.device),),
                  (_fill((2,) + tuple(row), 1, net.device),), compute, False)


def _tiny_mlp(device):
    from deeplearning4j_tpu_torch import zoo
    return zoo.mnist_mlp(device=device)


def _tiny_lenet(device):
    from deeplearning4j_tpu_torch import zoo
    return zoo.lenet(device=device)


def _tiny_gpt(device):
    from deeplearning4j_tpu_torch import zoo
    return zoo.gpt_mini(vocab_size=11, width=16, n_layers=2, n_heads=2,
                        max_len=8, device=device)


def _tiny_graph(device):
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.updater import Adam

    conf = (NeuralNetConfiguration.builder()
            .seed(7).updater(Adam(1e-3)).graph_builder()
            .add_inputs("in")
            .add_layer("d1", Dense(n_out=6, activation="tanh"), "in")
            .add_layer("out", Output(n_out=3, activation="softmax",
                                     loss="mcxent"), "d1")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(5))
            .build())
    return ComputationGraph(conf, device=device).init()


#: target name -> builder(device) (kept lazy: building makes a model)
TARGETS: Dict[str, Callable] = {
    "mnist_mlp.fit_step": lambda device="cpu": _target(
        _tiny_mlp, "fit", device=device),
    "mnist_mlp.forward": lambda device="cpu": _target(
        _tiny_mlp, "forward", device=device),
    "lenet.fit_step": lambda device="cpu": _target(
        _tiny_lenet, "fit", device=device),
    # one-hot token rows (T=8, V=11): the sequence length is a serving
    # choice, not inferable from the conf
    "gpt_mini.fit_step": lambda device="cpu": _target(
        _tiny_gpt, "fit", row=(8, 11), label_row=(8, 11), device=device),
    "gpt_mini.forward": lambda device="cpu": _target(
        _tiny_gpt, "forward", row=(8, 11), device=device),
    "graph.fit_step": lambda device="cpu": _target(
        _tiny_graph, "fit", device=device),
}


def list_targets() -> List[str]:
    return sorted(TARGETS)


def lint_run(t: Target, name: str) -> List[Finding]:
    """The CPU checks of one target: an eager step or call first (what is
    made at first use is made there), then two ``make_fx`` records on
    value-varied arguments, the storages held over the first."""
    params = t.net.params
    t.fn(*t.args_a)
    before = storages(t.net)
    gm_a, nodes = record_fx(t.fn, t.args_a, params)
    after = storages(t.net)
    gm_b, _ = record_fx(t.fn, t.args_b, params)
    findings = check_ir(nodes, name, t.compute_dtype)
    findings.extend(check_retrace(gm_a.code, gm_b.code, name))
    if t.fit:
        findings.extend(check_realloc(before, after, name))
    return findings


def lint_target(name: str) -> List[Finding]:
    """All CPU checks of one named target. A target that fails to build
    or record is itself a finding (J000), never a skip."""
    try:
        return lint_run(TARGETS[name](), name)
    except Exception as e:  # noqa: BLE001 — any failure is a finding
        return [Finding(
            code="DL4J-J000", path="<fx>", line=0, symbol=name,
            message=f"target failed to trace: {type(e).__name__}: {e}")]


def lint_all(names: Optional[List[str]] = None) -> List[Finding]:
    out: List[Finding] = []
    for name in (names or list_targets()):
        out.extend(lint_target(name))
    return out


def lint_on_device(net, batch_a, batch_b, name: str,
                   steps: int = 4) -> Tuple[List[Finding], dict]:
    """The checks of a fit step where it runs (the card): one eager step
    recorded under the dispatch mode (J001, J002, J005, and J004 over
    it), then ``StepGraph`` steps on batches alternating between the two
    value variants (J003: one capture; J004 over a replay). Returns the
    findings and {"ops": histogram, "kernels": kernel counts, "nodes":
    node count, "kernel_nodes": kernel node count, "captures": n}. Leaves the net ``steps`` + the warm-up
    steps further on."""
    from deeplearning4j_tpu_torch.nn import multistep

    fn = fit_step(net)
    compute = net.conf.global_conf.dtype.compute_dtype
    fn(batch_a)                                    # builds, warms
    before = storages(net)
    nodes = record_dispatch(fn, (batch_a,), net.params)
    findings = check_ir(nodes, name, compute)
    findings.extend(check_realloc(before, storages(net), name))
    sg = multistep.step_graph(net, batch_a)
    for i in range(multistep.WARMUP_STEPS + steps):
        sg.load(batch_a if i % 2 == 0 else batch_b)
        if sg.graph is not None:
            before = storages(net)
        sg.step()
        net.iteration += 1
    findings.extend(check_realloc(before, storages(net), name))
    findings.extend(check_captures(sg.captures if sg.capture else 1, name))
    return findings, {"ops": histogram(nodes),
                      "kernels": kernel_counts(nodes),
                      "nodes": len(nodes),
                      "kernel_nodes": sum(1 for n in nodes if n.kernels),
                      "captures": sg.captures}
