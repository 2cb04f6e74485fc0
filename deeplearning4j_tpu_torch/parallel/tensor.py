"""Tensor (model) parallelism over a mesh's model axis, for either network
kind (counterpart of deeplearning4j_tpu/parallel/tensor.py).

The JAX package places each parameter with a ``NamedSharding`` and lets
XLA's SPMD partitioner split every product and insert the collectives.
Nothing in PyTorch partitions a step that runs hand-written ``ctypes``
kernels, so the port renders the layers explicitly, Megatron style: one
process a rank, each holding its SHARD of every sharded leaf, the layers
computing on their shards, and the collectives written as autograd
Functions over the model axis's process group.

**Placement** is the JAX package's, so the same rules place the same
leaves in both packages. ``default_rule``: a float leaf with ndim >= 2
whose LAST axis divides the model-axis size is sharded on that axis
(column-parallel); biases, norms, scalars and indivisible leaves
replicate. ``rules`` override it: a dict of EXACT keystr paths
(``"['layer_0']['W']"``) or ``(regex, spec)`` pairs searched against the
keystr path, first match wins. Optimizer slots take their parameter's
spec (``opt_state_specs``). ``P`` is the port's own partition spec: a
tuple of axis names or ``None``, one per dimension.

**The collectives** (identity on a model group of one, with no
collective, as ``GradAllReduce`` keeps a group of one to the unmeshed
arithmetic):

- ``copy_to_model`` (Megatron's *f*): identity forward, all-reduce of the
  gradient backward. Before a column-parallel product, whose gradient
  into a replicated input is a partial sum on each rank.
- ``reduce_from_model`` (*g*): all-reduce forward, identity backward.
  After a row-parallel product, whose output is a partial sum.
- ``gather_from_model``: all-gather on a dimension forward, this rank's
  slice of the gradient backward. Before anything that mixes features
  (LayerNorm, softmax, the loss), and for a leaf a layer computes with
  whole. The computation after a gather is replicated, so every rank
  holds the same gradient of the gathered tensor and its slice is the
  exact gradient of its shard (a reduce-scatter would add m equal
  copies).
- ``scatter_to_model``: this rank's slice forward, all-gather of the
  slices' gradients backward. For a replicated input of a row-parallel
  product, and for a replicated bias beside a column-parallel weight:
  each rank's gradient covers only its slice, and the gather gives every
  rank the same whole gradient, so its replica stays bit-equal.

Every all-reduce and all-gather hands every rank the same bits, so a
replicated leaf's gradient, and with it the leaf, stays bit-equal across
the model group. The all-gather is ``all_gather_into_tensor`` on either
backend: gloo takes it on CUDA tensors too (checked on an H100 under
torch 2.11 by ``chip_smoke.py --tensor-parallel``, its
``gloo_all_gather_into_tensor_cuda`` field), and on the CPU.

**The layers** (nn/layers/{feedforward,attention}.py). A layer whose
leaves these renderings cover computes on its shards (``LayerTP.linear``):
column-parallel Wq/Wk/Wv give this rank's n_heads / m heads (head-major
columns), and K3 runs on them; row-parallel Wo and W2 are followed by
*g*; W1 column-parallel with the activation applied locally; a
column-sharded Dense, output head or embedding table is followed by the
gather. A convolution (nn/layers/convolution.py) whose HWIO W is sharded
on its output channels takes the whole input through *f*, computes this
rank's channels, adds its bias's slice, applies the activation and
gathers the channel axis. Every other layer kind (LSTM, batch norm's
sharded leaves, LRN, the pretrain layers), an attention layer whose
heads do not divide m, and any layer in streaming inference
(``rnn_time_step``, ``gather_route``) takes the gather route: its
sharded leaves are gathered whole, it computes as unmeshed, and each
call is counted under ``tensor_parallel:composed[gather:<layer type>]``
(ops/registry.py). A GravesLSTM there runs K1/K2 on the whole Wh, as the
JAX package does: its Pallas kernel does not partition under GSPMD
either.

**A graph** (nn/graph.py) takes the same renderings vertex by vertex.
Batch norm after a sharded convolution runs on the gathered, whole
activation: its gamma and beta replicate under the default rule, so
every rank computes the same statistics and the same state with no
collective of its own (over a data axis, its one all-reduce a site runs
on the data group, ops/normalization.py). A fused bottleneck tail
(nn/fusion.py) runs K4-K7 on this rank's N/m columns of its 1x1 conv,
with gamma, beta, the shift and the shortcut cut to them: K4's and K6's
column sums are then exact on the rank's own channels, K5's output and
the batch statistics are gathered, and K7's partial dx all-reduced. The
pooling, padding, element-wise and merge vertices hold no params and
see whole activations. Remat spans recompute the same renderings, and
their collectives, in the backward (every rank runs the same backward in
the same order).

**What sums over the model axis**: a sharded leaf's share of a norm
(``nn/updater.py::normalize_gradients``) and of the regularization term
(``nn/layers/base.py``) are partial sums, all-reduced (``LayerTP``'s
``sum_sharded``). A rank's batch rows must be its model group's: checked
once, by hash (``TensorParallel.check_rows``). The gradient all-reduce of
the step runs over the data axis only (parallel/data_parallel.py).
"""

from __future__ import annotations

import contextlib
import hashlib
import re
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

__all__ = ["P", "default_rule", "match_partition_rules", "unmatched_rules",
           "param_specs", "opt_state_specs", "apply_tensor_parallel",
           "copy_to_model", "reduce_from_model", "gather_from_model",
           "scatter_to_model", "gather_route", "ModelGroup", "LayerTP",
           "TensorParallel"]

#: the launch-counter op the gather route counts under
GATHER_OP = "tensor_parallel"


class P(tuple):
    """A partition spec: one entry a dimension, an axis name or None
    (``P()`` replicates). Equal to the tuple of its entries, so it
    compares with the JAX package's ``PartitionSpec`` as a tuple."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P({', '.join(repr(a) for a in self)})"


# ------------------------------------------------------------ placement
def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _with_paths(tree, path=()):
    """(keystr path, leaf) of a nested dict, keys in the JAX package's
    sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _with_paths(tree[k], path + (k,))
    else:
        yield _keystr(path), tree


def _map_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(_keystr(path), tree)


def _axis_size(mesh, axis: str) -> int:
    """The size of ``mesh``'s ``axis``: a ``{axis: size}`` dict or a
    DeviceMesh (parallel/mesh.py)."""
    if isinstance(mesh, dict):
        return int(mesh[axis])
    names = tuple(mesh.mesh_dim_names or ())
    return int(mesh.mesh.shape[names.index(axis)])


def default_rule(path: str, leaf, model_axis: str, axis_size: int):
    """PartitionSpec for one parameter leaf (see module docstring)."""
    shape = tuple(getattr(leaf, "shape", ()))
    if (len(shape) >= 2 and shape[-1] % axis_size == 0
            and shape[-1] >= axis_size):
        return P(*([None] * (len(shape) - 1) + [model_axis]))
    return P()


def _split_rules(rules):
    """The two rule forms as (exact dict, [(compiled regex, spec)]): a
    dict maps EXACT keystr paths to specs, a sequence holds (pattern,
    spec) pairs searched against the path, first match wins."""
    if not rules:
        return {}, []
    if hasattr(rules, "items"):
        return dict(rules), []
    return {}, [(re.compile(pat), spec) for pat, spec in rules]


def match_partition_rules(rules, params, *, on_unmatched: str = "error"):
    """Regex rules -> spec tree: ``(regex, spec)`` pairs searched against
    each leaf's keystr path, first match wins; scalar and size-1 leaves
    never partition. ``on_unmatched``: "error" raises naming the path,
    "replicate" gives ``P()``."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_of(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or torch.Size(shape).numel() == 1:
            return P()
        for pat, spec in compiled:
            if pat.search(path):
                return spec
        if on_unmatched == "replicate":
            return P()
        raise ValueError(f"partition rule not found for param: {path}")

    return _map_paths(spec_of, params)


def unmatched_rules(rules, params) -> list:
    """Rule entries that match no param path (exact keys by equality,
    regex pairs by ``re.search``), in rule order: a rule that silently
    places nothing is usually a misspelt layer name."""
    exact, regex = _split_rules(rules)
    paths = [p for p, _ in _with_paths(params)]
    missing = [key for key in exact if key not in paths]
    missing.extend(pat.pattern for pat, _ in regex
                   if not any(pat.search(p) for p in paths))
    return missing


def param_specs(params, mesh, model_axis: str = "model",
                rules=None, rule: Optional[Callable] = None):
    """The spec tree of a param tree: ``rules`` (exact keystr paths, or
    ``(regex, spec)`` pairs, first match wins) over ``rule`` (default:
    ``default_rule``, last-axis column sharding). ``mesh`` is a
    DeviceMesh or a ``{axis: size}`` dict."""
    axis_size = _axis_size(mesh, model_axis)
    rule = rule or default_rule
    exact, regex = _split_rules(rules)

    def spec_of(path, leaf):
        if path in exact:
            return exact[path]
        for pat, spec in regex:
            if pat.search(path):
                return spec
        return rule(path, leaf, model_axis, axis_size)

    return _map_paths(spec_of, params)


def _same_structure(a, b) -> bool:
    if isinstance(a, dict) != isinstance(b, dict):
        return False
    if not isinstance(a, dict):
        return True
    return (sorted(a) == sorted(b)
            and all(_same_structure(a[k], b[k]) for k in a))


def opt_state_specs(opt_state, specs):
    """The spec tree of a net's opt_state: each layer's slot whose
    structure is the layer's param tree takes the SAME specs, rules'
    overrides included (a param replicated by a rule keeps replicated
    momentum); scalar slots (step counters) and entries that are not
    layers (the loss-scale state) replicate."""
    def layer_specs(ln, ln_state):
        ln_specs = specs.get(ln) if hasattr(specs, "get") else None
        out = {}
        for slot, sub in ln_state.items():
            if ln_specs is not None and _same_structure(sub, ln_specs):
                out[slot] = ln_specs
            else:
                out[slot] = _map_paths(lambda _p, _l: P(), sub)
        return out

    return {ln: layer_specs(ln, st) for ln, st in opt_state.items()}


def sharded_dim(spec, model_axis: str):
    """The dimension ``spec`` shards on ``model_axis``, or None."""
    for d, a in enumerate(spec or ()):
        if a == model_axis or (isinstance(a, tuple) and model_axis in a):
            return d
    return None


def local_shard(t, spec, model_axis: str, rank: int, size: int):
    """This rank's contiguous shard of the whole tensor ``t``."""
    d = sharded_dim(spec, model_axis)
    if d is None or size == 1:
        return t
    if t.shape[d] % size:
        raise ValueError(f"dimension {d} of {tuple(t.shape)} does not "
                         f"divide the model axis ({size})")
    part = t.shape[d] // size
    return t.narrow(d, rank * part, part).contiguous()


# ----------------------------------------------------------- collectives
class ModelGroup:
    """A model axis's process group: its size, this rank's index in it,
    and the collectives it ran (``calls``, ``bytes``: what each rank sent
    in; ``seconds``: the host's time inside the calls, which is the
    collectives' time where they block the host, as gloo's do; plain
    counters)."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def _run(self, collective, x, *args):
        self.calls += 1
        self.bytes += x.numel() * x.element_size()
        t0 = time.perf_counter()
        collective(*args, group=self.group)
        self.seconds += time.perf_counter() - t0

    def all_reduce(self, x):
        x = x.contiguous()
        self._run(dist.all_reduce, x, x)
        return x

    def all_gather(self, x, dim: int):
        """The ranks' ``x`` concatenated on ``dim`` in rank order."""
        x = x.contiguous()
        flat = x.new_empty(self.size * x.numel())
        self._run(dist.all_gather_into_tensor, x, flat, x.reshape(-1))
        return torch.cat(flat.view(self.size, *x.shape).unbind(0), dim=dim)

    def slice(self, x, dim: int):
        part = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * part, part).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mg.all_reduce(g.clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return mg.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim = mg, dim
        return mg.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mg.slice(g, ctx.dim), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim = mg, dim
        return mg.slice(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mg.all_gather(g, ctx.dim), None, None


def copy_to_model(x, mg):
    """*f*: identity forward, all-reduce over the model group backward."""
    return x if mg.size == 1 else _CopyToModel.apply(x, mg)


def reduce_from_model(x, mg):
    """*g*: all-reduce over the model group forward, identity backward."""
    return x if mg.size == 1 else _ReduceFromModel.apply(x, mg)


def gather_from_model(x, mg, dim=-1):
    """All-gather on ``dim`` forward, this rank's slice backward."""
    dim = dim % x.dim()
    return x if mg.size == 1 else _GatherFromModel.apply(x, mg, dim)


def scatter_to_model(x, mg, dim=-1):
    """This rank's slice of ``dim`` forward, all-gather backward."""
    dim = dim % x.dim()
    return x if mg.size == 1 else _ScatterToModel.apply(x, mg, dim)


# -------------------------------------------------------------- layers
_COL, _ROW, _REP = "column", "row", "replicated"


def _kind(spec, model_axis):
    """"column" for a weight sharded on its last axis only (a dense W
    [in, out], a conv's HWIO W on its output channels), "row" for a 2-D
    weight sharded on its first, "replicated"; None for another
    placement."""
    d = sharded_dim(spec, model_axis)
    if d is None:
        return _REP if not any(a is not None for a in (spec or ())) \
            else None
    if any(a is not None for i, a in enumerate(spec) if i != d):
        return None
    if len(spec) >= 2 and d == len(spec) - 1:
        return _COL
    return _ROW if len(spec) == 2 and d == 0 else None


class LayerTP:
    """One layer's placement on the model axis: the specs of its leaves
    ({param name: P}, nested as the layer's params), the model group and
    whether a rendering covers the layer (``rendered``; else the gather
    route). The layers call ``linear``, ``bias`` and ``gather``; the
    updater and the regularization term call ``sharded_flags`` and
    ``sum_sharded``."""

    def __init__(self, layer, specs, mg: ModelGroup, model_axis: str):
        self.layer = layer
        self.specs = specs
        self.mg = mg
        self.model_axis = model_axis
        self.reason = None
        self.rendered = self._renders()

    # -- placement
    def spec(self, name):
        return self.specs.get(name, P())

    def kind(self, name):
        return _kind(self.spec(name), self.model_axis)

    def is_sharded(self, name) -> bool:
        return sharded_dim(self.spec(name), self.model_axis) is not None

    def any_sharded(self) -> bool:
        return any(sharded_dim(s, self.model_axis) is not None
                   for _, s in _with_specs(self.specs))

    def sharded_flags(self, tree, sort=True):
        """Whether each leaf of ``tree`` (shaped like the layer's params)
        is sharded, in ``nn/updater.py::_leaves``' sorted order, or in
        the tree's insertion order with ``sort=False``."""
        return [sharded_dim(_spec_at(self.specs, path), self.model_axis)
                is not None for path in _paths(tree, sort)]

    def sum_sharded(self, x):
        """A sharded leaves' partial sum, all-reduced over the model group
        (forward; identity backward)."""
        return reduce_from_model(x, self.mg)

    # -- which layers a rendering covers
    def _bias_ok(self, w_kind, bname):
        if bname not in self.specs:
            return True
        b = self.spec(bname)
        if sharded_dim(b, self.model_axis) is None:
            return True
        return w_kind == _COL and len(b) == 1

    def _dense_ok(self, w="W", b="b"):
        k = self.kind(w)
        return k is not None and self._bias_ok(k, b)

    def _renders(self) -> bool:
        from deeplearning4j_tpu_torch.nn.layers import attention as att_l
        from deeplearning4j_tpu_torch.nn.layers import convolution as conv_l
        from deeplearning4j_tpu_torch.nn.layers import feedforward as ff_l
        from deeplearning4j_tpu_torch.nn.layers.recurrent import (
            RnnOutputLayerImpl)
        layer = self.layer
        if not self.any_sharded():
            return False
        if isinstance(layer, att_l.GptEmbeddingLayer):
            return self.kind("Wtok") == _COL and self.kind("Wpos") == _COL
        if isinstance(layer, att_l._AttentionCore):
            heads_ok = layer.n_heads % self.mg.size == 0
            if not heads_ok:
                self.reason = f"n_heads%{self.mg.size}"
            ok = (heads_ok and all(self.kind(w) == _COL
                                   and self._bias_ok(_COL, "b" + w[1])
                                   for w in ("Wq", "Wk", "Wv"))
                  and self._dense_ok("Wo", "bo"))
            if isinstance(layer, att_l.TransformerBlockLayer):
                ok = ok and self._dense_ok("W1", "b1") and self._dense_ok(
                    "W2", "b2") and not any(
                        self.is_sharded(n) for n in ("ln1_g", "ln1_b",
                                                     "ln2_g", "ln2_b"))
            return ok
        if isinstance(layer, ff_l.EmbeddingLayerImpl):
            return self.kind("W") == _COL and self._bias_ok(_COL, "b")
        if isinstance(layer, (ff_l.DenseLayer, RnnOutputLayerImpl)):
            return self._dense_ok()
        if isinstance(layer, (conv_l.ConvolutionLayer,
                              conv_l.Convolution1DLayerImpl)):
            return self.kind("W") == _COL and self._bias_ok(_COL, "b")
        return False

    # -- the renderings' pieces
    def gather(self, x, dim=-1):
        return gather_from_model(x, self.mg, dim)

    def copy(self, x):
        """*f* on the whole input of a column-parallel product: its
        gradient, a partial sum on each rank, is all-reduced."""
        return copy_to_model(x, self.mg)

    def columns(self, t, name=None, dim=-1):
        """This rank's columns of ``t``, a whole tensor beside a
        column-parallel product (a replicated bias, gamma or beta, or an
        activation such as a shortcut): scattered, so its gradient is
        gathered whole again. A leaf ``name`` this layer shards is its
        shard already and comes back as it is."""
        if name is not None and self.is_sharded(name):
            return t
        return scatter_to_model(t, self.mg, dim)

    def bias(self, b, name):
        """The bias ``name`` as this rank uses it beside a column-parallel
        weight: its slice (scattered, so its gradient is gathered whole
        again) or its own shard."""
        return self.columns(b, name, 0)

    def linear(self, x, x_sharded, W, b, cd, wname="W", bname="b",
               copied=False):
        """x @ W + b in the compute dtype ``cd`` on this rank's shard of W:
        (z, z_sharded). A column-parallel W takes the whole x (gathered
        if sharded, then *f*, unless the caller ``copied`` it through *f*
        already, once for several products) and gives this rank's
        columns; a row-parallel W takes this rank's slice of x and gives
        the whole z after *g*, the bias added after the sum; a replicated
        W takes the whole x."""
        kind = self.kind(wname)
        if kind == _COL:
            if x_sharded:
                x = self.gather(x)
            if not copied:
                x = copy_to_model(x, self.mg)
            z = torch.matmul(x.to(cd), W.to(cd))
            if b is not None:
                z = z + self.bias(b, bname).to(cd)
            return z, True
        if kind == _ROW:
            if not x_sharded:
                x = scatter_to_model(x, self.mg, -1)
            z = reduce_from_model(torch.matmul(x.to(cd), W.to(cd)), self.mg)
            if b is not None:
                z = z + b.to(cd)
            return z, False
        if x_sharded:
            x = self.gather(x)
        z = torch.matmul(x.to(cd), W.to(cd))
        if b is not None:
            z = z + b.to(cd)
        return z, False

    def dense(self, x, W, b, cd):
        """A dense layer's pre-activation, whole: ``linear`` and the
        gather of a column-sharded result."""
        z, sharded = self.linear(x, False, W, b, cd)
        return self.gather(z) if sharded else z

    def whole_params(self, params):
        """The gather route: every sharded leaf gathered whole (its
        gradient sliced back to the shard), the rest as they are."""
        def whole(path, t):
            spec = _spec_at(self.specs, path)
            d = sharded_dim(spec, self.model_axis)
            return t if d is None else gather_from_model(t, self.mg, d)
        return _map_names(whole, params)


def _tensors(obj):
    """The tensors of a batch's features and labels: a MultiLayerNetwork's
    tensors, a graph's dict of inputs and list of labels (dicts by sorted
    key)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _tensors(obj[k])
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


def _paths(tree, sort, path=()):
    """The key paths of a nested dict's leaves."""
    if isinstance(tree, dict):
        for k in (sorted(tree) if sort else tree):
            yield from _paths(tree[k], sort, path + (k,))
    else:
        yield path


def _with_specs(specs, path=()):
    """(path, spec) of a layer's spec tree in ``_leaves`` order."""
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from _with_specs(specs[k], path + (k,))
    else:
        yield path, specs


def _spec_at(specs, path):
    node = specs
    for k in path:
        node = node[k]
    return node


def _map_names(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_names(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


class TensorParallel:
    """A net's tensor-parallel placement: the mesh, its data and model
    axes, the rules, the spec tree and each layer's ``LayerTP``."""

    def __init__(self, net, mesh, data_axis, model_axis, rules):
        from deeplearning4j_tpu_torch.parallel.mesh import axis_group
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.rules = rules
        self.mg = ModelGroup(axis_group(mesh, model_axis))
        self.specs = param_specs(net.params, mesh, model_axis, rules)
        self.rows_checked = False
        self.layers = {}
        for layer in net.layers:
            if layer.name in net.params:
                self.layers[layer.name] = LayerTP(
                    layer, self.specs[layer.name], self.mg, model_axis)

    def place(self, tree, specs):
        """``tree`` (whole leaves) with each leaf replaced by this rank's
        shard under ``specs``."""
        return _map_names(
            lambda path, t: local_shard(t, _spec_at(specs, path),
                                        self.model_axis, self.mg.rank,
                                        self.mg.size), tree)

    def gathered(self, tree, specs):
        """``tree`` of this rank's shards with every sharded leaf gathered
        whole (a collective: every rank of the model group calls it)."""
        def whole(path, t):
            d = sharded_dim(_spec_at(specs, path), self.model_axis)
            if d is None or self.mg.size == 1:
                return t
            with torch.no_grad():
                return self.mg.all_gather(t, d)
        return _map_names(whole, tree)

    def opt_specs(self, opt_state):
        return opt_state_specs(opt_state, self.specs)

    def check_rows(self, batch):
        """Once: every rank of a model group steps on the same batch rows.
        Raises naming each rank's hash of its features and labels
        otherwise."""
        if self.rows_checked or self.mg.size == 1:
            return
        h = hashlib.sha256()
        for t in _tensors(batch[:2]):
            h.update(t.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
        mine = h.hexdigest()
        seen = [None] * self.mg.size
        dist.all_gather_object(seen, mine, group=self.mg.group)
        if len(set(seen)) != 1:
            raise ValueError(
                f"tensor parallelism: the ranks of a model group must "
                f"step on the same batch rows; their features and labels "
                f"hash to {seen} (this rank, {self.mg.rank}: {mine[:16]}). "
                f"Give every rank of a model group its data-axis slice "
                f"(DevicePrefetchIterator(sharding=))")
        self.rows_checked = True

    def detail(self):
        return {"model_axis": self.model_axis, "tp_rules": self.rules}


@contextlib.contextmanager
def gather_route(net):
    """While open, every layer of a tensor-parallel ``net`` takes the
    counted gather route (its sharded leaves gathered whole, the layer
    computed as unmeshed): streaming inference (``rnn_time_step``), whose
    every rank then runs the unmeshed arithmetic. A net off a model axis
    is left as it is."""
    tp = getattr(net, "_tp", None)
    if tp is None:
        yield
        return
    rendered = {name: lt.rendered for name, lt in tp.layers.items()}
    for lt in tp.layers.values():
        lt.rendered = False
    try:
        yield
    finally:
        for name, flag in rendered.items():
            tp.layers[name].rendered = flag


def check_rules(rules, params, where: str = ""):
    """Raise if an entry of ``rules`` matches no param path of
    ``params``; ``where`` is added to the message."""
    missing = unmatched_rules(rules, params) if rules else None
    if missing:
        raise ValueError(
            f"tp_rules entries match no param path: {missing!r}{where}. "
            "Paths use the keystr form, e.g. \"['layer_0']['W']\" for "
            "exact keys or a regex searched against that string for "
            "(pattern, spec) rules")


def apply_tensor_parallel(net, mesh, data_axis: str = "data",
                          model_axis: str = "model", rules=None):
    """Place a net's params over ``mesh``'s model axis (each rank keeps
    its shard; optimizer slots follow their params' specs) and give the
    layers their ``LayerTP``. The whole trees must already agree over the
    model group: parallel/data_parallel.py ``apply_mesh``, its caller,
    replicates them first (or a restore read them alike on every rank)."""
    tp = TensorParallel(net, mesh, data_axis, model_axis, rules)
    o_specs = tp.opt_specs(net.opt_state or {})
    net.params = tp.place(net.params, tp.specs)
    if net.opt_state:
        net.opt_state = tp.place(net.opt_state, o_specs)
    net._tp = tp if tp.mg.size > 1 else None
    for layer in net.layers:
        layer.tp = tp.layers.get(layer.name) if tp.mg.size > 1 else None
    return net
