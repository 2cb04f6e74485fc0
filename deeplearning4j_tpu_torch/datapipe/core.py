"""Checkpointable record-pipeline core — the DataVec tier of this stack
(counterpart of deeplearning4j_tpu/datapipe/core.py).

The reference delegates all ingestion to the external DataVec project;
the TensorFlow system paper (arXiv:1605.08695 §4.2) makes the input
pipeline a first-class runtime subsystem because a starved accelerator
is the most expensive way to idle. This package is that subsystem: composable
sources → transforms → shuffle → shard → batch → prefetch, with one
capability the ad-hoc iterators in ``datasets/iterator.py`` cannot
offer: **O(1) checkpointable pipeline state**.

``Pipeline.state_dict()`` captures, per stage, everything needed to
resume the record stream exactly where it stopped — epoch counter,
source position, shuffle RNG + window contents, partial batch buffers,
prefetched-but-unconsumed batches — in a JSON-serializable dict whose
size is bounded by the configured window/buffer sizes, never by the
dataset. The resilience supervisor threads this state through its
checkpoints (``meta.json``), so ``resilient_fit`` over a shuffled or
streaming source resumes mid-epoch bit-identically: no record is
replayed, none is skipped.

Stage protocol (``Stage``): ``__iter__`` yields the *remainder of the
current epoch* from the stage's instance state — all iteration state
lives in instance attributes mutated between yields, never in generator
locals, which is what makes mid-stream ``state_dict()`` consistent.
``on_epoch(e)`` advances to epoch ``e`` (position 0, per-epoch RNGs
re-derived from ``seed + e``); ``reset()`` rewinds to epoch 0.

Records are tuples of numpy arrays / scalars / None — usually
``(features,)`` or ``(features, label)``; the batch stage collates them
into :class:`~deeplearning4j_tpu_torch.datasets.dataset.DataSet` minibatches.
"""

from __future__ import annotations

import base64
import io
import threading
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.observability.trace import get_tracer

__all__ = ["Stage", "Pipeline", "PipelineStats", "encode_state_value",
           "decode_state_value", "encode_record", "decode_record"]

_END = object()

STATE_VERSION = 1


# ---------------------------------------------------------------------------
# state serialization: everything in a state_dict must survive json.dump
# (checkpoint state lands inside the checkpoint's meta.json)
# ---------------------------------------------------------------------------

def _encode_array(a: np.ndarray) -> dict:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(a), allow_pickle=False)
    return {"__nd__": base64.b64encode(buf.getvalue()).decode("ascii")}


def _decode_array(d: dict) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(d["__nd__"])),
                   allow_pickle=False)


def encode_state_value(v):
    """Recursively encode a state value (numpy arrays -> base64 .npy,
    DataSet/MultiDataSet -> tagged field lists) into JSON-safe types.

    A pipeline's state holds host data only: a tensor on the card here
    would make ``state_dict()`` wait on it from the step path, so one is
    refused; a CPU tensor encodes as its numpy array."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.ndarray):
        return _encode_array(v)
    if isinstance(v, torch.Tensor):
        if v.device.type != "cpu":
            raise TypeError(
                f"pipeline state holds a tensor on {v.device}: a state "
                "records host copies only (a read of a card tensor waits "
                "on the card)")
        return _encode_array(v.detach().numpy())
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    if isinstance(v, DataSet):
        return {"__ds__": [encode_state_value(x) for x in (
            v.features, v.labels, v.features_mask, v.labels_mask)]}
    if isinstance(v, MultiDataSet):
        return {"__mds__": [[encode_state_value(x) for x in part]
                            for part in (v.features, v.labels,
                                         v.features_masks, v.labels_masks)]}
    if isinstance(v, (list, tuple)):
        return [encode_state_value(x) for x in v]
    if isinstance(v, dict):
        return {str(k): encode_state_value(x) for k, x in v.items()}
    # device arrays and other array-likes round-trip through numpy
    return _encode_array(np.asarray(v))


def decode_state_value(v):
    if isinstance(v, dict):
        if "__nd__" in v:
            return _decode_array(v)
        if "__ds__" in v:
            f, l, fm, lm = [decode_state_value(x) for x in v["__ds__"]]
            return DataSet(f, l, fm, lm)
        if "__mds__" in v:
            f, l, fm, lm = [[decode_state_value(x) for x in part]
                            for part in v["__mds__"]]
            return MultiDataSet(f, l, fm, lm)
        return {k: decode_state_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [decode_state_value(x) for x in v]
    return v


def encode_record(rec) -> list:
    """A record is a tuple of arrays/scalars/None."""
    return [encode_state_value(x) for x in rec]


def decode_record(enc) -> tuple:
    return tuple(decode_state_value(x) for x in enc)


def _world():
    """``(world size, rank)`` of the ``torch.distributed`` process group,
    or ``(1, 0)`` when none is initialised."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _rng_state(rng: np.random.Generator) -> dict:
    return encode_state_value(rng.bit_generator.state)


def _restore_rng(state: dict) -> np.random.Generator:
    rng = np.random.default_rng(0)
    rng.bit_generator.state = decode_state_value(state)
    return rng


# ---------------------------------------------------------------------------
# stage base
# ---------------------------------------------------------------------------

class Stage:
    """One pipeline stage. Subclasses set ``name`` and implement
    ``__iter__`` (yield the remainder of the current epoch, keeping ALL
    iteration state in instance attributes), plus ``_state()`` /
    ``_load_state()`` for their own checkpointable fields."""

    name = "stage"

    def __init__(self, upstream: Optional["Stage"] = None):
        self.upstream = upstream
        self.records_out = 0       # lifetime counter (metrics)
        self.seconds = 0.0         # own processing time (see _clock)

    # ------------------------------------------------------------- iteration
    def __iter__(self) -> Iterator:
        raise NotImplementedError

    def on_epoch(self, epoch: int):
        """Advance to the start of ``epoch`` (position 0; per-epoch RNGs
        re-derive from ``seed + epoch``)."""
        if self.upstream is not None:
            self.upstream.on_epoch(epoch)

    def reset(self):
        """Rewind to the start of epoch 0 (the DataSetIterator replay
        contract)."""
        self.on_epoch(0)

    # ------------------------------------------------------------ checkpoint
    def state_dict(self) -> dict:
        s = {"kind": self.name}
        s.update(self._state())
        if self.upstream is not None:
            s["upstream"] = self.upstream.state_dict()
        return s

    def load_state_dict(self, state: dict):
        if state.get("kind") != self.name:
            raise ValueError(
                f"pipeline state mismatch: stage {self.name!r} cannot load "
                f"state saved by {state.get('kind')!r} — the restoring "
                "pipeline must be built with the same stage sequence")
        self._load_state(state)
        if self.upstream is not None:
            if "upstream" not in state:
                raise ValueError(f"stage {self.name!r}: state has no "
                                 "upstream entry")
            self.upstream.load_state_dict(state["upstream"])

    def _state(self) -> dict:
        return {}

    def _load_state(self, state: dict):
        pass

    # --------------------------------------------------------------- helpers
    def chain(self) -> List["Stage"]:
        """Source-first list of stages ending at this one."""
        out = [] if self.upstream is None else self.upstream.chain()
        out.append(self)
        return out

    def _clock(self, t0: float):
        """Accumulate own processing time (call with a perf_counter
        start). Used at batch/fill granularity — never per record on the
        hot path."""
        self.seconds += time.perf_counter() - t0


# ---------------------------------------------------------------------------
# pipeline-level stats (the /metrics surface)
# ---------------------------------------------------------------------------

class PipelineStats:
    """Throughput/stall counters for one pipeline, bridged into the
    observability registry as a render-time collector (the ServingStats/
    ResilienceStats pattern: these counters stay the source of truth)."""

    def __init__(self, pipeline: "Pipeline"):
        self._pipeline = pipeline
        self._lock = threading.Lock()
        self.records_total = 0
        self.batches_total = 0
        self.wait_seconds = 0.0      # consumer time blocked pulling batches
        self.records_per_second = 0.0
        self._window_t0 = None
        self._window_records = 0
        self._active_t0 = None       # first pull of the current run
        self._registry = None
        self._collector = None

    def note_batch(self, n_records: int, wait_s: float):
        with self._lock:
            now = time.perf_counter()
            self.records_total += n_records
            self.batches_total += 1
            self.wait_seconds += wait_s
            if self._active_t0 is None:
                self._active_t0 = now
            if self._window_t0 is None:
                self._window_t0 = now
            self._window_records += n_records
            dt = now - self._window_t0
            if dt >= 0.5:            # recent-rate window
                self.records_per_second = self._window_records / dt
                self._window_t0, self._window_records = now, 0

    def stall_fraction(self) -> float:
        """Fraction of the consumer's wall-clock since the first pull
        spent blocked waiting for data (the accelerator-starvation
        number)."""
        with self._lock:
            if self._active_t0 is None:
                return 0.0
            wall = time.perf_counter() - self._active_t0
            if wall <= 0:
                return 0.0
            return min(1.0, self.wait_seconds / wall)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "records_total": self.records_total,
                "batches_total": self.batches_total,
                "wait_seconds": self.wait_seconds,
                "records_per_second": self.records_per_second,
            }
        out["stall_fraction"] = self.stall_fraction()
        out["queue_depth"] = self._pipeline.queue_depth()
        return out

    # ------------------------------------------------ registry bridge
    def metric_families(self, labels=None):
        from deeplearning4j_tpu_torch.observability.metrics import MetricFamily
        L = dict(labels or {})
        snap = self.snapshot()
        fams = [
            MetricFamily("dl4j_datapipe_records_total", "counter",
                         "Records emitted by the pipeline").add(
                             snap["records_total"], L),
            MetricFamily("dl4j_datapipe_batches_total", "counter",
                         "Batches emitted by the pipeline").add(
                             snap["batches_total"], L),
            MetricFamily("dl4j_datapipe_records_per_second", "gauge",
                         "Recent pipeline throughput (records/sec)").add(
                             snap["records_per_second"], L),
            MetricFamily("dl4j_datapipe_stall_fraction", "gauge",
                         "Fraction of consumer wall-clock blocked on "
                         "data (0 = never starved)").add(
                             snap["stall_fraction"], L),
            MetricFamily("dl4j_datapipe_queue_depth", "gauge",
                         "Prefetched batches ready for the consumer").add(
                             snap["queue_depth"], L),
        ]
        rec = MetricFamily("dl4j_datapipe_stage_records_total", "counter",
                           "Records emitted per stage")
        sec = MetricFamily("dl4j_datapipe_stage_seconds_total", "counter",
                           "Own processing seconds per stage (batch/fill "
                           "granularity)")
        pad = MetricFamily("dl4j_datapipe_padding_waste_fraction", "gauge",
                           "Padded timestep cells over total cells "
                           "collated by pad-to-bucket stages")
        padc = MetricFamily("dl4j_datapipe_padded_cells_total", "counter",
                            "Filler timestep cells emitted by "
                            "pad-to-bucket stages")
        for i, st in enumerate(self._pipeline.tail.chain()):
            sl = {**L, "stage": f"{i}:{st.name}"}
            rec.add(st.records_out, sl)
            sec.add(round(st.seconds, 6), sl)
            real = getattr(st, "cells_real", None)
            padded = getattr(st, "cells_padded", None)
            if real is not None and padded is not None and real + padded:
                pad.add(round(padded / (real + padded), 4), sl)
                padc.add(padded, sl)
        fams.extend([rec, sec])
        if pad.samples:
            fams.extend([pad, padc])
        return fams

    def attach_to_registry(self, registry=None, *, labels=None):
        from deeplearning4j_tpu_torch.observability.metrics import get_registry
        self.detach_from_registry()
        reg = registry if registry is not None else get_registry()

        def _collect():
            return self.metric_families(labels)

        reg.register_collector(_collect)
        self._registry, self._collector = reg, _collect
        return reg

    def detach_from_registry(self):
        if self._registry is not None:
            self._registry.unregister_collector(self._collector)
            self._registry = self._collector = None


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

class Pipeline(DataSetIterator):
    """A composed record pipeline, presented as a ``DataSetIterator``.

    ``__iter__`` yields the remainder of the *current* epoch and then
    auto-advances the epoch counter (``auto_epochs = True`` — the fit
    loops know not to ``reset()`` between epochs, so per-epoch shuffle
    orders derive from ``seed + epoch``). ``reset()`` rewinds the whole
    pipeline to epoch 0. ``stream(epochs)`` is the flat multi-epoch
    stream the resilience supervisor consumes.

    Build with the fluent constructors in ``datapipe/__init__``::

        pipe = (datapipe.from_arrays(x, y)
                .shuffle(window=512, seed=7)
                .shard()                    # process-aware by default
                .batch(128, drop_last=True)
                .prefetch(2))
        net.fit(pipe, epochs=3)             # or net.resilient_fit(pipe, ...)

    Checkpointing: ``state_dict()`` / ``load_state_dict()`` cover the
    epoch counter and every stage's position/RNG/window/buffer state; the
    restoring pipeline must be built with the same stage sequence over
    the same data.
    """

    auto_epochs = True

    def __init__(self, tail: Stage, name: str = "datapipe"):
        self.tail = tail
        self.name = name
        self.epoch = 0
        self.stats = PipelineStats(self)

    # ------------------------------------------------------------- builders
    def _extend(self, stage: Stage) -> "Pipeline":
        p = Pipeline(stage, name=self.name)
        p.epoch = self.epoch
        return p

    def map(self, fn, workers: int = 0) -> "Pipeline":
        """Apply ``fn(record) -> record``. ``workers > 0`` runs ``fn`` on
        a thread pool with in-order emission (``fn`` must be
        deterministic: in-flight records are re-run on restore)."""
        from deeplearning4j_tpu_torch.datapipe.stages import MapStage
        return self._extend(MapStage(self.tail, fn, workers=workers))

    def filter(self, pred) -> "Pipeline":
        from deeplearning4j_tpu_torch.datapipe.stages import FilterStage
        return self._extend(FilterStage(self.tail, pred))

    def normalize(self, stats=None, eps: float = 1e-8) -> "Pipeline":
        """Standardize record features with :class:`NormalizerStats`
        (``stats=None`` fits mean/std by streaming the pipeline built so
        far once, then rewinding it)."""
        from deeplearning4j_tpu_torch.datapipe.stages import (NormalizerStats,
                                                        NormalizeStage)
        if stats is None:
            stats = NormalizerStats.fit(self, eps=eps)
        return self._extend(NormalizeStage(self.tail, stats))

    def tokenize(self, tokenizer) -> "Pipeline":
        """Map text records to token-id records with a
        ``tokens.CharTokenizer``-style tokenizer (``.encode(str)``)."""
        from deeplearning4j_tpu_torch.datapipe.tokens import TokenizeStage
        return self._extend(TokenizeStage(self.tail, tokenizer))

    def window(self, size: int, stride: Optional[int] = None,
               vocab_size: Optional[int] = None) -> "Pipeline":
        """Cut token-stream records into next-token training windows of
        up to ``size`` steps (``(x_onehot, y_onehot)`` pairs when
        ``vocab_size`` is given) — feed into ``bucket_batch`` for the
        padded-length ladder."""
        from deeplearning4j_tpu_torch.datapipe.tokens import WindowStage
        return self._extend(WindowStage(self.tail, size, stride=stride,
                                        vocab_size=vocab_size))

    def shuffle(self, window: int = 1024, seed: int = 0) -> "Pipeline":
        """Windowed shuffle with an explicit seeded RNG (per-epoch RNG =
        ``seed + epoch``). Checkpoint state includes the RNG state and
        the window contents — O(window), not O(dataset)."""
        from deeplearning4j_tpu_torch.datapipe.stages import ShuffleStage
        return self._extend(ShuffleStage(self.tail, window=window, seed=seed))

    def shard(self, num_shards: Optional[int] = None,
              index: Optional[int] = None) -> "Pipeline":
        """Deterministic ``record_i -> shard (i % num_shards)`` partition:
        shards are disjoint and their union covers every record, for any
        dataset size. Defaults are process-aware (``torch.distributed``'s
        world size and rank when a process group is initialised, else
        one shard, index 0), so a multi-process run drops one
        ``.shard()`` in and each process reads its own disjoint slice."""
        from deeplearning4j_tpu_torch.datapipe.stages import ShardStage
        if num_shards is None or index is None:
            world, rank = _world()
            num_shards = world if num_shards is None else num_shards
            index = rank if index is None else index
        return self._extend(ShardStage(self.tail, num_shards, index))

    def batch(self, batch_size: int, drop_last: bool = False) -> "Pipeline":
        from deeplearning4j_tpu_torch.datapipe.stages import BatchStage
        return self._extend(BatchStage(self.tail, batch_size,
                                       drop_last=drop_last))

    def bucket_batch(self, batch_size: int, ladder=None,
                     drop_last: bool = False) -> "Pipeline":
        """Pad-to-bucket batching for variable-length sequence records:
        each ``[t, f]`` record pads to the next bucket length (the
        serving tier's power-of-two ladder idea) and batches only with
        records of the same bucket, bounding the batch signatures (one
        captured step graph each) while masks keep the math exact."""
        from deeplearning4j_tpu_torch.datapipe.stages import BucketBatchStage
        return self._extend(BucketBatchStage(self.tail, batch_size,
                                             ladder=ladder,
                                             drop_last=drop_last))

    def prefetch(self, depth: int = 2) -> "Pipeline":
        """Parallel worker prefetch: a background thread pulls batches
        ahead of the consumer (layers under the fit loops' own
        ``AsyncDataSetIterator`` / ``DevicePrefetchIterator`` wrappers).
        Prefetched-but-unconsumed batches are part of the checkpoint
        state, so resume neither replays nor drops them."""
        from deeplearning4j_tpu_torch.datapipe.prefetch import PrefetchStage
        return self._extend(PrefetchStage(self.tail, depth=depth))

    # ------------------------------------------------------------ iteration
    def __iter__(self):
        tracer = get_tracer()
        self.stats.attach_to_registry(labels={"pipeline": self.name})
        stream = iter(self.tail)
        while True:
            t0 = time.perf_counter()
            with tracer.span("data_wait", pipeline=self.name):
                ds = next(stream, _END)
            wait = time.perf_counter() - t0
            if ds is _END:
                break
            ds = self._as_dataset(ds)
            self.stats.note_batch(ds.num_examples, wait)
            yield ds
        self._advance_epoch()

    def stream(self, epochs: int):
        """Flat stream of batches until ``self.epoch`` reaches
        ``epochs`` — continues mid-epoch from restored state, then runs
        the remaining full epochs."""
        while self.epoch < epochs:
            before = self.epoch
            for ds in self:
                yield ds
            if self.epoch == before:    # defensive: __iter__ must advance
                raise RuntimeError("pipeline epoch failed to advance")

    def _advance_epoch(self):
        self.epoch += 1
        self.tail.on_epoch(self.epoch)

    @staticmethod
    def _as_dataset(item):
        if isinstance(item, (DataSet, MultiDataSet)):
            return item
        # a bare record tuple at the tail (no batch stage): 1-record sets
        if isinstance(item, tuple):
            parts = list(item) + [None] * (4 - len(item))
            return DataSet(*[None if p is None else np.asarray(p)[None]
                             for p in parts[:4]])
        raise TypeError(f"pipeline tail yielded {type(item)!r}; add a "
                        ".batch(...) stage or yield DataSet objects")

    # --------------------------------------------------- iterator protocol
    def reset(self):
        """Rewind the WHOLE pipeline to epoch 0 (replay-deterministic:
        per-epoch orders re-derive from ``seed + epoch``)."""
        self.epoch = 0
        self.tail.reset()

    @property
    def batch_size(self):
        for st in reversed(self.tail.chain()):
            b = getattr(st, "batch_size", None)
            if b is not None:
                return b
        return None

    def queue_depth(self) -> int:
        for st in reversed(self.tail.chain()):
            d = getattr(st, "buffered", None)
            if d is not None:
                return d()
        return 0

    # ----------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        """O(1)-in-dataset-size resumable state: epoch + per-stage
        position/RNG/window/buffer. JSON-serializable (numpy payloads are
        base64 ``.npy``); lands inside the resilience checkpoint's
        ``meta.json``."""
        return {"version": STATE_VERSION, "name": self.name,
                "epoch": self.epoch, "stage": self.tail.state_dict()}

    def load_state_dict(self, state: dict):
        if state.get("version") != STATE_VERSION:
            raise ValueError(
                f"unsupported pipeline state version {state.get('version')}")
        self.epoch = int(state["epoch"])
        self.tail.load_state_dict(state["stage"])

    def close(self):
        """Stop any prefetch workers and detach metrics collectors."""
        for st in self.tail.chain():
            stop = getattr(st, "stop", None)
            if stop is not None:
                stop()
        self.stats.detach_from_registry()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
