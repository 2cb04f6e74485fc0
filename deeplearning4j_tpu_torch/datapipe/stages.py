"""Transform stages: map/filter, normalization, windowed shuffle,
deterministic shard, batch and pad-to-bucket batch (counterpart of
deeplearning4j_tpu/datapipe/stages.py).

Every stage follows the core contract: iteration state lives in instance
attributes (never generator locals), ``on_epoch`` re-derives per-epoch
RNGs from ``seed + epoch``, and ``_state()`` captures exactly what a
resume needs — bounded by window/buffer sizes, never the dataset.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datapipe.core import (Stage, _restore_rng, _rng_state,
                                              decode_record, encode_record)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.observability.trace import get_tracer
from deeplearning4j_tpu_torch.serving.batcher import next_bucket

__all__ = ["MapStage", "FilterStage", "NormalizerStats", "NormalizeStage",
           "ShuffleStage", "ShardStage", "BatchStage", "BucketBatchStage"]


class MapStage(Stage):
    """Apply ``fn(record) -> record``. With ``workers > 0`` the function
    runs on a thread pool with in-order emission; the raw in-flight
    records are checkpoint state and re-submitted on restore, so ``fn``
    must be deterministic (same record in, same record out)."""

    name = "map"

    def __init__(self, upstream: Stage, fn: Callable, workers: int = 0):
        super().__init__(upstream)
        self.fn = fn
        self.workers = int(workers)
        self._inflight: List[tuple] = []   # raw records submitted, unemitted

    def __iter__(self):
        if self.workers <= 0:
            for rec in self.upstream:
                out = self.fn(rec)
                self.records_out += 1
                yield out
            return
        with ThreadPoolExecutor(self.workers,
                                thread_name_prefix="dl4j-pipe-map") as pool:
            # re-submit work that was in flight when the checkpoint hit
            pending = [(raw, pool.submit(self.fn, raw))
                       for raw in self._inflight]
            up = iter(self.upstream)
            exhausted = False
            while pending or not exhausted:
                while not exhausted and len(pending) < 2 * self.workers:
                    raw = next(up, None)
                    if raw is None:
                        exhausted = True
                        break
                    self._inflight.append(raw)
                    pending.append((raw, pool.submit(self.fn, raw)))
                if not pending:
                    break
                raw, fut = pending.pop(0)
                # a wedged map fn (hung I/O in user code) must fail the
                # pipeline, not hang the consumer forever
                out = fut.result(timeout=float(os.environ.get(
                    "DL4J_TPU_PIPE_MAP_TIMEOUT_S", "600")))
                self._inflight.remove(raw)
                self.records_out += 1
                yield out

    def on_epoch(self, epoch: int):
        super().on_epoch(epoch)
        self._inflight = []

    def _state(self):
        return {"inflight": [encode_record(r) for r in self._inflight]}

    def _load_state(self, state):
        self._inflight = [decode_record(r) for r in state["inflight"]]


class FilterStage(Stage):
    """Keep records where ``pred(record)`` is truthy. Stateless: the
    upstream cursor is the only position."""

    name = "filter"

    def __init__(self, upstream: Stage, pred: Callable):
        super().__init__(upstream)
        self.pred = pred

    def __iter__(self):
        for rec in self.upstream:
            if self.pred(rec):
                self.records_out += 1
                yield rec


class NormalizerStats:
    """Per-feature mean/std fitted by streaming (Welford accumulation) —
    the NormalizerStandardize tier. Fit once, then reuse across runs:
    ``stats.state_dict()`` makes the statistics part of the pipeline
    checkpoint, so a resumed run normalizes with bit-identical moments."""

    def __init__(self, mean: np.ndarray, std: np.ndarray):
        self.mean = np.asarray(mean, np.float64)
        self.std = np.asarray(std, np.float64)

    @classmethod
    def fit(cls, pipeline, eps: float = 1e-8) -> "NormalizerStats":
        """Stream the pipeline's records once (field 0 = features),
        then rewind it."""
        count = 0
        mean = m2 = None
        for rec in pipeline.tail:
            x = np.asarray(rec[0], np.float64)
            if mean is None:
                mean, m2 = np.zeros_like(x), np.zeros_like(x)
            count += 1
            delta = x - mean
            mean += delta / count
            m2 += delta * (x - mean)
        if count == 0:
            raise ValueError("cannot fit normalizer statistics on an "
                             "empty pipeline")
        var = m2 / count
        pipeline.reset()
        return cls(mean, np.sqrt(var) + eps)

    def transform(self, x: np.ndarray) -> np.ndarray:
        return ((np.asarray(x, np.float64) - self.mean)
                / self.std).astype(np.float32)

    def state_dict(self):
        from deeplearning4j_tpu_torch.datapipe.core import encode_state_value
        return {"mean": encode_state_value(self.mean),
                "std": encode_state_value(self.std)}

    @classmethod
    def from_state_dict(cls, state):
        from deeplearning4j_tpu_torch.datapipe.core import decode_state_value
        return cls(decode_state_value(state["mean"]),
                   decode_state_value(state["std"]))


class NormalizeStage(Stage):
    """Standardize record features (field 0) with fitted
    :class:`NormalizerStats`. The statistics themselves are checkpoint
    state (a resumed pipeline must not refit on different data)."""

    name = "normalize"

    def __init__(self, upstream: Stage, stats: NormalizerStats):
        super().__init__(upstream)
        self.stats = stats

    def __iter__(self):
        for rec in self.upstream:
            self.records_out += 1
            yield (self.stats.transform(rec[0]),) + tuple(rec[1:])

    def _state(self):
        return {"stats": self.stats.state_dict()}

    def _load_state(self, state):
        self.stats = NormalizerStats.from_state_dict(state["stats"])


class ShuffleStage(Stage):
    """Windowed (reservoir-style) shuffle with an explicit seeded RNG.

    Fills a window of ``window`` records, then on each pull swaps a
    random window slot with the tail, pops it, and refills from
    upstream — uniform within the window, streaming-friendly, and
    exactly resumable: checkpoint state is the RNG bit-generator state
    plus the window contents (O(window), never O(dataset)). The
    per-epoch RNG derives from ``seed + epoch`` so every epoch visits a
    distinct deterministic order and ``reset()`` replays epoch 0
    bit-identically.
    """

    name = "shuffle"

    def __init__(self, upstream: Stage, window: int = 1024, seed: int = 0):
        super().__init__(upstream)
        if window < 1:
            raise ValueError("shuffle window must be >= 1")
        self.window = int(window)
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._buf: List[tuple] = []

    def _top_up(self, up):
        # the initial fill is the expensive pull — span/clock that one;
        # steady-state single-record refills stay untimed (hot path)
        if not self._buf:
            t0 = time.perf_counter()
            with get_tracer().span("pipe_shuffle_fill", window=self.window):
                while len(self._buf) < self.window:
                    rec = next(up, None)
                    if rec is None:
                        return
                    self._buf.append(rec)
            self._clock(t0)
            return
        while len(self._buf) < self.window:
            rec = next(up, None)
            if rec is None:
                return
            self._buf.append(rec)

    def _pop(self) -> tuple:
        j = int(self._rng.integers(len(self._buf)))
        self._buf[j], self._buf[-1] = self._buf[-1], self._buf[j]
        return self._buf.pop()

    def __iter__(self):
        # resume invariant: the top-up happens BEFORE each pop, so the
        # instance state at every yield boundary (buffer just popped,
        # not yet refilled) replays identically whether this generator
        # resumes or a restored stage starts a fresh one
        up = iter(self.upstream)
        while True:
            if len(self._buf) < self.window:
                self._top_up(up)
            if not self._buf:
                break
            rec = self._pop()
            self.records_out += 1
            yield rec

    def on_epoch(self, epoch: int):
        super().on_epoch(epoch)
        self._rng = np.random.default_rng(self.seed + epoch)
        self._buf = []

    def _state(self):
        return {"rng": _rng_state(self._rng),
                "buf": [encode_record(r) for r in self._buf]}

    def _load_state(self, state):
        self._rng = _restore_rng(state["rng"])
        self._buf = [decode_record(r) for r in state["buf"]]


class ShardStage(Stage):
    """Deterministic modulo shard: record ``k`` (0-based position in the
    upstream stream this epoch) belongs to shard ``k % num_shards``; this
    stage keeps ``k % num_shards == index``. Disjoint and covering by
    construction for ANY dataset size — every k lands in exactly one
    shard — with shard sizes differing by at most one record when
    ``num_shards`` does not divide the dataset. Place BEFORE shuffle for
    fully independent per-host streams, or give every host the same
    shuffle seed and place it after for identical global orders."""

    name = "shard"

    def __init__(self, upstream: Stage, num_shards: int, index: int):
        super().__init__(upstream)
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} out of range "
                             f"[0, {num_shards})")
        self.num_shards = int(num_shards)
        self.index = int(index)
        self._k = 0              # upstream records seen this epoch

    def __iter__(self):
        for rec in self.upstream:
            mine = self._k % self.num_shards == self.index
            self._k += 1
            if mine:
                self.records_out += 1
                yield rec

    def on_epoch(self, epoch: int):
        super().on_epoch(epoch)
        self._k = 0

    def _state(self):
        # n/i ride along so a checkpoint records WHICH shard of HOW MANY
        # this cursor belongs to — the elastic remap (datapipe/reshard.py)
        # needs them to re-cut the stream for a different fleet size
        return {"k": self._k, "n": self.num_shards, "i": self.index}

    def _load_state(self, state):
        # a cursor saved for shard (i of n) is meaningless under any
        # other (n, i): loading it silently would drop/double records.
        # Cross-fleet resume must go through datapipe.reshard.remap_state
        # which rewrites these fields for the new fleet first.
        if "n" in state and (int(state["n"]) != self.num_shards
                             or int(state["i"]) != self.index):
            raise ValueError(
                f"shard state was saved for shard {state['i']} of "
                f"{state['n']}, but this pipeline shards {self.index} of "
                f"{self.num_shards} — remap it with "
                "deeplearning4j_tpu_torch.datapipe.reshard.remap_state first")
        self._k = int(state["k"])


class BatchStage(Stage):
    """Collate ``batch_size`` records into one :class:`DataSet`
    (``np.stack`` per field; a partial buffer at checkpoint time is
    state). Field order: features, labels, features_mask, labels_mask."""

    name = "batch"

    def __init__(self, upstream: Stage, batch_size: int,
                 drop_last: bool = False):
        super().__init__(upstream)
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)
        self._buf: List[tuple] = []

    @staticmethod
    def _collate(rows: Sequence[tuple]) -> DataSet:
        width = max(len(r) for r in rows)
        fields = []
        for f in range(4):
            if f >= width or all(len(r) <= f or r[f] is None for r in rows):
                fields.append(None)
            else:
                fields.append(np.stack([np.asarray(r[f]) for r in rows]))
        return DataSet(*fields)

    def _emit(self) -> DataSet:
        t0 = time.perf_counter()
        with get_tracer().span("pipe_collate", n=len(self._buf)):
            ds = self._collate(self._buf)
        self._buf = []
        self._clock(t0)
        return ds

    def __iter__(self):
        for rec in self.upstream:
            self._buf.append(rec)
            if len(self._buf) >= self.batch_size:
                self.records_out += self.batch_size
                yield self._emit()
        if self._buf and not self.drop_last:
            self.records_out += len(self._buf)
            yield self._emit()
        self._buf = []

    def on_epoch(self, epoch: int):
        super().on_epoch(epoch)
        self._buf = []

    def _state(self):
        return {"buf": [encode_record(r) for r in self._buf]}

    def _load_state(self, state):
        self._buf = [decode_record(r) for r in state["buf"]]


class BucketBatchStage(Stage):
    """Pad-to-bucket batching for variable-length sequence records.

    Each record's time dimension (``[t, f]`` features, optional per-step
    labels) pads to the next rung of a power-of-two length ladder — the
    serving dispatcher's bucket idea (``serving.batcher.next_bucket``)
    pointed at sequence length instead of batch size — and batches only
    with same-bucket records. The batch signatures, and so the captured
    step graphs of ``fit(multi_step=k)`` (one per signature), stay
    bounded by the ladder (log(t_max) shapes, not one per distinct
    length) while the emitted masks keep the padded math exact.
    Per-bucket partial buffers are checkpoint state.
    """

    name = "bucket_batch"

    def __init__(self, upstream: Stage, batch_size: int,
                 ladder: Optional[Sequence[int]] = None,
                 drop_last: bool = False):
        super().__init__(upstream)
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.batch_size = int(batch_size)
        self.ladder = None if ladder is None else sorted(int(x)
                                                         for x in ladder)
        self.drop_last = bool(drop_last)
        self._bufs = {}          # bucket_len -> list of records
        self.cells_real = 0      # feature cells holding real timesteps
        self.cells_padded = 0    # feature cells that are bucket filler

    def _bucket(self, t: int) -> int:
        if self.ladder is None:
            return next_bucket(t, max_batch=1 << 62)
        for rung in self.ladder:
            if t <= rung:
                return rung
        return self.ladder[-1]   # over-ladder sequences truncate to top rung

    def _collate(self, bucket: int, rows: List[tuple]) -> DataSet:
        t0 = time.perf_counter()
        real_steps = 0
        with get_tracer().span("pipe_collate", n=len(rows), bucket=bucket):
            b = len(rows)
            f = np.asarray(rows[0][0]).shape[-1]
            x = np.zeros((b, bucket, f), np.float32)
            fmask = np.zeros((b, bucket), np.float32)
            y = lmask = None
            for i, rec in enumerate(rows):
                s = np.asarray(rec[0], np.float32)[:bucket]
                real_steps += s.shape[0]
                x[i, :s.shape[0]] = s
                fmask[i, :s.shape[0]] = 1.0
                if len(rec) > 1 and rec[1] is not None:
                    l = np.asarray(rec[1], np.float32)
                    if l.ndim >= 2:       # per-step labels pad+mask too
                        if y is None:
                            y = np.zeros((b, bucket, l.shape[-1]), np.float32)
                            lmask = np.zeros((b, bucket), np.float32)
                        l = l[:bucket]
                        y[i, :l.shape[0]] = l
                        lmask[i, :l.shape[0]] = 1.0
                    else:                 # one label per sequence
                        if y is None:
                            y = np.zeros((b,) + l.shape, np.float32)
                        y[i] = l
        # padding-waste accounting in timestep cells: b*bucket cells
        # went to the device, real_steps of them carry data
        padded_steps = b * bucket - real_steps
        self.cells_real += real_steps
        self.cells_padded += padded_steps
        from deeplearning4j_tpu_torch.observability import goodput as _goodput
        _goodput.record_padding("datapipe_bucket_batch", real_steps,
                                padded_steps)
        self._clock(t0)
        return DataSet(x, y, fmask, lmask)

    def __iter__(self):
        for rec in self.upstream:
            t = int(np.asarray(rec[0]).shape[0])
            bucket = self._bucket(t)
            buf = self._bufs.setdefault(bucket, [])
            buf.append(rec)
            if len(buf) >= self.batch_size:
                self._bufs[bucket] = []
                self.records_out += len(buf)
                yield self._collate(bucket, buf)
        if not self.drop_last:
            for bucket in sorted(self._bufs):
                buf = self._bufs[bucket]
                if buf:
                    self._bufs[bucket] = []
                    self.records_out += len(buf)
                    yield self._collate(bucket, buf)
        self._bufs = {}

    def on_epoch(self, epoch: int):
        super().on_epoch(epoch)
        self._bufs = {}

    def _state(self):
        return {"bufs": {str(k): [encode_record(r) for r in v]
                         for k, v in self._bufs.items() if v}}

    def _load_state(self, state):
        self._bufs = {int(k): [decode_record(r) for r in v]
                      for k, v in state["bufs"].items()}
