"""DataSetIterator, the in-memory iterators and the prefetch wrappers
(counterpart of deeplearning4j_tpu/datasets/iterator.py):
``AsyncDataSetIterator`` prepares batches on a background thread,
``DevicePrefetchIterator`` copies batch N+1 to the card while step N
runs, ``ReconstructionDataSetIterator`` makes the features the labels,
``NativeDataSetIterator`` takes its batches from the C++ prefetch loader
(datasets/native_io.py)."""

from __future__ import annotations

import os
import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet


def default_prefetch_depth() -> int:
    """Async prefetch queue depth (the reference's default 2;
    ``DL4J_TPU_PREFETCH_DEPTH`` overrides it for slow input pipelines)."""
    return max(1, int(os.environ.get("DL4J_TPU_PREFETCH_DEPTH", "2")))


class DataSetIterator:
    """Iterate DataSets; ``reset()`` restarts the stream."""

    def __iter__(self):
        raise NotImplementedError

    def reset(self):
        pass

    @property
    def batch_size(self) -> Optional[int]:
        return None


class ListDataSetIterator(DataSetIterator):
    """Iterates a pre-built list of DataSet minibatches."""

    def __init__(self, datasets: List[DataSet]):
        self._datasets = list(datasets)

    def __iter__(self):
        return iter(self._datasets)

    def __len__(self):
        return len(self._datasets)

    @property
    def batch_size(self):
        return self._datasets[0].num_examples if self._datasets else None


class ArrayDataSetIterator(DataSetIterator):
    """Slices (features, labels) arrays into minibatches. With ``shuffle``
    each pass draws its order from ``seed + epoch`` (numpy's generator, the
    JAX package's scheme), and ``reset()`` rewinds to epoch 0, so a replay
    after a reset sees the same orders."""

    def __init__(self, features, labels, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels) if labels is not None else None
        self._batch = int(batch_size)
        self._shuffle = shuffle
        self._seed = int(seed)
        self._epoch = 0
        self._drop_last = drop_last

    def _selections(self):
        """Each batch's example indices for one pass (the pass's epoch
        counted when it starts)."""
        n = self.features.shape[0]
        idx = np.arange(n)
        if self._shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(idx)
        self._epoch += 1
        stop = (n // self._batch) * self._batch if self._drop_last else n
        for start in range(0, stop, self._batch):
            yield idx[start:start + self._batch]

    def __iter__(self):
        for sel in self._selections():
            yield DataSet(self.features[sel],
                          None if self.labels is None else self.labels[sel])

    def __len__(self):
        n = self.features.shape[0]
        return n // self._batch if self._drop_last else -(-n // self._batch)

    def reset(self):
        self._epoch = 0

    @property
    def batch_size(self):
        return self._batch


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch (AsyncDataSetIterator.java: a blocking
    queue of depth 2 by default). An exception in the producer is raised
    in the consumer; the consumer's ``finally`` drains the queue and joins
    the producer, so a loop left early leaks no thread."""

    _SENTINEL = object()
    THREAD_NAME = "dl4j-async-prefetch"

    def __init__(self, base, queue_size: Optional[int] = None):
        self.base = base
        self.queue_size = (default_prefetch_depth() if queue_size is None
                           else max(1, int(queue_size)))

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.queue_size)
        stop = threading.Event()
        error: list = []

        def put(item) -> bool:
            # gives up once the consumer has left
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for ds in self.base:
                    if not put(ds):
                        return
            except BaseException as e:  # raised on the consumer's side
                error.append(e)
            finally:
                put(self._SENTINEL)

        t = threading.Thread(target=producer, daemon=True,
                             name=self.THREAD_NAME)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=1.0)
                except queue.Empty:
                    if not t.is_alive() and q.empty():
                        if error:
                            raise error[0]
                        raise RuntimeError(
                            "async prefetch producer died without "
                            "delivering its end-of-data sentinel")
                    continue
                if item is self._SENTINEL:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)

    def reset(self):
        self.base.reset()

    @property
    def batch_size(self):
        return self.base.batch_size


class DevicePrefetchIterator(DataSetIterator):
    """Double-buffered host-to-card copy: batch N+1's copy is issued (from
    pinned host memory, on a side stream) before batch N is yielded, so
    it rides under step N. The consumer's stream waits on the copy's
    event before it reads a batch, and each tensor is marked as used on
    that stream (``record_stream``) for the caching allocator. Yielded
    DataSets hold tensors on ``device``; on the CPU they are the host
    arrays as tensors (no copy to hide).

    ``sharding`` (optional): a meshed net's batch placement
    (parallel/data_parallel.py ``BatchSharding(mesh)``, the counterpart
    of the JAX package's data ``Sharding``): every leaf of a global batch
    is cut to this rank's rows on the data axis (the same rows on every
    rank of a model group) before the copy, onto the sharding's device
    unless ``device`` names one."""

    def __init__(self, base, device=None, sharding=None):
        self.base = base
        self.sharding = sharding
        if device is None and sharding is not None:
            device = sharding.device
        self.device = torch.device(device if device is not None else
                                   "cuda")
        self._stream = None

    def _put(self, arr):
        if arr is None:
            return None
        t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
            np.asarray(arr))
        if self.sharding is not None:
            t = self.sharding.rows(t)
        if self.device.type != "cuda" or t.device == self.device:
            return t.to(self.device)
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _to_device(self, ds):
        """(the batch on the device, the event its copies end on)."""
        if self.device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                out = _map_batch(self._put, ds)
                event = torch.cuda.Event()
                event.record(self._stream)
            return out, event
        return _map_batch(self._put, ds), None

    def _handed_over(self, pending):
        ds, event = pending
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            _map_batch(lambda t: None if t is None else t.record_stream(cur),
                       ds)
        return ds

    def __iter__(self):
        it = iter(self.base)
        try:
            pending = self._to_device(next(it))
        except StopIteration:
            return
        for ds in it:
            nxt = self._to_device(ds)  # in flight while batch N computes
            yield self._handed_over(pending)
            pending = nxt
        yield self._handed_over(pending)

    def reset(self):
        self.base.reset()

    @property
    def batch_size(self):
        return self.base.batch_size


def _map_batch(fn, ds):
    if isinstance(ds, MultiDataSet):
        lists = lambda xs: None if xs is None else [fn(x) for x in xs]  # noqa: E731
        return MultiDataSet(lists(ds.features), lists(ds.labels),
                            lists(ds.features_masks), lists(ds.labels_masks))
    return DataSet(fn(ds.features), fn(ds.labels), fn(ds.features_mask),
                   fn(ds.labels_mask))


class MultipleEpochsIterator(DataSetIterator):
    """Replays a base iterator for N epochs (MultipleEpochsIterator). The
    base is not reset between epochs: a base with seed + epoch orders
    gives each epoch its own order; ``reset`` rewinds all."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self.epochs = epochs
        self.base = base
        self._epoch = 0

    def __iter__(self):
        while self._epoch < self.epochs:
            self._epoch += 1
            yield from self.base

    def reset(self):
        self._epoch = 0
        self.base.reset()

    @property
    def batch_size(self):
        return self.base.batch_size


class IteratorDataSetIterator(DataSetIterator):
    """A plain Python iterable of DataSets from a factory, so ``reset``
    can make it anew (IteratorDataSetIterator)."""

    def __init__(self, iterable_factory):
        self._factory = iterable_factory

    def __iter__(self):
        return iter(self._factory())


class NativeDataSetIterator(DataSetIterator):
    """DataSetIterator over the C++ prefetch loader
    (datasets/native_io.py): shuffling, batch assembly and the depth-2
    prefetch ring run in a native worker thread, and the batches are host
    arrays (``fit``'s ``DevicePrefetchIterator`` copies them to the card).
    There is no fallback: without ``g++`` or the library the constructor
    raises ``native_io.NativeIOUnavailable``."""

    def __init__(self, features, labels, batch_size: int,
                 shuffle: bool = True, seed: int = 0, depth: int = 2,
                 drop_last: bool = True):
        from deeplearning4j_tpu_torch.datasets.native_io import \
            NativeBatchLoader
        self._loader = NativeBatchLoader(
            features, labels, batch_size, shuffle=shuffle, seed=seed,
            depth=depth, drop_last=drop_last)
        self._batch_size = self._loader.batch_size

    def __iter__(self):
        for x, y in self._loader:
            yield DataSet(x, y)

    def __len__(self):
        return self._loader.batches_per_epoch

    def reset(self):
        # restart the native stream (fresh epoch position + empty
        # prefetch ring) — the DataSetIterator contract; a mid-epoch
        # abandoned generator must not shift later epochs
        self._loader.reset()

    @property
    def batch_size(self):
        return self._batch_size

    def close(self):
        self._loader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SamplingDataSetIterator(DataSetIterator):
    """``total_batches`` batches a pass drawn WITH replacement from one
    DataSet (SamplingDataSetIterator.java), from
    ``np.random.default_rng(seed + epoch)``: the JAX package's draws."""

    def __init__(self, dataset, batch_size: int, total_batches: int,
                 seed: int = 0):
        self._x = np.asarray(dataset.features)
        self._y = (None if dataset.labels is None
                   else np.asarray(dataset.labels))
        self._batch_size = int(batch_size)
        self.total_batches = int(total_batches)
        self._seed = seed
        self._epoch = 0

    def __iter__(self):
        rng = np.random.default_rng(self._seed + self._epoch)
        self._epoch += 1
        n = len(self._x)
        for _ in range(self.total_batches):
            idx = rng.integers(0, n, self._batch_size)
            yield DataSet(self._x[idx],
                          None if self._y is None else self._y[idx])

    def reset(self):
        """Replay yields the epoch-0 draws again."""
        self._epoch = 0

    def __len__(self):
        return self.total_batches

    @property
    def batch_size(self):
        return self._batch_size


class ReconstructionDataSetIterator(DataSetIterator):
    """Wraps an iterator, replacing the labels with the features:
    autoencoder reconstruction targets. The features mask applies to both
    sides, so a masked sequence autoencoder does not score padded
    steps."""

    def __init__(self, base: DataSetIterator):
        self.base = base

    def __iter__(self):
        for ds in self.base:
            yield DataSet(ds.features, ds.features, ds.features_mask,
                          ds.features_mask)

    def reset(self):
        self.base.reset()

    @property
    def batch_size(self):
        return self.base.batch_size
