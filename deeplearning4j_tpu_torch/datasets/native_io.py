"""ctypes binding for the native data-loading runtime (counterpart of
deeplearning4j_tpu/datasets/native_io.py).

The reference's ingestion is native-grade code outside the JVM hot path
(external DataVec + AsyncDataSetIterator's background thread); here the
IDX parsing, batch assembly, shuffling and prefetch ring run in C++
worker threads behind a C API (``native/dataloader.cpp``, the JAX
package's runtime, compiled as it is). The binding:

- ``available()``     -> bool: the library loads (built first if needed)
- ``read_idx(path)``  -> np.ndarray (float32; u8 payloads normalized /255)
- ``NativeBatchLoader(x, y, batch_size, ...)`` -> iterator of
  (features, labels) host arrays with C++-side prefetch (depth-2 ring,
  the AsyncDataSetIterator default)

The library is compiled by ``g++`` at first use into the port's build
directory (ops/_build.py ``load_host``). There is no pure-Python
fallback: without ``g++`` or the library, ``read_idx`` and
``NativeBatchLoader`` raise ``NativeIOUnavailable`` naming what is
missing. The batches are host arrays; ``fit`` (or
``DevicePrefetchIterator``) moves them to the card.
"""

from __future__ import annotations

import ctypes

import numpy as np

from deeplearning4j_tpu_torch.ops import _build

LIBRARY = "dl4jtpu_io"


class NativeIOUnavailable(RuntimeError):
    """The native library cannot be built or loaded here."""


def _load() -> ctypes.CDLL:
    try:
        lib = _build.load_host(LIBRARY)
    except (_build.KernelBuildError, OSError) as e:
        raise NativeIOUnavailable(
            f"native IO library unavailable: {e}") from e
    lib.dl4j_idx_read.restype = ctypes.c_int
    lib.dl4j_idx_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.dl4j_idx_free.restype = None
    lib.dl4j_idx_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.dl4j_loader_open.restype = ctypes.c_void_p
    lib.dl4j_loader_open.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.dl4j_loader_next.restype = ctypes.c_int64
    lib.dl4j_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    lib.dl4j_loader_close.restype = None
    lib.dl4j_loader_close.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    try:
        _load()
    except NativeIOUnavailable:
        return False
    return True


def read_idx(path: str, normalize: bool = True) -> np.ndarray:
    """Parse an (uncompressed) IDX file natively. Raises
    ``NativeIOUnavailable`` without the library and ``RuntimeError`` for
    a file it cannot parse."""
    lib = _load()
    dims = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int32()
    data = ctypes.POINTER(ctypes.c_float)()
    rc = lib.dl4j_idx_read(path.encode(), 1 if normalize else 0, dims,
                           ctypes.byref(ndim), ctypes.byref(data))
    if rc != 0:
        raise RuntimeError(f"dl4j_idx_read({path}) failed with code {rc}")
    shape = tuple(int(dims[i]) for i in range(ndim.value))
    n = int(np.prod(shape)) if shape else 0
    try:
        out = np.ctypeslib.as_array(data, shape=(n,)).copy().reshape(shape)
    finally:
        lib.dl4j_idx_free(data)
    return out


class NativeBatchLoader:
    """C++-prefetched minibatch iterator over in-memory arrays.

    Features flatten to [n, feat] for transport and are reshaped back per
    batch; labels must be one-hot [n, classes]. ``depth`` is the prefetch
    ring size (AsyncDataSetIterator's queue of 2 by default). The C++
    side copies both arrays when the stream opens."""

    def __init__(self, features, labels, batch_size: int,
                 shuffle: bool = True, seed: int = 0, depth: int = 2,
                 drop_last: bool = True):
        self._handle = None
        self._lib = _load()
        x = np.ascontiguousarray(np.asarray(features, np.float32))
        y = np.ascontiguousarray(np.asarray(labels, np.float32))
        if y.ndim != 2 or x.shape[0] != y.shape[0]:
            raise ValueError("labels must be one-hot [n, classes] aligned "
                             "with features")
        self._feat_shape = x.shape[1:]
        self.batch_size = min(batch_size, x.shape[0])
        self._feat = int(np.prod(self._feat_shape)) if self._feat_shape else 1
        self._classes = y.shape[1]
        self._n = x.shape[0]
        self.batches_per_epoch = (
            self._n // self.batch_size if drop_last
            else -(-self._n // self.batch_size))
        self._open_args = (x.reshape(self._n, -1), y, 1 if shuffle else 0,
                           seed, depth, 1 if drop_last else 0)
        self._reopen()
        self._xbuf = np.empty((self.batch_size, self._feat), np.float32)
        self._ybuf = np.empty((self.batch_size, self._classes), np.float32)

    def _reopen(self):
        """(Re)start the native stream — reset() semantics: a fresh
        epoch position and an empty prefetch ring."""
        self.close()
        xf, y, shuffle, seed, depth, drop_last = self._open_args
        self._handle = self._lib.dl4j_loader_open(
            xf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._n, self._feat, self._classes, self.batch_size,
            shuffle, seed, depth, drop_last)
        if not self._handle:
            raise RuntimeError("dl4j_loader_open failed")

    def reset(self):
        self._reopen()

    def next_batch(self):
        if self._handle is None:
            raise RuntimeError("native loader is closed")
        n = self._lib.dl4j_loader_next(
            self._handle,
            self._xbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._ybuf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n < 0:
            raise RuntimeError("native loader stopped")
        x = self._xbuf[:n].reshape((n,) + self._feat_shape).copy()
        y = self._ybuf[:n].copy()
        return x, y

    def __iter__(self):
        for _ in range(self.batches_per_epoch):
            yield self.next_batch()

    def close(self):
        if self._handle:
            self._lib.dl4j_loader_close(self._handle)
        self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # the C++ worker thread and its ring live until closed
        if getattr(self, "_handle", None):
            self.close()
