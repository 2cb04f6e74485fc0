"""The port's native loader (deeplearning4j_tpu_torch/datasets/
native_io.py, ``NativeDataSetIterator``) held against the JAX package's
on the CPU: the cases of tests/test_native_io.py.

Both packages drive the same C++ runtime (native/dataloader.cpp), the
port's copy compiled by g++ into its own build directory
(ops/_build.py ``load_host``). IDX reads and every batch are bit-equal
to the JAX package's; an epoch covers every row once with its label; a
net trained on the port's iterator reaches the JAX test's accuracy and
the JAX package's parameters. Without g++ or the source the port raises
naming what is missing: there is no Python fallback.
"""

import struct

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import native_io as jnative
from deeplearning4j_tpu.datasets.iterator import (
    NativeDataSetIterator as JNativeDataSetIterator)
from deeplearning4j_tpu_torch.datasets import native_io
from deeplearning4j_tpu_torch.datasets.iterator import NativeDataSetIterator
from deeplearning4j_tpu_torch.ops import _build


def _write_idx_u8(path, arr):
    arr = np.asarray(arr, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x00000800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def _write_idx_f32(path, arr):
    arr = np.asarray(arr, np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x00000D00 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.astype(">f4").tobytes())


def _traceable(n, feat, classes, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, feat)).astype(np.float32)
    x[:, 0] = np.arange(n)           # the example id, to trace batches
    labels = rng.integers(0, classes, n)
    return x, np.eye(classes, dtype=np.float32)[labels], labels


# ------------------------------------------------------------------ IDX
@pytest.mark.parametrize("normalize", [False, True])
def test_u8_equals_the_jax_package(tmp_path, normalize):
    arr = np.random.default_rng(0).integers(0, 256, (7, 5, 4)).astype(
        np.uint8)
    p = str(tmp_path / "t.idx")
    _write_idx_u8(p, arr)
    got = native_io.read_idx(p, normalize=normalize)
    want = jnative.read_idx(p, normalize=normalize)
    assert got.dtype == np.float32 and got.shape == arr.shape
    np.testing.assert_array_equal(got, want)
    if normalize:
        np.testing.assert_allclose(got, arr / 255.0, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.astype(np.uint8), arr)


def test_f32_big_endian(tmp_path):
    arr = np.random.default_rng(1).normal(size=(6, 3)).astype(np.float32)
    p = str(tmp_path / "f.idx")
    _write_idx_f32(p, arr)
    np.testing.assert_array_equal(native_io.read_idx(p), arr)
    np.testing.assert_array_equal(native_io.read_idx(p), jnative.read_idx(p))


def test_missing_file_raises():
    with pytest.raises(RuntimeError, match="code 1"):
        native_io.read_idx("/nonexistent/file.idx")


def test_corrupt_idx_fails_cleanly(tmp_path):
    # a header claiming absurd dims: an error code, not a crash
    p = str(tmp_path / "corrupt.idx")
    with open(p, "wb") as f:
        f.write(struct.pack(">I", 0x00000803))
        f.write(struct.pack(">I", 0xFFFFFFFF) * 3)
        f.write(b"\x00" * 16)
    with pytest.raises(RuntimeError, match="code 2"):
        native_io.read_idx(p)


# --------------------------------------------------------------- loader
@pytest.mark.parametrize("shuffle,seed", [(True, 7), (True, 8),
                                          (False, 0)])
def test_batches_equal_the_jax_package(shuffle, seed):
    x, y, _ = _traceable(64, 6, 3, seed=2)
    with native_io.NativeBatchLoader(x, y, 16, shuffle=shuffle,
                                     seed=seed) as ours:
        theirs = jnative.NativeBatchLoader(x, y, 16, shuffle=shuffle,
                                           seed=seed)
        try:
            for _ in range(3 * ours.batches_per_epoch):
                (bx, by), (jx, jy) = ours.next_batch(), theirs.next_batch()
                np.testing.assert_array_equal(bx, jx)
                np.testing.assert_array_equal(by, jy)
        finally:
            theirs.close()


def test_covers_epoch_without_duplicates():
    n, feat, classes, bs = 64, 6, 3, 16
    x, y, _ = _traceable(n, feat, classes, seed=2)
    with native_io.NativeBatchLoader(x, y, bs, seed=7) as loader:
        seen = []
        for bx, by in loader:
            assert bx.shape == (bs, feat) and by.shape == (bs, classes)
            ids = bx[:, 0].astype(int)
            np.testing.assert_array_equal(bx, x[ids])
            seen.extend(ids.tolist())
        assert sorted(seen) == list(range(n))


def test_labels_stay_aligned():
    x, y, labels = _traceable(40, 4, 5, seed=3)
    with native_io.NativeBatchLoader(x, y, 8, seed=1) as loader:
        for _ in range(2 * loader.batches_per_epoch):
            bx, by = loader.next_batch()
            np.testing.assert_array_equal(by.argmax(axis=1),
                                          labels[bx[:, 0].astype(int)])


def test_nd_features_reshaped():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(32, 5, 5, 2)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)]
    with native_io.NativeBatchLoader(x, y, 8) as loader:
        bx, by = loader.next_batch()
        assert bx.shape == (8, 5, 5, 2) and by.shape == (8, 2)


def test_reset_restarts_epoch():
    """Abandoning a mid-epoch stream then reset() restarts it, in both
    the loader and the iterator."""
    n = 32
    x = np.zeros((n, 3), np.float32)
    x[:, 0] = np.arange(n)
    y = np.eye(2, dtype=np.float32)[np.zeros(n, int)]
    with native_io.NativeBatchLoader(x, y, 8, shuffle=False) as loader:
        first, _ = loader.next_batch()
        loader.reset()
        again, _ = loader.next_batch()
        np.testing.assert_array_equal(first[:, 0], again[:, 0])
    with NativeDataSetIterator(x, y, 8, seed=5) as it:
        one = next(iter(it)).features
        it.reset()
        np.testing.assert_array_equal(next(iter(it)).features, one)
        assert len(it) == 4 and it.batch_size == 8


def test_next_after_close_raises():
    x = np.zeros((8, 2), np.float32)
    y = np.eye(2, dtype=np.float32)[np.zeros(8, int)]
    loader = native_io.NativeBatchLoader(x, y, 4)
    loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        loader.next_batch()


def test_iterator_trains_a_net_as_the_jax_package_does():
    """NativeDataSetIterator feeds MultiLayerNetwork.fit: the JAX test's
    accuracy, and the JAX package's parameters on the same batches."""
    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
    from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
    from deeplearning4j_tpu.nn.updater import Adam as JAdam
    from deeplearning4j_tpu.utils.serialization import write_model
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.utils.serialization import \
        restore_multi_layer_network

    rng = np.random.default_rng(5)
    centers = rng.normal(0, 3.0, (3, 8))
    idx = rng.integers(0, 3, 256)
    x = (centers[idx] + rng.normal(0, 0.5, (256, 8))).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[idx]
    conf = (JNNC.builder().seed(1).updater(JAdam(5e-3)).list()
            .layer(JDense(n_in=8, n_out=16, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    jnet = JMLN(conf).init()
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        write_model(jnet, f"{d}/m.zip")
        net = restore_multi_layer_network(f"{d}/m.zip", device="cpu")
    with NativeDataSetIterator(x, y, batch_size=64, seed=3) as it:
        net.fit(it, epochs=8, async_prefetch=False)
    jit = JNativeDataSetIterator(x, y, batch_size=64, seed=3)
    try:
        jnet.fit(jit, epochs=8, async_prefetch=False)
    finally:
        jit.close()
    assert net.evaluate(DataSet(x, y)).accuracy() > 0.95
    for layer in jnet.layers:
        for k, v in jnet.params[layer.name].items():
            np.testing.assert_allclose(net.params[layer.name][k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------- no fallback
def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_DIR", [tmp_path / "build"])


def test_the_library_is_built_into_the_ports_build_dir(monkeypatch,
                                                       tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    assert native_io.available()
    built = list((tmp_path / "build").glob("libdl4jtpu_io_*.so"))
    assert built == [_build.host_library_path(native_io.LIBRARY)]


def test_without_gxx_the_loader_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_GXX_RELEASE", [])
    assert not native_io.available()
    x = np.zeros((8, 2), np.float32)
    y = np.eye(2, dtype=np.float32)[np.zeros(8, int)]
    with pytest.raises(native_io.NativeIOUnavailable, match="g\\+\\+ not"):
        NativeDataSetIterator(x, y, 4)
    with pytest.raises(native_io.NativeIOUnavailable, match="g\\+\\+ not"):
        native_io.read_idx(str(tmp_path / "any.idx"))


def test_without_the_source_the_loader_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setitem(_build.HOST_SOURCES, native_io.LIBRARY,
                        tmp_path / "missing" / "dataloader.cpp")
    x = np.zeros((8, 2), np.float32)
    y = np.eye(2, dtype=np.float32)[np.zeros(8, int)]
    with pytest.raises(native_io.NativeIOUnavailable,
                       match="dataloader.cpp not found"):
        native_io.NativeBatchLoader(x, y, 4)
