"""The port's dataset fetchers and iterators
(deeplearning4j_tpu_torch/datasets/fetchers.py) against the JAX package's
on tests/test_datasets_clustering.py's fetcher cases: files of the
published formats written in tmp_path (MNIST IDX plain and gzip, CIFAR-10
binary batches, iris.data, LFW's image tree, curves.npz) and the
synthetic sets. ``DL4J_TPU_DATA_DIR`` and ``HOME`` point at tmp_path, so
no user cache is read. Arrays, batches and descriptors equal the JAX
package's; the iterators hold their sets on the requested device."""

import gzip
import struct

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import fetchers as jf
from deeplearning4j_tpu_torch.datasets import fetchers as tf


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "data"))
    return tmp_path


def write_idx(path, arr, gz=False):
    arr = np.ascontiguousarray(arr, np.uint8)
    raw = struct.pack(">I", 0x00000800 | arr.ndim)
    raw += b"".join(struct.pack(">I", d) for d in arr.shape) + arr.tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(raw)


def mnist_files(d, n=40, gz=False, train=True, seed=0):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    base = ("train" if train else "t10k")
    suffix = ".gz" if gz else ""
    write_idx(d / f"{base}-images-idx3-ubyte{suffix}", imgs, gz)
    write_idx(d / f"{base}-labels-idx1-ubyte{suffix}", labels, gz)
    return imgs, labels


def cifar_files(d, per_batch=12, train=True, seed=1):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    for fn in names:
        rows = np.concatenate(
            [rng.integers(0, 10, (per_batch, 1), dtype=np.uint8),
             rng.integers(0, 256, (per_batch, 3072), dtype=np.uint8)], 1)
        rows.tofile(d / fn)


def iris_file(path):
    rng = np.random.default_rng(2)
    names = ["Iris-setosa", "Iris-versicolor", "Iris-virginica"]
    lines = [",".join(f"{v:.1f}" for v in rng.uniform(0.1, 8.0, 4))
             + f",{names[i % 3]}" for i in range(150)]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n\n")


def lfw_tree(root, counts):
    from PIL import Image
    rng = np.random.default_rng(0)
    for person, n in counts.items():
        d = root / person
        d.mkdir(parents=True)
        for i in range(n):
            arr = (rng.random((40, 30, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"{person}_{i:04d}.jpg")


def assert_same_fetch(got, want):
    (gds, gdesc), (wds, wdesc) = got, want
    assert (gdesc.name, gdesc.synthetic, gdesc.num_examples) == \
        (wdesc.name, wdesc.synthetic, wdesc.num_examples)
    for a, b in ((gds.features, wds.features), (gds.labels, wds.labels)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def assert_same_batches(tit, jit, epochs=2):
    """The port iterator's batches (CPU tensors) equal the JAX one's,
    batch for batch, over ``epochs`` passes and after a reset."""
    assert tit.descriptor.synthetic == jit.descriptor.synthetic
    assert tit.descriptor.num_examples == jit.descriptor.num_examples
    for _ in range(epochs):
        tb, jb = list(tit), list(jit)
        assert len(tb) == len(jb) == len(tit) > 0
        for t, j in zip(tb, jb):
            assert isinstance(t.features, torch.Tensor)
            assert t.features.device.type == "cpu"
            np.testing.assert_array_equal(t.features.numpy(),
                                          np.asarray(j.features))
            np.testing.assert_array_equal(t.labels.numpy(),
                                          np.asarray(j.labels))
    tit.reset()
    jit.reset()
    np.testing.assert_array_equal(next(iter(tit)).features.numpy(),
                                  np.asarray(next(iter(jit)).features))


# ------------------------------------------------------------ synthetic
@pytest.mark.parametrize("train", [True, False])
def test_mnist_synthetic_fetch_and_iterator(train):
    assert_same_fetch(
        tf.MnistDataFetcher().fetch(train=train, num_examples=16, seed=9),
        jf.MnistDataFetcher().fetch(train=train, num_examples=16, seed=9))
    kw = dict(batch_size=32, num_examples=96, train=train, seed=5)
    tit = tf.MnistDataSetIterator(device="cpu", **kw)
    assert tit.descriptor.synthetic
    assert_same_batches(tit, jf.MnistDataSetIterator(**kw))
    b = next(iter(tf.MnistDataSetIterator(flatten=True, device="cpu", **kw)))
    assert tuple(b.features.shape) == (32, 784)


def test_iris_cifar_lfw_curves_synthetic():
    cases = [
        ("IrisDataSetIterator", dict(batch_size=50, seed=4)),
        ("CifarDataSetIterator", dict(batch_size=16, num_examples=64)),
        ("LFWDataSetIterator", dict(batch_size=8, num_examples=24,
                                    image_size=(16, 16), num_labels=5,
                                    path="/nonexistent")),
        ("CurvesDataSetIterator", dict(batch_size=16, num_examples=64)),
    ]
    for cls, kw in cases:
        tit = getattr(tf, cls)(device="cpu", **kw)
        assert tit.descriptor.synthetic, cls
        assert_same_batches(tit, getattr(jf, cls)(**kw))
    x = next(iter(tf.CurvesDataSetIterator(16, num_examples=64,
                                           device="cpu")))
    assert torch.equal(x.features, x.labels)


# ------------------------------------------------------------ real files
@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("where", ["path", "data_dir", "home_cache"])
def test_mnist_idx_files(isolated_cache, gz, where):
    d = {"path": isolated_cache / "explicit",
         "data_dir": isolated_cache / "data" / "mnist",
         "home_cache": isolated_cache / "home" / ".deeplearning4j_tpu"
         / "mnist"}[where]
    imgs, labels = mnist_files(d, gz=gz)
    path = str(d) if where == "path" else None
    got = tf.MnistDataFetcher().fetch(path=path)
    assert_same_fetch(got, jf.MnistDataFetcher().fetch(path=path))
    ds, desc = got
    assert not desc.synthetic and desc.num_examples == 40
    np.testing.assert_array_equal(ds.features[..., 0],
                                  imgs.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(ds.labels.argmax(1), labels)
    kw = dict(batch_size=16, path=path, seed=3)
    assert_same_batches(tf.MnistDataSetIterator(device="cpu", **kw),
                        jf.MnistDataSetIterator(**kw))


def test_mnist_explicit_path_wins_over_the_cache(isolated_cache):
    mnist_files(isolated_cache / "data" / "mnist", n=8, seed=1)
    mnist_files(isolated_cache / "explicit", n=12, seed=2)
    ds, desc = tf.MnistDataFetcher().fetch(path=str(isolated_cache /
                                                    "explicit"))
    assert desc.num_examples == 12
    ds, desc = tf.MnistDataFetcher().fetch()
    assert desc.num_examples == 8 and not desc.synthetic
    t_test = tf.MnistDataFetcher().fetch(train=False)
    assert t_test[1].synthetic      # no t10k files: the synthetic set


def test_mnist_idx_reads_equal_the_jax_parser(isolated_cache):
    for gz in (False, True):
        p = isolated_cache / f"x{int(gz)}.idx"
        arr = np.random.default_rng(3).integers(0, 256, (5, 7, 3),
                                                dtype=np.uint8)
        write_idx(p, arr, gz)
        if gz:
            p = p.rename(str(p) + ".gz")
        got, want = tf._read_idx(str(p)), jf._read_idx(str(p))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("where", ["path", "data_dir"])
def test_cifar_binary_batches(isolated_cache, train, where):
    d = (isolated_cache / "cifar" if where == "path"
         else isolated_cache / "data" / "cifar-10-batches-bin")
    cifar_files(d, train=train)
    path = str(d) if where == "path" else None
    got = tf.CifarDataFetcher().fetch(train=train, path=path)
    assert_same_fetch(got, jf.CifarDataFetcher().fetch(train=train,
                                                       path=path))
    assert not got[1].synthetic
    assert got[1].num_examples == (60 if train else 12)
    kw = dict(batch_size=8, train=train, path=path, num_examples=20)
    assert_same_batches(tf.CifarDataSetIterator(device="cpu", **kw),
                        jf.CifarDataSetIterator(**kw))


@pytest.mark.parametrize("where", ["path", "data_dir"])
def test_iris_data_file(isolated_cache, where):
    p = (isolated_cache / "iris.data" if where == "path"
         else isolated_cache / "data" / "iris" / "iris.data")
    iris_file(p)
    path = str(p) if where == "path" else None
    got = tf.IrisDataFetcher().fetch(path=path)
    assert_same_fetch(got, jf.IrisDataFetcher().fetch(path=path))
    assert not got[1].synthetic and got[1].num_examples == 150
    kw = dict(batch_size=40, num_examples=120, path=path)
    assert_same_batches(tf.IrisDataSetIterator(device="cpu", **kw),
                        jf.IrisDataSetIterator(**kw))


def test_lfw_image_tree(isolated_cache):
    root = isolated_cache / "lfw"
    lfw_tree(root, {"Alice_A": 4, "Bob_B": 3, "Carol_C": 1})
    kw = dict(image_size=(32, 32), min_images_per_person=2, path=str(root))
    assert_same_fetch(tf.LFWDataFetcher().fetch(**kw),
                      jf.LFWDataFetcher().fetch(**kw))
    tit = tf.LFWDataSetIterator(batch_size=4, shuffle=False, device="cpu",
                                **kw)
    assert not tit.descriptor.synthetic and tit.descriptor.num_examples == 7
    assert_same_batches(tit, jf.LFWDataSetIterator(batch_size=4,
                                                   shuffle=False, **kw))
    assert tuple(next(iter(tit)).labels.shape) == (4, 2)


def test_curves_cache_file(isolated_cache):
    p = isolated_cache / "data" / "curves" / "curves.npz"
    p.parent.mkdir(parents=True)
    np.savez(p, x=np.random.default_rng(1).random((32, 28, 28)))
    for path in (str(p), None):
        got = tf.CurvesDataFetcher().fetch(path=path)
        assert_same_fetch(got, jf.CurvesDataFetcher().fetch(path=path))
        assert not got[1].synthetic and got[1].num_examples == 32


def test_fit_trains_from_the_ports_mnist_iterator():
    """tests/test_datasets_clustering.py's learnability check on the
    port: an MLP fit from the iterator's CPU tensors."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updater import Adam

    it = tf.MnistDataSetIterator(batch_size=128, num_examples=512, seed=1,
                                 device="cpu")
    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-3))
            .list()
            .layer(Dense(n_out=64, activation="relu"))
            .layer(Output(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(28, 28, 1))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.fit(it, epochs=5, async_prefetch=False)
    assert net.evaluate(DataSet(it.features, it.labels)).accuracy() > 0.9
