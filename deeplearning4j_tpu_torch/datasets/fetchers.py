"""Built-in dataset fetchers + iterators: MNIST, Iris, CIFAR-10, LFW,
curves (counterpart of deeplearning4j_tpu/datasets/fetchers.py).

Parity: deeplearning4j-core datasets/fetchers/MnistDataFetcher.java
(downloads + parses the IDX binary via datasets/mnist/MnistManager.java)
and datasets/iterator/impl/{Mnist,Iris,Cifar}DataSetIterator.java.

The fetchers never download; they resolve data as:
1. an explicit ``path`` argument,
2. the standard cache dirs (~/.deeplearning4j_tpu/<name>, ~/.cache/<name>,
   $DL4J_TPU_DATA_DIR/<name>) holding the usual raw files
   (train-images-idx3-ubyte etc. for MNIST, cifar-10 binary batches),
3. a clearly-flagged deterministic SYNTHETIC set with the same shapes
   and class structure (template-per-class + noise), so training pipelines
   and benchmarks run anywhere. ``DataSetDescriptor.synthetic`` reports
   which path was taken.

The arrays are the JAX package's, from the same files
or the same numpy draws. The iterators hold the whole set on ``device``
(None: the card) and gather each batch there, in ArrayDataSetIterator's
order; ``features``/``labels`` keep the host arrays. LFW's image files
are read with PIL, imported only when a directory of images is found.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.device import resolve_device


@dataclass
class DataSetDescriptor:
    name: str
    synthetic: bool
    num_examples: int


def _search_dirs(name: str):
    dirs = []
    env = os.environ.get("DL4J_TPU_DATA_DIR")
    if env:
        dirs.append(os.path.join(env, name))
    home = os.path.expanduser("~")
    dirs.append(os.path.join(home, ".deeplearning4j_tpu", name))
    dirs.append(os.path.join(home, ".cache", name))
    return dirs


def _find_file(name: str, filenames):
    for d in _search_dirs(name):
        for fn in filenames:
            p = os.path.join(d, fn)
            if os.path.exists(p):
                return p
    return None


def _read_idx(path: str) -> np.ndarray:
    """Parse an IDX file of unsigned bytes (MnistManager parity),
    gzip-transparent, into a uint8 array of the file's shape (the JAX
    package's bytes; the native loader, datasets/native_io.py, reads the
    same files for the C++ prefetch path)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _synthetic_images(classes, h, w, c, n, seed, split_seed=0):
    """Per-class template + noise images in [0, 1] — separable, MNIST-like
    statistics; deterministic in ``seed``. Templates depend ONLY on
    ``seed`` so train/test splits (different ``split_seed``) share the
    same class structure — otherwise a model trained on the synthetic
    train split scores chance accuracy on the test split."""
    templates = np.random.default_rng(seed).random(
        (classes, h, w, c)).astype(np.float32)
    rng = np.random.default_rng(seed * 7919 + split_seed + 1)
    labels = rng.integers(0, classes, n)
    x = templates[labels] + 0.35 * rng.standard_normal(
        (n, h, w, c)).astype(np.float32)
    x = np.clip(x, 0.0, 1.0)
    y = np.eye(classes, dtype=np.float32)[labels]
    return x, y


class MnistDataFetcher:
    """28x28x1, 10 classes (MnistDataFetcher.java parity)."""

    TRAIN_IMAGES = ("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz")
    TRAIN_LABELS = ("train-labels-idx1-ubyte", "train-labels-idx1-ubyte.gz")
    TEST_IMAGES = ("t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte.gz")
    TEST_LABELS = ("t10k-labels-idx1-ubyte", "t10k-labels-idx1-ubyte.gz")

    def fetch(self, train: bool = True, num_examples: Optional[int] = None,
              path: Optional[str] = None, seed: int = 0
              ) -> Tuple[DataSet, DataSetDescriptor]:
        img_names = self.TRAIN_IMAGES if train else self.TEST_IMAGES
        lbl_names = self.TRAIN_LABELS if train else self.TEST_LABELS
        if path is not None:
            img_p = os.path.join(path, img_names[0])
            if not os.path.exists(img_p):
                img_p = os.path.join(path, img_names[1])
            lbl_p = os.path.join(path, lbl_names[0])
            if not os.path.exists(lbl_p):
                lbl_p = os.path.join(path, lbl_names[1])
        else:
            img_p = _find_file("mnist", img_names)
            lbl_p = _find_file("mnist", lbl_names)
        if img_p and lbl_p and os.path.exists(img_p) and os.path.exists(lbl_p):
            imgs = _read_idx(img_p).astype(np.float32) / 255.0
            labels = _read_idx(lbl_p)
            x = imgs[..., None]
            y = np.eye(10, dtype=np.float32)[labels]
            if num_examples:
                x, y = x[:num_examples], y[:num_examples]
            return DataSet(x, y), DataSetDescriptor("mnist", False, len(x))
        n = num_examples or (6000 if train else 1000)
        x, y = _synthetic_images(10, 28, 28, 1, n, seed,
                                 split_seed=0 if train else 1)
        return DataSet(x, y), DataSetDescriptor("mnist(synthetic)", True, n)


class CifarDataFetcher:
    """32x32x3, 10 classes (CifarDataSetIterator parity). Reads the binary
    batch format (data_batch_*.bin) when cached."""

    def fetch(self, train: bool = True, num_examples: Optional[int] = None,
              path: Optional[str] = None, seed: int = 0
              ) -> Tuple[DataSet, DataSetDescriptor]:
        names = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                 if train else ["test_batch.bin"])
        dirs = [path] if path else _search_dirs("cifar-10-batches-bin")
        xs, ys = [], []
        for d in dirs:
            if d is None or not os.path.isdir(d):
                continue
            for fn in names:
                p = os.path.join(d, fn)
                if not os.path.exists(p):
                    continue
                raw = np.fromfile(p, dtype=np.uint8).reshape(-1, 3073)
                ys.append(raw[:, 0])
                xs.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                          .transpose(0, 2, 3, 1))
            if xs:
                break
        if xs:
            x = (np.concatenate(xs).astype(np.float32) / 255.0)
            y = np.eye(10, dtype=np.float32)[np.concatenate(ys)]
            if num_examples:
                x, y = x[:num_examples], y[:num_examples]
            return DataSet(x, y), DataSetDescriptor("cifar10", False, len(x))
        n = num_examples or (5000 if train else 1000)
        x, y = _synthetic_images(10, 32, 32, 3, n, seed,
                                 split_seed=0 if train else 1)
        return DataSet(x, y), DataSetDescriptor("cifar10(synthetic)", True, n)


class IrisDataFetcher:
    """150 examples, 4 features, 3 classes (IrisDataFetcher.java parity).
    Reads iris.data CSV when cached; synthetic 3-Gaussian set with
    iris-like class means otherwise."""

    def fetch(self, path: Optional[str] = None, seed: int = 0
              ) -> Tuple[DataSet, DataSetDescriptor]:
        p = path or _find_file("iris", ("iris.data", "iris.csv"))
        if p and os.path.exists(p):
            rows, labels = [], []
            label_map = {}
            with open(p) as f:
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) < 5:
                        continue
                    rows.append([float(v) for v in parts[:4]])
                    lbl = parts[4]
                    label_map.setdefault(lbl, len(label_map))
                    labels.append(label_map[lbl])
            x = np.asarray(rows, np.float32)
            y = np.eye(3, dtype=np.float32)[np.asarray(labels)]
            return DataSet(x, y), DataSetDescriptor("iris", False, len(x))
        rng = np.random.default_rng(seed)
        means = np.array([[5.0, 3.4, 1.5, 0.2],
                          [5.9, 2.8, 4.3, 1.3],
                          [6.6, 3.0, 5.6, 2.0]], np.float32)
        stds = np.array([[0.35, 0.38, 0.17, 0.10],
                         [0.51, 0.31, 0.47, 0.20],
                         [0.64, 0.32, 0.55, 0.27]], np.float32)
        labels = np.repeat(np.arange(3), 50)
        x = (means[labels]
             + stds[labels] * rng.standard_normal((150, 4))).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[labels]
        perm = rng.permutation(150)
        return (DataSet(x[perm], y[perm]),
                DataSetDescriptor("iris(synthetic)", True, 150))


# ---------------------------------------------------------------------------
# Iterators (datasets/iterator/impl parity)
# ---------------------------------------------------------------------------

class _FetchedDataSetIterator(ArrayDataSetIterator):
    """An ArrayDataSetIterator over a fetched set whose arrays are also
    held on ``device`` (None: the card): each batch is the same
    selection as the host iterator's, gathered there."""

    def __init__(self, features, labels, descriptor, batch_size: int,
                 shuffle: bool, seed: int, device):
        super().__init__(features, labels, batch_size=batch_size,
                         shuffle=shuffle, seed=seed)
        self.descriptor = descriptor
        self.device = resolve_device(device)
        self._features = torch.as_tensor(self.features, device=self.device)
        self._labels = torch.as_tensor(self.labels, device=self.device)

    def __iter__(self):
        for sel in self._selections():
            idx = torch.as_tensor(sel, device=self.device)
            yield DataSet(self._features[idx], self._labels[idx])


class MnistDataSetIterator(_FetchedDataSetIterator):
    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, flatten: bool = False,
                 shuffle: bool = True, seed: int = 123,
                 path: Optional[str] = None, device=None):
        ds, descriptor = MnistDataFetcher().fetch(
            train=train, num_examples=num_examples, path=path, seed=seed)
        x = ds.features
        if flatten:
            x = x.reshape(x.shape[0], -1)
        super().__init__(x, ds.labels, descriptor, batch_size, shuffle,
                         seed, device)


class CifarDataSetIterator(_FetchedDataSetIterator):
    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, shuffle: bool = True, seed: int = 123,
                 path: Optional[str] = None, device=None):
        ds, descriptor = CifarDataFetcher().fetch(
            train=train, num_examples=num_examples, path=path, seed=seed)
        super().__init__(ds.features, ds.labels, descriptor, batch_size,
                         shuffle, seed, device)


class IrisDataSetIterator(_FetchedDataSetIterator):
    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 seed: int = 123, path: Optional[str] = None, device=None):
        ds, descriptor = IrisDataFetcher().fetch(path=path, seed=seed)
        super().__init__(ds.features[:num_examples], ds.labels[:num_examples],
                         descriptor, batch_size, False, seed, device)


class LFWDataFetcher:
    """Labeled Faces in the Wild (LFWDataSetIterator.java /
    datasets/fetchers/LFWDataFetcher.java parity). Reads the standard
    extracted layout ``lfw/<person_name>/<person_name>_NNNN.jpg`` from a
    ``path`` or the cache dirs; persons with fewer than
    ``min_images_per_person`` images are dropped (the reference's
    subset-by-label behavior). Otherwise a synthetic set: per-identity
    face templates. PIL is imported only when a directory of images is
    found."""

    def fetch(self, num_examples: Optional[int] = None,
              image_size: Tuple[int, int] = (64, 64),
              min_images_per_person: int = 2, num_labels: int = 10,
              path: Optional[str] = None, seed: int = 0
              ) -> Tuple[DataSet, DataSetDescriptor]:
        h, w = image_size
        root = path
        if root is None:
            for d in _search_dirs("lfw"):
                if os.path.isdir(d):
                    root = d
                    break
        if root and os.path.isdir(root):
            people = []
            for person in sorted(os.listdir(root)):
                pdir = os.path.join(root, person)
                if not os.path.isdir(pdir):
                    continue
                imgs = sorted(fn for fn in os.listdir(pdir)
                              if fn.lower().endswith((".jpg", ".jpeg",
                                                      ".png")))
                if len(imgs) >= min_images_per_person:
                    people.append((person, [os.path.join(pdir, fn)
                                            for fn in imgs]))
            # most-photographed first, capped at num_labels (the
            # reference's useSubset semantics)
            people.sort(key=lambda p: (-len(p[1]), p[0]))
            people = people[:num_labels]
            if people:
                from PIL import Image
                xs, ys = [], []
                for label, (_, paths) in enumerate(people):
                    for p in paths:
                        img = Image.open(p).convert("RGB").resize((w, h))
                        xs.append(np.asarray(img, np.float32) / 255.0)
                        ys.append(label)
                x = np.stack(xs)
                y = np.eye(len(people), dtype=np.float32)[np.asarray(ys)]
                if num_examples:
                    x, y = x[:num_examples], y[:num_examples]
                return (DataSet(x, y),
                        DataSetDescriptor("lfw", False, len(x)))
        n = num_examples or 400
        x, y = _synthetic_images(num_labels, h, w, 3, n, seed)
        return DataSet(x, y), DataSetDescriptor("lfw(synthetic)", True, n)


def _render_curve(rng, size: int = 28) -> np.ndarray:
    """Rasterize one random cubic Bezier stroke into a [size, size] float
    image — the 'curves' dataset's generative family (the reference's
    CurvesDataFetcher serves precomputed images of exactly such random
    curves for the deep-autoencoder examples)."""
    pts = rng.uniform(0.1, 0.9, (4, 2))
    t = np.linspace(0.0, 1.0, 160)[:, None]
    b = ((1 - t) ** 3 * pts[0] + 3 * (1 - t) ** 2 * t * pts[1]
         + 3 * (1 - t) * t ** 2 * pts[2] + t ** 3 * pts[3])
    img = np.zeros((size, size), np.float32)
    ij = np.clip((b * size).astype(int), 0, size - 1)
    img[ij[:, 1], ij[:, 0]] = 1.0
    # 1-pixel blur to soften the stroke (matches the dataset's antialiased
    # look and gives the autoencoder a non-binary target)
    blurred = img.copy()
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        blurred += 0.35 * np.roll(np.roll(img, dy, 0), dx, 1)
    return np.clip(blurred, 0.0, 1.0)


class CurvesDataFetcher:
    """The 'curves' autoencoder dataset: 28x28 images of random cubic
    curves (datasets/fetchers/CurvesDataFetcher.java parity — the
    reference downloads precomputed curve images; here they load from a
    cached ``curves.npz`` (key ``x``) or are generated deterministically,
    which is faithful to the dataset's own synthetic construction).
    Features == labels (autoencoder reconstruction target)."""

    def fetch(self, num_examples: Optional[int] = None,
              path: Optional[str] = None, seed: int = 0
              ) -> Tuple[DataSet, DataSetDescriptor]:
        p = path or _find_file("curves", ("curves.npz",))
        if p and os.path.exists(p):
            x = np.load(p)["x"].astype(np.float32)
            if num_examples:
                x = x[:num_examples]
            x = x.reshape(len(x), -1)
            return (DataSet(x, x.copy()),
                    DataSetDescriptor("curves", False, len(x)))
        n = num_examples or 2000
        rng = np.random.default_rng(seed)
        x = np.stack([_render_curve(rng) for _ in range(n)])
        x = x.reshape(n, -1)
        return (DataSet(x, x.copy()),
                DataSetDescriptor("curves(synthetic)", True, n))


class LFWDataSetIterator(_FetchedDataSetIterator):
    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 image_size: Tuple[int, int] = (64, 64),
                 min_images_per_person: int = 2, num_labels: int = 10,
                 shuffle: bool = True, seed: int = 123,
                 path: Optional[str] = None, device=None):
        ds, descriptor = LFWDataFetcher().fetch(
            num_examples=num_examples, image_size=image_size,
            min_images_per_person=min_images_per_person,
            num_labels=num_labels, path=path, seed=seed)
        super().__init__(ds.features, ds.labels, descriptor, batch_size,
                         shuffle, seed, device)


class CurvesDataSetIterator(_FetchedDataSetIterator):
    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 seed: int = 123, path: Optional[str] = None, device=None):
        ds, descriptor = CurvesDataFetcher().fetch(
            num_examples=num_examples, path=path, seed=seed)
        super().__init__(ds.features, ds.labels, descriptor, batch_size,
                         False, seed, device)
