"""The dataset fetchers and image pipeline of the PyTorch port against the
JAX package (CPU), bit for bit: the synthetic MNIST, CIFAR-10 and EMNIST
stand-ins and their iterators' batches; IDX (plain and gzipped) and
CIFAR-10 (python pickle and binary) files written here; the port's own
IDX parse and its refusals; the image transforms under a seed;
``SyntheticImageNetIterator``; ``ImageRecordReader`` over PNGs written
here (PIL where installed)."""

import gzip
import os
import pickle
import struct

import numpy as np
import pytest

from deeplearning4j_tpu import datasets as jds
from deeplearning4j_tpu.datasets import mnist as jmnist
from deeplearning4j_tpu_torch import datasets as tds
from deeplearning4j_tpu_torch.datasets import mnist as tmnist


def _batches(it):
    return [(b.features, b.labels) for b in it]


def _assert_same_batches(a, b):
    a, b = _batches(a), _batches(b)
    assert len(a) == len(b) > 0
    for (fa, la), (fb, lb) in zip(a, b):
        assert fa.dtype == fb.dtype and la.dtype == lb.dtype
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)


def _idx(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.uint8)
    return (bytes([0, 0, 8, arr.ndim]) + struct.pack(f">{arr.ndim}I",
                                                     *arr.shape)
            + arr.tobytes())


def _write_idx(path, arr, gz=False):
    data = _idx(arr)
    with (gzip.open(path + ".gz", "wb") if gz else open(path, "wb")) as f:
        f.write(data)


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_mnist_matches_jax(train, tmp_path):
    for n, seed in ((7, 123), (50, 5)):
        for a, b in zip(tmnist.synthetic_mnist(n, seed=seed),
                        jmnist.synthetic_mnist(n, seed=seed)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    root = str(tmp_path)  # no files: the synthetic stand-in
    t = tds.MnistDataSetIterator(16, train=train, seed=3, root=root,
                                 num_examples=40)
    j = jds.MnistDataSetIterator(16, train=train, seed=3, root=root,
                                 num_examples=40)
    assert t.synthetic and j.synthetic
    for _ in range(2):  # two epochs: the train split reshuffles
        _assert_same_batches(t, j)


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_idx_files_match_jax(gz, tmp_path):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, size=(20, 28, 28))
    labels = rng.randint(0, 10, size=20)
    root = str(tmp_path)
    _write_idx(os.path.join(root, "t10k-images-idx3-ubyte"), imgs, gz)
    _write_idx(os.path.join(root, "t10k-labels-idx1-ubyte"), labels, gz)
    t = tds.MnistDataSetIterator(8, train=False, root=root)
    j = jds.MnistDataSetIterator(8, train=False, root=root)
    assert not t.synthetic and not j.synthetic
    _assert_same_batches(t, j)
    first = next(iter(t))
    np.testing.assert_array_equal(
        first.features[0], imgs[0].reshape(-1).astype(np.float32) / 255.0)


def test_idx_parse_refuses_malformed_buffers():
    arr = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    np.testing.assert_array_equal(tmnist.parse_idx(_idx(arr)), arr)
    for bad, what in ((b"\x00\x00\x09\x01" + b"\x00" * 8, "unsigned-byte"),
                      (b"\x00\x00\x08\x03\x00", "header"),
                      (_idx(arr)[:-1], "data")):
        with pytest.raises(ValueError, match=what):
            tmnist.parse_idx(bad)


def test_synthetic_cifar_and_images_match_jax(tmp_path):
    for args in ((5, 32, 32, 3, 10), (3, 16, 8, 1, 4)):
        for a, b in zip(tds.synthetic_images(*args, seed=2),
                        jds.synthetic_images(*args, seed=2)):
            np.testing.assert_array_equal(a, b)
    root = str(tmp_path)
    for train in (True, False):
        t = tds.Cifar10DataSetIterator(8, train=train, seed=1, root=root,
                                       num_examples=20)
        j = jds.Cifar10DataSetIterator(8, train=train, seed=1, root=root,
                                       num_examples=20)
        assert t.synthetic
        _assert_same_batches(t, j)


@pytest.mark.parametrize("layout", ["py", "bin"])
def test_cifar_files_match_jax(layout, tmp_path):
    rng = np.random.RandomState(1)
    root = str(tmp_path)
    d = os.path.join(root, f"cifar-10-batches-{layout}")
    os.makedirs(d)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        data = rng.randint(0, 256, size=(3, 3072)).astype(np.uint8)
        labels = rng.randint(0, 10, size=3)
        if layout == "py":
            with open(os.path.join(d, name), "wb") as f:
                pickle.dump({b"data": data, b"labels": labels.tolist()}, f)
        else:
            rows = np.concatenate([labels[:, None].astype(np.uint8), data], 1)
            rows.tofile(os.path.join(d, name + ".bin"))
    for train in (True, False):
        t = tds.Cifar10DataSetIterator(4, train=train, root=root)
        j = jds.Cifar10DataSetIterator(4, train=train, root=root)
        assert not t.synthetic
        _assert_same_batches(t, j)
        assert next(iter(t)).features.shape[1:] == (32, 32, 3)


@pytest.mark.parametrize("name", sorted(jds.EMNIST_SETS))
def test_emnist_matches_jax(name, tmp_path):
    assert tds.EMNIST_SETS == jds.EMNIST_SETS
    root = str(tmp_path)
    t = tds.EmnistDataSetIterator(8, emnist_set=name, seed=4, root=root,
                                  num_examples=24)
    j = jds.EmnistDataSetIterator(8, emnist_set=name, seed=4, root=root,
                                  num_examples=24)
    assert t.synthetic and t.num_classes == jds.EMNIST_SETS[name]
    _assert_same_batches(t, j)


def test_emnist_letters_files_are_one_based(tmp_path):
    rng = np.random.RandomState(2)
    root = str(tmp_path)
    _write_idx(os.path.join(root, "emnist-letters-train-images-idx3-ubyte"),
               rng.randint(0, 256, size=(10, 28, 28)))
    _write_idx(os.path.join(root, "emnist-letters-train-labels-idx1-ubyte"),
               np.r_[1, 26, rng.randint(1, 27, size=8)], gz=True)
    t = tds.EmnistDataSetIterator(5, emnist_set="letters", root=root)
    j = jds.EmnistDataSetIterator(5, emnist_set="letters", root=root)
    assert not t.synthetic
    _assert_same_batches(t, j)
    with pytest.raises(ValueError, match="unknown EMNIST set"):
        tds.EmnistDataSetIterator(5, emnist_set="nope", root=root)


def _transforms(pkg):
    return [pkg.FlipImageTransform(), pkg.RandomCropTransform(5, 6),
            pkg.RandomCropTransform(12, 3), pkg.RotateImageTransform(),
            pkg.RotateImageTransform((1, 3)), pkg.ColorJitterTransform(),
            pkg.PipelineImageTransform([(pkg.FlipImageTransform(), 0.5),
                                        (pkg.RandomCropTransform(6, 6), 0.7),
                                        (pkg.ColorJitterTransform(0.3, 0.1),
                                         0.9)])]


def test_image_transforms_match_jax_under_a_seed():
    img = np.random.RandomState(0).rand(8, 10, 3).astype(np.float32)
    for tt, jt in zip(_transforms(tds), _transforms(jds)):
        rt, rj = np.random.RandomState(5), np.random.RandomState(5)
        for _ in range(6):
            a, b = tt(img, rt), jt(img, rj)
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert rt.rand() == rj.rand()


def test_synthetic_imagenet_iterator_matches_jax():
    kw = dict(batch_size=3, height=12, width=10, channels=3, num_classes=7,
              batches_per_epoch=2, seed=9)
    t, j = tds.SyntheticImageNetIterator(**kw), jds.SyntheticImageNetIterator(
        **kw)
    assert t.batch_size == 3
    for _ in range(2):
        _assert_same_batches(t, j)


def test_image_record_reader_matches_jax(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(3)
    root = str(tmp_path)
    for label in ("cats", "dogs"):
        os.makedirs(os.path.join(root, label))
        for i in range(3):
            px = rng.randint(0, 256, size=(9, 7, 3)).astype(np.uint8)
            Image.fromarray(px).save(os.path.join(root, label, f"{i}.png"))
        with open(os.path.join(root, label, "notes.txt"), "w") as f:
            f.write("not an image")
    kw = dict(height=6, width=5, batch_size=4, seed=2)
    t = tds.ImageRecordReader(root, transform=tds.FlipImageTransform(), **kw)
    j = jds.ImageRecordReader(root, transform=jds.FlipImageTransform(), **kw)
    assert t.labels == j.labels == ["cats", "dogs"]
    assert len(t.files) == 6 and t.batch_size == 4
    for _ in range(2):
        _assert_same_batches(t, j)
    shard = tds.ImageRecordReader(root, **kw).shard_files(1, 2)
    assert shard.files == jds.ImageRecordReader(root, **kw).shard_files(
        1, 2).files
    assert len(shard.files) == 3
