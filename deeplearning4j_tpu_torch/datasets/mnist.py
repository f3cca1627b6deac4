"""MNIST-shaped dataset iterator, deeplearning4j-datasets parity.

Counterpart of ``deeplearning4j_tpu/datasets/mnist.py``
(MnistDataSetIterator / MnistDataFetcher), host numpy: the IDX files
under ``root`` (default ``~/.dl4jtpu/mnist``) when they exist, else the
deterministic synthetic stand-in (each class a smoothed random prototype
glyph; samples the prototype shifted by up to 2 pixels plus pixel noise),
whose draws are the JAX package's, so both give the same arrays. Nothing
is downloaded.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, ListDataSetIterator)

_DEFAULT_ROOT = os.path.expanduser("~/.dl4jtpu/mnist")


def parse_idx(buf: bytes) -> np.ndarray:
    """An IDX unsigned-byte container (magic 0x00000800 | ndim, big-endian
    dims, then the bytes) as a uint8 array of its shape; ValueError for a
    malformed or truncated buffer. The port's own numpy parse: the JAX
    package reads IDX files through its ``native_ops`` record loader,
    which the port does not have yet, and this gives the same array."""
    if len(buf) < 4 or buf[0] or buf[1] or buf[2] != 0x08:
        raise ValueError("not an unsigned-byte IDX buffer")
    ndim = buf[3]
    if len(buf) < 4 + 4 * ndim:
        raise ValueError("truncated IDX header")
    dims = struct.unpack(f">{ndim}I", buf[4:4 + 4 * ndim])
    total = int(np.prod(dims))
    if len(buf) < 4 + 4 * ndim + total:
        raise ValueError("truncated IDX data")
    return np.frombuffer(buf, np.uint8, count=total,
                         offset=4 + 4 * ndim).reshape(dims).copy()


def _load_idx(path: str) -> np.ndarray:
    """An IDX file (gzipped when its name ends in ``.gz``) as uint8."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return parse_idx(f.read())


def _find_idx(root: str, names) -> Optional[str]:
    for n in names:
        for ext in ("", ".gz"):
            p = os.path.join(root, n + ext)
            if os.path.exists(p):
                return p
    return None


def _smooth(img: np.ndarray, passes: int = 2) -> np.ndarray:
    for _ in range(passes):
        img = (
            img
            + np.roll(img, 1, 0) + np.roll(img, -1, 0)
            + np.roll(img, 1, 1) + np.roll(img, -1, 1)
        ) / 5.0
    return img


def synthetic_mnist(n: int, seed: int = 123, num_classes: int = 10,
                    proto_seed: int = 777) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic learnable digit-like data: (n, 784) float32 in [0,1],
    int labels (n,). Class prototypes come from ``proto_seed`` (shared across
    train/test splits); sample noise/shifts come from ``seed``."""
    proto_rng = np.random.RandomState(proto_seed)
    protos = []
    for _ in range(num_classes):
        p = _smooth(proto_rng.rand(28, 28) > 0.75, passes=3).astype(np.float32)
        p = p / max(p.max(), 1e-6)
        protos.append(p)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n)
    imgs = np.empty((n, 28, 28), np.float32)
    shifts = rng.randint(-2, 3, size=(n, 2))
    noise = rng.rand(n, 28, 28).astype(np.float32)
    for i, (lab, (dy, dx)) in enumerate(zip(labels, shifts)):
        img = np.roll(np.roll(protos[lab], dy, axis=0), dx, axis=1)
        imgs[i] = np.clip(img + 0.15 * (noise[i] - 0.5), 0.0, 1.0)
    return imgs.reshape(n, 784), labels


def _one_hot(labels: np.ndarray, n: int = 10) -> np.ndarray:
    out = np.zeros((labels.size, n), np.float32)
    out[np.arange(labels.size), labels] = 1.0
    return out


class MnistDataSetIterator(ListDataSetIterator):
    """MnistDataSetIterator analog: (N, 784) features in [0,1], one-hot labels.

    ``train=True`` serves the train split, else the test split. Falls back to
    synthetic data when IDX files are absent (flagged via ``self.synthetic``).
    """

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 root: str = _DEFAULT_ROOT, num_examples: Optional[int] = None):
        img_names = ["train-images-idx3-ubyte"] if train else ["t10k-images-idx3-ubyte"]
        lab_names = ["train-labels-idx1-ubyte"] if train else ["t10k-labels-idx1-ubyte"]
        img_path = _find_idx(root, img_names)
        lab_path = _find_idx(root, lab_names)
        if img_path and lab_path:
            self.synthetic = False
            imgs = _load_idx(img_path).astype(np.float32) / 255.0
            labels = _load_idx(lab_path)
            feats = imgs.reshape(imgs.shape[0], -1)
        else:
            self.synthetic = True
            n = num_examples or (4096 if train else 1024)
            feats, labels = synthetic_mnist(n, seed=seed + (0 if train else 1))
        if num_examples:
            feats, labels = feats[:num_examples], labels[:num_examples]
        super().__init__(DataSet(feats, _one_hot(labels)), batch_size=batch_size,
                         shuffle=train, seed=seed)
