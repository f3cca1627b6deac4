"""CIFAR-10 and EMNIST dataset iterators.

Counterpart of ``deeplearning4j_tpu/datasets/cifar.py``
(Cifar10DataSetIterator, EmnistDataSetIterator and its splits), host
numpy: local files under ``root`` when they exist (CIFAR-10's python
pickle or binary batches, EMNIST's IDX files), else the deterministic
synthetic stand-ins, whose draws are the JAX package's. Nothing is
downloaded; ``self.synthetic`` says which was read.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.mnist import (
    _find_idx, _load_idx, _one_hot, _smooth, synthetic_mnist,
)

_DEFAULT_ROOT = os.path.expanduser("~/.deeplearning4j_tpu/datasets")


def synthetic_images(n: int, height: int, width: int, channels: int,
                     num_classes: int, seed: int = 123,
                     proto_seed: int = 991) -> Tuple[np.ndarray, np.ndarray]:
    """Learnable synthetic color images: class = smoothed color-blob
    prototype + per-sample shift/noise. (n, H, W, C) float32 in [0,1]."""
    proto_rng = np.random.RandomState(proto_seed)
    protos = []
    for _ in range(num_classes):
        chans = []
        for _c in range(channels):
            p = _smooth(proto_rng.rand(height, width) > 0.7, passes=3)
            chans.append(p.astype(np.float32))
        p = np.stack(chans, axis=-1)
        protos.append(p / max(p.max(), 1e-6))
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n)
    out = np.empty((n, height, width, channels), np.float32)
    shifts = rng.randint(-3, 4, size=(n, 2))
    for i, (lab, (dy, dx)) in enumerate(zip(labels, shifts)):
        img = np.roll(np.roll(protos[lab], dy, axis=0), dx, axis=1)
        noise = rng.rand(height, width, channels).astype(np.float32)
        out[i] = np.clip(img + 0.15 * (noise - 0.5), 0.0, 1.0)
    return out, labels


def _load_cifar_local(root: str, train: bool):
    """Read CIFAR-10 from the standard python pickle batches or the binary
    .bin batches if a user has placed them under root."""
    pydir = os.path.join(root, "cifar-10-batches-py")
    if os.path.isdir(pydir):
        names = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        xs, ys = [], []
        for nme in names:
            path = os.path.join(pydir, nme)
            if not os.path.exists(path):
                return None
            with open(path, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.uint8))
            ys.extend(d[b"labels"])
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32) / 255.0, np.asarray(ys, np.int64)
    bindir = os.path.join(root, "cifar-10-batches-bin")
    if os.path.isdir(bindir):
        names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        xs, ys = [], []
        for nme in names:
            path = os.path.join(bindir, nme)
            if not os.path.exists(path):
                return None
            raw = np.fromfile(path, np.uint8).reshape(-1, 3073)
            ys.append(raw[:, 0])
            xs.append(raw[:, 1:])
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32) / 255.0, np.concatenate(ys).astype(np.int64)
    return None


class Cifar10DataSetIterator(ListDataSetIterator):
    """Cifar10DataSetIterator analog: (N, 32, 32, 3) in [0,1] NHWC + one-hot
    10-class labels. Synthetic fallback when no local copy exists."""

    NUM_CLASSES = 10

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 root: str = _DEFAULT_ROOT,
                 num_examples: Optional[int] = None):
        loaded = _load_cifar_local(root, train)
        if loaded is not None:
            self.synthetic = False
            feats, labels = loaded
        else:
            self.synthetic = True
            n = num_examples or (4096 if train else 1024)
            feats, labels = synthetic_images(
                n, 32, 32, 3, self.NUM_CLASSES,
                seed=seed + (0 if train else 1))
        if num_examples:
            feats, labels = feats[:num_examples], labels[:num_examples]
        super().__init__(DataSet(feats, _one_hot(labels, self.NUM_CLASSES)),
                         batch_size=batch_size, shuffle=train, seed=seed)


# EMNIST split metadata (EmnistDataSetIterator.Set analog)
EMNIST_SETS = {
    "complete": 62, "merge": 47, "balanced": 47, "letters": 26,
    "digits": 10, "mnist": 10,
}


class EmnistDataSetIterator(ListDataSetIterator):
    """EmnistDataSetIterator analog: 28×28 grayscale flattened to (N, 784),
    classes per the chosen EMNIST split. Reads idx files named
    emnist-<set>-{train,test}-{images-idx3,labels-idx1}-ubyte from root;
    synthetic fallback otherwise."""

    def __init__(self, batch_size: int, emnist_set: str = "balanced",
                 train: bool = True, seed: int = 123,
                 root: str = _DEFAULT_ROOT,
                 num_examples: Optional[int] = None):
        if emnist_set not in EMNIST_SETS:
            raise ValueError(
                f"unknown EMNIST set {emnist_set!r}; known: "
                f"{sorted(EMNIST_SETS)}")
        self.emnist_set = emnist_set
        self.num_classes = EMNIST_SETS[emnist_set]
        split = "train" if train else "test"
        img = _find_idx(root, [f"emnist-{emnist_set}-{split}-images-idx3-ubyte"])
        lab = _find_idx(root, [f"emnist-{emnist_set}-{split}-labels-idx1-ubyte"])
        if img and lab:
            self.synthetic = False
            imgs = _load_idx(img).astype(np.float32) / 255.0
            labels = _load_idx(lab).astype(np.int64)
            # EMNIST letters labels are 1-based
            if emnist_set == "letters" and labels.min() == 1:
                labels = labels - 1
            feats = imgs.reshape(imgs.shape[0], -1)
        else:
            self.synthetic = True
            n = num_examples or (4096 if train else 1024)
            feats, labels = synthetic_mnist(
                n, seed=seed + (0 if train else 1),
                num_classes=self.num_classes)
        if num_examples:
            feats, labels = feats[:num_examples], labels[:num_examples]
        super().__init__(DataSet(feats, _one_hot(labels, self.num_classes)),
                         batch_size=batch_size, shuffle=train, seed=seed)
