"""Image data: the augmentation transforms, the file reader and the
synthetic ImageNet-shaped data.

Counterpart of ``deeplearning4j_tpu/datasets/image.py``, host numpy,
copied, so the same seed gives the same arrays in both packages:

* the datavec ImageTransform chain (flip, random crop, right-angle
  rotation, brightness/contrast jitter, a pipeline with per-stage
  probabilities), each called with the ``RandomState`` it draws from;
* :class:`ImageRecordReader` (datavec ImageRecordReader: the label is the
  parent directory's name), decoding with PIL where it is installed;
* :func:`synthetic_image_batch` (class-conditional random-frequency
  textures) and :class:`SyntheticImageNetIterator` over it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, DataSetIterator)


# ---------------------------------------------------------------------------
# Image transforms (datavec ImageTransform chain)
# ---------------------------------------------------------------------------


class ImageTransform:
    """Base transform: (H, W, C) float image -> image. Seeded per call."""

    def __call__(self, img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        raise NotImplementedError


class FlipImageTransform(ImageTransform):
    """FlipImageTransform.java: horizontal flip."""

    def __call__(self, img, rng):
        return img[:, ::-1]


class RandomCropTransform(ImageTransform):
    """CropImageTransform.java: random crop to (h, w), pad if needed."""

    def __init__(self, height: int, width: int):
        self.h, self.w = height, width

    def __call__(self, img, rng):
        H, W = img.shape[:2]
        if H < self.h or W < self.w:
            ph, pw = max(0, self.h - H), max(0, self.w - W)
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            H, W = img.shape[:2]
        y = rng.randint(0, H - self.h + 1)
        x = rng.randint(0, W - self.w + 1)
        return img[y : y + self.h, x : x + self.w]


class RotateImageTransform(ImageTransform):
    """RotateImageTransform.java: right-angle rotations (arbitrary-angle
    warps need cv2; right angles cover the augmentation role losslessly)."""

    def __init__(self, quarters: Sequence[int] = (0, 1, 2, 3)):
        self.quarters = list(quarters)

    def __call__(self, img, rng):
        k = self.quarters[rng.randint(len(self.quarters))]
        return np.rot90(img, k=k, axes=(0, 1)).copy()


class ColorJitterTransform(ImageTransform):
    """ColorConversionTransform-role: brightness/contrast jitter."""

    def __init__(self, brightness: float = 0.2, contrast: float = 0.2):
        self.brightness = brightness
        self.contrast = contrast

    def __call__(self, img, rng):
        b = 1.0 + self.brightness * (2 * rng.rand() - 1)
        c = 1.0 + self.contrast * (2 * rng.rand() - 1)
        mean = img.mean()
        return np.clip((img - mean) * c + mean * b, 0.0, 1.0)


class PipelineImageTransform(ImageTransform):
    """PipelineImageTransform.java: chain with per-stage probabilities."""

    def __init__(self, stages: Sequence[Tuple[ImageTransform, float]]):
        self.stages = list(stages)

    def __call__(self, img, rng):
        for t, prob in self.stages:
            if rng.rand() < prob:
                img = t(img, rng)
        return img


# ---------------------------------------------------------------------------
# File-based reader (ImageRecordReader) — used when real images exist on disk
# ---------------------------------------------------------------------------

_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".gif"}


def _load_image(path: str, height: int, width: int) -> np.ndarray:
    try:
        from PIL import Image  # pillow, where it is installed
    except ImportError as e:
        raise RuntimeError("PIL unavailable; file-based images unsupported") from e
    img = Image.open(path).convert("RGB").resize((width, height))
    return np.asarray(img, np.float32) / 255.0


class ImageRecordReader(DataSetIterator):
    """ImageRecordReader.java analog: label = parent directory name."""

    def __init__(self, root: str, height: int, width: int, batch_size: int = 32,
                 transform: Optional[ImageTransform] = None, seed: int = 0):
        self.root = root
        self.h, self.w = height, width
        self._bs = batch_size
        self.transform = transform
        self.seed = seed
        self.files: List[Tuple[str, int]] = []
        self.labels: List[str] = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        for li, lab in enumerate(self.labels):
            d = os.path.join(root, lab)
            for f in sorted(os.listdir(d)):
                if os.path.splitext(f)[1].lower() in _EXTS:
                    self.files.append((os.path.join(d, f), li))
        self._epoch = 0

    def shard_files(self, process_id: int = None, num_processes: int = None
                    ) -> "ImageRecordReader":
        """File-level sharding (``parallel.launch.host_shard``): this rank
        keeps ``files[pid::N]`` and reads only those."""
        from deeplearning4j_tpu_torch.parallel.launch import host_shard

        self.files = host_shard(self.files, process_id, num_processes)
        return self

    @property
    def batch_size(self):
        return self._bs

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self._epoch)
        self._epoch += 1
        order = rng.permutation(len(self.files))
        n_classes = len(self.labels)
        for i in range(0, len(order), self._bs):
            idx = order[i : i + self._bs]
            imgs, labs = [], []
            for j in idx:
                path, li = self.files[j]
                img = _load_image(path, self.h, self.w)
                if self.transform is not None:
                    img = self.transform(img, rng)
                imgs.append(img)
                labs.append(li)
            y = np.zeros((len(labs), n_classes), np.float32)
            y[np.arange(len(labs)), labs] = 1.0
            yield self._maybe_pre(DataSet(np.stack(imgs), y))


# ---------------------------------------------------------------------------
# Synthetic ImageNet-shaped data (no dataset ships with the repository)
# ---------------------------------------------------------------------------


def synthetic_image_batch(batch: int, height: int, width: int, channels: int,
                          num_classes: int, seed: int,
                          proto_seed: int = 4242
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional random-frequency textures: learnable,
    deterministic. Returns (NHWC float32 images in [0, 1.05], int labels)."""
    prng = np.random.RandomState(proto_seed)
    freqs = prng.rand(num_classes, channels, 4) * 0.3 + 0.05
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, batch)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    imgs = np.empty((batch, height, width, channels), np.float32)
    for i, lab in enumerate(labels):
        phase = rng.rand(channels, 2) * 6.28
        for c in range(channels):
            fy, fx, fy2, fx2 = freqs[lab, c]
            img = (np.sin(fy * yy + phase[c, 0]) * np.cos(fx * xx + phase[c, 1])
                   + 0.5 * np.sin(fy2 * yy + fx2 * xx))
            imgs[i, :, :, c] = img
    imgs = (imgs - imgs.min()) / max(imgs.max() - imgs.min(), 1e-6)
    imgs += 0.05 * rng.rand(*imgs.shape).astype(np.float32)
    return imgs.astype(np.float32), labels


class SyntheticImageNetIterator(DataSetIterator):
    """ImageNet-shaped iterator for throughput + convergence work when no
    real dataset exists on disk."""

    def __init__(self, batch_size: int = 32, height: int = 224, width: int = 224,
                 channels: int = 3, num_classes: int = 1000,
                 batches_per_epoch: int = 10, seed: int = 0):
        self._bs = batch_size
        self.h, self.w, self.c = height, width, channels
        self.num_classes = num_classes
        self.batches_per_epoch = batches_per_epoch
        self.seed = seed
        self._epoch = 0

    @property
    def batch_size(self):
        return self._bs

    def __iter__(self):
        base = self.seed + 100003 * self._epoch
        self._epoch += 1
        for b in range(self.batches_per_epoch):
            imgs, labels = synthetic_image_batch(
                self._bs, self.h, self.w, self.c, self.num_classes, base + b)
            y = np.zeros((self._bs, self.num_classes), np.float32)
            y[np.arange(self._bs), labels] = 1.0
            yield self._maybe_pre(DataSet(imgs, y))
