"""Synthetic ImageNet-shaped data.

Counterpart of ``deeplearning4j_tpu/datasets/image.py:179``
``synthetic_image_batch``, copied: pure numpy, so the same seed gives the
same batch in both packages.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
