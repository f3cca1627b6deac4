"""The zoo's vision workloads on the card: cells, data and FLOP counts.

``chip_smoke.py``'s ``zoo_cnn`` phase trains each trainable model of the
zoo at its defaults (the reference's constructor defaults: full width,
the input size the zoo sets) on synthetic batches drawn from a seed, and
serves the two detectors; this module holds what the phase and a CPU
rehearsal share:

* :data:`TRAIN` — (model, batch, updater) for the nine trainable models;
  the updater named is the zoo default the phase checks it got;
* :data:`DETECT` — the detectors at 416×416×3, batch 8;
* :func:`batches` — ``steps`` synthetic batches and one held batch;
* :func:`step_flops` — the multiply-adds of a step counted from the
  convolution and dense shapes (×2 for FLOPs): forward, weight gradient,
  and input gradient for every such layer not fed by the network input.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# (zoo class, batch, the zoo's default updater)
TRAIN: List[Tuple[str, int, str]] = [
    ("SimpleCNN", 64, "Adam"),
    ("AlexNet", 128, "Nesterovs"),
    ("VGG16", 32, "Nesterovs"),
    ("VGG19", 32, "Nesterovs"),
    ("Darknet19", 64, "Nesterovs"),
    ("SqueezeNet", 64, "Adam"),
    ("UNet", 16, "Adam"),
    ("Xception", 32, "Adam"),
    ("InceptionResNetV1", 64, "RmsProp"),
]
DETECT: List[Tuple[str, int]] = [("TinyYOLO", 8), ("YOLO2", 8)]


def batches(zoo, batch: int, steps: int, seed: int = 500):
    """``steps`` training batches and one held batch for ``zoo`` (a zoo
    model instance): synthetic class textures with one-hot labels, or for
    UNet a per-pixel 0/1 target of its output's shape."""
    from deeplearning4j_tpu_torch.datasets import synthetic_image_batch

    h, w, c = zoo.input_shape
    classes = getattr(zoo, "num_classes", None)
    out = []
    for i in range(steps + 1):
        x, lab = synthetic_image_batch(batch, h, w, c, classes or 2,
                                       seed=seed + i)
        if classes is None:  # UNet: a mask per pixel
            y = (x[..., :1] > 0.5).astype(np.float32)
        else:
            y = np.eye(classes, dtype=np.float32)[lab]
        out.append((x, y))
    return out[:steps], out[steps]


def _layer_macs(layer, batch: int) -> int:
    """Multiply-adds of one layer's forward at ``batch`` (convolutions
    and dense layers; 0 for the rest)."""
    from deeplearning4j_tpu_torch.nn import conf as C

    lc, it, ot = layer.lc, layer.itype, layer.otype
    if isinstance(lc, C.DenseLayer):
        return batch * lc.n_in * lc.n_out
    if not isinstance(lc, C.ConvolutionLayer):
        return 0
    kh, kw = C._pair(lc.kernel)
    out_px = batch * ot.height * ot.width
    if isinstance(lc, C.Deconvolution2D):
        return batch * it.height * it.width * lc.n_in * lc.n_out * kh * kw
    if isinstance(lc, C.DepthwiseConvolution2D):
        return out_px * lc.n_in * lc.depth_multiplier * kh * kw
    if isinstance(lc, C.SeparableConvolution2D):
        mid = lc.n_in * lc.depth_multiplier
        return out_px * mid * (kh * kw + lc.n_out)
    return out_px * lc.n_in * lc.n_out * kh * kw


def step_flops(net, batch: int) -> Dict[str, int]:
    """FLOPs (2 × multiply-adds) of one training step and of a forward
    of ``net`` (a MultiLayerNetwork or a ComputationGraph) at ``batch``,
    from its convolution and dense shapes."""
    if isinstance(net.layers, dict):  # ComputationGraph
        inputs = set(net.conf.network_inputs)
        layers = [(net.layers[n.name], bool(inputs & set(n.inputs)))
                  for n in net.conf.nodes if n.kind == "layer"]
    else:
        layers = [(layer, i == 0) for i, layer in enumerate(net.layers)]
    forward = backward = 0
    for layer, first in layers:
        macs = _layer_macs(layer, batch)
        forward += macs
        backward += macs if first else 2 * macs
    return {"forward": 2 * forward, "step": 2 * (forward + backward)}
