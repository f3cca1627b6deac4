"""Model zips: ModelSerializer's layout, the JAX package's bytes.

Counterpart of ``deeplearning4j_tpu/nn/serde.py`` ``save_model`` (:77)
and ``restore_model`` (:94). The zip holds, in this order:
``configuration.json`` (the configuration's JSON), ``coefficients.bin``
(the flat parameter vector, float32 little-endian), ``netState.bin``
(the layers' state, e.g. BatchNormalization's running statistics, the
same way), ``meta.json`` (``iteration_count``, ``epoch_count``) and, when
saved, ``updaterState.bin`` (the flat updater state). Flat order is the
JAX package's ``_sorted_leaves`` order, so a zip the JAX package saves
restores here and the reverse. Normalizers are not ported yet: saving one
raises, and ``restore_normalizer`` waits with them (ROADMAP).
"""

from __future__ import annotations

import json
import zipfile

import numpy as np

from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, flatten_trees, unflatten_trees)

_F32_LE = np.dtype("<f4")


def save_model(net: MultiLayerNetwork, path: str, save_updater: bool = True,
               normalizer=None) -> None:
    """ModelSerializer.writeModel."""
    if normalizer is not None:
        raise NotImplementedError(
            "normalizers are not ported to deeplearning4j_tpu_torch yet")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("configuration.json", net.conf.to_json())
        z.writestr("coefficients.bin",
                   net.params_flat().astype(_F32_LE).tobytes())
        z.writestr("netState.bin", flatten_trees(net.net_state).astype(
            _F32_LE).tobytes())
        z.writestr("meta.json", json.dumps(
            {"iteration_count": net.iteration_count,
             "epoch_count": net.epoch_count}))
        if save_updater and net.opt_state is not None:
            z.writestr("updaterState.bin",
                       net.updater_state_flat().astype(_F32_LE).tobytes())


def restore_model(path: str, load_updater: bool = True,
                  device=None) -> MultiLayerNetwork:
    """ModelSerializer.restoreMultiLayerNetwork, onto ``device``
    (``"cuda"`` unless the caller passes ``device="cpu"``)."""
    with zipfile.ZipFile(path, "r") as z:
        names = z.namelist()
        conf = MultiLayerConfiguration.from_json(
            z.read("configuration.json").decode())
        net = MultiLayerNetwork(conf, device=device).init()
        net.set_params_flat(np.frombuffer(z.read("coefficients.bin"),
                                          _F32_LE))
        if "netState.bin" in names:
            net.net_state, _ = unflatten_trees(
                net.net_state, np.frombuffer(z.read("netState.bin"),
                                             _F32_LE), net.device)
        if "meta.json" in names:
            meta = json.loads(z.read("meta.json").decode())
            net.iteration_count = meta.get("iteration_count", 0)
            net.epoch_count = meta.get("epoch_count", 0)
        if load_updater and "updaterState.bin" in names:
            net.set_updater_state_flat(np.frombuffer(
                z.read("updaterState.bin"), _F32_LE))
    return net
