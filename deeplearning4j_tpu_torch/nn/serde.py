"""Model zips: ModelSerializer's layout, the JAX package's bytes.

Counterpart of ``deeplearning4j_tpu/nn/serde.py`` ``save_model`` (:77),
``restore_model`` (:94) and ``restore_normalizer`` (:122), and of
``deeplearning4j_tpu/nn/graph.py`` ``save_graph`` (:1133) /
``restore_graph`` (:1152), which here are one writer and one reader for
either network. The zip holds, in this order:
``configuration.json`` (the configuration's JSON), ``coefficients.bin``
(the flat parameter vector, float32 little-endian), for a
MultiLayerNetwork ``netState.bin`` (the layers' state, e.g.
BatchNormalization's running statistics, the same way; a
ComputationGraph's zip has none, as the JAX package writes it, so a
restored graph starts from fresh layer state), ``meta.json``
(``iteration_count``, ``epoch_count``, and ``model_type`` for a
ComputationGraph), when saved ``updaterState.bin`` (the flat updater
state) and, when given, ``normalizer.json`` (the normalizer's class and
``state()``, read back by :func:`restore_normalizer`). Flat order is the
JAX package's (``_sorted_leaves`` by layer, and by sorted layer name for
a graph), so a zip the JAX package saves restores here and the reverse.
"""

from __future__ import annotations

import json
import zipfile

import numpy as np

from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, flatten_trees, unflatten_trees)

_F32_LE = np.dtype("<f4")
_GRAPH = "ComputationGraph"


def save_model(net, path: str, save_updater: bool = True,
               normalizer=None) -> None:
    """ModelSerializer.writeModel for a MultiLayerNetwork or a
    ComputationGraph (with the normalizer's statistics when
    ``normalizer`` is given)."""
    graph = isinstance(net, ComputationGraph)
    meta = {"iteration_count": net.iteration_count,
            "epoch_count": net.epoch_count}
    if graph:
        meta["model_type"] = _GRAPH
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("configuration.json", net.conf.to_json())
        z.writestr("coefficients.bin",
                   net.params_flat().astype(_F32_LE).tobytes())
        if not graph:
            z.writestr("netState.bin", flatten_trees(net.net_state).astype(
                _F32_LE).tobytes())
        z.writestr("meta.json", json.dumps(meta))
        if save_updater and net.opt_state is not None:
            z.writestr("updaterState.bin",
                       net.updater_state_flat().astype(_F32_LE).tobytes())
        if normalizer is not None:
            state = {k: np.asarray(v).tolist()
                     for k, v in normalizer.state().items()}
            z.writestr("normalizer.json", json.dumps(
                {"@type": type(normalizer).__name__, "state": state}))


def restore_model(path: str, load_updater: bool = True, device=None):
    """ModelSerializer.restoreMultiLayerNetwork, or
    restoreComputationGraph where ``meta.json`` names that model type,
    onto ``device`` (``"cuda"`` unless the caller passes
    ``device="cpu"``)."""
    with zipfile.ZipFile(path, "r") as z:
        names = z.namelist()
        meta = (json.loads(z.read("meta.json").decode())
                if "meta.json" in names else {})
        conf_json = z.read("configuration.json").decode()
        if meta.get("model_type") == _GRAPH:
            net = ComputationGraph(ComputationGraphConfiguration.from_json(
                conf_json), device=device).init()
        else:
            net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
                conf_json), device=device).init()
        net.set_params_flat(np.frombuffer(z.read("coefficients.bin"),
                                          _F32_LE))
        if "netState.bin" in names:
            net.net_state, _ = unflatten_trees(
                net.net_state, np.frombuffer(z.read("netState.bin"),
                                             _F32_LE), net.device)
        net.iteration_count = meta.get("iteration_count", 0)
        net.epoch_count = meta.get("epoch_count", 0)
        if load_updater and "updaterState.bin" in names:
            net.set_updater_state_flat(np.frombuffer(
                z.read("updaterState.bin"), _F32_LE))
    return net


def restore_normalizer(path: str):
    """ModelSerializer.restoreNormalizers: the normalizer a zip carries,
    or None."""
    from deeplearning4j_tpu_torch.datasets import dataset as D

    with zipfile.ZipFile(path, "r") as z:
        if "normalizer.json" not in z.namelist():
            return None
        d = json.loads(z.read("normalizer.json").decode())
    norm = getattr(D, d["@type"])()
    norm.load_state({k: np.asarray(v) for k, v in d["state"].items()})
    return norm
