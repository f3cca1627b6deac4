"""Transfer learning: graft, freeze and replace layers of a trained network.

Counterpart of ``deeplearning4j_tpu/nn/transfer.py`` (TransferLearning.java:
the builder's ``fineTuneConfiguration``, ``setFeatureExtractor``,
``removeOutputLayer`` / ``removeLayersFromOutput``, ``addLayer``,
``nOutReplace``; FineTuneConfiguration.java; TransferLearningHelper.java).

Frozen layers get the ``Frozen`` updater (a zero update): they stay in the
one training step, their backward still runs, and the fused updater's
``Frozen`` kind writes each leaf back bit for bit — the FrozenLayer effect.
:class:`TransferLearningHelper` runs the frozen prefix once over a
dataset (no gradients) and trains only the head on those activations.

The builders make the new network with ``init()`` (every parameter drawn
from the configuration's seed) and then copy the kept layers' parameters
and layer state from the source network, as tensors on the source's
device; re-initialized layers (added, ``n_out_replace``-d and their
consumers) keep the fresh draw. A kept layer's updater state is made anew
from the copied parameters: a fresh draw need not have their shapes (an
imported Keras attention layer's configuration leaves its input widths
0, as the reference's does, and only the imported arrays carry them).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, List, Optional

import torch

from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, ListDataSetIterator)
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, init_opt_state)
from deeplearning4j_tpu_torch.nn.updater import Frozen, get_updater


def _copy_tree(tree):
    """A parameter or state tree with every tensor copied (same device)."""
    from deeplearning4j_tpu_torch.models import _tree

    return _tree.map_tree(lambda t: t.detach().clone(), tree)


@dataclasses.dataclass
class FineTuneConfiguration:
    """FineTuneConfiguration.java: overrides applied to the network's
    configuration (the frozen layers keep their ``Frozen`` updater)."""

    updater: Any = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    weight_decay: Optional[float] = None
    seed: Optional[int] = None


def _apply_fine_tune(conf, ftc: Optional[FineTuneConfiguration]) -> None:
    """The FineTuneConfiguration overrides on a network configuration
    (both builders)."""
    if ftc is None:
        return
    if ftc.updater is not None:
        conf.updater = get_updater(ftc.updater)
    if ftc.l1 is not None:
        conf.l1 = ftc.l1
    if ftc.l2 is not None:
        conf.l2 = ftc.l2
    if ftc.weight_decay is not None:
        conf.weight_decay = ftc.weight_decay
    if ftc.seed is not None:
        conf.seed = ftc.seed


class TransferLearningBuilder:
    """TransferLearning.Builder for a MultiLayerNetwork."""

    def __init__(self, net: MultiLayerNetwork):
        self._src = net
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[int] = None
        self._remove_from: Optional[int] = None
        self._added: List[C.LayerConf] = []
        self._n_out_replace: dict = {}

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, layer_idx: int):
        """Freeze layers 0..layer_idx (inclusive): setFeatureExtractor."""
        self._freeze_until = layer_idx
        return self

    def remove_output_layer(self):
        self._remove_from = len(self._src.conf.layers) - 1
        return self

    def remove_layers_from_output(self, n: int):
        self._remove_from = len(self._src.conf.layers) - n
        return self

    def n_out_replace(self, layer_idx: int, n_out: int,
                      weight_init: str = "xavier"):
        """Replace a layer's n_out, re-initializing it and the next
        layer, whose n_in follows: nOutReplace."""
        self._n_out_replace[layer_idx] = (n_out, weight_init)
        return self

    def add_layer(self, lc: C.LayerConf):
        self._added.append(lc)
        return self

    def build(self) -> MultiLayerNetwork:
        src = self._src
        old_conf = src.conf
        keep_n = (self._remove_from if self._remove_from is not None
                  else len(old_conf.layers))
        new_layers = [copy.deepcopy(lc) for lc in old_conf.layers[:keep_n]]
        reinit = set()  # layers whose parameters keep the fresh draw

        for idx, (n_out, winit) in self._n_out_replace.items():
            new_layers[idx] = dataclasses.replace(
                new_layers[idx], n_out=n_out, weight_init=winit)
            reinit.add(idx)
            if (idx + 1 < len(new_layers)
                    and hasattr(new_layers[idx + 1], "n_in")):
                new_layers[idx + 1] = dataclasses.replace(
                    new_layers[idx + 1], n_in=n_out)
                reinit.add(idx + 1)

        if self._freeze_until is not None:
            for i in range(min(self._freeze_until + 1, len(new_layers))):
                new_layers[i] = dataclasses.replace(new_layers[i],
                                                    updater=Frozen())

        new_conf = copy.deepcopy(old_conf)
        _apply_fine_tune(new_conf, self._fine_tune)

        for lc in self._added:
            if hasattr(lc, "n_in") and getattr(lc, "n_in") == 0 and \
                    new_layers:
                # n_in from the kept stack's output type
                it = new_conf.input_type
                for i, kept in enumerate(new_layers):
                    pre = new_conf.preprocessors.get(i)
                    if isinstance(pre, C.FeedForwardToCnnPreProcessor):
                        it = C.InputType.convolutional(pre.height, pre.width,
                                                       pre.channels)
                    elif isinstance(pre, C.CnnToFeedForwardPreProcessor):
                        it = C.InputType.feed_forward(
                            pre.height * pre.width * pre.channels)
                    it = kept.output_type(it)
                size = (it.size if it.kind in ("feedforward", "recurrent")
                        else it.flat_size())
                lc = dataclasses.replace(lc, n_in=size)
            new_layers.append(lc)
            reinit.add(len(new_layers) - 1)

        new_conf.layers = new_layers
        new_conf.preprocessors = {i: p for i, p in
                                  new_conf.preprocessors.items()
                                  if i < len(new_layers)}
        out = MultiLayerNetwork(new_conf, device=src.device).init()
        for i in range(len(new_layers)):
            if i < keep_n and i not in reinit and i < len(src.params):
                out.params[i] = _copy_tree(src.params[i])
                out.net_state[i] = _copy_tree(src.net_state[i])
                out.opt_state[i] = init_opt_state(out.updaters[i],
                                                  out.params[i])
        return out


class TransferLearning:
    """Entry point: ``TransferLearning.builder(net)...build()``."""

    @staticmethod
    def builder(net: MultiLayerNetwork) -> TransferLearningBuilder:
        return TransferLearningBuilder(net)


class TransferLearningHelper:
    """TransferLearningHelper.java: run the frozen prefix (layers
    0..frozen_until) once a dataset and train only the unfrozen tail on
    its activations."""

    def __init__(self, net: MultiLayerNetwork, frozen_until: int):
        self.net = net
        self.frozen_until = frozen_until
        head_conf = copy.deepcopy(net.conf)
        head_conf.layers = [copy.deepcopy(lc)
                            for lc in net.conf.layers[frozen_until + 1:]]
        head_conf.preprocessors = {
            i - (frozen_until + 1): p
            for i, p in net.conf.preprocessors.items() if i > frozen_until}
        self.head = MultiLayerNetwork(head_conf, device=net.device)
        self.head.init(params=[_copy_tree(p)
                               for p in net.params[frozen_until + 1:]])

    def _prefix(self, x, mask):
        from deeplearning4j_tpu_torch.nn import dtype as DT
        from deeplearning4j_tpu_torch.nn.layers import apply_preprocessor

        net = self.net
        with torch.no_grad(), DT.precision_scope(net.conf.dtype):
            for i, layer in enumerate(net.layers[:self.frozen_until + 1]):
                x = apply_preprocessor(net.conf.preprocessors.get(i), x)
                x, _, mask = layer.apply(net.params[i], x, net.net_state[i],
                                         train=False, rng=None, mask=mask)
        return x, mask

    def featurize(self, ds: DataSet) -> DataSet:
        """The dataset with its features replaced by the frozen prefix's
        activations (and the prefix's output mask)."""
        from deeplearning4j_tpu_torch import observe
        from deeplearning4j_tpu_torch.nn import dtype as DT

        x = self.net._feed(ds.features)
        fm = self.net._feed(ds.features_mask)
        # featurize runs once a dataset: a new dataset shape is a new
        # signature of the prefix forward in the ledger
        observe.note_jit_signature(
            self._prefix, graph="transfer", key="prefix_forward",
            signature=observe.signature_of(x=ds.features,
                                           mask=ds.features_mask))
        feats, out_mask = self._prefix(x, fm)
        return DataSet(DT.host_array(feats), ds.labels,
                       None if out_mask is None else DT.host_array(out_mask),
                       ds.labels_mask)

    def fit_featurized(self, ds_or_iter, epochs: int = 1,
                       batch_size: int = 32):
        if isinstance(ds_or_iter, DataSet):
            self.head.fit(ListDataSetIterator(ds_or_iter,
                                              batch_size=batch_size),
                          epochs=epochs)
        else:
            self.head.fit(ds_or_iter, epochs=epochs)
        # the head's parameters and layer state back into the full network
        for j, p in enumerate(self.head.params):
            self.net.params[self.frozen_until + 1 + j] = p
            self.net.net_state[self.frozen_until + 1 + j] = \
                self.head.net_state[j]

    def unfrozen_mln(self) -> MultiLayerNetwork:
        return self.head


class GraphTransferLearningBuilder:
    """TransferLearning.GraphBuilder for a ComputationGraph: freeze a
    feature extractor by vertex name, remove or replace heads, graft new
    layers and vertices, keep the source's parameters for untouched
    layers."""

    def __init__(self, net):
        from deeplearning4j_tpu_torch.nn import graph as G

        self._G = G
        self._src = net
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_at: List[str] = []
        self._removed: List[str] = []
        self._added: List[Any] = []  # _GraphNode
        self._n_out_replace: dict = {}
        self._outputs: Optional[List[str]] = None

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, *names: str):
        """Freeze the named vertices and every ancestor feeding them."""
        self._freeze_at.extend(names)
        return self

    def remove_vertex_and_connections(self, name: str):
        self._removed.append(name)
        return self

    def n_out_replace(self, layer_name: str, n_out: int,
                      weight_init: str = "xavier"):
        self._n_out_replace[layer_name] = (n_out, weight_init)
        return self

    def add_layer(self, name: str, lc: C.LayerConf, *inputs: str):
        self._added.append(self._G._GraphNode(name=name, kind="layer",
                                              layer=lc, inputs=list(inputs)))
        return self

    def add_vertex(self, name: str, vertex, *inputs: str):
        if isinstance(vertex, C.LayerConf):
            return self.add_layer(name, vertex, *inputs)
        self._added.append(self._G._GraphNode(name=name, kind="vertex",
                                              vertex=vertex,
                                              inputs=list(inputs)))
        return self

    def set_outputs(self, *names: str):
        self._outputs = list(names)
        return self

    def build(self):
        G = self._G
        src = self._src
        conf = copy.deepcopy(src.conf)

        # a kept node left consuming a removed name is caught by the
        # produced-set check below; ComputationGraph re-sorts the nodes
        removed = set(self._removed)
        kept = [n for n in conf.nodes if n.name not in removed]

        reinit = set()
        by_name = {n.name: n for n in kept}
        for lname, (n_out, winit) in self._n_out_replace.items():
            node = by_name[lname]
            node.layer = dataclasses.replace(node.layer, n_out=n_out,
                                             weight_init=winit)
            reinit.add(lname)
            for n in kept:
                if (lname in n.inputs and n.layer is not None
                        and hasattr(n.layer, "n_in")):
                    n.layer = dataclasses.replace(n.layer, n_in=n_out)
                    reinit.add(n.name)

        if self._freeze_at:
            frozen = set()
            stack = list(self._freeze_at)
            while stack:
                cur = stack.pop()
                if cur in frozen or cur in conf.network_inputs:
                    continue
                frozen.add(cur)
                if cur in by_name:
                    stack.extend(by_name[cur].inputs)
            for n in kept:
                if n.name in frozen and n.layer is not None:
                    n.layer = dataclasses.replace(n.layer, updater=Frozen())

        _apply_fine_tune(conf, self._fine_tune)

        conf.nodes = kept + list(self._added)
        for a in self._added:
            reinit.add(a.name)
        if self._outputs is not None:
            conf.network_outputs = self._outputs
        produced = {n.name for n in conf.nodes} | set(conf.network_inputs)
        for n in conf.nodes:
            for i in n.inputs:
                if i not in produced:
                    raise ValueError(
                        f"vertex '{n.name}' consumes '{i}', which no longer "
                        f"exists — re-add it or remove '{n.name}' too")
        for o in conf.network_outputs:
            if o not in produced:
                raise ValueError(
                    f"network output '{o}' no longer exists — call "
                    f"set_outputs() with the new head name(s)")

        out = G.ComputationGraph(conf, device=src.device).init()
        for n in kept:
            if (n.kind == "layer" and n.name not in reinit
                    and src.params is not None and n.name in src.params):
                out.params[n.name] = _copy_tree(src.params[n.name])
                out.net_state[n.name] = _copy_tree(src.net_state[n.name])
                out.opt_state[n.name] = init_opt_state(
                    conf.layer_updater(out.layers[n.name].lc),
                    out.params[n.name])
        return out


def graph_transfer_builder(net) -> GraphTransferLearningBuilder:
    """TransferLearning.GraphBuilder(net)."""
    return GraphTransferLearningBuilder(net)
