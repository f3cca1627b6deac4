"""Graph checks over layer-level networks (``MultiLayerNetwork`` /
``ComputationGraph`` — the Keras import targets).

Counterpart of ``deeplearning4j_tpu/analysis/network.py``. Keras models do
not lower into SameDiff recordings; they assemble layer stacks whose shape
algebra is the ``InputType`` propagation of ``nn/conf.py`` /
``nn/graph.py``. This module replays that propagation and turns every
failure into the GC-coded :class:`~.report.CheckReport` the graph walk
produces, so the Keras importers verify before they run as the ONNX and TF
importers do:

* a layer whose ``output_type`` raises (rank/arity mismatch) → GC001;
* a layer whose declared ``n_in`` contradicts the propagated input size
  → GC002;
* a DAG that fails to sort (a cycle, a missing vertex input) → GC004.
"""

from __future__ import annotations

import time
from typing import List

from deeplearning4j_tpu_torch.analysis.findings import Finding, make_finding
from deeplearning4j_tpu_torch.analysis.report import CheckReport


def _layer_label(lc, i: int) -> str:
    return f"layer[{i}] {type(lc).__name__}"


def _check_layer_chain(conf, layers, itype, graph_name: str,
                       findings: List[Finding]) -> None:
    from deeplearning4j_tpu_torch.nn import conf as C

    for i, lc in enumerate(layers):
        pre = getattr(conf, "preprocessors", {}).get(i) if conf else None
        if pre is not None and itype is not None:
            if isinstance(pre, C.FeedForwardToCnnPreProcessor):
                itype = C.InputType.convolutional(pre.height, pre.width,
                                                  pre.channels)
            elif isinstance(pre, C.CnnToFeedForwardPreProcessor):
                itype = C.InputType.feed_forward(
                    pre.height * pre.width * pre.channels)
        if itype is not None and itype.kind == "feedforward" and \
                isinstance(lc, (C.DenseLayer, C.OutputLayer)):
            declared = getattr(lc, "n_in", 0)
            if declared and itype.size and declared != itype.size:
                findings.append(make_finding(
                    graph_name, i, "GC002",
                    f"{_layer_label(lc, i)}: declared n_in={declared} but "
                    f"the propagated input size is {itype.size}"))
        try:
            itype = lc.output_type(itype) if itype is not None else None
        except Exception as exc:  # noqa: BLE001 — converted to a finding
            findings.append(make_finding(
                graph_name, i, "GC001",
                f"{_layer_label(lc, i)}: output_type failed on input "
                f"{itype}: {type(exc).__name__}: {exc}"))
            itype = None


def check_network(net, graph_name: str = "<network>") -> CheckReport:
    """Static shape check of a built MultiLayerNetwork / ComputationGraph
    (or a bare configuration)."""
    t0 = time.perf_counter()
    findings: List[Finding] = []
    conf = getattr(net, "conf", net)

    nodes = getattr(conf, "nodes", None)
    if nodes is not None:  # ComputationGraph(Configuration)
        from deeplearning4j_tpu_torch.nn import conf as C

        itypes = {}
        for name in getattr(conf, "network_inputs", []):
            it = conf.input_types.get(name, C.InputType.feed_forward(0))
            if it.kind == "convolutionalflat":
                it = C.InputType.convolutional(it.height, it.width,
                                               it.channels)
            itypes[name] = it
        done = set(itypes)
        remaining = list(nodes)
        order = []
        while remaining:
            progress = False
            for n in list(remaining):
                if all(i in done for i in n.inputs):
                    order.append(n)
                    done.add(n.name)
                    remaining.remove(n)
                    progress = True
            if not progress:
                findings.append(make_finding(
                    graph_name, len(order), "GC004",
                    f"graph has a cycle or missing inputs: "
                    f"{[n.name for n in remaining]}"))
                break
        for i, node in enumerate(order):
            in_types = [itypes.get(x) for x in node.inputs]
            try:
                if node.kind == "vertex":
                    itypes[node.name] = node.vertex.output_type(in_types)
                else:
                    it = in_types[0]
                    needs_ff = isinstance(
                        node.layer, (C.DenseLayer, C.OutputLayer,
                                     C.EmbeddingLayer))
                    if it is not None and needs_ff and it.kind in (
                            "convolutional", "convolutional3d"):
                        # the runtime inserts the flatten (graph._infer_layer)
                        it = C.InputType.feed_forward(it.flat_size())
                    itypes[node.name] = node.layer.output_type(it)
            except Exception as exc:  # noqa: BLE001 — converted to a finding
                findings.append(make_finding(
                    graph_name, i, "GC001",
                    f"node '{node.name}' ({node.kind}): output_type failed "
                    f"on {in_types}: {type(exc).__name__}: {exc}"))
                itypes[node.name] = None
        return CheckReport(graph_name, findings,
                           seconds=time.perf_counter() - t0)

    layers = getattr(conf, "layers", None)
    if layers is not None:
        _check_layer_chain(conf, layers, getattr(conf, "input_type", None),
                           graph_name, findings)
    return CheckReport(graph_name, findings,
                       seconds=time.perf_counter() - t0)
