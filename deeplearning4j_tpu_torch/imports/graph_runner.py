"""GraphRunner — run imported TF/ONNX graphs directly.

Counterpart of ``deeplearning4j_tpu/imports/graph_runner.py`` (reference:
nd4j-tensorflow's ``GraphRunner`` and nd4j-onnxruntime's
``OnnxRuntimeRunner``): instead of embedding the TF C API or onnxruntime,
the model is converted ONCE through the port's importers into a SameDiff
graph on the card and run as the port runs its own graphs (the optimizer's
fusions, one CUDA-graph capture per feed signature). Feed/fetch names
match the source graph's tensor names, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch


def _sniff_framework(data: bytes) -> str:
    """Distinguish ONNX ModelProto from TF GraphDef by the leading wire tag:
    ModelProto field 1 (ir_version) is a varint → first byte 0x08; GraphDef
    field 1 (node, repeated message) is length-delimited → 0x0A."""
    if not data:
        raise ValueError("empty graph bytes")
    if data[0] == 0x08:
        return "onnx"
    if data[0] == 0x0A:
        return "tensorflow"
    raise ValueError(
        "cannot sniff framework from graph bytes (expected an ONNX "
        "ModelProto or TF GraphDef); pass framework= explicitly")


class GraphRunner:
    """Load a frozen TF GraphDef or ONNX ModelProto and run it.

    ``graph``: a file path (.pb / .onnx), raw protobuf bytes, or an already
    imported SameDiff. ``framework``: 'tensorflow' | 'onnx' | None (sniffed
    from the extension or wire format). ``outputs``: default fetch names
    (falls back to the graph's recorded outputs/terminal nodes).
    ``optimize``: run the graph optimizer on the imported graph (None =
    importer default, i.e. on; for an already-built SameDiff, None leaves
    its own flag untouched); per-compile instrumentation is surfaced as
    :attr:`compile_stats`. ``device``: where an imported graph lives (the
    card when None; unused for a SameDiff).
    """

    def __init__(self, graph: Union[str, bytes, Any], *,
                 framework: Optional[str] = None,
                 outputs: Optional[Sequence[str]] = None,
                 optimize: Optional[bool] = None,
                 device: Union[str, torch.device, None] = None):
        from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff

        if isinstance(graph, SameDiff):
            self.sd = graph
            if optimize is not None:
                self.sd.optimize = optimize
        else:
            optimize = True if optimize is None else optimize
            data = graph
            if isinstance(graph, str):
                if framework is None:
                    low = graph.lower()
                    if low.endswith(".onnx"):
                        framework = "onnx"
                    elif low.endswith((".pb", ".graphdef")):
                        framework = "tensorflow"
                with open(graph, "rb") as f:
                    data = f.read()
            if framework is None:
                framework = _sniff_framework(bytes(data[:1]))
            if framework == "onnx":
                from deeplearning4j_tpu_torch.imports.onnx_import import (
                    import_onnx)
                self.sd = import_onnx(data, optimize=optimize, device=device)
            elif framework in ("tensorflow", "tf"):
                from deeplearning4j_tpu_torch.imports.tf_import import (
                    TensorflowImporter)
                self.sd = TensorflowImporter(device=device).run_import(
                    data, optimize=optimize)
            else:
                raise ValueError(f"unknown framework {framework!r}")
        self.framework = framework
        self._outputs = list(outputs) if outputs else list(
            getattr(self.sd, "graph_outputs", []) or [])
        if not self._outputs:
            raise ValueError("graph has no recorded outputs; pass outputs=")

    # ------------------------------------------------------------------ api
    @property
    def input_names(self) -> List[str]:
        return list(getattr(self.sd, "graph_inputs", []) or [])

    @property
    def output_names(self) -> List[str]:
        return list(self._outputs)

    @property
    def compile_stats(self):
        """OptimizeStats of the most recent compilation (None before the
        first run) — per-pass node deltas, fusion counts, capture
        seconds."""
        return self.sd.last_compile_stats

    def run(self, feeds: Dict[str, Any],
            outputs: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        """Execute with named feeds; returns {fetch_name: np.ndarray}.
        (GraphRunner.run(Map<String, INDArray>) parity.)"""
        fetch = list(outputs) if outputs else self._outputs
        return self.sd.output(feeds, fetch)

    __call__ = run
