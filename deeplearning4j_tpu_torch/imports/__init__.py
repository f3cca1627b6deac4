"""Graph importers of the port: ONNX ModelProto bytes → a port SameDiff.

Counterpart of ``deeplearning4j_tpu/imports``: the wire codec
(:mod:`.protowire`), the framework-neutral IR walker (:mod:`.ir`) and the
ONNX front end (:mod:`.onnx_import`, entry point :func:`import_onnx`). The
TF and Keras importers and the graph runner are not ported yet
(ROADMAP.md, Queue 1 item 6).
"""

from deeplearning4j_tpu_torch.imports.onnx_import import (
    OnnxImporter, import_onnx, parse_model,
)

__all__ = ["OnnxImporter", "import_onnx", "parse_model"]
