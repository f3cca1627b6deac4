"""Graph importers of the port: TF GraphDefs / SavedModels and ONNX
ModelProtos → a port SameDiff.

Counterpart of ``deeplearning4j_tpu/imports``: the wire codec
(:mod:`.protowire`), TensorFlow's schemas (:mod:`.tf_proto`) and
checkpoint format (:mod:`.tensor_bundle`), the framework-neutral IR walker
(:mod:`.ir`), the TF front end (:mod:`.tf_import`: ``import_frozen_graph``,
``import_saved_model``), the ONNX front end (:mod:`.onnx_import`:
``import_onnx``) and the :class:`GraphRunner` over both. The Keras importer
is not ported yet (ROADMAP.md, Queue 1 item 7).
"""

from deeplearning4j_tpu_torch.imports.ir import IRGraph, IRImporter, IRNode
from deeplearning4j_tpu_torch.imports.tf_import import (
    TensorflowImporter,
    import_frozen_graph,
    import_saved_model,
    register_tf_op,
)
from deeplearning4j_tpu_torch.imports.onnx_import import (
    OnnxImporter,
    import_onnx,
    parse_model,
    register_onnx_op,
)
from deeplearning4j_tpu_torch.imports.graph_runner import GraphRunner

__all__ = ["IRGraph", "IRImporter", "IRNode", "TensorflowImporter",
           "import_frozen_graph", "import_saved_model", "register_tf_op",
           "OnnxImporter", "import_onnx", "parse_model", "register_onnx_op",
           "GraphRunner"]
