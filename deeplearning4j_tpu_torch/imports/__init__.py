"""Importers of the port: TF GraphDefs / SavedModels and ONNX
ModelProtos → a port SameDiff; Keras models → a port network.

Counterpart of ``deeplearning4j_tpu/imports``: the wire codec
(:mod:`.protowire`), TensorFlow's schemas (:mod:`.tf_proto`) and
checkpoint format (:mod:`.tensor_bundle`), the framework-neutral IR walker
(:mod:`.ir`), the TF front end (:mod:`.tf_import`: ``import_frozen_graph``,
``import_saved_model``), the ONNX front end (:mod:`.onnx_import`:
``import_onnx``), the :class:`GraphRunner` over both, and the Keras
importer (:mod:`.keras_import`: ``import_keras_model_and_weights`` for
legacy ``.h5`` and Keras-3 ``.keras`` files, ``import_keras_model`` for a
live model, ``import_keras_sequential_model_and_weights``; files read by
the port's own HDF5 reader, :mod:`.hdf5`) → a MultiLayerNetwork or a
ComputationGraph.
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
from deeplearning4j_tpu_torch.imports.keras_import import (
    KerasLayerMapper,
    import_keras_model,
    import_keras_model_and_weights,
    import_keras_sequential_model_and_weights,
    register_custom_layer,
)

__all__ = ["IRGraph", "IRImporter", "IRNode", "TensorflowImporter",
           "import_frozen_graph", "import_saved_model", "register_tf_op",
           "OnnxImporter", "import_onnx", "parse_model", "register_onnx_op",
           "GraphRunner", "KerasLayerMapper", "import_keras_model",
           "import_keras_model_and_weights",
           "import_keras_sequential_model_and_weights",
           "register_custom_layer"]
