"""The DL4J network API of the port: layer configs, updaters, dtype
policies and the ComputationGraph runtime (trained with autograd)."""

from deeplearning4j_tpu_torch.nn.conf import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    FusedBottleneck, GlobalPoolingLayer, InputType, LayerConf, OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, ElementWiseVertex,
    GraphBuilder, graph_builder,
)
from deeplearning4j_tpu_torch.nn.updater import (
    UPDATERS, AdaDelta, AdaGrad, AdaMax, Adam, AmsGrad, Frozen, Nadam,
    Nesterovs, NoOp, RmsProp, Sgd, get_updater,
)

__all__ = [
    "ActivationLayer", "BatchNormalization", "ConvolutionLayer",
    "DenseLayer", "FusedBottleneck", "GlobalPoolingLayer", "InputType",
    "LayerConf", "OutputLayer", "SubsamplingLayer", "ComputationGraph",
    "ComputationGraphConfiguration", "ElementWiseVertex", "GraphBuilder",
    "graph_builder", "UPDATERS", "AdaDelta", "AdaGrad", "AdaMax", "Adam",
    "AmsGrad", "Frozen", "Nadam", "Nesterovs", "NoOp", "RmsProp", "Sgd",
    "get_updater",
]
