"""The DL4J network API of the port: layer configs, the sequential
network (``MultiLayerNetwork``, its builder and model zips), the
ComputationGraph runtime, updaters and dtype policies (trained with
autograd)."""

from deeplearning4j_tpu_torch.nn.conf import (
    GRU, LSTM, ActivationLayer, BatchNormalization, Bidirectional,
    CnnToFeedForwardPreProcessor, ConvolutionLayer, DenseLayer, DropoutLayer,
    EmbeddingLayer, EmbeddingSequenceLayer, FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor, FusedBottleneck, GlobalPoolingLayer,
    GravesLSTM, InputPreProcessor, InputType, LastTimeStep, LayerConf,
    LossLayer, MultiLayerConfiguration, NeuralNetConfigurationBuilder,
    OutputLayer, RnnLossLayer, RnnOutputLayer, RnnToFeedForwardPreProcessor,
    SimpleRnn, SubsamplingLayer, builder,
)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, ElementWiseVertex,
    GraphBuilder, graph_builder,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.serde import restore_model, save_model
from deeplearning4j_tpu_torch.nn.updater import (
    UPDATERS, AdaDelta, AdaGrad, AdaMax, Adam, AmsGrad, Frozen, Nadam,
    Nesterovs, NoOp, RmsProp, Sgd, get_updater,
)

__all__ = [
    "GRU", "LSTM", "ActivationLayer", "BatchNormalization", "Bidirectional",
    "CnnToFeedForwardPreProcessor", "ConvolutionLayer", "DenseLayer",
    "DropoutLayer", "EmbeddingLayer", "EmbeddingSequenceLayer",
    "FeedForwardToCnnPreProcessor", "FeedForwardToRnnPreProcessor",
    "FusedBottleneck", "GlobalPoolingLayer", "GravesLSTM",
    "InputPreProcessor", "InputType", "LastTimeStep", "LayerConf",
    "LossLayer", "MultiLayerConfiguration", "NeuralNetConfigurationBuilder",
    "OutputLayer", "RnnLossLayer", "RnnOutputLayer",
    "RnnToFeedForwardPreProcessor", "SimpleRnn", "SubsamplingLayer",
    "builder", "ComputationGraph", "ComputationGraphConfiguration",
    "ElementWiseVertex", "GraphBuilder", "graph_builder",
    "MultiLayerNetwork", "restore_model", "save_model",
    "UPDATERS", "AdaDelta", "AdaGrad", "AdaMax", "Adam", "AmsGrad", "Frozen",
    "Nadam", "Nesterovs", "NoOp", "RmsProp", "Sgd", "get_updater",
]
