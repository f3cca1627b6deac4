"""The DL4J network API of the port: layer configs (with the types the
Keras importer builds), the sequential
network (``MultiLayerNetwork``, its builder and model zips), the
ComputationGraph runtime with its vertices and zips, listeners, updaters
and dtype policies (trained with autograd)."""

from deeplearning4j_tpu_torch.nn.conf import (
    GRU, LSTM, ActivationLayer, BatchNormalization, Bidirectional,
    CnnToFeedForwardPreProcessor, ConvolutionLayer, Deconvolution2D,
    DenseLayer, DepthwiseConvolution2D, DropoutLayer, EmbeddingLayer,
    EmbeddingSequenceLayer, FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor, FusedBottleneck, GlobalPoolingLayer,
    GravesLSTM, InputPreProcessor, InputType, LastTimeStep, LayerConf,
    LocalResponseNormalization, LossLayer, MultiLayerConfiguration,
    NeuralNetConfigurationBuilder, OutputLayer, RnnLossLayer,
    RnnOutputLayer, RnnToFeedForwardPreProcessor, SeparableConvolution2D,
    SimpleRnn, SpaceToDepthLayer, SubsamplingLayer, Upsampling2D, builder,
)
from deeplearning4j_tpu_torch.nn.conf import (  # the Keras importer's
    AttentionVertex, CategoryEncodingLayer, CenterCropLayer, Cnn3DToFeedForwardPreProcessor,
    ConvLSTM2D, Convolution1D, Convolution3D, Cropping1D,
    Cropping2D, Cropping3D, Deconvolution1D, Deconvolution3D,
    DiscretizationLayer, DotAttentionLayer, EinsumDenseLayer, GroupNormalization,
    LayerNormalization, LocallyConnected1D, LocallyConnected2D, MaskZeroLayer,
    PermuteLayer, PReLULayer, RepeatVector, RescaleLayer,
    ReshapeLayer, ResizeLayer, SeparableConvolution1D, Subsampling1DLayer,
    Subsampling3DLayer, UnitNormLayer, Upsampling1D, Upsampling3D,
    ZeroPadding1DLayer, ZeroPadding3DLayer, ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, DotProductVertex,
    DuplicateToTimeSeriesVertex, ElementWiseVertex, FlattenVertex,
    GraphBuilder, L2NormalizeVertex, LastTimeStepVertex, MergeVertex,
    ReshapeVertex, ScaleVertex, ShiftVertex, StackVertex, SubsetVertex,
    UnstackVertex, graph_builder, restore_graph, save_graph,
)
from deeplearning4j_tpu_torch.nn.listeners import (
    CheckpointListener, CollectScoresIterationListener, EvaluativeListener,
    PerformanceListener, ScoreIterationListener, TimeIterationListener,
    TrainingListener,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.serde import (
    restore_model, restore_normalizer, save_model)
from deeplearning4j_tpu_torch.nn.updater import (
    UPDATERS, AdaDelta, AdaGrad, AdaMax, Adam, AmsGrad, Frozen, Nadam,
    Nesterovs, NoOp, RmsProp, Sgd, get_updater,
)

__all__ = [
    "GRU", "LSTM", "ActivationLayer", "BatchNormalization", "Bidirectional",
    "CnnToFeedForwardPreProcessor", "ConvolutionLayer", "Deconvolution2D",
    "DenseLayer", "DepthwiseConvolution2D", "DropoutLayer", "EmbeddingLayer",
    "EmbeddingSequenceLayer", "FeedForwardToCnnPreProcessor",
    "FeedForwardToRnnPreProcessor", "FusedBottleneck", "GlobalPoolingLayer",
    "GravesLSTM", "InputPreProcessor", "InputType", "LastTimeStep",
    "LayerConf", "LocalResponseNormalization", "LossLayer",
    "MultiLayerConfiguration", "NeuralNetConfigurationBuilder",
    "OutputLayer", "RnnLossLayer", "RnnOutputLayer",
    "RnnToFeedForwardPreProcessor", "SeparableConvolution2D", "SimpleRnn",
    "SpaceToDepthLayer", "SubsamplingLayer", "Upsampling2D", "builder",
    "AttentionVertex", "CategoryEncodingLayer", "CenterCropLayer",
    "Cnn3DToFeedForwardPreProcessor", "ConvLSTM2D", "Convolution1D",
    "Convolution3D", "Cropping1D", "Cropping2D", "Cropping3D",
    "Deconvolution1D", "Deconvolution3D", "DiscretizationLayer",
    "DotAttentionLayer", "EinsumDenseLayer", "GroupNormalization",
    "LayerNormalization", "LocallyConnected1D", "LocallyConnected2D",
    "MaskZeroLayer", "PermuteLayer", "PReLULayer", "RepeatVector",
    "RescaleLayer", "ReshapeLayer", "ResizeLayer", "SeparableConvolution1D",
    "Subsampling1DLayer", "Subsampling3DLayer", "UnitNormLayer",
    "Upsampling1D", "Upsampling3D", "ZeroPadding1DLayer",
    "ZeroPadding3DLayer", "ZeroPaddingLayer",
    "ComputationGraph", "ComputationGraphConfiguration",
    "DotProductVertex", "DuplicateToTimeSeriesVertex", "ElementWiseVertex",
    "FlattenVertex", "GraphBuilder", "L2NormalizeVertex",
    "LastTimeStepVertex", "MergeVertex", "ReshapeVertex", "ScaleVertex",
    "ShiftVertex", "StackVertex", "SubsetVertex", "UnstackVertex",
    "graph_builder", "restore_graph", "save_graph",
    "CheckpointListener", "CollectScoresIterationListener",
    "EvaluativeListener", "PerformanceListener", "ScoreIterationListener",
    "TimeIterationListener", "TrainingListener",
    "MultiLayerNetwork", "restore_model", "restore_normalizer", "save_model",
    "UPDATERS", "AdaDelta", "AdaGrad", "AdaMax", "Adam", "AmsGrad", "Frozen",
    "Nadam", "Nesterovs", "NoOp", "RmsProp", "Sgd", "get_updater",
]
