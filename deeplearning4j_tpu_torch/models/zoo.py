"""Model zoo of the port: LeNet, ResNet-50 and TextGenerationLSTM.

Counterpart of ``deeplearning4j_tpu/models/zoo.py`` ``ZooModel``,
``LeNet`` (:44), ``ResNet50`` (:173-260) and ``TextGenerationLSTM``
(:349), with the same layer configs, graph node names and defaults, so
the JAX package's parameter trees carry across unchanged (through
:func:`graph_state_from_numpy` for the graph, ``init(params=...)`` for
the sequential networks). ``device`` is where the network lives:
``"cuda"`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from deeplearning4j_tpu_torch.models._tree import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ElementWiseVertex, GraphBuilder, graph_builder)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, Nesterovs, RmsProp


class ZooModel:
    """ZooModel.java analog."""

    def init(self):
        raise NotImplementedError


class LeNet(ZooModel):
    """zoo/model/LeNet.java: 2 × (conv 5×5 + max-pool 2×2/2), dense 500,
    softmax; Adam 1e-3, He init, seed 123; MNIST's 28×28×1 by default."""

    def __init__(self, num_classes: int = 10, seed: int = 123, updater=None,
                 input_shape: Tuple[int, int, int] = (28, 28, 1),
                 device=None):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-3)
        self.input_shape = input_shape
        self.device = device

    def conf(self) -> C.MultiLayerConfiguration:
        h, w, c = self.input_shape
        return (C.builder().seed(self.seed).weight_init("relu")
                .updater(self.updater).list()
                .layer(C.ConvolutionLayer(n_out=20, kernel=(5, 5),
                                          activation="relu"))
                .layer(C.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
                .layer(C.ConvolutionLayer(n_out=50, kernel=(5, 5),
                                          activation="relu"))
                .layer(C.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
                .layer(C.DenseLayer(n_out=500, activation="relu"))
                .layer(C.OutputLayer(n_out=self.num_classes,
                                     activation="softmax", loss="mcxent"))
                .set_input_type(C.InputType.convolutional_flat(h, w, c))
                .build())

    def init(self, params=None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=self.device).init(params)


class TextGenerationLSTM(ZooModel):
    """zoo/model/TextGenerationLSTM.java: character-level 2 × LSTM(tanh)
    + softmax over the vocabulary; RmsProp 1e-2, Xavier init, seed 123."""

    def __init__(self, vocab_size: int, hidden: int = 256, seed: int = 123,
                 updater=None, device=None):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.seed = seed
        self.updater = updater or RmsProp(learning_rate=1e-2)
        self.device = device

    def conf(self) -> C.MultiLayerConfiguration:
        return (C.builder().seed(self.seed).updater(self.updater)
                .weight_init("xavier").list()
                .layer(C.LSTM(n_out=self.hidden, activation="tanh"))
                .layer(C.LSTM(n_out=self.hidden, activation="tanh"))
                .layer(C.RnnOutputLayer(n_out=self.vocab_size,
                                        activation="softmax", loss="mcxent"))
                .set_input_type(C.InputType.recurrent(self.vocab_size))
                .build())

    def init(self, params=None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=self.device).init(params)


class ResNet50(ZooModel):
    """zoo/model/ResNet50.java: conv1 7×7/2 → maxpool 3×3/2 → stages
    [3, 4, 6, 3] of bottleneck blocks → global average pool → softmax.
    ``fused_blocks=True`` builds each block as one ``FusedBottleneck``
    (the fused BN/matmul kernel on its 1×1 convs)."""

    def __init__(self, num_classes: int = 1000, seed: int = 123, updater=None,
                 input_shape: Tuple[int, int, int] = (224, 224, 3),
                 dtype: str = "float32", fused_blocks: bool = False,
                 device=None):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Nesterovs(learning_rate=1e-1, momentum=0.9)
        self.input_shape = input_shape
        self.dtype = dtype
        self.fused_blocks = fused_blocks
        self.device = device

    def _bottleneck(self, b: GraphBuilder, name: str, inp: str, filters: int,
                    stride: int, project: bool) -> str:
        s = (stride, stride)
        b.add_layer(f"{name}_c1", C.ConvolutionLayer(
            n_out=filters, kernel=(1, 1), stride=s, convolution_mode="same",
            activation="identity", has_bias=False), inp)
        b.add_layer(f"{name}_bn1", C.BatchNormalization(activation="relu"),
                    f"{name}_c1")
        b.add_layer(f"{name}_c2", C.ConvolutionLayer(
            n_out=filters, kernel=(3, 3), convolution_mode="same",
            activation="identity", has_bias=False), f"{name}_bn1")
        b.add_layer(f"{name}_bn2", C.BatchNormalization(activation="relu"),
                    f"{name}_c2")
        b.add_layer(f"{name}_c3", C.ConvolutionLayer(
            n_out=4 * filters, kernel=(1, 1), convolution_mode="same",
            activation="identity", has_bias=False), f"{name}_bn2")
        b.add_layer(f"{name}_bn3",
                    C.BatchNormalization(activation="identity"), f"{name}_c3")
        if project:
            b.add_layer(f"{name}_sc", C.ConvolutionLayer(
                n_out=4 * filters, kernel=(1, 1), stride=s,
                convolution_mode="same", activation="identity",
                has_bias=False), inp)
            b.add_layer(f"{name}_scbn",
                        C.BatchNormalization(activation="identity"),
                        f"{name}_sc")
            shortcut = f"{name}_scbn"
        else:
            shortcut = inp
        b.add_vertex(f"{name}_add", ElementWiseVertex(op="add"),
                     f"{name}_bn3", shortcut)
        b.add_layer(f"{name}_out", C.ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_out"

    def conf(self):
        """The graph configuration (the JAX ``init``'s builder chain)."""
        h, w, c = self.input_shape
        b = (graph_builder().seed(self.seed).updater(self.updater)
             .weight_init("relu").dtype(self.dtype)
             .add_inputs("input")
             .set_input_types(input=C.InputType.convolutional(h, w, c)))
        b.add_layer("conv1", C.ConvolutionLayer(
            n_out=64, kernel=(7, 7), stride=(2, 2), convolution_mode="same",
            activation="identity", has_bias=False,
            s2d_stem=(h % 2 == 0 and w % 2 == 0)), "input")
        b.add_layer("bn1", C.BatchNormalization(activation="relu"), "conv1")
        b.add_layer("pool1", C.SubsamplingLayer(
            kernel=(3, 3), stride=(2, 2), convolution_mode="same"), "bn1")
        node = "pool1"
        stages = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
        for si, (filters, blocks, stride) in enumerate(stages):
            for bi in range(blocks):
                name = f"res{si}_{bi}"
                st = stride if bi == 0 else 1
                if self.fused_blocks is True:
                    b.add_layer(name, C.FusedBottleneck(
                        filters=filters, stride=st, project=(bi == 0)), node)
                    node = name
                else:
                    node = self._bottleneck(b, name, node, filters, st,
                                            project=(bi == 0))
        b.add_layer("gap", C.GlobalPoolingLayer(pooling_type="avg"), node)
        b.add_layer("fc", C.OutputLayer(n_out=self.num_classes,
                                        activation="softmax", loss="mcxent"),
                    "gap")
        b.set_outputs("fc")
        return b.build()

    def init(self) -> ComputationGraph:
        return ComputationGraph(self.conf(), device=self.device).init()


def graph_state_from_numpy(params: Dict[str, Any], net_state: Dict[str, Any],
                           opt_state: Dict[str, Any], device=None):
    """The JAX ComputationGraph's ``params`` / ``net_state`` /
    ``opt_state`` trees (numpy leaves, the same nesting and names: layer ->
    leaf, and for the updater state layer -> leaf -> state key) as the
    port's tensor trees on ``device``. Assign the three to a port network
    (``net.params, net.net_state, net.opt_state = ...``) to continue the
    JAX run."""
    return tuple(params_from_numpy(t, device)
                 for t in (params, net_state, opt_state))
