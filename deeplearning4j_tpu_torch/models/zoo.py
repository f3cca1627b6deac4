"""Model zoo of the port.

Counterpart of ``deeplearning4j_tpu/models/zoo.py``: ``ZooModel``,
``LeNet`` (:44), ``SimpleCNN`` (:71), ``AlexNet`` (:104), ``VGG16``
(:143), ``ResNet50`` (:173-260), ``Darknet19`` (:263), ``UNet`` (:305),
``TextGenerationLSTM`` (:349), the ``GPT`` entry (:372), ``VGG19`` (:408),
``SqueezeNet`` (:439), ``Xception`` (:497), ``TinyYOLO`` (:588),
``InceptionResNetV1`` (:645) and ``YOLO2`` (:777), with the same layer
configs, graph node names, constructor arguments and defaults, so the
JAX package's parameter trees carry across unchanged (through
``init(params=...)``, and :func:`graph_state_from_numpy` for a graph's
whole state). ``conf()`` gives each network's configuration, ``init``
the network. ``device`` is where the network lives: ``"cuda"`` unless
the caller passes ``device="cpu"``.

TinyYOLO and YOLO2 end in the raw detection convolution, as in the
reference: ``yolo_loss`` (the shared ``ops/losses.yolo2``) scores their
``output``; there is no ``fit`` path through it, as there is none in the
JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from deeplearning4j_tpu_torch.models._tree import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ElementWiseVertex, GraphBuilder, MergeVertex,
    ScaleVertex, graph_builder)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, Nesterovs, RmsProp


class ZooModel:
    """ZooModel.java analog."""

    device = None

    def conf(self):
        raise NotImplementedError

    def init(self, params=None):
        """The network on ``self.device``: parameters from ``params``
        (the JAX package's tree as numpy, or tensors) or drawn from the
        seed."""
        conf = self.conf()
        if isinstance(conf, C.MultiLayerConfiguration):
            return MultiLayerNetwork(conf, device=self.device).init(params)
        return ComputationGraph(conf, device=self.device).init(params)

    @staticmethod
    def _builder(seed, updater):
        return C.builder().seed(seed).weight_init("relu").updater(updater)


class _Classifier(ZooModel):
    """The common constructor of the zoo's image classifiers."""

    default_classes = 1000
    default_shape: Tuple[int, int, int] = (224, 224, 3)

    def __init__(self, num_classes: int = None, seed: int = 123,
                 updater=None, input_shape: Tuple[int, int, int] = None,
                 device=None):
        self.num_classes = (self.default_classes if num_classes is None
                            else num_classes)
        self.seed = seed
        self.updater = updater or self.default_updater()
        self.input_shape = tuple(input_shape or self.default_shape)
        self.device = device

    @staticmethod
    def default_updater():
        return Nesterovs(learning_rate=1e-2, momentum=0.9)


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


class SimpleCNN(_Classifier):
    """zoo/model/SimpleCNN.java: a small conv stack with batch norm."""

    default_classes = 10
    default_shape = (48, 48, 3)

    @staticmethod
    def default_updater():
        return Adam(learning_rate=1e-3)

    def conf(self) -> C.MultiLayerConfiguration:
        h, w, c = self.input_shape

        def conv(n):
            return C.ConvolutionLayer(n_out=n, kernel=(3, 3),
                                      convolution_mode="same",
                                      activation="relu")

        return (self._builder(self.seed, self.updater).list()
                .layer(conv(16)).layer(C.BatchNormalization())
                .layer(conv(16))
                .layer(C.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
                .layer(conv(32)).layer(C.BatchNormalization())
                .layer(C.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
                .layer(C.GlobalPoolingLayer(pooling_type="avg"))
                .layer(C.OutputLayer(n_out=self.num_classes,
                                     activation="softmax", loss="mcxent"))
                .set_input_type(C.InputType.convolutional(h, w, c))
                .build())


class AlexNet(_Classifier):
    """zoo/model/AlexNet.java (single tower): 5 convolutions with LRN and
    overlapping 3×3/2 max pools, 2 × dense 4096 with dropout 0.5."""

    def conf(self) -> C.MultiLayerConfiguration:
        h, w, c = self.input_shape

        def conv(n, k, **kw):
            return C.ConvolutionLayer(n_out=n, kernel=(k, k),
                                      activation="relu", **kw)

        def pool():
            return C.SubsamplingLayer(kernel=(3, 3), stride=(2, 2))

        return (self._builder(self.seed, self.updater).list()
                .layer(conv(96, 11, stride=(4, 4)))
                .layer(C.LocalResponseNormalization()).layer(pool())
                .layer(conv(256, 5, convolution_mode="same"))
                .layer(C.LocalResponseNormalization()).layer(pool())
                .layer(conv(384, 3, convolution_mode="same"))
                .layer(conv(384, 3, convolution_mode="same"))
                .layer(conv(256, 3, convolution_mode="same")).layer(pool())
                .layer(C.DenseLayer(n_out=4096, activation="relu",
                                    dropout=0.5))
                .layer(C.DenseLayer(n_out=4096, activation="relu",
                                    dropout=0.5))
                .layer(C.OutputLayer(n_out=self.num_classes,
                                     activation="softmax", loss="mcxent"))
                .set_input_type(C.InputType.convolutional(h, w, c))
                .build())


class VGG16(_Classifier):
    """zoo/model/VGG16.java: 13 convolutions 3×3 'same' in five stages,
    2 × dense 4096 with dropout 0.5."""

    stages = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

    def conf(self) -> C.MultiLayerConfiguration:
        h, w, c = self.input_shape
        b = self._builder(self.seed, self.updater).list()
        for n_out, reps in self.stages:
            for _ in range(reps):
                b = b.layer(C.ConvolutionLayer(
                    n_out=n_out, kernel=(3, 3), convolution_mode="same",
                    activation="relu"))
            b = b.layer(C.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
        return (b.layer(C.DenseLayer(n_out=4096, activation="relu",
                                     dropout=0.5))
                .layer(C.DenseLayer(n_out=4096, activation="relu",
                                    dropout=0.5))
                .layer(C.OutputLayer(n_out=self.num_classes,
                                     activation="softmax", loss="mcxent"))
                .set_input_type(C.InputType.convolutional(h, w, c))
                .build())


class VGG19(VGG16):
    """zoo/model/VGG19.java: VGG16 with one more convolution in each of
    the last three stages."""

    stages = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]


class Darknet19(_Classifier):
    """zoo/model/Darknet19.java: 19 convolutions, each with batch norm +
    leaky relu, 2×2 max pools, a 1×1 classifier conv and global average
    pooling."""

    @staticmethod
    def default_updater():
        return Nesterovs(learning_rate=1e-3, momentum=0.9)

    def conf(self) -> C.MultiLayerConfiguration:
        h, w, c = self.input_shape
        b = self._builder(self.seed, self.updater).list()

        def conv(n, k):
            nonlocal b
            b = (b.layer(C.ConvolutionLayer(
                n_out=n, kernel=(k, k), convolution_mode="same",
                activation="identity", has_bias=False))
                .layer(C.BatchNormalization(activation="leakyrelu")))

        def pool():
            nonlocal b
            b = b.layer(C.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))

        conv(32, 3), pool(), conv(64, 3), pool()
        for n, k in ((128, 3), (64, 1), (128, 3)):
            conv(n, k)
        pool()
        for n, k in ((256, 3), (128, 1), (256, 3)):
            conv(n, k)
        pool()
        for n, k in ((512, 3), (256, 1), (512, 3), (256, 1), (512, 3)):
            conv(n, k)
        pool()
        for n, k in ((1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)):
            conv(n, k)
        return (b.layer(C.ConvolutionLayer(
            n_out=self.num_classes, kernel=(1, 1), convolution_mode="same",
            activation="identity"))
            .layer(C.GlobalPoolingLayer(pooling_type="avg"))
            .layer(C.LossLayer(activation="softmax", loss="mcxent"))
            .set_input_type(C.InputType.convolutional(h, w, c))
            .build())


def _graph(seed, updater, input_shape) -> GraphBuilder:
    h, w, c = input_shape
    return (graph_builder().seed(seed).updater(updater).weight_init("relu")
            .add_inputs("input")
            .set_input_types(input=C.InputType.convolutional(h, w, c)))


class UNet(ZooModel):
    """zoo/model/UNet.java: a two-level encoder/decoder, nearest
    upsampling and skip connections merged on the channel axis."""

    def __init__(self, n_channels_out: int = 1, seed: int = 123,
                 updater=None,
                 input_shape: Tuple[int, int, int] = (128, 128, 1),
                 base: int = 16, device=None):
        self.n_channels_out = n_channels_out
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-3)
        self.input_shape = tuple(input_shape)
        self.base = base
        self.device = device

    def conf(self):
        f = self.base
        b = _graph(self.seed, self.updater, self.input_shape)

        def double_conv(name, inp, n):
            b.add_layer(f"{name}_a", C.ConvolutionLayer(
                n_out=n, kernel=(3, 3), convolution_mode="same",
                activation="relu"), inp)
            b.add_layer(f"{name}_b", C.ConvolutionLayer(
                n_out=n, kernel=(3, 3), convolution_mode="same",
                activation="relu"), f"{name}_a")
            return f"{name}_b"

        e1 = double_conv("enc1", "input", f)
        b.add_layer("pool1", C.SubsamplingLayer(kernel=(2, 2),
                                                stride=(2, 2)), e1)
        e2 = double_conv("enc2", "pool1", f * 2)
        b.add_layer("pool2", C.SubsamplingLayer(kernel=(2, 2),
                                                stride=(2, 2)), e2)
        mid = double_conv("mid", "pool2", f * 4)
        b.add_layer("up2", C.Upsampling2D(size=(2, 2)), mid)
        b.add_vertex("cat2", MergeVertex(), "up2", e2)
        d2 = double_conv("dec2", "cat2", f * 2)
        b.add_layer("up1", C.Upsampling2D(size=(2, 2)), d2)
        b.add_vertex("cat1", MergeVertex(), "up1", e1)
        d1 = double_conv("dec1", "cat1", f)
        b.add_layer("out", C.ConvolutionLayer(
            n_out=self.n_channels_out, kernel=(1, 1),
            convolution_mode="same", activation="sigmoid"), d1)
        b.set_outputs("out")
        return b.build()


class GPT(ZooModel):
    """The zoo entry of the decoder-only transformer
    (:mod:`~deeplearning4j_tpu_torch.models.gpt`): ``init()`` returns a
    ``GptModel`` for ``serving.GenerativeEngine``. ``init_draft`` (the
    speculative-decoding draft) waits for speculative decoding (ROADMAP
    Queue 1 item 8)."""

    def __init__(self, preset: str = "tiny", seed: int = 0, device=None,
                 **overrides):
        from deeplearning4j_tpu_torch.models.gpt import GptConfig

        if preset not in ("tiny", "base"):
            raise ValueError(f"unknown GPT preset {preset!r} "
                             "(known: tiny, base)")
        self.cfg = (GptConfig.tiny(**overrides) if preset == "tiny"
                    else GptConfig.base(**overrides))
        self.seed = seed
        self.device = device

    def init(self, params=None):
        """A ``GptModel``: weights drawn from the seed, or ``params`` (the
        JAX model's tree as numpy, or tensors) copied to the device."""
        from deeplearning4j_tpu_torch.models.gpt import GptModel

        if params is not None:
            params = params_from_numpy(params, self.device)
        return GptModel(self.cfg, seed=self.seed, params=params,
                        device=self.device)


class SqueezeNet(_Classifier):
    """zoo/model/SqueezeNet.java (v1.1): fire modules (1×1 squeeze, then
    1×1 and 3×3 expands merged on the channel axis), overlapping 3×3/2 max
    pools, dropout 0.5, a 1×1 classifier conv and global average
    pooling."""

    default_shape = (227, 227, 3)

    @staticmethod
    def default_updater():
        return Adam(learning_rate=1e-3)

    @staticmethod
    def _fire(b: GraphBuilder, name: str, inp: str, squeeze: int,
              expand: int) -> str:
        b.add_layer(f"{name}_sq", C.ConvolutionLayer(
            n_out=squeeze, kernel=(1, 1), activation="relu",
            convolution_mode="same"), inp)
        b.add_layer(f"{name}_e1", C.ConvolutionLayer(
            n_out=expand, kernel=(1, 1), activation="relu",
            convolution_mode="same"), f"{name}_sq")
        b.add_layer(f"{name}_e3", C.ConvolutionLayer(
            n_out=expand, kernel=(3, 3), activation="relu",
            convolution_mode="same"), f"{name}_sq")
        b.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_e1",
                     f"{name}_e3")
        return f"{name}_cat"

    def conf(self):
        b = _graph(self.seed, self.updater, self.input_shape)
        b.add_layer("conv1", C.ConvolutionLayer(
            n_out=64, kernel=(3, 3), stride=(2, 2), activation="relu",
            convolution_mode="valid"), "input")
        b.add_layer("pool1", C.SubsamplingLayer(kernel=(3, 3),
                                                stride=(2, 2)), "conv1")
        node = "pool1"
        for i, (sq, ex) in enumerate(((16, 64), (16, 64), (32, 128),
                                      (32, 128), (48, 192), (48, 192),
                                      (64, 256), (64, 256))):
            node = self._fire(b, f"fire{i + 2}", node, sq, ex)
            if i in (1, 3):
                pool = f"pool{i + 2}"
                b.add_layer(pool, C.SubsamplingLayer(kernel=(3, 3),
                                                     stride=(2, 2)), node)
                node = pool
        b.add_layer("drop9", C.DropoutLayer(rate=0.5), node)
        b.add_layer("conv10", C.ConvolutionLayer(
            n_out=self.num_classes, kernel=(1, 1), activation="relu",
            convolution_mode="same"), "drop9")
        b.add_layer("gap", C.GlobalPoolingLayer(pooling_type="avg"),
                    "conv10")
        b.add_layer("out", C.LossLayer(loss="mcxent", activation="softmax"),
                    "gap")
        b.set_outputs("out")
        return b.build()


class Xception(ZooModel):
    """zoo/model/Xception.java: separable-convolution stacks with
    projection shortcuts (entry, middle and exit flows; the middle flow's
    repeat count is a constructor argument)."""

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 updater=None,
                 input_shape: Tuple[int, int, int] = (299, 299, 3),
                 middle_repeats: int = 8, device=None):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-3)
        self.input_shape = tuple(input_shape)
        self.middle_repeats = middle_repeats
        self.device = device

    @staticmethod
    def _sep_bn(b, name, inp, n_out, relu_first=True):
        if relu_first:
            b.add_layer(f"{name}_act", C.ActivationLayer(activation="relu"),
                        inp)
            inp = f"{name}_act"
        b.add_layer(f"{name}_sep", C.SeparableConvolution2D(
            n_out=n_out, kernel=(3, 3), convolution_mode="same",
            activation="identity", has_bias=False), inp)
        b.add_layer(f"{name}_bn", C.BatchNormalization(activation="identity"),
                    f"{name}_sep")
        return f"{name}_bn"

    def _projected(self, b, name, inp, node, n_out):
        """3×3/2 pool of ``node`` plus a 1×1/2 conv + BN shortcut of
        ``inp``."""
        b.add_layer(f"{name}_pool", C.SubsamplingLayer(
            kernel=(3, 3), stride=(2, 2), convolution_mode="same"), node)
        b.add_layer(f"{name}_sc", C.ConvolutionLayer(
            n_out=n_out, kernel=(1, 1), stride=(2, 2),
            convolution_mode="same", activation="identity",
            has_bias=False), inp)
        b.add_layer(f"{name}_scbn", C.BatchNormalization(
            activation="identity"), f"{name}_sc")
        b.add_vertex(f"{name}_add", ElementWiseVertex(op="add"),
                     f"{name}_pool", f"{name}_scbn")
        return f"{name}_add"

    def _entry_block(self, b, name, inp, n_out, first_relu=True):
        node = self._sep_bn(b, f"{name}_a", inp, n_out,
                            relu_first=first_relu)
        node = self._sep_bn(b, f"{name}_b", node, n_out)
        return self._projected(b, name, inp, node, n_out)

    def conf(self):
        b = _graph(self.seed, self.updater, self.input_shape)
        b.add_layer("conv1", C.ConvolutionLayer(
            n_out=32, kernel=(3, 3), stride=(2, 2), activation="identity",
            convolution_mode="same", has_bias=False), "input")
        b.add_layer("bn1", C.BatchNormalization(activation="relu"), "conv1")
        b.add_layer("conv2", C.ConvolutionLayer(
            n_out=64, kernel=(3, 3), activation="identity",
            convolution_mode="same", has_bias=False), "bn1")
        b.add_layer("bn2", C.BatchNormalization(activation="relu"), "conv2")
        node = self._entry_block(b, "entry1", "bn2", 128, first_relu=False)
        node = self._entry_block(b, "entry2", node, 256)
        node = self._entry_block(b, "entry3", node, 728)
        for i in range(self.middle_repeats):
            inp = node
            m = self._sep_bn(b, f"mid{i}_a", inp, 728)
            m = self._sep_bn(b, f"mid{i}_b", m, 728)
            m = self._sep_bn(b, f"mid{i}_c", m, 728)
            b.add_vertex(f"mid{i}_add", ElementWiseVertex(op="add"), m, inp)
            node = f"mid{i}_add"
        # exit block (Xception.java block13): separable 728 then 1024,
        # with a 1024-channel projection shortcut
        inp = node
        node = self._sep_bn(b, "exit1_a", inp, 728)
        node = self._sep_bn(b, "exit1_b", node, 1024)
        node = self._projected(b, "exit1", inp, node, 1024)
        node = self._sep_bn(b, "exit2", node, 1536)
        b.add_layer("exit2_relu", C.ActivationLayer(activation="relu"), node)
        node = self._sep_bn(b, "exit3", "exit2_relu", 2048)
        b.add_layer("exit3_relu", C.ActivationLayer(activation="relu"), node)
        b.add_layer("gap", C.GlobalPoolingLayer(pooling_type="avg"),
                    "exit3_relu")
        b.add_layer("fc", C.OutputLayer(n_out=self.num_classes,
                                        activation="softmax", loss="mcxent"),
                    "gap")
        b.set_outputs("fc")
        return b.build()


class _Yolo(ZooModel):
    """The detectors' constructor and loss: ``output`` is the raw head,
    (N, H, W, B·(5+C)) per cell."""

    def __init__(self, num_classes: int = None, num_boxes: int = 5,
                 seed: int = 123, updater=None,
                 input_shape: Tuple[int, int, int] = (416, 416, 3),
                 device=None):
        self.num_classes = (self.default_classes if num_classes is None
                            else num_classes)
        self.num_boxes = num_boxes
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-3)
        self.input_shape = tuple(input_shape)
        self.device = device

    def yolo_loss(self, pred, target, *, lambda_coord: float = 5.0,
                  lambda_noobj: float = 0.5):
        """YOLOv2 sum-squared loss (Yolo2OutputLayer.computeScore): the
        shared ``ops/losses.yolo2`` over pred (N, H, W, B·(5+C)) and
        target (N, H, W, B, 5+C) = [x, y, w, h, obj, class one-hot]."""
        from deeplearning4j_tpu_torch.ops.losses import yolo2

        return yolo2(pred, target, None, lambda_coord=lambda_coord,
                     lambda_noobj=lambda_noobj)


class TinyYOLO(_Yolo):
    """zoo/model/TinyYOLO.java: a darknet-tiny backbone (conv + BN +
    leaky relu, 2×2 pools) and a 1×1 detection conv of B·(5+C)
    channels."""

    default_classes = 20

    def conf(self) -> C.MultiLayerConfiguration:
        h, w, c = self.input_shape
        b = self._builder(self.seed, self.updater).list()
        for f in (16, 32, 64, 128, 256, 512, 1024):
            b = (b.layer(C.ConvolutionLayer(
                n_out=f, kernel=(3, 3), convolution_mode="same",
                activation="identity", has_bias=False))
                .layer(C.BatchNormalization(activation="leakyrelu")))
            if f <= 256:
                b = b.layer(C.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
        depth = self.num_boxes * (5 + self.num_classes)
        return (b.layer(C.ConvolutionLayer(n_out=depth, kernel=(1, 1),
                                           convolution_mode="same",
                                           activation="identity"))
                .set_input_type(C.InputType.convolutional(h, w, c))
                .build())


class InceptionResNetV1(ZooModel):
    """zoo/model/InceptionResNetV1.java: stem → Inception-ResNet-A ×
    blocks[0] → Reduction-A → B × blocks[1] → Reduction-B → C ×
    blocks[2] → average pool → bottleneck embedding + BN → classifier.
    Each block merges its branches on the channel axis, projects with a
    1×1 conv, scales (0.17 / 0.10 / 0.20) and adds the block's input."""

    def __init__(self, num_classes: int = 128, seed: int = 123,
                 updater=None,
                 input_shape: Tuple[int, int, int] = (160, 160, 3),
                 blocks: Tuple[int, int, int] = (5, 10, 5),
                 embedding_size: int = 128, device=None):
        self.num_classes = num_classes
        self.seed = seed
        self.updater = updater or RmsProp(learning_rate=0.1)
        self.input_shape = tuple(input_shape)
        self.blocks = tuple(blocks)
        self.embedding_size = embedding_size
        self.device = device

    @staticmethod
    def _conv_bn(b, name, inp, n_out, kernel, stride=(1, 1), mode="same"):
        b.add_layer(f"{name}_c", C.ConvolutionLayer(
            n_out=n_out, kernel=kernel, stride=stride, convolution_mode=mode,
            activation="identity", has_bias=False), inp)
        b.add_layer(f"{name}_bn", C.BatchNormalization(activation="relu"),
                    f"{name}_c")
        return f"{name}_bn"

    def _residual(self, b, name, inp, branches, channels, scale):
        """Merge the branch outputs, 1×1 up-projection, scale, add the
        block input, relu."""
        b.add_vertex(f"{name}_cat", MergeVertex(), *branches)
        b.add_layer(f"{name}_up", C.ConvolutionLayer(
            n_out=channels, kernel=(1, 1), convolution_mode="same",
            activation="identity"), f"{name}_cat")
        b.add_vertex(f"{name}_scale", ScaleVertex(scale=scale),
                     f"{name}_up")
        b.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                     f"{name}_scale")
        b.add_layer(f"{name}_out", C.ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_out"

    def _block_a(self, b, name, inp, channels):
        cb = self._conv_bn
        b1 = cb(b, f"{name}_b1", inp, 32, (1, 1))
        b2 = cb(b, f"{name}_b2b", cb(b, f"{name}_b2a", inp, 32, (1, 1)), 32,
                (3, 3))
        b3 = cb(b, f"{name}_b3a", inp, 32, (1, 1))
        b3 = cb(b, f"{name}_b3b", b3, 32, (3, 3))
        b3 = cb(b, f"{name}_b3c", b3, 32, (3, 3))
        return self._residual(b, name, inp, (b1, b2, b3), channels, 0.17)

    def _block_bc(self, b, name, inp, channels, width, k, scale):
        cb = self._conv_bn
        b1 = cb(b, f"{name}_b1", inp, width, (1, 1))
        b2 = cb(b, f"{name}_b2a", inp, width, (1, 1))
        b2 = cb(b, f"{name}_b2b", b2, width, (1, k))
        b2 = cb(b, f"{name}_b2c", b2, width, (k, 1))
        return self._residual(b, name, inp, (b1, b2), channels, scale)

    def conf(self):
        na, nb, nc = self.blocks
        cb = self._conv_bn
        b = _graph(self.seed, self.updater, self.input_shape)
        node = cb(b, "stem1", "input", 32, (3, 3), (2, 2), "valid")
        node = cb(b, "stem2", node, 32, (3, 3), mode="valid")
        node = cb(b, "stem3", node, 64, (3, 3))
        b.add_layer("stem_pool", C.SubsamplingLayer(kernel=(3, 3),
                                                    stride=(2, 2)), node)
        node = cb(b, "stem4", "stem_pool", 80, (1, 1), mode="valid")
        node = cb(b, "stem5", node, 192, (3, 3), mode="valid")
        node = cb(b, "stem6", node, 256, (3, 3), (2, 2), "valid")
        for i in range(na):
            node = self._block_a(b, f"a{i}", node, 256)
        # Reduction-A: 384 + 256 + 256 = 896 channels
        r1 = cb(b, "redA_b1", node, 384, (3, 3), (2, 2), "valid")
        r2 = cb(b, "redA_b2a", node, 192, (1, 1))
        r2 = cb(b, "redA_b2b", r2, 192, (3, 3))
        r2 = cb(b, "redA_b2c", r2, 256, (3, 3), (2, 2), "valid")
        b.add_layer("redA_pool", C.SubsamplingLayer(kernel=(3, 3),
                                                    stride=(2, 2)), node)
        b.add_vertex("redA_cat", MergeVertex(), r1, r2, "redA_pool")
        node = "redA_cat"
        for i in range(nb):
            node = self._block_bc(b, f"b{i}", node, 896, 128, 7, 0.10)
        # Reduction-B: 384 + 256 + 256 + 896 = 1792 channels
        r1 = cb(b, "redB_b1b", cb(b, "redB_b1a", node, 256, (1, 1)), 384,
                (3, 3), (2, 2), "valid")
        r2 = cb(b, "redB_b2b", cb(b, "redB_b2a", node, 256, (1, 1)), 256,
                (3, 3), (2, 2), "valid")
        r3 = cb(b, "redB_b3a", node, 256, (1, 1))
        r3 = cb(b, "redB_b3b", r3, 256, (3, 3))
        r3 = cb(b, "redB_b3c", r3, 256, (3, 3), (2, 2), "valid")
        b.add_layer("redB_pool", C.SubsamplingLayer(kernel=(3, 3),
                                                    stride=(2, 2)), node)
        b.add_vertex("redB_cat", MergeVertex(), r1, r2, r3, "redB_pool")
        node = "redB_cat"
        for i in range(nc):
            node = self._block_bc(b, f"c{i}", node, 1792, 192, 3, 0.20)
        b.add_layer("gap", C.GlobalPoolingLayer(pooling_type="avg"), node)
        b.add_layer("bottleneck", C.DenseLayer(
            n_out=self.embedding_size, activation="identity",
            has_bias=False), "gap")
        b.add_layer("emb_norm", C.BatchNormalization(activation="identity"),
                    "bottleneck")
        b.add_layer("out", C.OutputLayer(n_out=self.num_classes,
                                         activation="softmax",
                                         loss="mcxent"), "emb_norm")
        b.set_outputs("out")
        return b.build()


class YOLO2(_Yolo):
    """zoo/model/YOLO2.java: the Darknet19 backbone and the YOLOv2
    passthrough: the 26×26×512 features squeezed by a 1×1 conv, reorganized
    by space-to-depth (block 2) and merged with the 13×13×1024 path before
    the 1×1 detection conv of B·(5+C) channels."""

    default_classes = 80

    def conf(self):
        b = _graph(self.seed, self.updater, self.input_shape)
        idx = 0

        def conv(inp, n, k):
            nonlocal idx
            idx += 1
            b.add_layer(f"c{idx}", C.ConvolutionLayer(
                n_out=n, kernel=(k, k), convolution_mode="same",
                activation="identity", has_bias=False), inp)
            b.add_layer(f"bn{idx}", C.BatchNormalization(
                activation="leakyrelu"), f"c{idx}")
            return f"bn{idx}"

        def pool(inp):
            nonlocal idx
            idx += 1
            b.add_layer(f"p{idx}", C.SubsamplingLayer(kernel=(2, 2),
                                                      stride=(2, 2)), inp)
            return f"p{idx}"

        def chain(x, spec):
            for n, k in spec:
                x = conv(x, n, k)
            return x

        x = pool(conv("input", 32, 3))
        x = pool(conv(x, 64, 3))
        x = pool(chain(x, ((128, 3), (64, 1), (128, 3))))
        x = pool(chain(x, ((256, 3), (128, 1), (256, 3))))
        route = chain(x, ((512, 3), (256, 1), (512, 3), (256, 1), (512, 3)))
        x = chain(pool(route), ((1024, 3), (512, 1), (1024, 3), (512, 1),
                                (1024, 3), (1024, 3), (1024, 3)))
        sq = conv(route, 64, 1)
        b.add_layer("reorg", C.SpaceToDepthLayer(block_size=2), sq)
        b.add_vertex("route_cat", MergeVertex(), x, "reorg")
        x = conv("route_cat", 1024, 3)
        b.add_layer("detect", C.ConvolutionLayer(
            n_out=self.num_boxes * (5 + self.num_classes), kernel=(1, 1),
            convolution_mode="same", activation="identity"), x)
        b.set_outputs("detect")
        return b.build()


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
