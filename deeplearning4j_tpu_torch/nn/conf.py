"""Declarative layer and network configuration with JSON round trip.

Counterpart of ``deeplearning4j_tpu/nn/conf.py`` for the ported layers:
``InputType``; the layer configs of ResNet-50 (``ConvolutionLayer`` with
``s2d_stem``, ``SubsamplingLayer``, ``GlobalPoolingLayer``,
``BatchNormalization``, ``ActivationLayer``, ``DenseLayer`` /
``OutputLayer``, ``FusedBottleneck``), of the zoo's other vision models
(``Deconvolution2D``, ``DepthwiseConvolution2D``,
``SeparableConvolution2D``, ``Upsampling2D``,
``LocalResponseNormalization``, ``SpaceToDepthLayer``) and of the
sequential network
(``LossLayer``, ``EmbeddingLayer``, ``EmbeddingSequenceLayer``,
``DropoutLayer``, ``LSTM``, ``GravesLSTM``, ``GRU``, ``SimpleRnn``,
``Bidirectional``, ``RnnOutputLayer``, ``LastTimeStep``,
``RnnLossLayer``), the 34 layer types the Keras importer builds
(``AttentionVertex`` for MultiHeadAttention, the 1-D and 3-D
convolution, pooling, padding, cropping and upsampling layers, locally
connected, ``PReLULayer``, the normalizations, shape, attention and
preprocessing layers); the preprocessors ``FeedForwardToCnn``,
``CnnToFeedForward``, ``Cnn3DToFeedForward``, ``RnnToFeedForward`` and
``FeedForwardToRnn``;
``MultiLayerConfiguration`` with its JSON, the fluent
``NeuralNetConfigurationBuilder`` (``builder()``) and the build-time shape
inference (``_infer_shapes`` / ``_adapt``); and the ``to_dict`` /
``from_dict`` JSON the JAX package writes ("@type" discriminators, lists
for tuples, ``{"__updater__": ...}`` for per-layer updaters). The field
names and defaults are the JAX package's, so its JSON loads here and the
port's loads there. A layer or preprocessor type that is not ported yet
is refused by name.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn.updater import Adam, Updater, get_updater

# ---------------------------------------------------------------------------
# InputType — shape inference tokens (conf/inputs/InputType.java)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputType:
    """Shape token flowing between layer configs at build time: kind
    'feedforward', 'recurrent', 'convolutional' (height, width, channels;
    NHWC), 'convolutional3d' (depth too; NDHWC) or
    'convolutionalflat'."""

    kind: str
    size: int = 0
    height: int = 0
    width: int = 0
    channels: int = 0
    depth: int = 0
    timesteps: int = -1

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("feedforward", size=size)

    @staticmethod
    def recurrent(size: int, timesteps: int = -1) -> "InputType":
        return InputType("recurrent", size=size, timesteps=timesteps)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("convolutional", height=height, width=width,
                         channels=channels)

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int,
                        channels: int) -> "InputType":
        """NDHWC volumetric input (InputTypeConvolutional3D)."""
        return InputType("convolutional3d", depth=depth, height=height,
                         width=width, channels=channels)

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputType":
        return InputType("convolutionalflat", size=height * width * channels,
                         height=height, width=width, channels=channels)

    def flat_size(self) -> int:
        if self.kind in ("feedforward", "convolutionalflat", "recurrent"):
            return (self.size if self.size
                    else self.height * self.width * self.channels)
        if self.kind == "convolutional3d":
            return self.depth * self.height * self.width * self.channels
        return self.height * self.width * self.channels

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        return InputType(**d)


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


# ---------------------------------------------------------------------------
# Layer configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerConf:
    """Base layer config; per-layer overrides of the net-wide defaults."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    weight_decay: Optional[float] = None
    # DROP RATE (fraction zeroed), not DL4J's dropOut(x) retain probability
    dropout: Optional[float] = None
    updater: Optional[Any] = None

    def output_type(self, itype: InputType) -> InputType:
        return itype

    def has_params(self) -> bool:
        return False

    def to_dict(self) -> Dict[str, Any]:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Updater):
                v = {"__updater__": v.to_dict()}
            d[f.name] = v
        d["@type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LayerConf":
        def tuplify(v):
            return tuple(tuplify(x) for x in v) if isinstance(v, list) else v

        d = dict(d)
        name = d.pop("@type")
        cls = LAYER_TYPES.get(name)
        if cls is None:
            raise ValueError(
                f"layer type {name!r} is not ported to deeplearning4j_tpu_torch"
                f" yet; ported: {sorted(LAYER_TYPES)}")
        for k, v in list(d.items()):
            if isinstance(v, dict) and "__updater__" in v:
                d[k] = Updater.from_dict(v["__updater__"])
            elif isinstance(v, list):
                d[k] = tuplify(v)
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class DenseLayer(LayerConf):
    """conf/layers/DenseLayer.java: fully connected, W (nIn,nOut) + b."""

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = True

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class OutputLayer(DenseLayer):
    """conf/layers/OutputLayer.java: dense + loss function."""

    loss: str = "mcxent"


@dataclasses.dataclass(frozen=True)
class ConvolutionLayer(LayerConf):
    """conf/layers/ConvolutionLayer.java; NHWC/HWIO inside. ``s2d_stem``
    lowers a 7×7/2 'same' conv as a 4×4/1 conv over a 2×2 space-to-depth
    input with the canonical (7,7,C,F) kernel kept in the parameters."""

    n_in: int = 0
    n_out: int = 0
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"
    has_bias: bool = True
    s2d_stem: bool = False

    def output_type(self, itype):
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        dh, dw = _pair(self.dilation)
        ph, pw = _pair(self.padding)
        ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
        if self.convolution_mode == "same":
            oh = -(-itype.height // sh)
            ow = -(-itype.width // sw)
        else:
            oh = (itype.height + 2 * ph - ekh) // sh + 1
            ow = (itype.width + 2 * pw - ekw) // sw + 1
        return InputType.convolutional(oh, ow, self.n_out)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class Deconvolution2D(ConvolutionLayer):
    """conf/layers/Deconvolution2D.java: transposed convolution, W
    (kh, kw, n_in, n_out). The declared output size is the reference's;
    with an explicit padding the op's (the JAX ``deconv2d``'s) can differ
    from it, as in the JAX package."""

    def output_type(self, itype):
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        if self.convolution_mode == "same":
            oh, ow = itype.height * sh, itype.width * sw
        else:
            oh = sh * (itype.height - 1) + kh - 2 * ph
            ow = sw * (itype.width - 1) + kw - 2 * pw
        return InputType.convolutional(oh, ow, self.n_out)


@dataclasses.dataclass(frozen=True)
class DepthwiseConvolution2D(ConvolutionLayer):
    """conf/layers/DepthwiseConvolution2D.java: W (kh, kw, C,
    depth_multiplier), C · depth_multiplier output channels."""

    depth_multiplier: int = 1

    def output_type(self, itype):
        base = super().output_type(itype)
        return InputType.convolutional(
            base.height, base.width, itype.channels * self.depth_multiplier)


@dataclasses.dataclass(frozen=True)
class SeparableConvolution2D(ConvolutionLayer):
    """conf/layers/SeparableConvolution2D.java: depthwise dW (kh, kw, C,
    depth_multiplier), then pointwise pW (1, 1, C · depth_multiplier,
    n_out)."""

    depth_multiplier: int = 1


@dataclasses.dataclass(frozen=True)
class Upsampling2D(LayerConf):
    """conf/layers/Upsampling2D.java: nearest upsampling by ``size``."""

    size: Tuple[int, int] = (2, 2)

    def output_type(self, itype):
        sh, sw = _pair(self.size)
        return InputType.convolutional(itype.height * sh, itype.width * sw,
                                       itype.channels)


@dataclasses.dataclass(frozen=True)
class LocalResponseNormalization(LayerConf):
    """conf/layers/LocalResponseNormalization.java: window ``n`` channels,
    bias ``k``, ``alpha``, ``beta``."""

    n: int = 5
    k: float = 2.0
    alpha: float = 1e-4
    beta: float = 0.75


@dataclasses.dataclass(frozen=True)
class SpaceToDepthLayer(LayerConf):
    """conf/layers/SpaceToDepthLayer.java: (N, H, W, C) → (N, H/b, W/b,
    C·b·b), the YOLOv2 passthrough (reorg) block."""

    block_size: int = 2

    def output_type(self, itype):
        b = self.block_size
        return InputType.convolutional(itype.height // b, itype.width // b,
                                       itype.channels * b * b)


@dataclasses.dataclass(frozen=True)
class SubsamplingLayer(LayerConf):
    """conf/layers/SubsamplingLayer.java: pooling (MAX/AVG/PNORM)."""

    pooling_type: str = "max"
    kernel: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def output_type(self, itype):
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        if self.convolution_mode == "same":
            oh = -(-itype.height // sh)
            ow = -(-itype.width // sw)
        else:
            oh = (itype.height + 2 * ph - kh) // sh + 1
            ow = (itype.width + 2 * pw - kw) // sw + 1
        return InputType.convolutional(oh, ow, itype.channels)


@dataclasses.dataclass(frozen=True)
class GlobalPoolingLayer(LayerConf):
    """conf/layers/GlobalPoolingLayer.java: conv/recurrent -> feedforward."""

    pooling_type: str = "avg"

    def output_type(self, itype):
        if itype.kind == "recurrent":
            return InputType.feed_forward(itype.size)
        return InputType.feed_forward(itype.channels)


@dataclasses.dataclass(frozen=True)
class BatchNormalization(LayerConf):
    """conf/layers/BatchNormalization.java: gamma/beta + running stats."""

    n_out: int = 0
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class ActivationLayer(LayerConf):
    """conf/layers/ActivationLayer.java: standalone activation."""


@dataclasses.dataclass(frozen=True)
class FusedBottleneck(LayerConf):
    """ResNet v1 bottleneck as one layer: 1×1 → BN+relu → 3×3 → BN+relu →
    1×1 → BN → (+shortcut) → relu, arranged so the two 1×1 convs run
    through ``fused_matmul_bn`` (the fused BN-apply/matmul/BN-stats
    kernel). The composed layers' math."""

    n_in: int = 0
    filters: int = 0
    stride: int = 1
    project: bool = False
    decay: float = 0.9
    eps: float = 1e-5

    def output_type(self, itype):
        s = self.stride
        return InputType.convolutional(
            -(-itype.height // s), -(-itype.width // s), 4 * self.filters)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class LossLayer(LayerConf):
    """conf/layers/LossLayer.java: loss without params (identity
    transform, then the activation)."""

    loss: str = "mcxent"


@dataclasses.dataclass(frozen=True)
class EmbeddingLayer(LayerConf):
    """conf/layers/EmbeddingLayer.java: int ids -> embedding rows."""

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = False

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class EmbeddingSequenceLayer(LayerConf):
    """conf/layers/EmbeddingSequenceLayer.java: id sequence -> vector
    sequence."""

    n_in: int = 0
    n_out: int = 0
    input_length: int = -1

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, self.input_length)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class DropoutLayer(LayerConf):
    """conf/layers/DropoutLayer.java: standalone dropout; ``mode`` is the
    IDropout variant: "elementwise", "spatial" (whole feature maps along
    the trailing channel axis), "alpha" (SELU-preserving) or "gaussian"
    (multiplicative N(1, rate/(1-rate)) noise)."""

    rate: float = 0.5
    mode: str = "elementwise"


@dataclasses.dataclass(frozen=True)
class LSTM(LayerConf):
    """conf/layers/LSTM.java: LSTM over the time axis, gate order i, f, o,
    g, forget-gate bias init; the activation is the cell-output
    activation."""

    n_in: int = 0
    n_out: int = 0
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, itype.timesteps)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class GravesLSTM(LSTM):
    """conf/layers/GravesLSTM.java. The peepholes are omitted, as in the
    JAX package (its documented divergence): the math is LSTM's."""


@dataclasses.dataclass(frozen=True)
class GRU(LayerConf):
    """GRU over the ``gru_cell`` op: gate order r, z, n with separate
    input and recurrent biases."""

    n_in: int = 0
    n_out: int = 0

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, itype.timesteps)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class SimpleRnn(LayerConf):
    """conf/layers/recurrent/SimpleRnn.java: h' = act(x·W + h·RW + b)."""

    n_in: int = 0
    n_out: int = 0

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, itype.timesteps)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class Bidirectional(LayerConf):
    """conf/layers/recurrent/Bidirectional.java: wraps a recurrent layer
    config (kept serialized in ``fwd``); mode concat | add | mul |
    average."""

    fwd: Optional[Dict[str, Any]] = None
    mode: str = "concat"

    def inner(self) -> LayerConf:
        return LayerConf.from_dict(dict(self.fwd))

    def output_type(self, itype):
        out = self.inner().output_type(itype)
        if self.mode == "concat":
            return InputType.recurrent(out.size * 2, out.timesteps)
        return out

    def has_params(self):
        return True

    @staticmethod
    def wrap(inner: LayerConf, mode: str = "concat",
             name=None) -> "Bidirectional":
        return Bidirectional(fwd=inner.to_dict(), mode=mode, name=name)


@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(LayerConf):
    """conf/layers/RnnOutputLayer.java: per-timestep dense + loss."""

    n_in: int = 0
    n_out: int = 0
    loss: str = "mcxent"
    has_bias: bool = True

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, itype.timesteps)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class LastTimeStep(LayerConf):
    """conf/layers/recurrent/LastTimeStep.java: wraps a recurrent layer,
    emits its last (unmasked) step."""

    fwd: Optional[Dict[str, Any]] = None
    mode: str = "last"

    def inner(self) -> LayerConf:
        return LayerConf.from_dict(dict(self.fwd))

    def output_type(self, itype):
        return InputType.feed_forward(self.inner().output_type(itype).size)

    def has_params(self):
        return True

    @staticmethod
    def wrap(inner: LayerConf, name=None) -> "LastTimeStep":
        return LastTimeStep(fwd=inner.to_dict(), name=name)


@dataclasses.dataclass(frozen=True)
class RnnLossLayer(LayerConf):
    """conf/layers/RnnLossLayer.java: per-timestep loss over (N, T, C)."""

    loss: str = "mcxent"


# ---------------------------------------------------------------------------
# The Keras importer's layer types (JAX nn/conf.py:653-1530): attention,
# 1-D and 3-D convolution and pooling, padding / cropping / upsampling,
# locally connected, normalization, shape and preprocessing layers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionVertex(LayerConf):
    """conf/graph/AttentionVertex.java: multi-head attention as a graph
    vertex with parameters, inputs (queries, keys, values) or (queries,
    keys = values); ``keras_order`` takes them in Keras
    MultiHeadAttention's call order (query, value[, key]). ``d_out`` is the
    output projection's width where it differs from ``n_out``."""

    n_out: int = 0
    n_heads: int = 1
    n_in_queries: int = 0
    n_in_keys: int = 0
    n_in_values: int = 0
    keras_order: bool = False
    has_bias: bool = False
    d_out: int = 0

    def output_type(self, itype):
        return InputType.recurrent(self.d_out or self.n_out, itype.timesteps)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class Convolution1D(LayerConf):
    """conf/layers/Convolution1DLayer.java: temporal convolution over
    (N, T, C), W (k, C_in, C_out)."""

    n_in: int = 0
    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    convolution_mode: str = "same"  # same | valid (truncate)
    dilation: int = 1

    def output_type(self, itype):
        t = itype.timesteps
        if t and t > 0:
            if self.convolution_mode == "same":
                t = -(-t // self.stride)
            else:
                eff = (self.kernel - 1) * self.dilation + 1
                t = (t - eff) // self.stride + 1
        return InputType.recurrent(self.n_out, t)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class Convolution3D(LayerConf):
    """conf/layers/Convolution3D.java: volumetric convolution over
    (N, D, H, W, C), W (kd, kh, kw, C_in, C_out)."""

    n_in: int = 0
    n_out: int = 0
    kernel: Tuple[int, int, int] = (3, 3, 3)
    stride: Tuple[int, int, int] = (1, 1, 1)
    convolution_mode: str = "same"

    def output_type(self, itype):
        def out(sz, k, s):
            return -(-sz // s) if self.convolution_mode == "same" \
                else (sz - k) // s + 1

        k, s = self.kernel, self.stride
        return InputType.convolutional3d(
            out(itype.depth, k[0], s[0]), out(itype.height, k[1], s[1]),
            out(itype.width, k[2], s[2]), self.n_out)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class Subsampling3DLayer(LayerConf):
    """conf/layers/Subsampling3DLayer.java: 3-D pooling (NDHWC), valid."""

    kernel: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (2, 2, 2)
    pooling_type: str = "max"

    def output_type(self, itype):
        k, s = self.kernel, self.stride
        return InputType.convolutional3d(
            (itype.depth - k[0]) // s[0] + 1,
            (itype.height - k[1]) // s[1] + 1,
            (itype.width - k[2]) // s[2] + 1, itype.channels)


@dataclasses.dataclass(frozen=True)
class LocallyConnected2D(LayerConf):
    """conf/layers/LocallyConnected2D.java: the convolution's topology
    with unshared per-position weights."""

    n_in: int = 0
    n_out: int = 0
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    input_size: Tuple[int, int] = (0, 0)  # inferred at build when 0

    def output_type(self, itype):
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        return InputType.convolutional(
            (itype.height - kh) // sh + 1, (itype.width - kw) // sw + 1,
            self.n_out)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class LocallyConnected1D(LayerConf):
    """conf/layers/LocallyConnected1D.java: temporal locally connected."""

    n_in: int = 0
    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    input_size: int = 0

    def output_type(self, itype):
        t = (itype.timesteps - self.kernel) // self.stride + 1 \
            if itype.timesteps and itype.timesteps > 0 else itype.timesteps
        return InputType.recurrent(self.n_out, t)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class PReLULayer(LayerConf):
    """conf/layers/PReLULayer.java: max(0, x) + alpha · min(0, x) with a
    learned per-feature alpha (``n_in`` features, the last axis)."""

    n_in: int = 0

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class ZeroPadding1DLayer(LayerConf):
    """conf/layers/ZeroPadding1DLayer.java: pads the time axis of
    (N, T, C)."""

    padding: Tuple[int, int] = (1, 1)

    def output_type(self, itype):
        t = itype.timesteps
        p = _pair(self.padding)
        return InputType.recurrent(
            itype.size, t + p[0] + p[1] if t and t > 0 else t)


@dataclasses.dataclass(frozen=True)
class ZeroPaddingLayer(LayerConf):
    """conf/layers/ZeroPaddingLayer.java: NHWC spatial zero padding,
    ``padding`` = (top, bottom, left, right)."""

    padding: Tuple[int, int, int, int] = (1, 1, 1, 1)

    def output_type(self, itype):
        t, b, l, r = self.padding
        return InputType.convolutional(itype.height + t + b,
                                       itype.width + l + r, itype.channels)


@dataclasses.dataclass(frozen=True)
class ZeroPadding3DLayer(LayerConf):
    """conf/layers/ZeroPadding3DLayer.java: NDHWC zero padding,
    ``padding`` = (d_lo, d_hi, h_lo, h_hi, w_lo, w_hi)."""

    padding: Tuple[int, int, int, int, int, int] = (1, 1, 1, 1, 1, 1)

    def output_type(self, itype):
        p = self.padding
        return InputType.convolutional3d(
            itype.depth + p[0] + p[1], itype.height + p[2] + p[3],
            itype.width + p[4] + p[5], itype.channels)


@dataclasses.dataclass(frozen=True)
class Cropping1D(LayerConf):
    """conf/layers/convolutional/Cropping1D.java: crops the time axis."""

    cropping: Tuple[int, int] = (1, 1)

    def output_type(self, itype):
        t = itype.timesteps
        c = _pair(self.cropping)
        return InputType.recurrent(
            itype.size, t - c[0] - c[1] if t and t > 0 else t)


@dataclasses.dataclass(frozen=True)
class Cropping2D(LayerConf):
    """conf/layers/convolutional/Cropping2D.java: NHWC crop, ``cropping``
    = (top, bottom, left, right)."""

    cropping: Tuple[int, int, int, int] = (1, 1, 1, 1)

    def output_type(self, itype):
        t, b, l, r = self.cropping
        return InputType.convolutional(itype.height - t - b,
                                       itype.width - l - r, itype.channels)


@dataclasses.dataclass(frozen=True)
class Cropping3D(LayerConf):
    """conf/layers/convolutional/Cropping3D.java: NDHWC crop, ``cropping``
    = (d_lo, d_hi, h_lo, h_hi, w_lo, w_hi)."""

    cropping: Tuple[int, int, int, int, int, int] = (1, 1, 1, 1, 1, 1)

    def output_type(self, itype):
        c = self.cropping
        return InputType.convolutional3d(
            itype.depth - c[0] - c[1], itype.height - c[2] - c[3],
            itype.width - c[4] - c[5], itype.channels)


@dataclasses.dataclass(frozen=True)
class Upsampling1D(LayerConf):
    """conf/layers/Upsampling1D.java: each timestep repeated ``size``
    times."""

    size: int = 2

    def output_type(self, itype):
        t = itype.timesteps
        return InputType.recurrent(itype.size,
                                   t * self.size if t and t > 0 else t)


@dataclasses.dataclass(frozen=True)
class Upsampling3D(LayerConf):
    """conf/layers/Upsampling3D.java: nearest upsampling, NDHWC."""

    size: Tuple[int, int, int] = (2, 2, 2)

    def output_type(self, itype):
        s = self.size
        return InputType.convolutional3d(
            itype.depth * s[0], itype.height * s[1], itype.width * s[2],
            itype.channels)


@dataclasses.dataclass(frozen=True)
class Subsampling1DLayer(LayerConf):
    """conf/layers/Subsampling1DLayer.java: temporal pooling over
    (N, T, C)."""

    kernel: int = 2
    stride: int = 2
    pooling_type: str = "max"  # max | avg
    convolution_mode: str = "valid"

    def output_type(self, itype):
        t = itype.timesteps
        if t and t > 0:
            if self.convolution_mode == "same":
                t = -(-t // self.stride)
            else:
                t = (t - self.kernel) // self.stride + 1
        return InputType.recurrent(itype.size, t)


@dataclasses.dataclass(frozen=True)
class Deconvolution3D(LayerConf):
    """conf/layers/Deconvolution3D.java: transposed volumetric
    convolution, NDHWC, W (kd, kh, kw, C_in, C_out)."""

    n_in: int = 0
    n_out: int = 0
    kernel: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (2, 2, 2)
    convolution_mode: str = "valid"

    def output_type(self, itype):
        def out(sz, k, s):
            return sz * s if self.convolution_mode == "same" \
                else (sz - 1) * s + k

        k, s = self.kernel, self.stride
        return InputType.convolutional3d(
            out(itype.depth, k[0], s[0]), out(itype.height, k[1], s[1]),
            out(itype.width, k[2], s[2]), self.n_out)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class MaskZeroLayer(LayerConf):
    """conf/layers/recurrent/MaskZeroLayer.java: masks the timesteps
    whose features all equal ``mask_value``, then runs the wrapped layer
    (``underlying``, a config or its dict) under that mask."""

    underlying: Optional[Any] = None
    mask_value: float = 0.0

    def inner(self) -> LayerConf:
        u = self.underlying
        return LayerConf.from_dict(u) if isinstance(u, dict) else u

    def output_type(self, itype):
        return self.inner().output_type(itype)

    def has_params(self):
        return self.inner().has_params()

    def to_dict(self):
        d = super().to_dict()
        if isinstance(d.get("underlying"), LayerConf):
            d["underlying"] = d["underlying"].to_dict()
        return d


@dataclasses.dataclass(frozen=True)
class RepeatVector(LayerConf):
    """conf/layers/misc/RepeatVector.java: (N, F) -> (N, n, F)."""

    n: int = 1

    def output_type(self, itype):
        return InputType.recurrent(itype.flat_size(), self.n)


@dataclasses.dataclass(frozen=True)
class PermuteLayer(LayerConf):
    """Permutation of the non-batch axes (Keras Permute; ``dims``
    1-indexed, as Keras writes them)."""

    dims: tuple = ()

    def output_type(self, itype):
        if itype.kind == "recurrent" and tuple(self.dims) == (2, 1):
            return InputType.recurrent(itype.timesteps, itype.size)
        if itype.kind == "convolutional" and len(self.dims) == 3:
            hwc = (itype.height, itype.width, itype.channels)
            ph, pw, pc = (hwc[d - 1] for d in self.dims)
            return InputType.convolutional(ph, pw, pc)
        if itype.kind == "feedforward":
            return itype
        raise ValueError(
            f"PermuteLayer: cannot infer the permuted shape for dims "
            f"{self.dims} on a {itype.kind} input")


@dataclasses.dataclass(frozen=True)
class ReshapeLayer(LayerConf):
    """Batch-preserving reshape (Keras Reshape); ``target_shape`` leaves
    out the batch axis, -1 is inferred."""

    target_shape: tuple = ()

    def output_type(self, itype):
        flat = itype.flat_size()
        shape = list(self.target_shape)
        if -1 in shape:
            known = 1
            for s in shape:
                if s != -1:
                    known *= int(s)
            shape[shape.index(-1)] = flat // max(known, 1)
        if len(shape) == 1:
            return InputType.feed_forward(shape[0])
        if len(shape) == 2:
            return InputType.recurrent(shape[1], shape[0])
        if len(shape) == 3:
            return InputType.convolutional(shape[0], shape[1], shape[2])
        return InputType.feed_forward(flat)


@dataclasses.dataclass(frozen=True)
class LayerNormalization(LayerConf):
    """Layer norm over the trailing axis with a learned gain and bias
    (Keras LayerNormalization; the catalog ``layer_norm`` op as a
    layer)."""

    n_out: int = 0
    eps: float = 1e-3

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class GroupNormalization(LayerConf):
    """Group norm over the channel axis (Keras GroupNormalization);
    ``groups`` -1 is instance norm, 1 layer norm over space and
    channels."""

    n_out: int = 0
    groups: int = 32
    eps: float = 1e-3

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class RescaleLayer(LayerConf):
    """x · scale + offset, broadcast per feature (Keras Rescaling and the
    adapted Normalization)."""

    scale: Any = 1.0
    offset: Any = 0.0


@dataclasses.dataclass(frozen=True)
class DiscretizationLayer(LayerConf):
    """Keras Discretization: values -> int32 bin indices by the given
    ascending boundaries."""

    bin_boundaries: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class CategoryEncodingLayer(LayerConf):
    """Keras CategoryEncoding: int ids -> one_hot / multi_hot / count
    vectors of width ``num_tokens``."""

    num_tokens: int = 0
    output_mode: str = "multi_hot"

    def output_type(self, itype):
        return InputType.feed_forward(self.num_tokens)


@dataclasses.dataclass(frozen=True)
class EinsumDenseLayer(LayerConf):
    """Keras EinsumDense: einsum(equation, x, W) (+ a bias of
    ``bias_shape``); ``out_shape`` holds the kernel's output dims, without
    the batch dims."""

    equation: str = ""
    out_shape: Tuple[int, ...] = ()
    bias_shape: Tuple[int, ...] = ()  # () = no bias

    def output_type(self, itype):
        eq = self.equation.replace(" ", "")
        out_spec = eq.split("->")[1]
        if itype.kind == "recurrent":
            # '...' keeps the (batch, time) prefix; an explicit output
            # spec keeps the recurrent shape only while it is rank 3
            if "..." in out_spec or len(out_spec) >= 3:
                return InputType.recurrent(int(self.out_shape[-1]),
                                           itype.timesteps)
            return InputType.feed_forward(int(self.out_shape[-1]))
        return InputType.feed_forward(int(math.prod(self.out_shape))
                                      if self.out_shape
                                      else itype.flat_size())

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class UnitNormLayer(LayerConf):
    """L2 normalization along the trailing axis (Keras
    UnitNormalization)."""

    eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class ConvLSTM2D(LayerConf):
    """Convolutional LSTM over (N, T, H, W, C) (Keras ConvLSTM2D), gate
    order i, f, o, g; the input-to-gate convolution takes ``padding``, the
    recurrent one is always 'same'."""

    n_in: int = 0
    filters: int = 0
    kernel: tuple = (3, 3)
    padding: str = "same"
    return_sequences: bool = False
    gate_activation: str = "sigmoid"

    def has_params(self):
        return True

    def output_type(self, itype):
        if self.padding not in ("same", "truncate", "valid"):
            raise ValueError(f"ConvLSTM2D padding {self.padding!r}")
        h, w = itype.height, itype.width
        if self.padding in ("truncate", "valid"):
            h = h - self.kernel[0] + 1
            w = w - self.kernel[1] + 1
        if self.return_sequences:
            return InputType("convolutional3d", depth=itype.depth or -1,
                             height=h, width=w, channels=self.filters)
        return InputType.convolutional(h, w, self.filters)


@dataclasses.dataclass(frozen=True)
class DotAttentionLayer(LayerConf):
    """Keras Attention / AdditiveAttention without parameters: inputs in
    Keras order (query, value[, key]); ``additive`` scores Bahdanau-style,
    tanh(q + k) reduced by ``scale`` under ``use_scale``."""

    use_scale: bool = False
    additive: bool = False
    scale: Any = None


@dataclasses.dataclass(frozen=True)
class SeparableConvolution1D(LayerConf):
    """Depthwise then pointwise temporal convolution over (N, T, C) (Keras
    SeparableConv1D): dW (k, 1, C · mult), pW (1, C · mult, n_out)."""

    n_in: int = 0
    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    convolution_mode: str = "truncate"
    depth_multiplier: int = 1
    has_bias: bool = True

    def output_type(self, itype):
        t = itype.timesteps
        if t and t > 0:
            if self.convolution_mode == "same":
                t = -(-t // self.stride)
            else:
                t = (t - self.kernel) // self.stride + 1
        return InputType.recurrent(self.n_out, t)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class Deconvolution1D(LayerConf):
    """Transposed temporal convolution over (N, T, C) (Keras
    Conv1DTranspose), W (k, C_in, C_out)."""

    n_in: int = 0
    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def output_type(self, itype):
        t = itype.timesteps
        if t and t > 0:
            if self.convolution_mode == "same":
                t = t * self.stride
            else:
                t = (t - 1) * self.stride + self.kernel
        return InputType.recurrent(self.n_out, t)

    def has_params(self):
        return True


@dataclasses.dataclass(frozen=True)
class ResizeLayer(LayerConf):
    """Spatial resize to a fixed (height, width) (Keras Resizing) over
    the catalog's resize ops."""

    height: int = 0
    width: int = 0
    method: str = "bilinear"  # bilinear | nearest | bicubic

    def output_type(self, itype):
        return InputType.convolutional(self.height, self.width,
                                       itype.channels)


@dataclasses.dataclass(frozen=True)
class CenterCropLayer(LayerConf):
    """Center crop to (height, width) (Keras CenterCrop)."""

    height: int = 0
    width: int = 0

    def output_type(self, itype):
        return InputType.convolutional(self.height, self.width,
                                       itype.channels)


LAYER_TYPES = {c.__name__: c for c in [
    DenseLayer, OutputLayer, ConvolutionLayer, Deconvolution2D,
    DepthwiseConvolution2D, SeparableConvolution2D, SubsamplingLayer,
    Upsampling2D, GlobalPoolingLayer, BatchNormalization,
    LocalResponseNormalization, ActivationLayer, SpaceToDepthLayer,
    FusedBottleneck, LossLayer, EmbeddingLayer, EmbeddingSequenceLayer,
    DropoutLayer, LSTM, GravesLSTM, GRU, SimpleRnn, Bidirectional,
    RnnOutputLayer, LastTimeStep, RnnLossLayer,
    # the Keras importer's
    AttentionVertex, Convolution1D, Convolution3D, Subsampling3DLayer,
    LocallyConnected2D, LocallyConnected1D, PReLULayer, ZeroPadding1DLayer,
    ZeroPaddingLayer, ZeroPadding3DLayer, Cropping1D, Cropping2D, Cropping3D,
    Upsampling1D, Upsampling3D, Subsampling1DLayer, Deconvolution3D,
    MaskZeroLayer, RepeatVector, PermuteLayer, ReshapeLayer,
    LayerNormalization, GroupNormalization, RescaleLayer,
    DiscretizationLayer, CategoryEncodingLayer, EinsumDenseLayer,
    UnitNormLayer, ConvLSTM2D, DotAttentionLayer, SeparableConvolution1D,
    Deconvolution1D, ResizeLayer, CenterCropLayer]}

# the conv-family layers a flat convolutional input is reshaped for
# (``_adapt``'s FeedForwardToCnnPreProcessor)
_CNN_LAYERS = (ConvolutionLayer, SubsamplingLayer, Upsampling2D,
               LocalResponseNormalization)


# ---------------------------------------------------------------------------
# Preprocessors (conf/preprocessor/*): shape adapters between layers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputPreProcessor:
    """Base preprocessor, applied to the activations flowing into a
    layer."""

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["@type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d):
        if d is None:
            return None
        d = dict(d)
        name = d.pop("@type")
        cls = PREPROCESSORS.get(name)
        if cls is None:
            raise ValueError(
                f"preprocessor type {name!r} is not ported to "
                f"deeplearning4j_tpu_torch yet; ported: "
                f"{sorted(PREPROCESSORS)}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """(N, C·H·W) in the reference's NCHW flat order -> (N, H, W, C)."""

    height: int = 0
    width: int = 0
    channels: int = 0


@dataclasses.dataclass(frozen=True)
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """(N, H, W, C) -> (N, C·H·W), flattened channel-major (the
    reference's NCHW order), so flat parameters and activations line up
    with the JAX package's."""

    height: int = 0
    width: int = 0
    channels: int = 0


@dataclasses.dataclass(frozen=True)
class Cnn3DToFeedForwardPreProcessor(InputPreProcessor):
    """(N, D, H, W, C) -> (N, C·D·H·W), flattened channel-major (the
    reference's NCDHW order)."""

    depth: int = 0
    height: int = 0
    width: int = 0
    channels: int = 0


@dataclasses.dataclass(frozen=True)
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """(N, T, F) -> (N·T, F)."""


@dataclasses.dataclass(frozen=True)
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """(N·T, F) -> (N, T, F); needs the batch size, so it is refused
    standalone, as in the JAX package."""


PREPROCESSORS = {c.__name__: c for c in [
    FeedForwardToCnnPreProcessor, CnnToFeedForwardPreProcessor,
    Cnn3DToFeedForwardPreProcessor, RnnToFeedForwardPreProcessor,
    FeedForwardToRnnPreProcessor]}


# ---------------------------------------------------------------------------
# Net-wide defaults
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiLayerConfiguration:
    """MultiLayerConfiguration.java: ordered layers, their preprocessors
    and the net-wide defaults (``ComputationGraph`` builds one as its
    defaults view). ``input_type`` drives the build-time shape inference:
    ``n_in`` fields left at 0 are filled and preprocessors inserted where
    the reference's InputType logic puts them. ``backprop_type`` "tbptt"
    with ``tbptt_fwd_length`` > 0 trains by truncated BPTT."""

    layers: List[LayerConf] = dataclasses.field(default_factory=list)
    preprocessors: Dict[int, InputPreProcessor] = dataclasses.field(
        default_factory=dict)
    input_type: Optional[InputType] = None
    seed: int = 0
    updater: Any = dataclasses.field(default_factory=Adam)
    activation: str = "identity"
    weight_init: str = "xavier"
    l1: float = 0.0
    l2: float = 0.0
    weight_decay: float = 0.0
    dtype: str = "float32"
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    tbptt_fwd_length: int = -1
    tbptt_back_length: int = -1
    backprop_type: str = "standard"  # standard | tbptt

    def to_json(self) -> str:
        return json.dumps({
            "layers": [lc.to_dict() for lc in self.layers],
            "preprocessors": {str(k): v.to_dict()
                              for k, v in self.preprocessors.items()},
            "input_type": (self.input_type.to_dict() if self.input_type
                           else None),
            "seed": self.seed,
            "updater": {"__updater__": get_updater(self.updater).to_dict()},
            "activation": self.activation,
            "weight_init": self.weight_init,
            "l1": self.l1, "l2": self.l2, "weight_decay": self.weight_decay,
            "dtype": self.dtype,
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "backprop_type": self.backprop_type,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        return MultiLayerConfiguration(
            layers=[LayerConf.from_dict(lc) for lc in d["layers"]],
            preprocessors={int(k): InputPreProcessor.from_dict(v)
                           for k, v in d.get("preprocessors", {}).items()},
            input_type=(InputType.from_dict(d["input_type"])
                        if d.get("input_type") else None),
            seed=d.get("seed", 0),
            updater=Updater.from_dict(d["updater"]["__updater__"]),
            activation=d.get("activation", "identity"),
            weight_init=d.get("weight_init", "xavier"),
            l1=d.get("l1", 0.0), l2=d.get("l2", 0.0),
            weight_decay=d.get("weight_decay", 0.0),
            dtype=d.get("dtype", "float32"),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0),
            tbptt_fwd_length=d.get("tbptt_fwd_length", -1),
            tbptt_back_length=d.get("tbptt_back_length", -1),
            backprop_type=d.get("backprop_type", "standard"),
        )

    def layer_activation(self, lc: LayerConf) -> str:
        return lc.activation if lc.activation is not None else self.activation

    def layer_weight_init(self, lc: LayerConf) -> str:
        return (lc.weight_init if lc.weight_init is not None
                else self.weight_init)

    def layer_updater(self, lc: LayerConf) -> Updater:
        return get_updater(lc.updater if lc.updater is not None
                           else self.updater)

    def layer_l1(self, lc: LayerConf) -> float:
        return lc.l1 if lc.l1 is not None else self.l1

    def layer_l2(self, lc: LayerConf) -> float:
        return lc.l2 if lc.l2 is not None else self.l2

    def layer_weight_decay(self, lc: LayerConf) -> float:
        return (lc.weight_decay if lc.weight_decay is not None
                else self.weight_decay)


class NeuralNetConfigurationBuilder:
    """NeuralNetConfiguration.Builder + ListBuilder in one fluent object::

        conf = (builder().seed(42).updater(Adam(1e-3)).list()
                .layer(ConvolutionLayer(...)).layer(...)
                .set_input_type(InputType.convolutional_flat(28, 28, 1))
                .build())
    """

    def __init__(self) -> None:
        self._conf = MultiLayerConfiguration()

    def _set(self, **kw):
        for k, v in kw.items():
            setattr(self._conf, k, v)
        return self

    def seed(self, s: int):
        return self._set(seed=s)

    def updater(self, u):
        return self._set(updater=u)

    def activation(self, a: str):
        return self._set(activation=a)

    def weight_init(self, w: str):
        return self._set(weight_init=w)

    def l1(self, v: float):
        return self._set(l1=v)

    def l2(self, v: float):
        return self._set(l2=v)

    def weight_decay(self, v: float):
        return self._set(weight_decay=v)

    def dtype(self, d: str):
        return self._set(dtype=d)

    def gradient_normalization(self, kind: str, threshold: float = 1.0):
        return self._set(gradient_normalization=kind,
                         gradient_normalization_threshold=threshold)

    def tbptt(self, fwd_length: int, back_length: Optional[int] = None):
        return self._set(backprop_type="tbptt", tbptt_fwd_length=fwd_length,
                         tbptt_back_length=back_length or fwd_length)

    def list(self):
        return self

    def layer(self, lc: LayerConf):
        self._conf.layers.append(lc)
        return self

    def input_pre_processor(self, idx: int, p: InputPreProcessor):
        self._conf.preprocessors[idx] = p
        return self

    def set_input_type(self, itype: InputType):
        return self._set(input_type=itype)

    def build(self) -> MultiLayerConfiguration:
        conf = self._conf
        if conf.input_type is not None:
            _infer_shapes(conf)
        return conf


def builder() -> NeuralNetConfigurationBuilder:
    return NeuralNetConfigurationBuilder()


def _infer_shapes(conf: MultiLayerConfiguration) -> None:
    """setInputType: fill ``n_in`` = 0 fields, insert preprocessors."""
    itype = conf.input_type
    new_layers: List[LayerConf] = []
    for i, lc in enumerate(conf.layers):
        itype, lc = _adapt(conf, i, itype, lc)
        new_layers.append(lc)
        itype = lc.output_type(itype)
    conf.layers = new_layers


def _adapt(conf, i, itype, lc) -> Tuple[InputType, LayerConf]:
    """Insert a preprocessor and fill ``n_in`` for one layer
    (InputType.getPreProcessorForInputType)."""
    needs_ff = isinstance(lc, (DenseLayer, EmbeddingLayer))
    is_conv = isinstance(lc, _CNN_LAYERS)
    if i not in conf.preprocessors:
        if itype.kind == "convolutionalflat" and is_conv:
            conf.preprocessors[i] = FeedForwardToCnnPreProcessor(
                itype.height, itype.width, itype.channels)
            itype = InputType.convolutional(itype.height, itype.width,
                                            itype.channels)
        elif itype.kind == "convolutional" and needs_ff:
            conf.preprocessors[i] = CnnToFeedForwardPreProcessor(
                itype.height, itype.width, itype.channels)
            itype = InputType.feed_forward(itype.flat_size())
        elif itype.kind == "convolutional3d" and needs_ff:
            conf.preprocessors[i] = Cnn3DToFeedForwardPreProcessor(
                itype.depth, itype.height, itype.width, itype.channels)
            itype = InputType.feed_forward(itype.flat_size())
        elif itype.kind == "convolutionalflat" and needs_ff:
            itype = InputType.feed_forward(itype.size)
    else:
        p = conf.preprocessors[i]
        if isinstance(p, FeedForwardToCnnPreProcessor):
            itype = InputType.convolutional(p.height, p.width, p.channels)
        elif isinstance(p, CnnToFeedForwardPreProcessor):
            itype = InputType.feed_forward(p.height * p.width * p.channels)
    if isinstance(lc, (Bidirectional, LastTimeStep)):
        # the wrapped config's n_in, then the wrapper rebuilt around it
        inner = lc.inner()
        if getattr(inner, "n_in", 1) == 0:
            size = (itype.size if itype.kind == "recurrent"
                    else itype.flat_size())
            lc = dataclasses.replace(lc, fwd=dataclasses.replace(
                inner, n_in=size).to_dict())
        return itype, lc
    return itype, _fill(itype, lc)


def _fill(itype: InputType, lc: LayerConf) -> LayerConf:
    """``lc`` with ``n_in`` = 0, a normalization's ``n_out`` = 0 and a
    locally connected layer's ``input_size`` filled from ``itype``."""
    updates: Dict[str, Any] = {}
    if hasattr(lc, "n_in") and getattr(lc, "n_in") == 0:
        if itype.kind in ("feedforward", "convolutionalflat"):
            updates["n_in"] = itype.flat_size()
        elif itype.kind == "recurrent":
            updates["n_in"] = itype.size
        elif itype.kind in ("convolutional", "convolutional3d"):
            updates["n_in"] = itype.channels
    if isinstance(lc, (BatchNormalization, LayerNormalization,
                       GroupNormalization)) and lc.n_out == 0:
        # all three normalize the trailing (feature / channel) axis
        updates["n_out"] = (itype.channels
                            if itype.kind in ("convolutional",
                                              "convolutional3d")
                            else (itype.size if itype.kind == "recurrent"
                                  else itype.flat_size()))
    if isinstance(lc, LocallyConnected2D) and tuple(lc.input_size) == (0, 0):
        updates["input_size"] = (itype.height, itype.width)
    if isinstance(lc, LocallyConnected1D) and lc.input_size == 0:
        if not itype.timesteps or itype.timesteps < 0:
            raise ValueError(
                "LocallyConnected1D needs a fixed sequence length — set "
                "input_size or use InputType.recurrent(size, timesteps)")
        updates["input_size"] = itype.timesteps
    if updates:
        lc = dataclasses.replace(lc, **updates)
    return lc


def infer_layer(itype: InputType, lc: LayerConf
                ) -> Tuple[InputType, LayerConf]:
    """Fill what :func:`_fill` fills from the input type, as
    :func:`_adapt` does for one layer of a graph (no preprocessors: a flat
    convolutional input feeding a conv/pool layer is taken as
    convolutional)."""
    if itype.kind == "convolutionalflat" and isinstance(lc, _CNN_LAYERS):
        itype = InputType.convolutional(itype.height, itype.width,
                                        itype.channels)
    elif itype.kind == "convolutionalflat" and isinstance(
            lc, (DenseLayer, EmbeddingLayer)):
        itype = InputType.feed_forward(itype.size)
    return itype, _fill(itype, lc)
