"""Declarative layer configuration with JSON round trip.

Counterpart of the part of ``deeplearning4j_tpu/nn/conf.py`` that
ComputationGraph training of ResNet-50 reaches: ``InputType``, the layer
configs ``ConvolutionLayer`` (with ``s2d_stem``), ``SubsamplingLayer``,
``GlobalPoolingLayer``, ``BatchNormalization``, ``ActivationLayer``,
``DenseLayer``/``OutputLayer`` and ``FusedBottleneck``, the net-wide
default lookups, and the ``to_dict``/``from_dict`` JSON the JAX package
writes ("@type" discriminators, lists for tuples, ``{"__updater__": ...}``
for per-layer updaters). The field names and defaults are the JAX
package's, so its JSON loads here. A layer type that is not ported yet is
refused by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn.updater import Adam, Updater, get_updater

# ---------------------------------------------------------------------------
# InputType — shape inference tokens (conf/inputs/InputType.java)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputType:
    """Shape token flowing between layer configs at build time: kind
    'feedforward', 'recurrent', 'convolutional' (height, width, channels;
    NHWC) or 'convolutionalflat'."""

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


LAYER_TYPES = {c.__name__: c for c in [
    DenseLayer, OutputLayer, ConvolutionLayer, SubsamplingLayer,
    GlobalPoolingLayer, BatchNormalization, ActivationLayer,
    FusedBottleneck]}


# ---------------------------------------------------------------------------
# Net-wide defaults
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiLayerConfiguration:
    """The net-wide defaults a layer resolves against
    (``MultiLayerConfiguration``'s fields and lookups). The sequential
    network itself is not ported yet; ComputationGraph builds one of these
    as its defaults view."""

    layers: List[LayerConf] = dataclasses.field(default_factory=list)
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


def infer_layer(itype: InputType, lc: LayerConf
                ) -> Tuple[InputType, LayerConf]:
    """Fill ``n_in`` (and a BatchNormalization's ``n_out``) from the input
    type, as the JAX ``_adapt`` does for one layer; a flat convolutional
    input feeding a conv/pool layer is taken as convolutional."""
    if itype.kind == "convolutionalflat" and isinstance(
            lc, (ConvolutionLayer, SubsamplingLayer)):
        itype = InputType.convolutional(itype.height, itype.width,
                                        itype.channels)
    elif itype.kind == "convolutionalflat" and isinstance(lc, DenseLayer):
        itype = InputType.feed_forward(itype.size)
    updates: Dict[str, Any] = {}
    if hasattr(lc, "n_in") and getattr(lc, "n_in") == 0:
        if itype.kind in ("feedforward", "convolutionalflat"):
            updates["n_in"] = itype.flat_size()
        elif itype.kind == "recurrent":
            updates["n_in"] = itype.size
        elif itype.kind in ("convolutional", "convolutional3d"):
            updates["n_in"] = itype.channels
    if isinstance(lc, BatchNormalization) and lc.n_out == 0:
        updates["n_out"] = (itype.channels
                            if itype.kind in ("convolutional",
                                              "convolutional3d")
                            else (itype.size if itype.kind == "recurrent"
                                  else itype.flat_size()))
    if updates:
        lc = dataclasses.replace(lc, **updates)
    return itype, lc
