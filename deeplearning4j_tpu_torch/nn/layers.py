"""Runtime layers: ``init`` / ``apply`` per layer config.

Counterpart of the part of ``deeplearning4j_tpu/nn/layers.py`` that
ResNet-50 reaches. A layer is
``apply(params, x, state, *, train, rng, mask) -> (y, new_state, mask)``
over NHWC activations and HWIO kernels; ``state`` carries the
non-trainable buffers (BatchNormalization's running statistics).
Parameter names are the JAX package's ("W", "b", "gamma", "beta"), so
its parameter trees carry across unchanged. Gradients come from autograd
(BatchNormalization's through the hand-written ``_BNCore`` backward).

``init`` draws from an explicit ``torch.Generator`` and puts the tensors
on the layer's device.
"""

from __future__ import annotations

from typing import Dict, Type

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn.dtype import param_dtype
from deeplearning4j_tpu_torch.ops import exec_op, nn_ops
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.weight_init import init_weights

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]


class Layer:
    """Runtime twin of one LayerConf."""

    def __init__(self, net_conf: C.MultiLayerConfiguration, lc: C.LayerConf,
                 itype: C.InputType, device: torch.device):
        self.net_conf = net_conf
        self.lc = lc
        self.itype = itype
        self.otype = lc.output_type(itype)
        self.activation = get_activation(net_conf.layer_activation(lc))
        self.winit = net_conf.layer_weight_init(lc)
        self.dtype = param_dtype(net_conf.dtype)
        self.device = device

    def init(self, gen: torch.Generator) -> Params:
        return {}

    def init_state(self) -> State:
        return {}

    def apply(self, params: Params, x, state: State, *, train: bool, rng,
              mask=None):
        raise NotImplementedError

    def _weights(self, gen, shape):
        return init_weights(gen, shape, self.winit, dtype=self.dtype,
                            device=self.device)

    def _zeros(self, n):
        return torch.zeros((n,), dtype=self.dtype, device=self.device)

    def _ones(self, n):
        return torch.ones((n,), dtype=self.dtype, device=self.device)

    def _maybe_dropout(self, x, *, train: bool, rng):
        """Input dropout (BaseLayer.applyDropOutIfNecessary). Not ported
        yet: no ResNet-50 layer sets it."""
        if self.lc.dropout and train:
            raise NotImplementedError(
                f"{type(self.lc).__name__}: layer dropout is not ported to "
                f"deeplearning4j_tpu_torch yet")
        return x


class DenseLayerImpl(Layer):
    """layers/feedforward/dense/DenseLayer.java: out = act(xW + b)."""

    def init(self, gen) -> Params:
        lc = self.lc
        p = {"W": self._weights(gen, (lc.n_in, lc.n_out))}
        if lc.has_bias:
            p["b"] = self._zeros(lc.n_out)
        return p

    def apply(self, params, x, state, *, train, rng, mask=None):
        x = self._maybe_dropout(x, train=train, rng=rng)
        z = x @ params["W"]
        if "b" in params:
            z = z + params["b"]
        return self.activation(z), state, mask


class OutputLayerImpl(DenseLayerImpl):
    """layers/OutputLayer.java: dense + loss (applied by the network)."""


class ConvolutionLayerImpl(Layer):
    """layers/convolution/ConvolutionLayer.java (NHWC, HWIO)."""

    def init(self, gen) -> Params:
        lc = self.lc
        kh, kw = C._pair(lc.kernel)
        p = {"W": self._weights(gen, (kh, kw, lc.n_in, lc.n_out))}
        if lc.has_bias:
            p["b"] = self._zeros(lc.n_out)
        return p

    def _conv_args(self):
        lc = self.lc
        if lc.convolution_mode == "same":
            padding = "same"
        else:
            ph, pw = C._pair(lc.padding)
            padding = ((ph, ph), (pw, pw))
        return dict(stride=C._pair(lc.stride), padding=padding,
                    dilation=C._pair(lc.dilation))

    def apply(self, params, x, state, *, train, rng, mask=None):
        x = self._maybe_dropout(x, train=train, rng=rng)
        if self.lc.s2d_stem:
            z = self._s2d_stem_conv(x, params["W"], params.get("b"))
        else:
            z = nn_ops.conv2d.fn(x, params["W"], params.get("b"),
                                 **self._conv_args())
        return self.activation(z), state, mask

    def _s2d_stem_conv(self, x, W, b):
        """7×7/2 'same' conv as a 4×4/1 conv over a 2×2 space-to-depth
        input (``layers.py:169``): the kernel is zero-padded to 8×8 on the
        high edge and regrouped to (4, 4, 4·C, F) in space_to_depth's
        channel order; the stride-2 'same' pads (2, 3) become (1, 2).
        Gradients reach only the canonical 7×7 entries."""
        lc = self.lc
        if (C._pair(lc.kernel) != (7, 7) or C._pair(lc.stride) != (2, 2)
                or C._pair(lc.dilation) != (1, 1)
                or lc.convolution_mode != "same"
                or x.shape[1] % 2 or x.shape[2] % 2):
            return nn_ops.conv2d.fn(x, W, b, **self._conv_args())
        c_in, f = W.shape[2], W.shape[3]
        wp = F.pad(W, (0, 0, 0, 0, 0, 1, 0, 1))
        w2 = (wp.reshape(4, 2, 4, 2, c_in, f).permute(0, 2, 1, 3, 4, 5)
              .reshape(4, 4, 4 * c_in, f))
        x2 = exec_op("space_to_depth", x, block_size=2)
        return nn_ops.conv2d.fn(x2, w2, b, stride=(1, 1),
                                padding=((1, 2), (1, 2)))


class SubsamplingLayerImpl(Layer):
    """layers/convolution/subsampling/SubsamplingLayer.java."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        if lc.convolution_mode == "same":
            pad = "same"
        else:
            ph, pw = C._pair(lc.padding)
            pad = ((ph, ph), (pw, pw))
        kw = dict(kernel=C._pair(lc.kernel), stride=C._pair(lc.stride),
                  padding=pad)
        if lc.pooling_type == "max":
            y = nn_ops.maxpool2d.fn(x, **kw)
        elif lc.pooling_type == "avg":
            y = nn_ops.avgpool2d.fn(x, **kw)
        elif lc.pooling_type == "pnorm":
            y = nn_ops.pnormpool2d.fn(x, p=lc.pnorm, **kw)
        else:
            raise ValueError(f"unknown pooling type {lc.pooling_type}")
        return y, state, mask


class GlobalPoolingLayerImpl(Layer):
    """layers/pooling/GlobalPoolingLayer.java — NHWC (axes 1, 2) or
    recurrent (axis 1 = time, mask-aware)."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        pt = self.lc.pooling_type
        p = getattr(self.lc, "pnorm", 2)
        if x.ndim == 4:
            axes, m = (1, 2), None
        else:
            axes, m = (1,), mask
        if m is not None:
            m3 = m[..., None].to(x.dtype)
            if pt == "avg":
                y = (x * m3).sum(axes) / torch.clamp_min(m3.sum(axes), 1e-8)
            elif pt == "sum":
                y = (x * m3).sum(axes)
            elif pt == "max":
                y = torch.where(m3 > 0, x, torch.full_like(x, -torch.inf)
                                ).amax(axes)
            else:
                y = ((torch.abs(x) ** p) * m3).sum(axes) ** (1.0 / p)
        elif pt == "avg":
            y = x.mean(axes)
        elif pt == "sum":
            y = x.sum(axes)
        elif pt == "max":
            y = x.amax(axes)
        else:
            y = (torch.abs(x) ** p).sum(axes) ** (1.0 / p)
        return y, state, None


class BatchNormalizationImpl(Layer):
    """layers/normalization/BatchNormalization.java: gamma/beta trainable,
    running mean/var in the layer state; running = decay·running +
    (1−decay)·batch."""

    def init(self, gen) -> Params:
        n = self.lc.n_out
        if self.lc.lock_gamma_beta:
            return {}
        return {"gamma": self._ones(n), "beta": self._zeros(n)}

    def init_state(self) -> State:
        n = self.lc.n_out
        return {"mean": self._zeros(n), "var": self._ones(n)}

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        gamma = params.get("gamma")
        beta = params.get("beta")
        if train:
            y, new_mean, new_var = nn_ops.batch_norm_train(
                x, gamma, beta, state["mean"], state["var"],
                axis=tuple(range(x.ndim - 1)), eps=lc.eps,
                momentum=lc.decay)
            return self.activation(y), {"mean": new_mean, "var": new_var}, mask
        y = nn_ops.batchnorm.fn(x, state["mean"], state["var"], gamma, beta,
                                eps=lc.eps)
        return self.activation(y), state, mask


class ActivationLayerImpl(Layer):
    """layers/ActivationLayer.java."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        return self.activation(x), state, mask


LAYER_IMPLS: Dict[Type[C.LayerConf], Type[Layer]] = {
    C.DenseLayer: DenseLayerImpl,
    C.OutputLayer: OutputLayerImpl,
    C.ConvolutionLayer: ConvolutionLayerImpl,
    C.SubsamplingLayer: SubsamplingLayerImpl,
    C.GlobalPoolingLayer: GlobalPoolingLayerImpl,
    C.BatchNormalization: BatchNormalizationImpl,
    C.ActivationLayer: ActivationLayerImpl,
}


def build_layer(net_conf: C.MultiLayerConfiguration, lc: C.LayerConf,
                itype: C.InputType, device: torch.device) -> Layer:
    impl = LAYER_IMPLS.get(type(lc))
    if impl is None and type(lc) is C.FusedBottleneck:
        # registered late: fused_blocks imports Layer from this module
        from deeplearning4j_tpu_torch.nn.fused_blocks import (
            FusedBottleneckImpl)
        LAYER_IMPLS[C.FusedBottleneck] = FusedBottleneckImpl
        impl = FusedBottleneckImpl
    if impl is None:
        raise ValueError(f"no runtime impl for layer config "
                         f"{type(lc).__name__}")
    return impl(net_conf, lc, itype, device)
