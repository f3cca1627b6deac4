"""Runtime layers: ``init`` / ``apply`` per layer config.

Counterpart of the part of ``deeplearning4j_tpu/nn/layers.py`` that
ResNet-50, the zoo's other vision models and the sequential network
reach (dense, output, loss, embedding, convolution, transposed,
depthwise and separable convolution, upsampling, space-to-depth,
pooling, batch norm, LRN, activation, dropout, the
recurrent layers LSTM / GravesLSTM / GRU / SimpleRnn, Bidirectional,
RnnOutputLayer, LastTimeStep, RnnLossLayer) and
:func:`apply_preprocessor`. A layer is
``apply(params, x, state, *, train, rng, mask) -> (y, new_state, mask)``
over NHWC activations and HWIO kernels; ``state`` carries the
non-trainable buffers (BatchNormalization's running statistics).
Parameter names are the JAX package's ("W", "b", "gamma", "beta"; "dW",
"pW" for the separable convolution), so
its parameter trees carry across unchanged. Gradients come from autograd
(BatchNormalization's through the hand-written ``_BNCore`` backward).

``init`` draws from an explicit ``torch.Generator`` and puts the tensors
on the layer's device; ``rng`` in ``apply`` is the network's generator on
its device, which dropout draws from in training.

Recurrent layers also have ``apply_with_state(params, x, *, mask,
initial) -> (out, last_state)`` and ``zero_state(batch)``: the state
carried across tBPTT segments and ``rnn_time_step`` calls. The LSTM's
recurrence is the registry op ``lstm_layer`` (cuDNN on the card where its
gate admits the call, see :mod:`~deeplearning4j_tpu_torch.ops.cudnn_lstm`).
"""

from __future__ import annotations

from typing import Dict, Optional, Type

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn.dtype import param_dtype, promote
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
        """Input dropout (BaseLayer.applyDropOutIfNecessary): the layer's
        ``dropout`` drop rate on its input, in training only."""
        rate = self.lc.dropout
        if not rate or not train:
            return x
        return nn_ops.dropout.fn(x, rng, rate=rate)


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
        x, w = promote(x, params["W"])
        z = x @ w
        if "b" in params:
            z = z + params["b"]
        return self.activation(z), state, mask


class OutputLayerImpl(DenseLayerImpl):
    """layers/OutputLayer.java: dense + loss (applied by the network)."""


class LossLayerImpl(Layer):
    """layers/LossLayer.java: activation only; loss applied by the
    network."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        return self.activation(x), state, mask


class RnnLossLayerImpl(LossLayerImpl):
    """layers/recurrent/RnnLossLayer.java: per-timestep loss (N, T, C)."""


class EmbeddingLayerImpl(Layer):
    """layers/feedforward/embedding/EmbeddingLayer.java: ids -> rows."""

    def init(self, gen) -> Params:
        lc = self.lc
        p = {"W": self._weights(gen, (lc.n_in, lc.n_out))}
        if getattr(lc, "has_bias", False):
            p["b"] = self._zeros(lc.n_out)
        return p

    def apply(self, params, x, state, *, train, rng, mask=None):
        ids = x
        if ids.ndim == 2 and ids.shape[-1] == 1:
            ids = ids[:, 0]
        out = nn_ops.embedding_lookup.fn(params["W"], ids)
        if "b" in params:
            out = out + params["b"]
        return self.activation(out), state, mask


class EmbeddingSequenceLayerImpl(EmbeddingLayerImpl):
    """layers/feedforward/embedding/EmbeddingSequenceLayer.java:
    (N, T) ids -> (N, T, F)."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        ids = x
        if ids.ndim == 3 and ids.shape[-1] == 1:
            ids = ids[..., 0]
        out = nn_ops.embedding_lookup.fn(params["W"], ids)
        return self.activation(out), state, mask


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
        x, w, b = promote(x, params["W"], params.get("b"))
        if self.lc.s2d_stem:
            z = self._s2d_stem_conv(x, w, b)
        else:
            z = nn_ops.conv2d.fn(x, w, b, **self._conv_args())
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


class Deconvolution2DImpl(ConvolutionLayerImpl):
    """layers/convolution/Deconvolution2DLayer.java (transposed conv; W
    and b as a convolution's)."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        x = self._maybe_dropout(x, train=train, rng=rng)
        pad = "same" if lc.convolution_mode == "same" else C._pair(lc.padding)
        x, w, b = promote(x, params["W"], params.get("b"))
        z = nn_ops.deconv2d.fn(x, w, b, stride=C._pair(lc.stride),
                               padding=pad)
        return self.activation(z), state, mask


class DepthwiseConvolution2DImpl(Layer):
    """layers/convolution/DepthwiseConvolution2DLayer.java: W (kh, kw, C,
    mult), b (C·mult)."""

    def init(self, gen) -> Params:
        lc = self.lc
        kh, kw = C._pair(lc.kernel)
        mult = lc.depth_multiplier
        p = {"W": self._weights(gen, (kh, kw, lc.n_in, mult))}
        if lc.has_bias:
            p["b"] = self._zeros(lc.n_in * mult)
        return p

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        x = self._maybe_dropout(x, train=train, rng=rng)
        pad = "same" if lc.convolution_mode == "same" else "valid"
        x, w, b = promote(x, params["W"], params.get("b"))
        z = nn_ops.depthwise_conv2d.fn(
            x, w, b, stride=C._pair(lc.stride), padding=pad,
            dilation=C._pair(lc.dilation))
        return self.activation(z), state, mask


class SeparableConvolution2DImpl(Layer):
    """layers/convolution/SeparableConvolution2DLayer.java: dW (kh, kw, C,
    mult), pW (1, 1, C·mult, n_out), b (n_out)."""

    def init(self, gen) -> Params:
        lc = self.lc
        kh, kw = C._pair(lc.kernel)
        mult = lc.depth_multiplier
        p = {"dW": self._weights(gen, (kh, kw, lc.n_in, mult)),
             "pW": self._weights(gen, (1, 1, lc.n_in * mult, lc.n_out))}
        if lc.has_bias:
            p["b"] = self._zeros(lc.n_out)
        return p

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        x = self._maybe_dropout(x, train=train, rng=rng)
        pad = "same" if lc.convolution_mode == "same" else "valid"
        z = nn_ops.separable_conv2d.fn(
            *promote(x, params["dW"], params["pW"], params.get("b")),
            stride=C._pair(lc.stride), padding=pad)
        return self.activation(z), state, mask


class Upsampling2DImpl(Layer):
    """layers/convolution/upsampling/Upsampling2D.java."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        return (nn_ops.upsampling2d.fn(x, size=C._pair(self.lc.size)), state,
                mask)


class LocalResponseNormalizationImpl(Layer):
    """layers/normalization/LocalResponseNormalization.java."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        y = nn_ops.local_response_normalization.fn(
            x, depth=lc.n, bias=lc.k, alpha=lc.alpha, beta=lc.beta)
        return y, state, mask


class SpaceToDepthLayerImpl(Layer):
    """layers/convolution/SpaceToDepthLayer.java (the YOLOv2 reorg)."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        return (exec_op("space_to_depth", x, block_size=self.lc.block_size),
                state, mask)


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


class DropoutLayerImpl(Layer):
    """layers/DropoutLayer.java with the IDropout variants of
    conf/dropout/*.java, drawn from the network's generator."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        rate = self.lc.rate
        if not train or rate <= 0.0:
            return x, state, mask
        mode = self.lc.mode
        keep = 1.0 - rate
        if mode == "elementwise":
            return nn_ops.dropout.fn(x, rng, rate=rate), state, mask
        if mode == "spatial":
            # whole feature maps: one draw per (example, channel)
            shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
            kept = torch.rand(shape, generator=rng, device=x.device) < keep
            return (torch.where(kept, x / keep, torch.zeros_like(x)), state,
                    mask)
        if mode == "alpha":
            # Klambauer et al. 2017, section 3: keeps SELU's normalization
            alpha_p = -1.7580993408473766
            a = (keep + alpha_p ** 2 * keep * rate) ** -0.5
            b = -a * rate * alpha_p
            kept = torch.rand(x.shape, generator=rng, device=x.device) < keep
            return (a * torch.where(kept, x, torch.full_like(x, alpha_p)) + b,
                    state, mask)
        if mode == "gaussian":
            std = (rate / (1.0 - rate)) ** 0.5
            noise = 1.0 + std * torch.randn(x.shape, generator=rng,
                                            device=x.device, dtype=x.dtype)
            return x * noise, state, mask
        raise ValueError(f"unknown dropout mode {mode!r}")


# ---------------------------------------------------------------------------
# Recurrent layers (layers/recurrent/*)
# ---------------------------------------------------------------------------


class LSTMImpl(Layer):
    """layers/recurrent/LSTM.java through the ``lstm_layer`` op (gate order
    i, f, o, g; the configured activation is the cell-output activation).
    ``reverse`` scans from the last step to the first (Bidirectional's
    backward copy)."""

    reverse = False

    def init(self, gen) -> Params:
        lc = self.lc
        w = self._weights(gen, (lc.n_in, 4 * lc.n_out))
        rw = self._weights(gen, (lc.n_out, 4 * lc.n_out))
        b = self._zeros(4 * lc.n_out)
        # forget-gate bias init (forgetGateBiasInit); gate order [i, f, o, g]
        b[lc.n_out:2 * lc.n_out] = lc.forget_gate_bias_init
        return {"W": w, "RW": rw, "b": b}

    def zero_state(self, batch: int, dtype=torch.float32):
        n = self.lc.n_out
        z = torch.zeros((batch, n), dtype=dtype, device=self.device)
        return (z, z.clone())

    def apply(self, params, x, state, *, train, rng, mask=None,
              initial=None):
        x = self._maybe_dropout(x, train=train, rng=rng)
        hs, _ = self.apply_with_state(params, x, mask=mask, initial=initial)
        return hs, state, mask

    def apply_with_state(self, params, x, *, mask=None, initial=None):
        """(out, (h_last, c_last)): the one recurrence of the training
        forward, tBPTT and ``rnn_time_step``."""
        h0, c0 = initial if initial is not None else (None, None)
        # one dtype for the helper's gate and cuDNN: the operands promoted
        hs, h_last, c_last = exec_op(
            "lstm_layer", *promote(x, params["W"], params["RW"], params["b"],
                                   h0, c0),
            mask, gate_activation=self.lc.gate_activation,
            activation=self.net_conf.layer_activation(self.lc),
            reverse=self.reverse)
        return hs, (h_last, c_last)


class GRUImpl(Layer):
    """GRU over the ``gru_cell`` op, scanned across time, masked steps
    holding h."""

    def __init__(self, net_conf, lc, itype, device):
        super().__init__(net_conf, lc, itype, device)
        # gru_cell fixes tanh/sigmoid: an explicit other activation is
        # refused instead of ignored
        if lc.activation not in (None, "tanh"):
            raise ValueError(
                f"GRU uses the gru_cell op's fixed tanh/sigmoid gates; "
                f"activation={lc.activation!r} cannot apply")

    def init(self, gen) -> Params:
        lc = self.lc
        return {"W": self._weights(gen, (lc.n_in, 3 * lc.n_out)),
                "RW": self._weights(gen, (lc.n_out, 3 * lc.n_out)),
                "b": self._zeros(3 * lc.n_out),
                "rb": self._zeros(3 * lc.n_out)}

    def zero_state(self, batch: int, dtype=torch.float32):
        return torch.zeros((batch, self.lc.n_out), dtype=dtype,
                           device=self.device)

    def apply(self, params, x, state, *, train, rng, mask=None,
              initial=None):
        x = self._maybe_dropout(x, train=train, rng=rng)
        hs, _ = self.apply_with_state(params, x, mask=mask, initial=initial)
        return hs, state, mask

    def apply_with_state(self, params, x, *, mask=None, initial=None):
        h = (initial if initial is not None
             else x.new_zeros((x.shape[0], self.lc.n_out)))
        x, h, w, rw, b, rb = promote(x, h, params["W"], params["RW"],
                                     params["b"], params["rb"])
        outs = []
        for t in range(x.shape[1]):
            h_new = nn_ops.gru_cell.fn(x[:, t], h, w, rw, b, rb)
            if mask is not None:
                h_new = torch.where(mask[:, t, None] > 0, h_new, h)
            h = h_new
            outs.append(h)
        return torch.stack(outs, dim=1), h


class SimpleRnnImpl(Layer):
    """layers/recurrent/SimpleRnn.java: h' = act(x·W + h·RW + b)."""

    def init(self, gen) -> Params:
        lc = self.lc
        return {"W": self._weights(gen, (lc.n_in, lc.n_out)),
                "RW": self._weights(gen, (lc.n_out, lc.n_out)),
                "b": self._zeros(lc.n_out)}

    def zero_state(self, batch: int, dtype=torch.float32):
        return torch.zeros((batch, self.lc.n_out), dtype=dtype,
                           device=self.device)

    def apply(self, params, x, state, *, train, rng, mask=None,
              initial=None):
        x = self._maybe_dropout(x, train=train, rng=rng)
        hs, _ = self.apply_with_state(params, x, mask=mask, initial=initial)
        return hs, state, mask

    def apply_with_state(self, params, x, *, mask=None, initial=None):
        h = (initial if initial is not None
             else x.new_zeros((x.shape[0], self.lc.n_out)))
        x, h, w, rw = promote(x, h, params["W"], params["RW"])
        outs = []
        for t in range(x.shape[1]):
            h_new = self.activation(x[:, t] @ w + h @ rw + params["b"])
            if mask is not None:
                h_new = torch.where(mask[:, t, None] > 0, h_new, h)
            h = h_new
            outs.append(h)
        return torch.stack(outs, dim=1), h


class BidirectionalImpl(Layer):
    """layers/recurrent/BidirectionalLayer.java: a forward and a backward
    copy of the wrapped layer, merged by ``mode``. The LSTM runs backward
    as a reverse scan; GRU and SimpleRnn on the time-flipped input (and
    mask), their sequence output flipped back."""

    def __init__(self, net_conf, lc, itype, device):
        super().__init__(net_conf, lc, itype, device)
        inner = lc.inner()
        self.fwd_layer = build_layer(net_conf, inner, itype, device)
        self.bwd_layer = build_layer(net_conf, inner, itype, device)
        if isinstance(self.bwd_layer, LSTMImpl):
            self.bwd_layer.reverse = True

    def init(self, gen) -> Params:
        return {"fwd": self.fwd_layer.init(gen),
                "bwd": self.bwd_layer.init(gen)}

    def apply(self, params, x, state, *, train, rng, mask=None):
        yf, _, _ = self.fwd_layer.apply(params["fwd"], x, {}, train=train,
                                        rng=rng, mask=mask)
        if isinstance(self.bwd_layer, LSTMImpl):
            yb, _, _ = self.bwd_layer.apply(params["bwd"], x, {},
                                            train=train, rng=rng, mask=mask)
        else:
            xr = torch.flip(x, dims=(1,))
            mr = None if mask is None else torch.flip(mask, dims=(1,))
            yb, _, _ = self.bwd_layer.apply(params["bwd"], xr, {},
                                            train=train, rng=rng, mask=mr)
            if yb.ndim == x.ndim:
                # a sequence goes back to the input's time order; a
                # collapsed (last-step) output is already the backward
                # pass's final step: flipping it would scramble features
                yb = torch.flip(yb, dims=(1,))
        mode = self.lc.mode
        if mode == "concat":
            y = torch.cat([yf, yb], dim=-1)
        elif mode == "add":
            y = yf + yb
        elif mode == "mul":
            y = yf * yb
        elif mode == "average":
            y = 0.5 * (yf + yb)
        else:
            raise ValueError(f"unknown Bidirectional mode {mode}")
        return y, state, mask


class RnnOutputLayerImpl(Layer):
    """layers/recurrent/RnnOutputLayer.java: time-distributed dense +
    loss."""

    def init(self, gen) -> Params:
        lc = self.lc
        p = {"W": self._weights(gen, (lc.n_in, lc.n_out))}
        if lc.has_bias:
            p["b"] = self._zeros(lc.n_out)
        return p

    def apply(self, params, x, state, *, train, rng, mask=None):
        x, w = promote(x, params["W"])
        z = x @ w
        if "b" in params:
            z = z + params["b"]
        return self.activation(z), state, mask


class LastTimeStepImpl(Layer):
    """layers/recurrent/LastTimeStepLayer.java: the wrapped layer's output
    at each row's last unmasked step."""

    def __init__(self, net_conf, lc, itype, device):
        super().__init__(net_conf, lc, itype, device)
        self.inner_layer = build_layer(net_conf, lc.inner(), itype, device)

    def init(self, gen) -> Params:
        return {"inner": self.inner_layer.init(gen)}

    def apply(self, params, x, state, *, train, rng, mask=None):
        y, _, _ = self.inner_layer.apply(params["inner"], x, {}, train=train,
                                         rng=rng, mask=mask)
        if mask is None:
            out = y[:, -1]
        else:
            idx = torch.clamp_min(mask.sum(dim=1).long() - 1, 0)
            out = y[torch.arange(y.shape[0], device=y.device), idx]
        return out, state, None


LAYER_IMPLS: Dict[Type[C.LayerConf], Type[Layer]] = {
    C.DenseLayer: DenseLayerImpl,
    C.OutputLayer: OutputLayerImpl,
    C.ConvolutionLayer: ConvolutionLayerImpl,
    C.Deconvolution2D: Deconvolution2DImpl,
    C.DepthwiseConvolution2D: DepthwiseConvolution2DImpl,
    C.SeparableConvolution2D: SeparableConvolution2DImpl,
    C.SubsamplingLayer: SubsamplingLayerImpl,
    C.Upsampling2D: Upsampling2DImpl,
    C.LocalResponseNormalization: LocalResponseNormalizationImpl,
    C.SpaceToDepthLayer: SpaceToDepthLayerImpl,
    C.GlobalPoolingLayer: GlobalPoolingLayerImpl,
    C.BatchNormalization: BatchNormalizationImpl,
    C.ActivationLayer: ActivationLayerImpl,
    C.LossLayer: LossLayerImpl,
    C.EmbeddingLayer: EmbeddingLayerImpl,
    C.EmbeddingSequenceLayer: EmbeddingSequenceLayerImpl,
    C.DropoutLayer: DropoutLayerImpl,
    C.LSTM: LSTMImpl,
    C.GravesLSTM: LSTMImpl,
    C.GRU: GRUImpl,
    C.SimpleRnn: SimpleRnnImpl,
    C.Bidirectional: BidirectionalImpl,
    C.RnnOutputLayer: RnnOutputLayerImpl,
    C.LastTimeStep: LastTimeStepImpl,
    C.RnnLossLayer: RnnLossLayerImpl,
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


def apply_preprocessor(p: Optional[C.InputPreProcessor], x):
    """conf/preprocessor/* forward. The flat layouts are the reference's
    NCHW (channel-major) order; the runtime layout is NHWC."""
    if p is None:
        return x
    if isinstance(p, C.FeedForwardToCnnPreProcessor):
        return x.reshape(x.shape[0], p.channels, p.height,
                         p.width).permute(0, 2, 3, 1)
    if isinstance(p, C.CnnToFeedForwardPreProcessor):
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    if isinstance(p, C.RnnToFeedForwardPreProcessor):
        return x.reshape(-1, x.shape[-1])
    if isinstance(p, C.FeedForwardToRnnPreProcessor):
        raise ValueError("FeedForwardToRnnPreProcessor needs the batch size; "
                         "it is not supported standalone")
    return x
