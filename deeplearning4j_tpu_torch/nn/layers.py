"""Runtime layers: ``init`` / ``apply`` per layer config.

Counterpart of the part of ``deeplearning4j_tpu/nn/layers.py`` that
ResNet-50, the zoo's other vision models and the sequential network
reach (dense, output, loss, embedding, convolution, transposed,
depthwise and separable convolution, upsampling, space-to-depth,
pooling, batch norm, LRN, activation, dropout, the
recurrent layers LSTM / GravesLSTM / GRU / SimpleRnn, Bidirectional,
RnnOutputLayer, LastTimeStep, RnnLossLayer), the 34 types the Keras
importer builds (a multi-input layer such as ``AttentionVertexImpl`` also
has ``apply_multi(params, xs, state, ...)``, given every wired input) and
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
    """layers/pooling/GlobalPoolingLayer.java — NDHWC (axes 1-3), NHWC
    (axes 1, 2) or recurrent (axis 1 = time, mask-aware)."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        pt = self.lc.pooling_type
        p = getattr(self.lc, "pnorm", 2)
        if x.ndim == 5:  # NDHWC
            axes, m = (1, 2, 3), None
        elif x.ndim == 4:
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


# ---------------------------------------------------------------------------
# The Keras importer's layer types (JAX nn/layers.py:326-405, :908-1768)
# ---------------------------------------------------------------------------


def _same_pads(n: int, k: int, s: int, same: bool):
    """XLA's (lo, hi) pads of one window axis: SAME keeps ceil(n / s)
    outputs, the odd cell on the high side."""
    if not same:
        return 0, 0
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_transpose(x, w, strides, padding: str, flip: bool):
    """``lax.conv_transpose`` over channels-last ``x`` (N, *spatial, C)
    with ``w`` (*kernel, C_in, C_out): the input dilated by the strides,
    padded as ``lax._conv_transpose_padding`` pads it, then a stride-1
    correlation; ``flip`` reverses the kernel's spatial axes (the
    ``transpose_kernel=True`` form)."""
    nd = len(strides)
    if flip:
        w = torch.flip(w, dims=tuple(range(nd)))
    n, spatial, c = x.shape[0], x.shape[1:-1], x.shape[-1]
    dil = tuple((d - 1) * s + 1 for d, s in zip(spatial, strides))
    xd = x.new_zeros((n,) + dil + (c,))
    xd[(slice(None),) + tuple(slice(None, None, s) for s in strides)] = x
    flat = []
    for k, s in reversed(list(zip(w.shape[:nd], strides))):
        if padding == "same":
            pad_len = k + s - 2
            lo = k - 1 if s > k - 1 else -(-pad_len // 2)
        else:
            pad_len = k + s - 2 + max(k - s, 0)
            lo = k - 1
        flat += [lo, pad_len - lo]
    xc = F.pad(xd.movedim(-1, 1), flat)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nd]
    y = conv(xc, w.permute(nd + 1, nd, *range(nd)))
    return y.movedim(1, -1)


class DiscretizationLayerImpl(Layer):
    """Bin indices by the static boundaries (Keras semantics: the number
    of boundaries <= x), int32."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        bounds = torch.as_tensor(self.lc.bin_boundaries, dtype=torch.float32,
                                 device=x.device)
        idx = torch.searchsorted(bounds, x.float().contiguous(), right=True)
        return idx.to(torch.int32), state, mask


class CategoryEncodingLayerImpl(Layer):
    """one_hot / multi_hot / count vectors of width ``num_tokens`` (an id
    outside [0, num_tokens) gives a row of zeros, as ``jax.nn.one_hot``)."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        oh = nn_ops.one_hot.fn(x, depth=lc.num_tokens)
        if lc.output_mode == "one_hot":
            # Keras takes a trailing size-1 feature axis and squeezes it
            if oh.ndim >= 3 and oh.shape[-2] == 1:
                oh = oh.squeeze(-2)
            return oh, state, mask
        agg = oh.sum(dim=-2) if oh.ndim >= 2 else oh
        if lc.output_mode == "count":
            return agg, state, mask
        return torch.clamp_max(agg, 1.0), state, mask  # multi_hot


class EinsumDenseLayerImpl(Layer):
    """einsum(equation, x, W) + b: the kernel's shape is the equation's
    second operand, sized from ``out_shape`` and the input's dims."""

    def init(self, gen) -> Params:
        lc = self.lc
        eq = lc.equation.replace(" ", "")
        ins, out = eq.split("->")
        a_spec, b_spec = ins.split(",")
        sizes = {}
        for ax, n in zip(reversed(out.replace("...", "")),
                         reversed(lc.out_shape)):
            sizes[ax] = int(n)
        # the input labels sized from the input's dims, right-aligned:
        # recurrent (timesteps, size), else (flat,); without '...' the
        # leading label of the input spec is the batch axis
        if self.itype.kind == "recurrent":
            in_dims = (self.itype.timesteps, self.itype.size)
        else:
            in_dims = (self.itype.flat_size(),)
        labels_in = a_spec.replace("...", "")
        if "..." not in a_spec:
            labels_in = labels_in[1:]
        for ax, n in zip(reversed(labels_in), reversed(in_dims)):
            sizes.setdefault(ax, int(n))
        missing = [ax for ax in b_spec.replace("...", "") if ax not in sizes]
        if missing:
            raise ValueError(
                f"EinsumDenseLayer: cannot size kernel labels {missing} "
                f"from equation '{lc.equation}', out_shape {lc.out_shape} "
                f"and input {self.itype} — give a fully-specified "
                f"out_shape (every kernel-only label must appear in the "
                f"output spec)")
        p = {"W": self._weights(gen, tuple(
            sizes[ax] for ax in b_spec.replace("...", "")))}
        if lc.bias_shape:
            p["b"] = torch.zeros(tuple(lc.bias_shape), dtype=self.dtype,
                                 device=self.device)
        return p

    def apply(self, params, x, state, *, train, rng, mask=None):
        x = self._maybe_dropout(x, train=train, rng=rng)
        x, w = promote(x, params["W"])
        y = torch.einsum(self.lc.equation.replace(" ", ""), x, w)
        if "b" in params:
            y = y + params["b"]
        return self.activation(y), state, mask


class AttentionVertexImpl(Layer):
    """graph/vertex AttentionVertex: multi-input attention with
    parameters, through the registry's
    ``multi_head_dot_product_attention`` (whose attention goes through
    the ``dot_product_attention`` descriptor: the flash kernels on the
    card)."""

    def init(self, gen) -> Params:
        lc = self.lc
        d = lc.n_out
        d_out = lc.d_out or d
        nq = lc.n_in_queries or lc.n_in_keys
        nk = lc.n_in_keys or nq
        nv = lc.n_in_values or nk
        p = {"Wq": self._weights(gen, (nq, d)),
             "Wk": self._weights(gen, (nk, d)),
             "Wv": self._weights(gen, (nv, d)),
             "Wo": self._weights(gen, (d, d_out))}
        if lc.has_bias:
            p.update({"bq": self._zeros(d), "bk": self._zeros(d),
                      "bv": self._zeros(d), "bo": self._zeros(d_out)})
        return p

    def apply_multi(self, params, xs, state, *, train, rng, mask=None):
        if self.lc.keras_order and len(xs) >= 2:
            # Keras MultiHeadAttention's call order: (query, value[, key])
            queries, values = xs[0], xs[1]
            keys = xs[2] if len(xs) > 2 else values
        else:
            queries = xs[0]
            keys = xs[1] if len(xs) > 1 else xs[0]
            values = xs[2] if len(xs) > 2 else keys
        out = exec_op("multi_head_dot_product_attention",
                      queries, keys, values, params["Wq"], params["Wk"],
                      params["Wv"], params["Wo"], mask,
                      num_heads=self.lc.n_heads, bq=params.get("bq"),
                      bk=params.get("bk"), bv=params.get("bv"),
                      bo=params.get("bo"))
        return out, state, mask

    def apply(self, params, x, state, *, train, rng, mask=None):
        return self.apply_multi(params, [x], state, train=train, rng=rng,
                                mask=mask)


class Convolution1DImpl(Layer):
    """layers/convolution/Convolution1DLayer.java over (N, T, C): W (k,
    C_in, C_out) and b, through the ``conv1d`` op."""

    def init(self, gen) -> Params:
        lc = self.lc
        return {"W": self._weights(gen, (lc.kernel, lc.n_in, lc.n_out)),
                "b": self._zeros(lc.n_out)}

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        x = self._maybe_dropout(x, train=train, rng=rng)
        x, w, b = promote(x, params["W"], params.get("b"))
        z = nn_ops.conv1d.fn(x, w, b, stride=lc.stride,
                             padding=lc.convolution_mode,
                             dilation=lc.dilation)
        if mask is not None and z.shape[1] != mask.shape[1]:
            # a timestep survives if its window's start was valid
            mask = mask[:, ::lc.stride][:, :z.shape[1]]
        return self.activation(z), state, mask


class Convolution3DImpl(Layer):
    """layers/convolution/Convolution3DLayer.java over (N, D, H, W, C),
    through the ``conv3d`` op."""

    def init(self, gen) -> Params:
        lc = self.lc
        return {"W": self._weights(gen, tuple(lc.kernel) + (lc.n_in,
                                                             lc.n_out)),
                "b": self._zeros(lc.n_out)}

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        x = self._maybe_dropout(x, train=train, rng=rng)
        x, w, b = promote(x, params["W"], params.get("b"))
        z = nn_ops.conv3d.fn(x, w, b, stride=lc.stride,
                             padding=lc.convolution_mode)
        return self.activation(z), state, mask


class Subsampling3DLayerImpl(Layer):
    """layers/convolution/Subsampling3DLayer.java: valid NDHWC pooling."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        xc = x.permute(0, 4, 1, 2, 3)
        if lc.pooling_type == "max":
            z = F.max_pool3d(xc, tuple(lc.kernel), tuple(lc.stride))
        else:
            z = F.avg_pool3d(xc, tuple(lc.kernel), tuple(lc.stride))
        return z.permute(0, 2, 3, 4, 1), state, mask


class LocallyConnected2DImpl(Layer):
    """layers/convolution/LocallyConnected2DLayer.java: unshared
    per-position kernels, W (oh·ow, C·kh·kw, n_out) over the patches'
    channel-major features, b (oh, ow, n_out)."""

    def _out_hw(self):
        lc = self.lc
        kh, kw = C._pair(lc.kernel)
        sh, sw = C._pair(lc.stride)
        ih, iw = lc.input_size
        return (ih - kh) // sh + 1, (iw - kw) // sw + 1

    def init(self, gen) -> Params:
        lc = self.lc
        kh, kw = C._pair(lc.kernel)
        oh, ow = self._out_hw()
        return {"W": self._weights(gen, (oh * ow, kh * kw * lc.n_in,
                                         lc.n_out)),
                "b": torch.zeros((oh, ow, lc.n_out), dtype=self.dtype,
                                 device=self.device)}

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        oh, ow = self._out_hw()
        x, w, b = promote(x, params["W"], params["b"])
        p = nn_ops.patches(x, C._pair(lc.kernel), C._pair(lc.stride),
                           (1, 1), ((0, 0), (0, 0)))
        n = x.shape[0]
        z = torch.einsum("npf,pfo->npo", p.reshape(n, oh * ow, -1), w)
        z = z.reshape(n, oh, ow, lc.n_out) + b
        return self.activation(z), state, mask


class LocallyConnected1DImpl(Layer):
    """layers/convolution/LocallyConnected1DLayer.java over (N, T, C): W
    (ot, k·C, n_out), b (ot, n_out)."""

    def _out_t(self):
        lc = self.lc
        return (lc.input_size - lc.kernel) // lc.stride + 1

    def init(self, gen) -> Params:
        lc = self.lc
        ot = self._out_t()
        return {"W": self._weights(gen, (ot, lc.kernel * lc.n_in,
                                         lc.n_out)),
                "b": torch.zeros((ot, lc.n_out), dtype=self.dtype,
                                 device=self.device)}

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        ot = self._out_t()
        x, w, b = promote(x, params["W"], params["b"])
        idx = (torch.arange(ot, device=x.device)[:, None] * lc.stride
               + torch.arange(lc.kernel, device=x.device)[None, :])
        n = x.shape[0]
        windows = x[:, idx, :].reshape(n, ot, -1)  # (N, ot, k·C)
        z = torch.einsum("npf,pfo->npo", windows, w) + b
        if mask is not None and z.shape[1] != mask.shape[1]:
            mask = None
        return self.activation(z), state, mask


class PReLULayerImpl(Layer):
    """layers/feedforward/PReLULayer.java: learned per-feature slope
    (initialized 0.25)."""

    def init(self, gen) -> Params:
        return {"alpha": torch.full((self.lc.n_in,), 0.25, dtype=self.dtype,
                                    device=self.device)}

    def apply(self, params, x, state, *, train, rng, mask=None):
        x, a = promote(x, params["alpha"])
        return (torch.clamp_min(x, 0) + a * torch.clamp_max(x, 0), state,
                mask)


class ZeroPadding1DLayerImpl(Layer):
    """layers/convolution/ZeroPadding1DLayer.java: pads the time axis."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        a, b = C._pair(self.lc.padding)
        y = F.pad(x, (0, 0, a, b))
        if mask is not None:
            mask = F.pad(mask, (a, b))
        return y, state, mask


class ZeroPaddingLayerImpl(Layer):
    """layers/convolution/ZeroPaddingLayer.java: NHWC spatial padding."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        t, b, l, r = self.lc.padding
        return F.pad(x, (0, 0, l, r, t, b)), state, mask


class ZeroPadding3DLayerImpl(Layer):
    """layers/convolution/ZeroPadding3DLayer.java: NDHWC padding."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        p = self.lc.padding
        return F.pad(x, (0, 0, p[4], p[5], p[2], p[3], p[0], p[1])), state, \
            mask


class Cropping1DImpl(Layer):
    """layers/convolution/Cropping1DLayer.java."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        a, b = C._pair(self.lc.cropping)
        t = x.shape[1]
        if mask is not None:
            mask = mask[:, a:t - b]
        return x[:, a:t - b, :], state, mask


class Cropping2DImpl(Layer):
    """layers/convolution/Cropping2DLayer.java."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        t, b, l, r = self.lc.cropping
        h, w = x.shape[1], x.shape[2]
        return x[:, t:h - b, l:w - r, :], state, mask


class Cropping3DImpl(Layer):
    """layers/convolution/Cropping3DLayer.java."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        c = self.lc.cropping
        d, h, w = x.shape[1], x.shape[2], x.shape[3]
        return (x[:, c[0]:d - c[1], c[2]:h - c[3], c[4]:w - c[5], :], state,
                mask)


class Upsampling1DImpl(Layer):
    """layers/convolution/upsampling/Upsampling1D.java: each timestep
    repeated."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        s = self.lc.size
        if mask is not None:
            mask = torch.repeat_interleave(mask, s, dim=1)
        return torch.repeat_interleave(x, s, dim=1), state, mask


class Upsampling3DImpl(Layer):
    """layers/convolution/upsampling/Upsampling3D.java: nearest, NDHWC."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        s = self.lc.size
        for axis, k in zip((1, 2, 3), s):
            x = torch.repeat_interleave(x, k, dim=axis)
        return x, state, mask


class Subsampling1DLayerImpl(Layer):
    """layers/convolution/subsampling/Subsampling1DLayer.java: temporal
    max / average pooling; under 'same' the average counts only the
    cells inside the input, and the mask is max-pooled alongside."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        k, s = int(lc.kernel), int(lc.stride)
        lo, hi = _same_pads(x.shape[1], k, s, lc.convolution_mode == "same")
        xc = x.transpose(1, 2)
        if lc.pooling_type == "max":
            y = F.max_pool1d(F.pad(xc, (lo, hi), value=-torch.inf), k, s)
        else:
            tot = F.avg_pool1d(F.pad(xc, (lo, hi)), k, s) * k
            cnt = F.avg_pool1d(F.pad(torch.ones_like(xc[:1, :1]), (lo, hi)),
                               k, s) * k
            y = tot / cnt
        if mask is not None:
            mask = F.max_pool1d(F.pad(mask.to(x.dtype)[:, None], (lo, hi)),
                                k, s)[:, 0]
        return y.transpose(1, 2), state, mask


class Deconvolution3DImpl(Layer):
    """layers/convolution/Deconvolution3DLayer.java: transposed 3-D
    convolution as ``lax.conv_transpose`` computes it (kernel not
    flipped), W (kd, kh, kw, C_in, C_out)."""

    def init(self, gen) -> Params:
        lc = self.lc
        return {"W": self._weights(gen, tuple(lc.kernel) + (lc.n_in,
                                                             lc.n_out)),
                "b": self._zeros(lc.n_out)}

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        x, w, b = promote(x, params["W"], params["b"])
        y = _conv_transpose(x, w, tuple(lc.stride),
                            "same" if lc.convolution_mode == "same"
                            else "valid", flip=False) + b
        return self.activation(y), state, mask


class MaskZeroLayerImpl(Layer):
    """layers/recurrent/MaskZeroLayer.java: the timestep mask derived
    from the values, then the wrapped layer under it."""

    def __init__(self, net_conf, lc, itype, device):
        super().__init__(net_conf, lc, itype, device)
        self.inner_layer = build_layer(net_conf, lc.inner(), itype, device)

    def init(self, gen) -> Params:
        return {"inner": self.inner_layer.init(gen)}

    def init_state(self) -> State:
        return self.inner_layer.init_state()

    def apply(self, params, x, state, *, train, rng, mask=None):
        derived = torch.any(x != self.lc.mask_value, dim=-1).to(x.dtype)
        if mask is not None:
            derived = derived * mask.to(x.dtype)
        x = x * derived[..., None]
        y, st, _ = self.inner_layer.apply(params["inner"], x, state,
                                          train=train, rng=rng, mask=derived)
        return y, st, derived


class RepeatVectorImpl(Layer):
    """layers/RepeatVector.java: (N, F) -> (N, n, F)."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        return (x[:, None, :].expand(x.shape[0], self.lc.n, x.shape[-1]),
                state, None)


class PermuteLayerImpl(Layer):
    """Keras Permute: the non-batch axes reordered (1-indexed dims)."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        perm = (0,) + tuple(int(d) for d in self.lc.dims)
        return x.permute(perm), state, mask


class ReshapeLayerImpl(Layer):
    """Keras Reshape: batch-preserving, -1 inferred."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        shape = (x.shape[0],) + tuple(int(s) for s in self.lc.target_shape)
        return x.reshape(shape), state, mask


class LayerNormalizationImpl(Layer):
    """Trailing-axis layer norm with a learned gain and bias: the plain
    ``layer_norm`` op (its ``.fn``, as the JAX layer calls it)."""

    def init(self, gen) -> Params:
        n = self.lc.n_out
        return {"gain": self._ones(n), "b": self._zeros(n)}

    def apply(self, params, x, state, *, train, rng, mask=None):
        x, g, b = promote(x, params["gain"], params["b"])
        y = nn_ops.layer_norm.fn(x, g, b, axis=-1, eps=self.lc.eps)
        return self.activation(y), state, mask


class GroupNormalizationImpl(Layer):
    """Group norm: per (example, group) over the spatial axes and the
    group's channels, then a per-channel scale and shift."""

    def init(self, gen) -> Params:
        n = self.lc.n_out
        return {"gamma": self._ones(n), "beta": self._zeros(n)}

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        x, gamma, beta = promote(x, params["gamma"], params["beta"])
        c = x.shape[-1]
        g = lc.groups if lc.groups > 0 else c
        xg = x.reshape(tuple(x.shape[:-1]) + (g, c // g))
        axes = tuple(i for i in range(1, xg.ndim) if i != xg.ndim - 2)
        mean = xg.mean(dim=axes, keepdim=True)
        var = xg.var(dim=axes, keepdim=True, unbiased=False)
        y = ((xg - mean) * torch.rsqrt(var + lc.eps)).reshape(x.shape)
        return self.activation(y * gamma + beta), state, mask


class RescaleLayerImpl(Layer):
    """x · scale + offset (Keras Rescaling / adapted Normalization)."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        scale = torch.as_tensor(self.lc.scale, dtype=x.dtype,
                                device=x.device)
        offset = torch.as_tensor(self.lc.offset, dtype=x.dtype,
                                 device=x.device)
        return x * scale + offset, state, mask


class UnitNormLayerImpl(Layer):
    """L2 normalization along the trailing axis (Keras
    UnitNormalization)."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        return x / torch.clamp_min(norm, self.lc.eps), state, mask


class ConvLSTM2DImpl(Layer):
    """Convolutional LSTM over (N, T, H, W, C): gates = conv(x_t, W) +
    conv(h, RW) + b, gate order i, f, o, g; the input convolutions of
    every step as one batched convolution; the configured activation on
    the candidate and the cell output (Keras ConvLSTM2D)."""

    def init(self, gen) -> Params:
        lc = self.lc
        kh, kw = lc.kernel
        return {"W": self._weights(gen, (kh, kw, lc.n_in, 4 * lc.filters)),
                "RW": self._weights(gen, (kh, kw, lc.filters,
                                          4 * lc.filters)),
                "b": self._zeros(4 * lc.filters)}

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        gate = get_activation(lc.gate_activation)
        pad = "same" if lc.padding == "same" else "valid"
        x, w, rw, b = promote(x, params["W"], params["RW"], params["b"])
        n, t = x.shape[0], x.shape[1]
        zx = nn_ops.conv2d.fn(x.reshape((n * t,) + tuple(x.shape[2:])), w,
                              None, stride=(1, 1), padding=pad)
        zx = zx.reshape((n, t) + tuple(zx.shape[1:])) + b
        h = x.new_zeros((n,) + tuple(zx.shape[2:-1]) + (lc.filters,))
        c = h
        hs = []
        for step in range(t):
            # the recurrent convolution keeps the state's shape: 'same'
            gates = zx[:, step] + nn_ops.conv2d.fn(h, rw, None,
                                                   stride=(1, 1),
                                                   padding="same")
            i, f, o, g = torch.chunk(gates, 4, dim=-1)
            c = gate(f) * c + gate(i) * self.activation(g)
            h = gate(o) * self.activation(c)
            hs.append(h)
        if lc.return_sequences:
            return torch.stack(hs, dim=1), state, mask
        return h, state, None


class DotAttentionLayerImpl(Layer):
    """Keras Attention / AdditiveAttention without parameters: inputs in
    Keras order (query, value[, key]), the key defaulting to the value; a
    key-padding mask gives padded keys no weight."""

    def apply_multi(self, params, xs, state, *, train, rng, mask=None):
        q = xs[0]
        v = xs[1] if len(xs) > 1 else xs[0]
        k = xs[2] if len(xs) > 2 else v
        lc = self.lc
        if lc.additive:
            t = torch.tanh(q[:, :, None, :] + k[:, None, :, :])
            if lc.use_scale and lc.scale is not None:
                t = t * torch.as_tensor(lc.scale, dtype=t.dtype,
                                        device=t.device)
            scores = t.sum(dim=-1)
        else:
            scores = torch.einsum("bqd,bkd->bqk", q, k)
            if lc.use_scale and lc.scale is not None:
                scores = scores * torch.as_tensor(lc.scale,
                                                  dtype=scores.dtype,
                                                  device=scores.device)
        if mask is not None and mask.shape[-1] == k.shape[1]:
            scores = torch.where(mask[:, None, :] > 0, scores,
                                 torch.full((), -1e9, dtype=scores.dtype,
                                            device=scores.device))
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bqk,bkd->bqd", w, v), state, mask

    def apply(self, params, x, state, *, train, rng, mask=None):
        return self.apply_multi(params, [x], state, train=train, rng=rng,
                                mask=mask)


class SeparableConvolution1DImpl(Layer):
    """Depthwise (C groups) then pointwise temporal convolution: dW (k,
    1, C·mult), pW (1, C·mult, n_out)."""

    def init(self, gen) -> Params:
        lc = self.lc
        mult = lc.depth_multiplier
        p = {"dW": self._weights(gen, (lc.kernel, 1, lc.n_in * mult)),
             "pW": self._weights(gen, (1, lc.n_in * mult, lc.n_out))}
        if lc.has_bias:
            p["b"] = self._zeros(lc.n_out)
        return p

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        x = self._maybe_dropout(x, train=train, rng=rng)
        x, dw, pw, b = promote(x, params["dW"], params["pW"],
                               params.get("b"))
        lo, hi = _same_pads(x.shape[1], lc.kernel, lc.stride,
                            lc.convolution_mode == "same")
        xc = F.pad(x.transpose(1, 2), (lo, hi))
        z = F.conv1d(xc, dw.permute(2, 1, 0), None, lc.stride,
                     groups=lc.n_in)
        z = F.conv1d(z, pw.permute(2, 1, 0)).transpose(1, 2)
        if b is not None:
            z = z + b
        if mask is not None and z.shape[1] != mask.shape[1]:
            mask = mask[:, ::lc.stride][:, :z.shape[1]]
        return self.activation(z), state, mask


class Deconvolution1DImpl(Layer):
    """Transposed temporal convolution with TF's conv1d_transpose
    semantics (``lax.conv_transpose``, ``transpose_kernel=True``), W (k,
    C_in, C_out)."""

    def init(self, gen) -> Params:
        lc = self.lc
        p = {"W": self._weights(gen, (lc.kernel, lc.n_in, lc.n_out))}
        if lc.has_bias:
            p["b"] = self._zeros(lc.n_out)
        return p

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        x = self._maybe_dropout(x, train=train, rng=rng)
        x, w, b = promote(x, params["W"], params.get("b"))
        z = _conv_transpose(x, w, (lc.stride,),
                            "same" if lc.convolution_mode == "same"
                            else "valid", flip=True)
        if b is not None:
            z = z + b
        return self.activation(z), state, None


class ResizeLayerImpl(Layer):
    """Keras Resizing: NHWC resize through the catalog's resize ops
    (half-pixel centers)."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        op = {"bilinear": "resize_bilinear",
              "nearest": "resize_nearest_neighbor",
              "bicubic": "resize_bicubic"}[self.lc.method]
        return (exec_op(op, x, size=(self.lc.height, self.lc.width)), state,
                mask)


class CenterCropLayerImpl(Layer):
    """Keras CenterCrop: the centered window (start (in - out) // 2)."""

    def apply(self, params, x, state, *, train, rng, mask=None):
        h, w = x.shape[1], x.shape[2]
        th, tw = self.lc.height, self.lc.width
        if h < th or w < tw:
            # Keras would resize here; the declared output cannot flex
            raise ValueError(
                f"CenterCropLayer: input {h}x{w} smaller than target "
                f"{th}x{tw} (Keras would resize; use ResizeLayer instead)")
        y0, x0 = (h - th) // 2, (w - tw) // 2
        return x[:, y0:y0 + th, x0:x0 + tw, :], state, mask


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
    C.AttentionVertex: AttentionVertexImpl,
    C.Convolution1D: Convolution1DImpl,
    C.Convolution3D: Convolution3DImpl,
    C.Subsampling3DLayer: Subsampling3DLayerImpl,
    C.LocallyConnected2D: LocallyConnected2DImpl,
    C.LocallyConnected1D: LocallyConnected1DImpl,
    C.PReLULayer: PReLULayerImpl,
    C.ZeroPadding1DLayer: ZeroPadding1DLayerImpl,
    C.ZeroPaddingLayer: ZeroPaddingLayerImpl,
    C.ZeroPadding3DLayer: ZeroPadding3DLayerImpl,
    C.Cropping1D: Cropping1DImpl,
    C.Cropping2D: Cropping2DImpl,
    C.Cropping3D: Cropping3DImpl,
    C.Upsampling1D: Upsampling1DImpl,
    C.Upsampling3D: Upsampling3DImpl,
    C.Subsampling1DLayer: Subsampling1DLayerImpl,
    C.Deconvolution3D: Deconvolution3DImpl,
    C.MaskZeroLayer: MaskZeroLayerImpl,
    C.RepeatVector: RepeatVectorImpl,
    C.PermuteLayer: PermuteLayerImpl,
    C.ReshapeLayer: ReshapeLayerImpl,
    C.LayerNormalization: LayerNormalizationImpl,
    C.GroupNormalization: GroupNormalizationImpl,
    C.RescaleLayer: RescaleLayerImpl,
    C.DiscretizationLayer: DiscretizationLayerImpl,
    C.CategoryEncodingLayer: CategoryEncodingLayerImpl,
    C.EinsumDenseLayer: EinsumDenseLayerImpl,
    C.UnitNormLayer: UnitNormLayerImpl,
    C.ConvLSTM2D: ConvLSTM2DImpl,
    C.DotAttentionLayer: DotAttentionLayerImpl,
    C.SeparableConvolution1D: SeparableConvolution1DImpl,
    C.Deconvolution1D: Deconvolution1DImpl,
    C.ResizeLayer: ResizeLayerImpl,
    C.CenterCropLayer: CenterCropLayerImpl,
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
    NCHW / NCDHW (channel-major) order; the runtime layout is NHWC /
    NDHWC."""
    if p is None:
        return x
    if isinstance(p, C.FeedForwardToCnnPreProcessor):
        return x.reshape(x.shape[0], p.channels, p.height,
                         p.width).permute(0, 2, 3, 1)
    if isinstance(p, C.CnnToFeedForwardPreProcessor):
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    if isinstance(p, C.Cnn3DToFeedForwardPreProcessor):
        return x.permute(0, 4, 1, 2, 3).reshape(x.shape[0], -1)
    if isinstance(p, C.RnnToFeedForwardPreProcessor):
        return x.reshape(-1, x.shape[-1])
    if isinstance(p, C.FeedForwardToRnnPreProcessor):
        raise ValueError("FeedForwardToRnnPreProcessor needs the batch size; "
                         "it is not supported standalone")
    return x
