"""Generic neural-net ops of the port (plain PyTorch).

Counterpart of the slices of ``deeplearning4j_tpu/ops/nn_ops.py`` that the
ported paths reach:

* serving: the generic ``dot_product_attention`` (``nn_ops.py:448``); the
  hand-written flash kernel registers as its ``"cuda"`` platform helper in
  :mod:`.cuda_attention`;
* training (ResNet-50 through ``ComputationGraph``): ``conv2d`` with the
  reference padding modes, max/avg/pnorm pooling, global pooling, the
  inference ``batchnorm`` and the training ``batch_norm_train`` over a
  hand-written-backward core (:class:`_BNCore`, the ``_bn_core``
  custom VJP);
* the zoo's other vision families: ``depthwise_conv2d``, ``sconv2d``,
  ``deconv2d``, ``upsampling2d`` and ``lrn`` (``nn_ops.py:135-173``,
  ``:378``), generic only, as the JAX package left them to XLA;
* the imported-graph path: the catalog ``layer_norm``, the generic
  ``fused_matmul_bias_act`` with its activation catalog
  (``nn_ops.py:512-551``; the hand-written kernel registers as its
  ``"cuda"`` helper in :mod:`.cuda_matmul`) and the generic
  ``fused_layer_norm`` (``pallas_layernorm.py:37``; its kernel is still to
  be ported);
* the sequential network (``MultiLayerNetwork``): ``dropout`` (from an
  explicit ``torch.Generator``), ``embedding_lookup``, the cells
  ``lstm_cell`` (gate order i, f, g, o), ``gru_cell`` and
  ``simple_rnn_cell``, and the sequence ops ``lstm_sequence`` and
  ``gru_sequence`` (``nn_ops.py:393-660``). The LSTM layer's own
  recurrence (gate order i, f, o, g) is the ``lstm_layer`` op of
  :mod:`.cudnn_lstm`;
* :func:`table_rows`, the gather of a table's rows whose gradient has the
  same bits every run on the card, which BERT's token-type rows and
  SameDiff's ``gather`` share;
* the rest of the catalog's nn family (``nn_ops.py:92-623``): ``conv1d``,
  ``conv3d``, ``im2col``, ``matmul``, ``xw_plus_b``, ``gather`` (the
  fill mode of ``jnp.take``, :func:`take`), ``one_hot``,
  ``multi_head_dot_product_attention`` (through the
  ``dot_product_attention`` descriptor, so the flash kernels take its
  attention on the card), ``softmax_op``, ``log_softmax_op``,
  ``standardize``, ``clip_by_norm`` and ``clip_by_value``.

Layouts are the JAX package's: activations NHWC, conv kernels HWIO. Inside,
``x.permute(0, 3, 1, 2)`` of an NHWC-contiguous tensor is a
``channels_last`` NCHW tensor, so the convolutions and pools run on it
with no copy, and the NHWC view of their channels-last output is
contiguous again. Convolutions and pools are library calls (cuDNN on the
card), as the JAX package left them to XLA.

XLA's "SAME" padding is asymmetric (the odd cell goes on the high side);
torch's ``padding=`` is symmetric, so an asymmetric pad is applied with
``F.pad`` first.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.reductions import dims
from deeplearning4j_tpu_torch.ops.registry import op
from deeplearning4j_tpu_torch.ops.transforms import inexact

IntPair = Union[int, Tuple[int, int]]
Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _padding(mode, kernel, stride, dilation):
    """Reference padding modes: 'same' | 'valid' | 'truncate' | explicit
    (ph, pw) | ((top, bottom), (left, right)). Returns "SAME", "VALID" or
    explicit pairs, as the JAX package's ``_padding``."""
    if isinstance(mode, str):
        m = mode.upper()
        if m in ("SAME", "TRUNCATE", "VALID"):
            return "SAME" if m == "SAME" else "VALID"
        raise ValueError(f"unknown padding mode {mode}")
    if (isinstance(mode, (tuple, list)) and len(mode) == 2
            and isinstance(mode[0], (tuple, list))):
        return tuple((int(a), int(b)) for a, b in mode)
    ph, pw = _pair(mode)
    return ((ph, ph), (pw, pw))


def _explicit_pads(pad, in_hw: Sequence[int], kernel: Sequence[int],
                   stride: Sequence[int], dilation: Sequence[int]) -> Pads:
    """XLA's pads for "SAME"/"VALID" (``lax.padtype_to_pads``): SAME keeps
    ceil(in/stride) outputs and puts the odd cell of padding on the high
    side."""
    if pad == "VALID":
        return ((0, 0), (0, 0))
    if pad != "SAME":
        return tuple(tuple(p) for p in pad)
    out = []
    for n, k, s, d in zip(in_hw, kernel, stride, dilation):
        eff = (k - 1) * d + 1
        total = max((-(-n // s) - 1) * s + eff - n, 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


def _pad_nchw(xc, pads: Pads, value: float):
    """Apply ``pads`` to an NCHW tensor: symmetric pads go to the op's own
    ``padding=`` argument (returned), asymmetric ones through ``F.pad``."""
    (pt, pb), (pl_, pr) = pads
    if pt == pb and pl_ == pr and value == 0.0:
        return xc, (pt, pl_)
    if pt or pb or pl_ or pr:
        xc = F.pad(xc, (pl_, pr, pt, pb), value=value)
    return xc, (0, 0)


# --------------------------------------------------------------------------
# Convolutions
# --------------------------------------------------------------------------


@op("conv2d")
def conv2d(x, w, b=None, *, stride: IntPair = 1, padding="same",
           dilation: IntPair = 1, feature_group_count: int = 1):
    """2-D convolution. x: [N,H,W,C_in], w: [kH,kW,C_in/groups,C_out]."""
    s = _pair(stride)
    d = _pair(dilation)
    pads = _explicit_pads(_padding(padding, w.shape[:2], s, d),
                          x.shape[1:3], w.shape[:2], s, d)
    xc, sym = _pad_nchw(x.permute(0, 3, 1, 2), pads, 0.0)
    out = F.conv2d(xc, w.permute(3, 2, 0, 1), None, s, sym, d,
                   feature_group_count)
    out = out.permute(0, 2, 3, 1)
    if b is not None:
        out = out + b
    return out


@op("depthwise_conv2d")
def depthwise_conv2d(x, w, b=None, *, stride: IntPair = 1, padding="same",
                     dilation: IntPair = 1):
    """Depthwise conv. x: [N,H,W,C], w: [kH,kW,C,mult]. Output channel
    c·mult + m is input channel c under multiplier m (the JAX reshape to
    (kH, kW, 1, C·mult) with C groups)."""
    kh, kw, wc, mult = w.shape
    w2 = w.reshape(kh, kw, 1, wc * mult)
    return conv2d.fn(x, w2, b, stride=stride, padding=padding,
                     dilation=dilation, feature_group_count=x.shape[-1])


@op("sconv2d")
def separable_conv2d(x, depth_w, point_w, b=None, *, stride: IntPair = 1,
                     padding="same"):
    """Separable conv (reference sconv2d): depthwise then 1×1 pointwise."""
    y = depthwise_conv2d.fn(x, depth_w, None, stride=stride, padding=padding)
    return conv2d.fn(y, point_w, b, stride=1, padding="valid")


def _deconv_pads(padding, kernel: Sequence[int], stride: Sequence[int]):
    """The pads ``lax.conv_transpose`` puts on the stride-dilated input:
    "SAME" and "VALID" as its ``_conv_transpose_padding``, an explicit
    (ph, pw) as ((ph, ph), (pw, pw)) handed over unchanged."""
    if isinstance(padding, str):
        mode = "SAME" if padding.upper() == "SAME" else "VALID"
        out = []
        for k, s in zip(kernel, stride):
            if mode == "SAME":
                total = k + s - 2
                before = k - 1 if s > k - 1 else -(-total // 2)
            else:
                total = k + s - 2 + max(k - s, 0)
                before = k - 1
            out.append((before, total - before))
        return tuple(out)
    return tuple((int(p), int(p)) for p in _pair(padding))


@op("deconv2d")
def deconv2d(x, w, b=None, *, stride: IntPair = 1, padding="same"):
    """Transposed conv, TF conv_transpose semantics at every stride.
    x: [N,H,W,C_in], w: [kH,kW,C_in,C_out]. The JAX op's
    ``conv_transpose(..., transpose_kernel=True)`` is a correlation of the
    stride-dilated x with the flipped w under :func:`_deconv_pads`;
    ``F.conv_transpose2d`` with no padding is the same correlation under
    pads (k−1, k−1), so its output is cropped (or zero-extended: no tap
    reaches there) to the wanted pads."""
    s = _pair(stride)
    kh, kw = int(w.shape[0]), int(w.shape[1])
    (pt, pb), (pl_, pr) = _deconv_pads(padding, (kh, kw), s)
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1),
                             None, s)
    out = F.pad(out, (pl_ - (kw - 1), pr - (kw - 1),
                      pt - (kh - 1), pb - (kh - 1)))
    out = out.permute(0, 2, 3, 1)
    if b is not None:
        out = out + b
    return out


@op("upsampling2d")
def upsampling2d(x, *, size: IntPair = 2):
    """Nearest upsampling (``repeat`` along H then W) as a broadcast and
    a reshape: the backward is a plain sum over each block, with no
    atomics."""
    sh, sw = _pair(size)
    n, h, w, c = x.shape
    return (x[:, :, None, :, None, :].expand(n, h, sh, w, sw, c)
            .reshape(n, h * sh, w * sw, c))


@op("lrn")
def local_response_normalization(x, *, depth: int = 5, bias: float = 1.0,
                                 alpha: float = 1e-4, beta: float = 0.75):
    """LRN over the trailing (channel) axis, the JAX op's arithmetic:
    x / (bias + alpha · Σ x²)^beta over the window of ``depth`` channels
    starting ``depth // 2`` before each one (alpha is not divided by
    ``depth``, as ``F.local_response_norm`` would)."""
    half = depth // 2
    c = x.shape[-1]
    padded = F.pad(x * x, (half, half))
    window = sum(padded[..., i:i + c] for i in range(depth))
    return x / (bias + alpha * window) ** beta


# --------------------------------------------------------------------------
# Pooling
# --------------------------------------------------------------------------


def _pool_prep(x, kernel, stride, padding, value):
    k = _pair(kernel)
    s = _pair(stride if stride is not None else kernel)
    if isinstance(padding, str):
        pad = "SAME" if padding.upper() == "SAME" else "VALID"
    else:
        pad = _padding(padding, kernel, stride, 1)
    pads = _explicit_pads(pad, x.shape[1:3], k, s, (1, 1))
    (pt, pb), (pl_, pr) = pads
    xc = x.permute(0, 3, 1, 2)
    if pt or pb or pl_ or pr:
        xc = F.pad(xc, (pl_, pr, pt, pb), value=value)
    return xc, k, s


@op("maxpool2d")
def maxpool2d(x, *, kernel: IntPair, stride: Optional[IntPair] = None,
              padding="valid"):
    xc, k, s = _pool_prep(x, kernel, stride, padding, -math.inf)
    return F.max_pool2d(xc, k, s).permute(0, 2, 3, 1)


def _sum_pool(x, kernel, stride, padding):
    xc, k, s = _pool_prep(x, kernel, stride, padding, 0.0)
    return F.avg_pool2d(xc, k, s).permute(0, 2, 3, 1) * (k[0] * k[1])


@op("avgpool2d")
def avgpool2d(x, *, kernel: IntPair, stride: Optional[IntPair] = None,
              padding="valid", count_include_pad: bool = True):
    kh, kw = _pair(kernel)
    if count_include_pad or (isinstance(padding, str)
                             and padding.upper() == "VALID"):
        xc, k, s = _pool_prep(x, kernel, stride, padding, 0.0)
        return F.avg_pool2d(xc, k, s).permute(0, 2, 3, 1)
    summed = _sum_pool(x, kernel, stride, padding)
    counts = _sum_pool(torch.ones_like(x), kernel, stride, padding)
    return summed / counts


@op("pnormpool2d")
def pnormpool2d(x, *, kernel: IntPair, stride: Optional[IntPair] = None,
                padding="valid", p: float = 2.0):
    return _sum_pool(torch.abs(x) ** p, kernel, stride, padding) ** (1.0 / p)


@op("global_avg_pool")
def global_avg_pool(x):
    return torch.mean(x, dim=(1, 2))


@op("global_max_pool")
def global_max_pool(x):
    return torch.amax(x, dim=(1, 2))


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least float32 (``jnp.promote_types(x.dtype, float32)``)."""
    return torch.promote_types(dtype, torch.float32)


@op("batchnorm")
def batchnorm(x, mean, var, gamma=None, beta=None, *, eps: float = 1e-5):
    """Normalize with given statistics (inference form). Scale and shift
    are folded in at least float32 and cast to x's dtype, so a bfloat16
    stream stays bfloat16."""
    f32 = _stat_dtype(x.dtype)
    scale = torch.rsqrt(var.to(f32) + eps)
    if gamma is not None:
        scale = scale * gamma.to(f32)
    shift = -mean.to(f32) * scale
    if beta is not None:
        shift = shift + beta.to(f32)
    return x * scale.to(x.dtype) + shift.to(x.dtype)


def _bn_fwd_math(x, gamma, beta, stat_shift, eps):
    """Channel-last batch statistics and normalize (``_bn_fwd_math``):
    bfloat16 inputs take one-pass moments shifted by the running mean
    (stable while the running mean tracks the batch mean); every other
    dtype takes two passes. Returns (out, mean, biased var, inv, scale)."""
    f32 = _stat_dtype(x.dtype)
    axes = tuple(range(x.ndim - 1))
    xf = x.to(f32)
    if x.dtype == torch.bfloat16 and stat_shift is not None:
        sf = stat_shift.detach().to(f32)
        xc = xf - sf
        m1 = torch.mean(xc, dim=axes)
        m2 = torch.mean(torch.square(xc), dim=axes)
        mean = m1 + sf
        var = torch.clamp_min(m2 - torch.square(m1), 0.0)
    else:
        mean = torch.mean(xf, dim=axes)
        var = torch.mean(torch.square(xf - mean), dim=axes)
    inv = torch.rsqrt(var + eps)
    scale = inv if gamma is None else inv * gamma.to(f32)
    shift = -mean * scale
    if beta is not None:
        shift = shift + beta.to(f32)
    out = x * scale.to(x.dtype) + shift.to(x.dtype)
    return out, mean, var, inv, scale


class _BNCore(torch.autograd.Function):
    """Channel-last training batch norm with the hand-written backward of
    ``_bn_core`` (the canonical two-reduction form). Returns
    (out, mean, biased var); the statistics feed the running buffers and
    are not differentiable, and ``stat_shift`` (the running mean) only
    stabilizes the bfloat16 one-pass moments."""

    @staticmethod
    def forward(ctx, x, gamma, beta, stat_shift, eps):
        out, mean, var, inv, _ = _bn_fwd_math(x, gamma, beta, stat_shift, eps)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.has_beta = beta is not None
        ctx.beta_dtype = None if beta is None else beta.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        f32 = _stat_dtype(x.dtype)
        axes = tuple(range(x.ndim - 1))
        n = x.numel() // x.shape[-1]
        dyf = dy.to(f32)
        xhat = (x.to(f32) - mean) * inv
        sum_dy = torch.sum(dyf, dim=axes)
        sum_dy_xhat = torch.sum(dyf * xhat, dim=axes)
        g = inv if gamma is None else inv * gamma.to(f32)
        dx = g * (dyf - sum_dy / n - xhat * (sum_dy_xhat / n))
        dgamma = None if gamma is None else sum_dy_xhat.to(gamma.dtype)
        dbeta = sum_dy.to(ctx.beta_dtype) if ctx.has_beta else None
        return dx.to(x.dtype), dgamma, dbeta, None, None


def batch_norm_train(x, gamma, beta, running_mean, running_var, *,
                     axis=(0,), eps: float = 1e-5, momentum: float = 0.9):
    """Training-mode batch norm: (out, new_running_mean, new_running_var).

    DL4J ``decay`` semantics: running = momentum·running +
    (1−momentum)·batch_stat, with the unbiased (n/(n−1)) batch variance.
    Statistics are taken in at least float32; the running buffers keep
    their own dtype. The channel-last case (the layer path) runs
    :class:`_BNCore`; other axes take autograd of the plain math."""
    if tuple(axis) == tuple(range(x.ndim - 1)):
        out, mean, var = _BNCore.apply(x, gamma, beta, running_mean, eps)
    else:
        xf = x.to(_stat_dtype(x.dtype))
        mean = torch.mean(xf, dim=tuple(axis))
        var = torch.var(xf, dim=tuple(axis), correction=0)
        out = batchnorm.fn(x, mean, var, gamma, beta, eps=eps)
    n = x.numel() // mean.numel()
    unbiased = var * n / max(n - 1, 1)
    rdt = running_mean.dtype
    new_mean = (momentum * running_mean
                + (1.0 - momentum) * mean.detach().to(rdt))
    new_var = (momentum * running_var
               + (1.0 - momentum) * unbiased.detach().to(rdt))
    return out, new_mean, new_var


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


@op("dot_product_attention")
def dot_product_attention(q, k, v, mask=None, *, scaled: bool = True,
                          causal: bool = False, dropout_rate: float = 0.0,
                          dropout_rng: Optional[torch.Generator] = None):
    """q:[...,Lq,Dk] k:[...,Lk,Dk] v:[...,Lk,Dv] -> [...,Lq,Dv].

    ``mask``: boolean, broadcast against the scores; masked scores are
    filled with ``-1e9``. ``causal``: END-aligned lower-triangular mask
    (``tril(k=Lk-Lq)``), composed with ``mask``. ``dropout_rate`` /
    ``dropout_rng`` (a ``torch.Generator``): post-softmax dropout of the
    attention probabilities."""
    scores = torch.matmul(q, k.transpose(-1, -2))
    if scaled:
        # √D rounded to the scores' dtype, as the reference's
        # jnp.sqrt(jnp.asarray(D, scores.dtype)): 9.8125 for D 96 in bf16;
        # a 0-d CPU tensor, which torch takes as a host scalar on any
        # device, as it takes its value: no host read inside a step
        scores = scores / torch.tensor(float(q.shape[-1]),
                                       dtype=scores.dtype).sqrt()
    # a fill on the device (no host copy, so it runs inside a capture)
    neg = torch.full((), -1e9, dtype=scores.dtype, device=scores.device)
    if mask is not None:
        scores = torch.where(mask.bool(), scores, neg)
    if causal:
        l_q, l_k = scores.shape[-2], scores.shape[-1]
        tri = torch.ones((l_q, l_k), dtype=torch.bool,
                         device=scores.device).tril(diagonal=l_k - l_q)
        scores = torch.where(tri, scores, neg)
    weights = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        if dropout_rng is None:
            raise ValueError(
                "dot_product_attention: dropout_rate > 0 requires "
                "dropout_rng (pass rate 0 for eval mode)")
        keep = torch.rand(weights.shape, generator=dropout_rng,
                          device=weights.device) >= dropout_rate
        weights = torch.where(keep, weights / (1.0 - dropout_rate),
                              torch.zeros_like(weights))
    return torch.matmul(weights, v)


# --------------------------------------------------------------------------
# Imported-graph path: the catalog layer norm and the matmul epilogue
# --------------------------------------------------------------------------


@op("layer_norm")
def layer_norm(x, gain, bias=None, *, axis: int = -1, eps: float = 1e-5):
    """(x - mean) * rsqrt(var + eps) * gain (+ bias) over ``axis``, with the
    population variance — the op ONNX LayerNormalization records."""
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.var(x, dim=axis, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + eps) * gain
    if bias is not None:
        out = out + bias
    return out


# Activation epilogues the fused matmul understands. "gelu" is the tanh
# approximation (what the graph/registry `gelu` op computes); "gelu_exact"
# is the erf formula the decomposed ONNX/TF exporter chains
# (x·0.5·(1+erf(x/√2))) lower to. The optimizer's epilogue matcher
# (autodiff/optimize.py) picks the variant that matches the replaced
# subgraph.
FUSED_MATMUL_ACTIVATIONS = ("none", "relu", "tanh", "gelu", "gelu_exact")


def apply_fused_activation(y, activation: str):
    if activation == "none":
        return y
    if activation == "relu":
        return torch.relu(y)
    if activation == "tanh":
        return torch.tanh(y)
    if activation == "gelu":
        return F.gelu(y, approximate="tanh")
    if activation == "gelu_exact":
        return F.gelu(y)
    raise ValueError(
        f"fused_matmul_bias_act: unknown activation '{activation}'; "
        f"valid: {list(FUSED_MATMUL_ACTIVATIONS)}")


@op("fused_matmul_bias_act")
def fused_matmul_bias_act(x, w, b=None, *, activation: str = "none",
                          transpose_a: bool = False,
                          transpose_b: bool = False):
    """act(x @ w + b) — the matmul-epilogue fusion target.

    x:[...,M,K] w:[K,N] b:[N] -> [...,M,N]. The generic impl is the op
    chain it replaces, op by op in the operands' dtype (promoted as
    ``jnp.matmul`` promotes mixed operands); the hand-written CUDA kernel
    (``ops/cuda_matmul.py``) registers as its ``"cuda"`` helper."""
    if transpose_a:
        x = x.transpose(-1, -2)
    if transpose_b:
        w = w.transpose(-1, -2)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return apply_fused_activation(y, activation)


@op("fused_layer_norm")
def fused_layer_norm(x, gain, bias=None, *, axis: int = -1,
                     eps: float = 1e-5, activation: str = "none"):
    """act(layer_norm(x) * gain + bias) — the LN-epilogue fusion target the
    optimizer emits for a trailing-axis layer norm feeding a GELU. The
    generic impl is the op chain it replaces; the hand-written one-pass
    CUDA kernel (``ops/cuda_layernorm.py``) registers as its ``"cuda"``
    helper.

    Trailing-axis only: the (N,)-shaped gain/bias broadcast along the last
    axis, so a non-trailing ``axis`` raises."""
    if axis not in (-1, x.ndim - 1):
        raise ValueError(
            f"fused_layer_norm normalizes the trailing axis only "
            f"(gain/bias are per-last-dim); got axis={axis} for rank "
            f"{x.ndim} — use the catalog layer_norm for other axes")
    return apply_fused_activation(
        layer_norm.fn(x, gain, bias, axis=-1, eps=eps), activation)


# --------------------------------------------------------------------------
# Dropout, embeddings and the recurrent cells (the sequential network's)
# --------------------------------------------------------------------------


@op("dropout")
def dropout(x, gen: Optional[torch.Generator], *, rate: float,
            deterministic: bool = False):
    """Inverted dropout: each entry kept with probability ``1 - rate``,
    drawn from ``gen`` (a ``torch.Generator`` on x's device), and scaled
    by ``1 / (1 - rate)``; the rest zero. The JAX package draws from a PRNG
    key, so the two agree in distribution, not bit for bit."""
    if deterministic or rate <= 0.0:
        return x
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))


# the most rows a table may have for :func:`table_rows` to take its
# gradient as a GEMM against the one-hot ids (that many multiply-adds an
# element of the gradient at most)
ONE_HOT_ROWS = 512


class _TableRows(torch.autograd.Function):
    """The rows of a small table, whose gradient is ``one_hot(ids)ᵀ @
    grad``: a GEMM, summing in the same order every run."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        rows = torch.arange(ctx.rows, device=ids.device)
        hot = (ids.reshape(-1, 1) == rows).to(grad.dtype)
        return hot.t() @ grad.reshape(-1, grad.shape[-1]), None


def table_rows(table, ids):
    """The rows of a 2-D float ``table`` at integer ``ids``: ids.shape +
    (table.shape[1],), with a gradient into the table that has the same
    bits every run on the card. ``F.embedding``'s backward there sums the
    duplicate indices of a table of a few rows in an order that varies
    from run to run (thousands of equal ids into a two-row table differ
    run to run; the same count into a 30 522-row word table does not), and
    ``index_select``'s sums with atomics. So a table of at most
    :data:`ONE_HOT_ROWS` rows takes its gradient as the one-hot GEMM
    (:class:`_TableRows`; no ``F.one_hot``, which reads the ids' range on
    the host) and a larger one through ``F.embedding``. The forward is
    ``F.embedding``'s either way: the rows themselves."""
    if table.shape[0] <= ONE_HOT_ROWS and table.requires_grad \
            and torch.is_grad_enabled():
        return _TableRows.apply(table, ids)
    return F.embedding(ids, table)


@op("embedding_lookup")
def embedding_lookup(table, ids):
    """Rows of ``table`` at integer ``ids``: ids.shape + table.shape[1:]."""
    flat = ids.reshape(-1).long()
    return table.index_select(0, flat).reshape(
        tuple(ids.shape) + tuple(table.shape[1:]))


@op("lstm_cell")
def lstm_cell(x, h_prev, c_prev, w_ih, w_hh, b, *, forget_bias: float = 0.0):
    """Standard LSTM cell, gate order i, f, g (cell), o. x:[B,I],
    h/c:[B,H], w_ih:[I,4H], w_hh:[H,4H], b:[4H]."""
    z = x @ w_ih + h_prev @ w_hh + b
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return h, c


@op("gru_cell")
def gru_cell(x, h_prev, w_ih, w_hh, b_ih, b_hh):
    """GRU cell, gate order r, z, n, with separate input and recurrent
    biases. x:[B,I], h:[B,H], w_ih:[I,3H], w_hh:[H,3H]."""
    gi = x @ w_ih + b_ih
    gh = h_prev @ w_hh + b_hh
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h_prev


@op("simple_rnn_cell")
def simple_rnn_cell(x, h_prev, w_ih, w_hh, b, *, activation=torch.tanh):
    return activation(x @ w_ih + h_prev @ w_hh + b)


@op("lstm_sequence")
def lstm_sequence(x, w_ih, w_hh, b, h0=None, c0=None):
    """Full-sequence LSTM over ``lstm_cell`` (gate order i, f, g, o),
    batch-major x:[N,T,I]. Returns (ys:[N,T,H], h_T, c_T)."""
    h_dim = w_hh.shape[0]
    n = x.shape[0]
    h = x.new_zeros((n, h_dim)) if h0 is None else h0
    c = x.new_zeros((n, h_dim)) if c0 is None else c0
    ys = []
    for t in range(x.shape[1]):
        h, c = lstm_cell.fn(x[:, t], h, c, w_ih, w_hh, b)
        ys.append(h)
    return torch.stack(ys, dim=1), h, c


@op("gru_sequence")
def gru_sequence(x, w_ih, w_hh, b_ih, b_hh, h0=None, *,
                 linear_before_reset: bool = True):
    """Full-sequence GRU, gate order r, z, n; batch-major x:[N,T,I].
    Returns (ys:[N,T,H], h_T). ``linear_before_reset=True`` is
    ``gru_cell``; False is the ONNX GRU default
    (n = tanh(Wn x + Rn (r*h) + b))."""
    h_dim = w_hh.shape[0]
    n = x.shape[0]
    h = x.new_zeros((n, h_dim)) if h0 is None else h0
    ys = []
    for t in range(x.shape[1]):
        xt = x[:, t]
        if linear_before_reset:
            h = gru_cell.fn(xt, h, w_ih, w_hh, b_ih, b_hh)
        else:
            gi = xt @ w_ih + b_ih
            i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
            r = torch.sigmoid(i_r + h @ w_hh[:, :h_dim] + b_hh[:h_dim])
            z = torch.sigmoid(i_z + h @ w_hh[:, h_dim:2 * h_dim]
                              + b_hh[h_dim:2 * h_dim])
            nn = torch.tanh(i_n + (r * h) @ w_hh[:, 2 * h_dim:]
                            + b_hh[2 * h_dim:])
            h = (1.0 - z) * nn + z * h
        ys.append(h)
    return torch.stack(ys, dim=1), h


# --------------------------------------------------------------------------
# The rest of the catalog's nn family (``nn_ops.py:92-623``): 1-D and 3-D
# convolutions, im2col, the dense primitives, gather and one-hot, projected
# multi-head attention, the softmax ops, standardize and the clips
# --------------------------------------------------------------------------


@op("conv1d")
def conv1d(x, w, b=None, *, stride: int = 1, padding="same",
           dilation: int = 1):
    """1-D convolution. x: [N,W,C], w: [k,C_in,C_out]."""
    s, d = int(stride), int(dilation)
    if isinstance(padding, str):
        pad = "SAME" if padding.upper() == "SAME" else "VALID"
    else:
        p = int(padding) if not isinstance(padding, (tuple, list)) \
            else int(padding[0])
        pad = ((p, p),)
    ((lo, hi),) = ((0, 0),) if pad == "VALID" else _explicit_pads(
        pad, x.shape[1:2], w.shape[:1], (s,), (d,))
    xc = F.pad(x.permute(0, 2, 1), (lo, hi))
    out = F.conv1d(xc, w.permute(2, 1, 0), None, s, 0, d).permute(0, 2, 1)
    if b is not None:
        out = out + b
    return out


@op("conv3d")
def conv3d(x, w, b=None, *, stride=1, padding="same", dilation=1):
    """3-D convolution. x: [N,D,H,W,C], w: [kD,kH,kW,C_in,C_out] (NDHWC)."""

    def triple(v):
        return tuple(int(a) for a in v) if isinstance(v, (tuple, list)) \
            else (int(v),) * 3

    s, d = triple(stride), triple(dilation)
    if isinstance(padding, str):
        pad = "SAME" if padding.upper() == "SAME" else "VALID"
    else:
        pad = tuple((int(p), int(p)) for p in triple(padding))
    pads = _explicit_pads(pad, x.shape[1:4], w.shape[:3], s, d)
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    xc = F.pad(x.permute(0, 4, 1, 2, 3), flat)
    out = F.conv3d(xc, w.permute(4, 3, 0, 1, 2), None, s, 0, d)
    out = out.permute(0, 2, 3, 4, 1)
    if b is not None:
        out = out + b
    return out


def patches(x, kernel, stride, dilation, pads):
    """NHWC patches of ``x`` after ``pads``: (N, oh, ow, C·kh·kw) with the
    features channel-major (C, kh, kw), as
    ``lax.conv_general_dilated_patches`` orders them."""
    (pt, pb), (pl_, pr) = pads
    xc = F.pad(x.permute(0, 3, 1, 2), (pl_, pr, pt, pb))
    n, c, h, w = xc.shape
    kh, kw = kernel
    oh = (h - (kh - 1) * dilation[0] - 1) // stride[0] + 1
    ow = (w - (kw - 1) * dilation[1] - 1) // stride[1] + 1
    cols = F.unfold(xc, (kh, kw), dilation=dilation, stride=stride)
    return cols.reshape(n, c * kh * kw, oh, ow).permute(0, 2, 3, 1)


@op("im2col")
def im2col(x, *, kernel: IntPair, stride: IntPair = 1, padding="valid",
           dilation: IntPair = 1):
    """Patch extraction (reference helpers/im2col): NHWC x to (N, oh, ow,
    C·kh·kw), features ordered (C, kh, kw). Exposed for parity; the
    convolutions do not use it."""
    k, s, d = _pair(kernel), _pair(stride), _pair(dilation)
    pads = _explicit_pads(_padding(padding, k, s, d), x.shape[1:3], k, s, d)
    return patches(x, k, s, d, pads)


@op("matmul")
def matmul(a, b, *, transpose_a: bool = False, transpose_b: bool = False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.matmul(a, b)


@op("xw_plus_b")
def xw_plus_b(x, w, b):
    """Dense layer primitive (reference xw_plus_b.cpp)."""
    return torch.matmul(x, w) + b


def take(params, indices, axis: int = 0):
    """``jnp.take(params, indices, axis)`` in its default fill mode:
    negative indices count from the end, and out-of-range ones give NaN
    for floats and the dtype's minimum for integers (True for bool)."""
    axis = int(axis) % params.ndim
    n = params.shape[axis]
    idx = indices.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    flat = torch.clamp(idx, 0, max(n - 1, 0)).reshape(-1)
    if axis == 0 and params.ndim == 2 and params.is_floating_point():
        # a table's rows (an embedding): :func:`table_rows`, whose gradient
        # has the same bits every run on the card, where index_select's
        # (index_add_) sums with atomics
        out = table_rows(params, flat)
    else:
        out = torch.index_select(params, axis, flat)
    out = out.reshape(params.shape[:axis] + idx.shape
                      + params.shape[axis + 1:])
    if params.is_floating_point() or params.is_complex():
        fill = float("nan")
    elif params.dtype == torch.bool:
        fill = True
    else:
        fill = torch.iinfo(params.dtype).min
    keep = valid.reshape((1,) * axis + idx.shape
                         + (1,) * (params.ndim - axis - 1))
    return torch.where(keep, out, torch.full((), fill, dtype=out.dtype,
                                             device=out.device))


@op("gather")
def gather(params, indices, *, axis: int = 0):
    return take(params, indices, axis)


@op("one_hot")
def one_hot(indices, *, depth: int, on_value: float = 1.0,
            off_value: float = 0.0, dtype="float32"):
    """``jax.nn.one_hot``: a row of zeros for an index outside [0, depth);
    built on the device (``F.one_hot`` reads the range on the host)."""
    from deeplearning4j_tpu_torch.analysis.values import as_dtype

    cls = torch.arange(int(depth), device=indices.device)
    oh = (indices.to(torch.int64)[..., None] == cls).to(as_dtype(dtype))
    return oh * on_value + (1.0 - oh) * off_value


@op("multi_head_dot_product_attention")
def multi_head_dot_product_attention(q, k, v, wq, wk, wv, wo, mask=None, *,
                                     num_heads: int, scaled: bool = True,
                                     bq=None, bk=None, bv=None, bo=None):
    """Projected multi-head attention, q/k/v: [B, L, D]; w*: [D, D].
    Optional per-projection biases (Keras MultiHeadAttention use_bias);
    ``mask`` [B, Lk] keeps the keys where it is nonzero."""

    def split(x, w, bias):
        y = torch.matmul(x, w)
        if bias is not None:
            y = y + bias
        b, length, d = y.shape
        return y.reshape(b, length, num_heads,
                         d // num_heads).permute(0, 2, 1, 3)

    qh, kh, vh = split(q, wq, bq), split(k, wk, bk), split(v, wv, bv)
    m = None
    if mask is not None:
        m = mask[:, None, None, :].bool()
    # through the DESCRIPTOR, so the flash kernels (the "cuda" helper) take
    # the call on the card; calling .fn would pin the plain version
    out = dot_product_attention(qh, kh, vh, m, scaled=scaled)
    b, h, length, d = out.shape
    out = out.permute(0, 2, 1, 3).reshape(b, length, h * d)
    out = torch.matmul(out, wo)
    return out if bo is None else out + bo


@op("softmax_op")
def softmax_op(x, *, axis: int = -1):
    return torch.softmax(inexact(x), dim=axis)


@op("log_softmax_op")
def log_softmax_op(x, *, axis: int = -1):
    return torch.log_softmax(inexact(x), dim=axis)


@op("standardize")
def standardize(x, *, axis=-1, eps: float = 1e-5):
    x = inexact(x)
    mean = torch.mean(x, dim=dims(x, axis), keepdim=True)
    std = torch.std(x, dim=dims(x, axis), unbiased=False, keepdim=True)
    return (x - mean) / (std + eps)


@op("clip_by_norm")
def clip_by_norm(x, *, clip_norm: float, axis=None):
    n = torch.sqrt(torch.sum(x * x, dim=dims(x, axis),
                             keepdim=axis is not None))
    scale = torch.clamp_max(clip_norm / torch.clamp_min(n, 1e-12), 1.0)
    return x * scale


@op("clip_by_value")
def clip_by_value(x, *, min_value: float, max_value: float):
    return torch.clamp(x, min_value, max_value)
