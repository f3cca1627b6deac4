"""The LSTM layer's recurrence as a registry op, with cuDNN as its helper.

``lstm_layer`` is an op of the port's own (the JAX package runs the
recurrence inline, ``_lstm_scan`` at ``nn/layers.py:513``, as one
``lax.scan`` with no Pallas kernel). Its generic impl transcribes that
scan step by step: gates ``x·W + h·RW + b`` in the order **i, f, o, g**,
the configurable gate activation on i, f and o, ``tanh`` on g,
``c' = f·c + i·g``, ``h' = o·act(c')`` with the layer's activation as
the cell-output activation, masked steps holding both h and c, and
``reverse`` scanning from the last step to the first. The input product
``x·W`` is taken for all steps at once; each step adds ``h·RW`` and ``b``
to its slice in the scan's order.

The ``"cuda"`` helper runs the same recurrence through cuDNN's LSTM
(``torch._cudnn_rnn``, what ``nn.LSTM`` reaches on the card), the role
DL4J's ``CudnnLSTMHelper`` plays. It is a library call, not a
hand-written kernel: the reference has no TPU kernel here. It sits behind
:func:`cudnn_usable`, which accepts only what cuDNN computes the same
way: sigmoid gates, a tanh cell activation, float32 or float16 (cuDNN's
RNN is not offered bfloat16 by PyTorch), and a mask that is ``None`` or
a prefix of ones in every row (right padding, every row at least one
step). Everything else runs the generic. The helper never gives way to
the generic: a cuDNN failure raises. Its dispatch is tallied as
``impl="cudnn"``.

What the helper does to give the generic's answers:

* gate order: cuDNN takes (4H, ·) weights in the order i, f, g, o; the
  layer's (I, 4H) ``W``, (H, 4H) ``RW`` and (4H,) ``b`` are permuted and
  transposed by differentiable ops, so gradients land in the layer's own
  leaves; ``b`` is passed once, with a zero second bias;
* right padding: the rows are packed (``pack_padded_sequence``, one host
  read of the lengths a call), so cuDNN stops each row at its length.
  Packed outputs are zero past the length; the scan instead holds h
  there, so the forward direction's padded outputs are rebuilt from the
  last h, and the reverse direction's are the initial h (zero unless a
  state is carried in);
* ``reverse``: each row's valid prefix is reversed in time before the
  call and the outputs are put back in order after it.
"""

from __future__ import annotations

import warnings
import weakref
from typing import Optional

import torch
from torch.nn.utils.rnn import (
    PackedSequence, pack_padded_sequence, pad_packed_sequence)

from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.registry import op, registry

CUDNN_LSTM_MODE = 2          # cudnnRNNMode_t CUDNN_LSTM
CUDNN_DTYPES = (torch.float32, torch.float16)


@op("lstm_layer")
def lstm_layer(x, W, RW, b, h0=None, c0=None, mask=None, *,
               gate_activation="sigmoid", activation="tanh",
               reverse: bool = False):
    """LSTM over x:[N,T,I] with W:[I,4H], RW:[H,4H], b:[4H] (gate order
    i, f, o, g). Returns (hs:[N,T,H], h_last, c_last); ``mask`` [N,T]
    holds the state at steps where it is 0. Mixed float operands compute
    in their promoted dtype, as jnp promotes them (float32 x with
    bfloat16 weights runs in float32)."""
    dt = x.dtype
    for a in (W, RW, b, h0, c0):
        if a is not None:
            dt = torch.promote_types(dt, a.dtype)
    x, W, RW, b = x.to(dt), W.to(dt), RW.to(dt), b.to(dt)
    h0 = None if h0 is None else h0.to(dt)
    c0 = None if c0 is None else c0.to(dt)
    n, t = x.shape[0], x.shape[1]
    hdim = RW.shape[0]
    h = x.new_zeros((n, hdim)) if h0 is None else h0
    c = x.new_zeros((n, hdim)) if c0 is None else c0
    gate = get_activation(gate_activation)
    cell = get_activation(activation)
    held = None if mask is None else (mask > 0)
    xw = x @ W
    outs = [None] * t
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        gates = xw[:, s] + h @ RW + b
        i, f, o, g = torch.chunk(gates, 4, dim=-1)
        i, f, o = gate(i), gate(f), gate(o)
        g = torch.tanh(g)
        c_new = f * c + i * g
        h_new = o * cell(c_new)
        if held is not None:
            m = held[:, s, None]
            h_new = torch.where(m, h_new, h)
            c_new = torch.where(m, c_new, c)
        h, c = h_new, c_new
        outs[s] = h
    return torch.stack(outs, dim=1), h, c


# --------------------------------------------------------------------------
# The cuDNN helper
# --------------------------------------------------------------------------

_LENGTHS = {"ref": None, "version": -1, "lengths": None}


def right_padded_lengths(mask) -> Optional[torch.Tensor]:
    """The rows' lengths (int64 on the host) when ``mask`` [N,T] is a
    prefix of ones in every row with every length at least 1, else None.
    One host read a mask: the answer is kept for the same tensor (by
    identity and version), which the gate and the helper both ask."""
    memo = _LENGTHS
    ref = memo["ref"]
    if ref is not None and ref() is mask and memo["version"] == mask._version:
        return memo["lengths"]
    valid = mask > 0
    lengths = valid.sum(dim=1)
    steps = torch.arange(mask.shape[1], device=mask.device)
    prefix = steps[None, :] < lengths[:, None]
    ok = (valid == prefix).all() & (lengths > 0).all()
    host = torch.cat([ok.view(1).long(), lengths.long()]).cpu()
    result = host[1:] if bool(host[0]) else None
    memo.update(ref=weakref.ref(mask), version=mask._version, lengths=result)
    return result


def cudnn_usable(x, W, RW, b, h0=None, c0=None, mask=None, *,
                 gate_activation="sigmoid", activation="tanh",
                 reverse: bool = False) -> bool:
    """What cuDNN's LSTM computes as ``lstm_layer`` does."""
    if not (isinstance(gate_activation, str)
            and gate_activation.lower() == "sigmoid"
            and isinstance(activation, str) and activation.lower() == "tanh"):
        return False
    if x.ndim != 3 or not x.is_cuda or x.dtype not in CUDNN_DTYPES:
        return False
    if any(a is not None and a.dtype != x.dtype for a in (W, RW, b, h0, c0)):
        return False
    if not (torch.backends.cudnn.is_available()
            and torch.backends.cudnn.enabled):
        return False
    return mask is None or right_padded_lengths(mask) is not None


def _cudnn_order(w):
    """Gate blocks [i, f, o, g] along the last axis as cuDNN's
    [i, f, g, o]."""
    h = w.shape[-1] // 4
    return torch.cat([w[..., :2 * h], w[..., 3 * h:], w[..., 2 * h:3 * h]],
                     dim=-1)


def _cudnn_call(inp, weights, h0, c0, batch_sizes):
    """One cuDNN LSTM layer, one direction. ``inp`` is (N, T, I), or the
    packed (sum(batch_sizes), I) data."""
    hdim = h0.shape[-1]
    with warnings.catch_warnings():
        # the weights are fresh permuted copies, packed by cuDNN at each
        # call by design, which it warns of
        warnings.filterwarnings("ignore", message="RNN module weights")
        out = torch._cudnn_rnn(
            inp, weights, 4, None, h0[None].contiguous(),
            c0[None].contiguous(), CUDNN_LSTM_MODE, hdim, 0, 1, True, 0.0,
            torch.is_grad_enabled(), False, batch_sizes, None)
    return out[0], out[1][0], out[2][0]


def lstm_layer_cudnn(x, W, RW, b, h0=None, c0=None, mask=None, *,
                     gate_activation="sigmoid", activation="tanh",
                     reverse: bool = False):
    """``lstm_layer`` through cuDNN (the helper :func:`cudnn_usable`
    admits)."""
    n, t = x.shape[0], x.shape[1]
    hdim = RW.shape[0]
    h0 = x.new_zeros((n, hdim)) if h0 is None else h0
    c0 = x.new_zeros((n, hdim)) if c0 is None else c0
    cb = _cudnn_order(b)
    weights = [_cudnn_order(W).t().contiguous(),
               _cudnn_order(RW).t().contiguous(),
               cb.contiguous(), torch.zeros_like(cb)]
    lengths = None
    if mask is not None:
        lengths = right_padded_lengths(mask)
        if lengths is None:
            raise ValueError("lstm_layer's cuDNN helper takes right-padded "
                             "masks only (its gate refuses the others)")
        if int(lengths.min()) == t:
            lengths = None
    if lengths is None:
        xs = x.flip(1) if reverse else x
        y, hy, cy = _cudnn_call(xs.contiguous(), weights, h0, c0, [])
        return (y.flip(1) if reverse else y), hy, cy
    steps = torch.arange(t, device=x.device)[None, :]
    lens = lengths.to(x.device)[:, None]
    valid = steps < lens
    if reverse:
        # each row's valid prefix reversed; padded steps stay in place
        order = torch.where(valid, lens - 1 - steps, steps)
        x = torch.gather(x, 1, order[..., None].expand_as(x))
    packed = pack_padded_sequence(x, lengths, batch_first=True,
                                  enforce_sorted=False)
    srt, unsrt = packed.sorted_indices, packed.unsorted_indices
    y, hy, cy = _cudnn_call(packed.data, weights, h0.index_select(0, srt),
                            c0.index_select(0, srt),
                            packed.batch_sizes.tolist())
    y, _ = pad_packed_sequence(
        PackedSequence(y, packed.batch_sizes, srt, unsrt), batch_first=True,
        total_length=t)
    hy, cy = hy.index_select(0, unsrt), cy.index_select(0, unsrt)
    if reverse:
        y = torch.gather(y, 1, order[..., None].expand(-1, -1, hdim))
        fill = h0
    else:
        fill = hy
    y = torch.where(valid[..., None], y, fill[:, None, :])
    return y, hy, cy


def register_platform_lstm() -> None:
    """Install cuDNN's LSTM as the ``"cuda"`` helper of ``lstm_layer``,
    tallied as ``impl="cudnn"``."""
    reg = registry()
    if "cuda" not in reg.get("lstm_layer").platform_impls:
        reg.register_platform("lstm_layer", "cuda", lstm_layer_cudnn,
                              cudnn_usable, label="cudnn")
