"""A dynamically quantized BERT encoder built through the SameDiff API.

ONNX Runtime's dynamic quantization of a BERT encoder (the layout its
``quantize_dynamic`` gives a transformer): every dense weight MatMul
becomes an int8 matmul — the weight quantized once, offline, per output
column; the activations per row at call time — while embeddings, biases,
LayerNorms, attention and softmax stay float32. Here each of those
MatMuls is the catalog op ``matmul_int8``, the serving path of
``ops/quantized.py``.

:func:`bert_int8_encoder` computes the same function as
:func:`.onnx_builder.bert_onnx_model` with its weights
(:func:`.onnx_builder.bert_onnx_weights`), layer by layer: the embedding
``gather`` plus positions; q, k, v projections split into heads by
``reshape`` / ``transpose``; scaled ``dot_product_attention`` under the
(B, 1, 1, T) boolean key mask; the output projection, the residual and a
``layer_norm`` (eps 1e-6); the FF up-projection, the erf GELU (``div``,
``erf``, ``add``, ``mul``) and the down-projection, the residual and a
``layer_norm``; the (d, 2) classifier and a ``softmax``. Its 6 dense
weights a layer plus the classifier — 73 at BERT-base's 12 layers — are
``matmul_int8`` nodes.

It is duck-typed: it calls only ``sd.placeholder``, ``sd.constant`` and
``sd.op`` (and ``rename`` on what they return), so one builder records
the graph on the JAX package's ``SameDiff`` and on the port's alike.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.quantized import quantize_int8


def quantize_weight(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``quantize_int8(w, axis=0)`` of a float32 (K, N) weight, offline:
    the int8 (K, N) weight and its (1, N) float32 column scales."""
    q, s = quantize_int8.fn(torch.from_numpy(np.ascontiguousarray(w)),
                            axis=0)
    return q.numpy(), s.numpy()


def bert_int8_encoder(sd, arrays: Dict[str, np.ndarray], *, batch: int,
                      seq: int, heads: int, eps: float = 1e-6
                      ) -> Dict[str, str]:
    """Record the int8 encoder on ``sd`` from the float32 ``arrays`` of
    :func:`.onnx_builder.bert_onnx_weights` (the layer count is read from
    them). Adds the placeholders ``ids`` and ``mask`` (batch, seq), float32
    as :func:`.onnx_builder.bert_onnx_feeds` makes them. Returns the names
    of the output probabilities (``y``, (batch, seq, 2)) and of the last
    hidden state (``hidden``, (batch, seq, d))."""
    d = arrays["emb"].shape[1]
    hd = d // heads
    layers = sum(1 for k in arrays if k.endswith("_wq"))

    def const(name, value):
        return sd.constant(name, value)

    def dense(x, p, w, b=None):
        q, s = quantize_weight(arrays[f"{p}_w{w}"])
        y = sd.op("matmul_int8", x, const(f"{p}_w{w}_q", q),
                  const(f"{p}_w{w}_scale", s))
        return y if b is None else sd.op("add", y, const(b, arrays[b]))

    def split_heads(t):
        t = sd.op("reshape", t, shape=(batch, seq, heads, hd))
        return sd.op("transpose", t, axes=(0, 2, 1, 3))

    def layer_norm(x, p):
        return sd.op("layer_norm", x, const(f"{p}_g", arrays[f"{p}_g"]),
                     const(f"{p}_b", arrays[f"{p}_b"]), eps=eps)

    ids = sd.placeholder("ids", (batch, seq))
    mask = sd.placeholder("mask", (batch, seq))
    keys = sd.op("cast", sd.op("reshape", mask, shape=(batch, 1, 1, seq)),
                 dtype="bool")
    x = sd.op("add", sd.op("gather", const("emb", arrays["emb"]), ids,
                           axis=0), const("pos", arrays["pos"]))
    sqrt2 = const("sqrt2", np.float32(np.sqrt(2.0)))
    one = const("one", np.float32(1.0))
    half = const("half", np.float32(0.5))
    for i in range(layers):
        p = f"l{i}"
        q, k, v = (split_heads(dense(x, p, t, f"{p}_b{t}"))
                   for t in ("q", "k", "v"))
        ctx = sd.op("dot_product_attention", q, k, v, keys, scaled=True)
        ctx = sd.op("reshape", sd.op("transpose", ctx, axes=(0, 2, 1, 3)),
                    shape=(batch, seq, d))
        x1 = layer_norm(sd.op("add", x, dense(ctx, p, "o", f"{p}_bo")),
                        f"{p}_ln1")
        h = dense(x1, p, "1", f"{p}_b1")
        e = sd.op("add", sd.op("erf", sd.op("div", h, sqrt2)), one)
        g = sd.op("mul", sd.op("mul", h, e), half)
        x = layer_norm(sd.op("add", x1, dense(g, p, "2", f"{p}_b2")),
                       f"{p}_ln2")
    x.rename("hidden")
    sd.op("softmax", dense(x, "cls", ""), axis=-1).rename("y")
    return {"y": "y", "hidden": "hidden"}
