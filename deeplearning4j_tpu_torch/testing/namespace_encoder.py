"""A BERT-style encoder built through SameDiff's public namespaces only.

One builder for both packages' ``SameDiff`` (their namespaces have the same
methods and arguments): chip_smoke's ``sd_namespaces`` phase builds it at
BERT-base width on the card, and ``tests/test_torch_samediff_namespaces.py``
builds a 2-layer, width-64 version in both packages from the same weights.

The graph, for a float32 placeholder ``x`` [B, T, D] and one-hot ``labels``
[B, C]: ``layers`` times

1. ``sd.nn.multi_head_dot_product_attention(x, x, x, wq, wk, wv, wo,
   num_heads)``;
2. a residual add, then ``sd.nn.layer_norm``;
3. ``sd.nn.linear`` D→F, then ``sd.nn.gelu``;
4. ``sd.nn.linear`` F→D;
5. a residual add, then ``sd.nn.layer_norm``;

then the mean over T, ``sd.nn.linear`` D→C and
``sd.loss.softmax_cross_entropy``. Weights: numpy ``RandomState(seed)`` ×
0.02 for every matrix, LayerNorm gains 1 and every bias 0.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# BERT-base width (12 layers, d 768, 12 heads, ff 3072) over batch 8 ×
# seq 128, a two-class head
BERT_BASE = dict(batch=8, seq=128, d=768, heads=12, ff=3072, layers=12,
                 classes=2)


def encoder_weights(cfg: Dict[str, int], seed: int = 0
                    ) -> Dict[str, np.ndarray]:
    """The encoder's arrays by variable name."""
    r = np.random.RandomState(seed)
    d, ff = cfg["d"], cfg["ff"]
    out: Dict[str, np.ndarray] = {}

    def mat(*shape):
        return (r.randn(*shape) * 0.02).astype(np.float32)

    for i in range(cfg["layers"]):
        for n in ("wq", "wk", "wv", "wo"):
            out[f"l{i}_{n}"] = mat(d, d)
        out[f"l{i}_w1"] = mat(d, ff)
        out[f"l{i}_b1"] = np.zeros(ff, np.float32)
        out[f"l{i}_w2"] = mat(ff, d)
        out[f"l{i}_b2"] = np.zeros(d, np.float32)
        for k in (1, 2):
            out[f"l{i}_ln{k}_g"] = np.ones(d, np.float32)
            out[f"l{i}_ln{k}_b"] = np.zeros(d, np.float32)
    out["cls_w"] = mat(d, cfg["classes"])
    out["cls_b"] = np.zeros(cfg["classes"], np.float32)
    return out


def encoder_batch(cfg: Dict[str, int], seed: int = 1):
    """(x [B, T, D] float32, one-hot labels [B, C] float32)."""
    r = np.random.RandomState(seed)
    x = r.randn(cfg["batch"], cfg["seq"], cfg["d"]).astype(np.float32)
    cls = r.randint(0, cfg["classes"], cfg["batch"])
    return x, np.eye(cfg["classes"], dtype=np.float32)[cls]


class Batch:
    """One ``sd.fit`` batch: the features feed ``x``, the labels
    ``labels``."""

    def __init__(self, x, labels):
        self.features = x
        self.labels = labels

    def num_examples(self) -> int:
        return int(self.labels.shape[0])


def build_encoder(sd, cfg: Dict[str, int], weights: Dict[str, np.ndarray]):
    """Record the encoder on ``sd`` (either package's SameDiff). Returns
    the names (logits, loss)."""
    v = {n: sd.var(n, a) for n, a in weights.items()}
    x = sd.placeholder("x", (None, cfg["seq"], cfg["d"]))
    labels = sd.placeholder("labels", (None, cfg["classes"]))
    h = x
    for i in range(cfg["layers"]):
        p = f"l{i}_"
        att = sd.nn.multi_head_dot_product_attention(
            h, h, h, v[p + "wq"], v[p + "wk"], v[p + "wv"], v[p + "wo"],
            num_heads=cfg["heads"])
        h = sd.nn.layer_norm(h + att, v[p + "ln1_g"], v[p + "ln1_b"])
        f = sd.nn.gelu(sd.nn.linear(h, v[p + "w1"], v[p + "b1"]))
        f = sd.nn.linear(f, v[p + "w2"], v[p + "b2"])
        h = sd.nn.layer_norm(h + f, v[p + "ln2_g"], v[p + "ln2_b"])
    pooled = h.mean(1)
    logits = sd.nn.linear(pooled, v["cls_w"], v["cls_b"])
    loss = sd.loss.softmax_cross_entropy(logits, labels)
    return logits.name, loss.name
