"""ONNX ModelProto assembly at the protobuf wire level.

A copy of the JAX package's ``deeplearning4j_tpu/testing/onnx_builder.py``
(``tensor_proto``, ``attr_proto``, ``node_proto``, ``value_info``,
``build_model``, ``bert_onnx_model``, whose weights :func:`bert_onnx_weights`
draws) on the port's own wire codec, so the
port and ``chip_smoke.py`` build ONNX bytes without importing the JAX
package; a test holds the two builders' bytes equal.

:func:`bert_onnx_model` is a parameterizable BERT-base-style encoder with
the redundancy per-module tracing exporters emit — re-inlined
attention-mask expansion chains, Dropout and Identity no-ops, per-layer
foldable scale chains, decomposed erf-gelu — the surface the graph
optimizer's passes and fusion tier attack.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.imports import protowire as pw

_NP_DT = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
          np.dtype(np.int32): 6, np.dtype(np.float64): 11,
          np.dtype(np.uint8): 2, np.dtype(np.int8): 3}


def tensor_proto(name, arr):
    arr = np.ascontiguousarray(arr)
    out = pw.field_packed_varints(1, arr.shape) if arr.ndim else b""
    out += pw.field_varint(2, _NP_DT[arr.dtype])
    out += pw.field_string(8, name)
    out += pw.field_bytes(9, arr.tobytes())
    return out


def scalar_constant(output, value, name=""):
    """A ``Constant`` node whose value is a 0-d TensorProto, written with no
    dims as ``torch.onnx.export`` writes a Python int index (``x[:, 0]``).
    :func:`tensor_proto` gives every array dims, a 0-d one (1,), as the
    JAX package's builder does."""
    value = np.asarray(value)
    t = pw.field_varint(2, _NP_DT[value.dtype]) + pw.field_bytes(
        9, value.tobytes())
    attr = (pw.field_string(1, "value") + pw.field_bytes(5, t)
            + pw.field_varint(20, 4))
    return (pw.field_string(2, output)
            + pw.field_string(3, name or output + "_node")
            + pw.field_string(4, "Constant") + pw.field_bytes(5, attr))


def attr_proto(name, val):
    out = pw.field_string(1, name)
    if isinstance(val, float):
        out += pw.field_float(2, val) + pw.field_varint(20, 1)
    elif isinstance(val, int):
        out += pw.field_varint(3, val) + pw.field_varint(20, 2)
    elif isinstance(val, str):
        out += pw.field_bytes(4, val.encode()) + pw.field_varint(20, 3)
    elif isinstance(val, np.ndarray):
        out += pw.field_bytes(5, tensor_proto("", val)) + pw.field_varint(20, 4)
    elif isinstance(val, (list, tuple)) and val and isinstance(val[0], str):
        out += b"".join(pw.field_bytes(9, v.encode()) for v in val) \
            + pw.field_varint(20, 8)
    elif isinstance(val, (list, tuple)) and val and isinstance(val[0], float):
        out += b"".join(pw.field_float(7, v) for v in val) + pw.field_varint(20, 6)
    elif isinstance(val, (list, tuple)):
        out += pw.field_packed_varints(8, val) + pw.field_varint(20, 7)
    else:
        raise TypeError(type(val))
    return out


def node_proto(op_type, inputs, outputs, name="", **attrs):
    out = b"".join(pw.field_string(1, i) for i in inputs)
    out += b"".join(pw.field_string(2, o) for o in outputs)
    out += pw.field_string(3, name or outputs[0] + "_node")
    out += pw.field_string(4, op_type)
    out += b"".join(pw.field_bytes(5, attr_proto(k, v))
                    for k, v in attrs.items())
    return out


def value_info(name, shape):
    dims = b"".join(pw.field_bytes(1, pw.field_varint(1, d)) for d in shape)
    shape_p = pw.field_bytes(2, dims)
    tensor_t = pw.field_varint(1, 1) + shape_p  # elem_type=FLOAT
    type_p = pw.field_bytes(1, tensor_t)
    return pw.field_string(1, name) + pw.field_bytes(2, type_p)


def graph_proto(nodes, inputs, outputs, initializers=None, name="sub"):
    """A GraphProto's bytes: a Loop / If / Scan body (the JAX package's
    control-flow tests' helper of the same name)."""
    g = b"".join(pw.field_bytes(1, n) for n in nodes)
    g += pw.field_string(2, name)
    for n, a in (initializers or {}).items():
        g += pw.field_bytes(5, tensor_proto(n, a))
    g += b"".join(pw.field_bytes(11, value_info(n, s)) for n, s in inputs)
    g += b"".join(pw.field_bytes(12, value_info(n, s)) for n, s in outputs)
    return g


def graph_attr(name, graph_bytes):
    """A GRAPH-typed AttributeProto holding ``graph_bytes``."""
    return pw.field_string(1, name) + pw.field_bytes(6, graph_bytes) \
        + pw.field_varint(20, 5)


def node_with_graph_attrs(op_type, inputs, outputs, graph_attrs,
                          name="", **attrs):
    """:func:`node_proto` with GRAPH attributes (``{name: graph bytes}``)
    after the others."""
    out = b"".join(pw.field_string(1, i) for i in inputs)
    out += b"".join(pw.field_string(2, o) for o in outputs)
    out += pw.field_string(3, name or outputs[0] + "_node")
    out += pw.field_string(4, op_type)
    out += b"".join(pw.field_bytes(5, attr_proto(k, v))
                    for k, v in attrs.items())
    out += b"".join(pw.field_bytes(5, graph_attr(k, g))
                    for k, g in graph_attrs.items())
    return out


def build_model(nodes, inputs, outputs, initializers):
    """nodes: list of node_proto bytes; inputs/outputs: [(name, shape)];
    initializers: {name: array}."""
    g = b"".join(pw.field_bytes(1, n) for n in nodes)
    g += pw.field_string(2, "test_graph")
    g += b"".join(pw.field_bytes(5, tensor_proto(n, a))
                  for n, a in initializers.items())
    g += b"".join(pw.field_bytes(11, value_info(n, s)) for n, s in inputs)
    g += b"".join(pw.field_bytes(12, value_info(n, s)) for n, s in outputs)
    m = pw.field_varint(1, 8)  # ir_version
    m += pw.field_bytes(7, g)
    m += pw.field_bytes(8, pw.field_string(1, "") + pw.field_varint(2, 13))
    return m


def bert_onnx_weights(*, layers: int = 12, seq: int = 16, d: int = 768,
                      ff: int = 3072, vocab: int = 512,
                      seed: int = 0) -> dict:
    """The float32 weights of :func:`bert_onnx_model`, named as its
    initializers, drawn in its order from numpy ``RandomState(seed)``:
    embeddings, positions, the (d, 2) classifier, then per layer the six
    N(0, 0.02²) dense weights (zero biases, unit LayerNorm gains, zero
    LayerNorm biases)."""
    r = np.random.RandomState(seed)
    out = {"emb": (r.randn(vocab, d) * 0.02).astype(np.float32),
           "pos": (r.randn(seq, d) * 0.02).astype(np.float32),
           "cls_w": (r.randn(d, 2) * 0.02).astype(np.float32)}
    for i in range(layers):
        p = f"l{i}"
        for nm, shape in [("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                          ("wo", (d, d)), ("w1", (d, ff)), ("w2", (ff, d))]:
            out[f"{p}_{nm}"] = (r.randn(*shape) * 0.02).astype(np.float32)
        for nm, size in [("bq", d), ("bk", d), ("bv", d), ("bo", d),
                         ("b1", ff), ("b2", d)]:
            out[f"{p}_{nm}"] = np.zeros(size, np.float32)
        for ln in ("ln1", "ln2"):
            out[f"{p}_{ln}_g"] = np.ones(d, np.float32)
            out[f"{p}_{ln}_b"] = np.zeros(d, np.float32)
    return out


def bert_onnx_model(*, layers: int = 12, batch: int = 1, seq: int = 16,
                    d: int = 768, heads: int = 12, ff: int = 3072,
                    vocab: int = 512, seed: int = 0) -> bytes:
    """A BERT-style encoder ModelProto with exporter-shaped redundancy.

    Every layer re-inlines the attention-mask expansion chain (the CSE
    target), carries Dropout/Identity no-op nodes, computes its scale from
    constants (the fold target), emits the verbatim matmul→scale→mask→
    softmax→matmul attention chain with transpose/reshape head splits (the
    attention-fusion target) and the decomposed erf-gelu FF (the epilogue-
    fusion target). Inputs: ``ids``/``mask`` of shape (batch, seq);
    output: ``y`` of shape (batch, seq, 2)."""
    hd = d // heads
    weights = bert_onnx_weights(layers=layers, seq=seq, d=d, ff=ff,
                                vocab=vocab, seed=seed)
    nodes = []
    init = {
        "emb": weights["emb"],
        "pos": weights["pos"],
        "cls_w": weights["cls_w"],
        "shape_split": np.asarray([batch, seq, heads, hd], np.int64),
        "shape_merge": np.asarray([batch, seq, d], np.int64),
        "one": np.float32(1.0),
        "half": np.float32(0.5),
        "two": np.float32(2.0),
        "neg_big": np.float32(-10000.0),
        "hd_f": np.float32(hd),
        "eps": np.float32(1e-6),
    }

    def n(op, ins, outs, **attrs):
        nodes.append(node_proto(op, ins, outs, **attrs))
        return outs[0]

    def layer_norm(p, x):
        mu = n("ReduceMean", [x], [f"{p}_mu"], axes=[-1], keepdims=1)
        dd = n("Sub", [x, mu], [f"{p}_d"])
        sq = n("Pow", [dd, "two"], [f"{p}_sq"])
        var = n("ReduceMean", [sq], [f"{p}_var"], axes=[-1], keepdims=1)
        ve = n("Add", [var, "eps"], [f"{p}_ve"])
        std = n("Sqrt", [ve], [f"{p}_std"])
        norm = n("Div", [dd, std], [f"{p}_norm"])
        g = n("Mul", [norm, f"{p}_g"], [f"{p}_gn"])
        return n("Add", [g, f"{p}_b"], [f"{p}_out"])

    x = n("Gather", ["emb", "ids"], ["embedded"], axis=0)
    x = n("Add", [x, "pos"], ["h0"])

    for i in range(layers):
        p = f"l{i}"
        init.update((k, a) for k, a in weights.items()
                    if k.startswith(f"{p}_"))

        # the attention-mask expansion chain, re-inlined per layer exactly
        # as per-module tracing exporters do — the CSE target
        mu = n("Unsqueeze", ["mask"], [f"{p}_mask_u"], axes=[1, 2])
        mc = n("Cast", [mu], [f"{p}_mask_c"], to=1)
        mi = n("Sub", ["one", mc], [f"{p}_mask_i"])
        pen = n("Mul", [mi, "neg_big"], [f"{p}_mask_pen"])

        h = {}
        for t in ("q", "k", "v"):
            mm = n("MatMul", [x, f"{p}_w{t}"], [f"{p}_{t}mm"])
            a = n("Add", [mm, f"{p}_b{t}"], [f"{p}_{t}"])
            rs = n("Reshape", [a, "shape_split"], [f"{p}_{t}r"])
            h[t] = n("Transpose", [rs], [f"{p}_{t}h"], perm=[0, 2, 1, 3])
        kt = n("Transpose", [h["k"]], [f"{p}_kt"], perm=[0, 1, 3, 2])
        scores = n("MatMul", [h["q"], kt], [f"{p}_scores"])
        scale = n("Sqrt", ["hd_f"], [f"{p}_scale"])  # foldable const chain
        scaled = n("Div", [scores, scale], [f"{p}_scaled"])
        masked = n("Add", [scaled, pen], [f"{p}_masked"])
        probs = n("Softmax", [masked], [f"{p}_probs"], axis=-1)
        probs = n("Dropout", [probs], [f"{p}_probs_d"])  # no-op at inference
        ctx = n("MatMul", [probs, h["v"]], [f"{p}_ctx"])
        ctx = n("Transpose", [ctx], [f"{p}_ctxt"], perm=[0, 2, 1, 3])
        ctx = n("Reshape", [ctx, "shape_merge"], [f"{p}_ctxm"])
        proj = n("MatMul", [ctx, f"{p}_wo"], [f"{p}_projmm"])
        proj = n("Add", [proj, f"{p}_bo"], [f"{p}_proj"])
        proj = n("Dropout", [proj], [f"{p}_proj_d"])
        res = n("Add", [x, proj], [f"{p}_res1"])
        x1 = layer_norm(f"{p}_ln1", res)

        # FF with the decomposed-gelu chain exporters emit
        h1 = n("MatMul", [x1, f"{p}_w1"], [f"{p}_ffmm"])
        h1 = n("Add", [h1, f"{p}_b1"], [f"{p}_ff1"])
        s2 = n("Sqrt", ["two"], [f"{p}_sqrt2"])  # foldable const chain
        e = n("Div", [h1, s2], [f"{p}_ge_div"])
        e = n("Erf", [e], [f"{p}_ge_erf"])
        e = n("Add", [e, "one"], [f"{p}_ge_add"])
        e = n("Mul", [h1, e], [f"{p}_ge_mul"])
        g = n("Mul", [e, "half"], [f"{p}_gelu"])
        h2 = n("MatMul", [g, f"{p}_w2"], [f"{p}_ff2mm"])
        h2 = n("Add", [h2, f"{p}_b2"], [f"{p}_ff2"])
        h2 = n("Dropout", [h2], [f"{p}_ff2_d"])
        res2 = n("Add", [x1, h2], [f"{p}_res2"])
        x = layer_norm(f"{p}_ln2", res2)
        x = n("Identity", [x], [f"{p}_out"])  # exporter block boundary

    logits = n("MatMul", [x, "cls_w"], ["logits"])
    n("Softmax", [logits], ["y"], axis=-1)
    return build_model(nodes, [("ids", (batch, seq)), ("mask", (batch, seq))],
                       [("y", (batch, seq, 2))], init)


# The imported-BERT configuration the card runs (chip_smoke.py's onnx_bert
# phase, profile_import.py): BERT-base widths and vocabulary at the GLUE
# fine-tune shape, batch 32 × seq 128. Not in the JAX builder, which tests
# and benches at smaller sizes.
BERT_BASE_ONNX = dict(layers=12, batch=32, seq=128, d=768, heads=12,
                      ff=3072, vocab=30522)


def bert_onnx_feeds(batch: int, seq: int, vocab: int, *, seed: int = 1,
                    min_len: int = 16):
    """Feeds for :func:`bert_onnx_model`: token ids (float32, as the model
    declares its inputs) and an end-padded 0/1 key mask with ragged row
    lengths in ``[min_len, seq]`` — no row fully masked, so the graph's
    additive -10000 penalty and the fused node's masking agree."""
    r = np.random.RandomState(seed)
    lens = r.randint(min(min_len, seq), seq + 1, batch)
    return {"ids": r.randint(0, vocab, (batch, seq)).astype(np.float32),
            "mask": (np.arange(seq)[None] < lens[:, None]).astype(
                np.float32)}


# The token-classification head a fine-tune adds in SameDiff on top of the
# imported encoder (chip_smoke.py's sd_bert_finetune phase,
# profile_import.py's fine-tune mode): dense → LayerNorm → GELU →
# classifier over the 9 BIO tags of CoNLL-2003 NER, and a softmax
# cross-entropy loss against one-hot token labels. The LayerNorm → GELU
# pair is what the optimizer fuses into one ``fused_layer_norm`` node.
NER_TAGS = 9


def token_head_arrays(d: int, tags: int = NER_TAGS, *, seed: int = 2):
    """Head weights from numpy ``RandomState(seed)``: dense (d, d) and
    classifier (d, tags) N(0, 0.02²), LayerNorm gain 1 + N(0, 0.1²) and
    bias N(0, 0.1²), dense bias N(0, 0.02²), classifier bias zeros."""
    r = np.random.RandomState(seed)
    return {
        "head_w": (r.randn(d, d) * 0.02).astype(np.float32),
        "head_b": (r.randn(d) * 0.02).astype(np.float32),
        "head_ln_g": (1.0 + 0.1 * r.randn(d)).astype(np.float32),
        "head_ln_b": (0.1 * r.randn(d)).astype(np.float32),
        "cls_head_w": (r.randn(d, tags) * 0.02).astype(np.float32),
        "cls_head_b": np.zeros(tags, np.float32),
    }


def add_token_head(sd, enc_name: str, arrays, batch: int, seq: int):
    """Record the head on ``sd`` (a SameDiff of either package: only the
    API both share is used) reading ``enc_name``. Adds the placeholder
    ``labels`` (batch, seq, tags) and returns the names of the logits and
    of the scalar loss."""
    tags = arrays["cls_head_w"].shape[1]
    v = {k: sd.var(k, a) for k, a in arrays.items()}
    h = sd.get_variable(enc_name) @ v["head_w"] + v["head_b"]
    a = sd.nn.gelu(sd.nn.layer_norm(h, v["head_ln_g"], v["head_ln_b"]))
    logits = (a @ v["cls_head_w"] + v["cls_head_b"]).rename("head_logits")
    labels = sd.placeholder("labels", (batch, seq, tags))
    sd.loss.softmax_cross_entropy(logits, labels).rename("head_loss")
    return "head_logits", "head_loss"


def token_labels(batch: int, seq: int, tags: int = NER_TAGS, *,
                 seed: int = 3) -> np.ndarray:
    """One-hot float32 token labels (batch, seq, tags) from numpy."""
    ids = np.random.RandomState(seed).randint(0, tags, (batch, seq))
    return np.eye(tags, dtype=np.float32)[ids]


class TokenBatch:
    """One ``sd.fit`` batch of the fine-tune: ``features`` is the list
    ``[ids, mask]`` (``fit`` feeds one array per mapped placeholder; a
    ``DataSet`` would stack them into one array) and ``labels`` the
    one-hot token labels."""

    def __init__(self, feeds, labels):
        self.features = [feeds["ids"], feeds["mask"]]
        self.labels = labels

    def num_examples(self) -> int:
        return int(self.labels.shape[0])


# ---------------------------------------------------------------------------
# Vision models, laid out as torch.onnx.export writes them
# ---------------------------------------------------------------------------

# google/vit-base-patch16-224 (HF ViTConfig defaults): image 224, patch 16,
# hidden 768, 12 layers, 12 heads, intermediate 3072, exact GELU,
# layer_norm_eps 1e-12, 1000 classes
VIT_B16 = dict(layers=12, image=224, patch=16, d=768, heads=12, ff=3072,
               classes=1000)


def vit_onnx_weights(*, layers: int = 12, image: int = 224, patch: int = 16,
                     d: int = 768, ff: int = 3072, classes: int = 1000,
                     channels: int = 3, seed: int = 0) -> dict:
    """The float32 weights of :func:`vit_onnx_model`, named as its
    initializers, drawn in this order from numpy ``RandomState(seed)``:
    the patch projection, class token, position table and head, then per
    layer the six dense weights and biases, all N(0, 0.02²); LayerNorm
    gains 1 + N(0, 0.02²) and biases N(0, 0.02²)."""
    r = np.random.RandomState(seed)
    tokens = (image // patch) ** 2 + 1

    def n(*shape):
        return (r.randn(*shape) * 0.02).astype(np.float32)

    out = {"patch_w": n(d, channels, patch, patch), "patch_b": n(d),
           "cls_token": n(1, 1, d), "pos_emb": n(1, tokens, d),
           "head_w": n(classes, d), "head_b": n(classes)}
    for i in range(layers):
        p = f"l{i}"
        for nm, shape in [("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                          ("wo", (d, d)), ("w1", (d, ff)), ("w2", (ff, d))]:
            out[f"{p}_{nm}"] = n(*shape)
        for nm, size in [("bq", d), ("bk", d), ("bv", d), ("bo", d),
                         ("b1", ff), ("b2", d)]:
            out[f"{p}_{nm}"] = n(size)
    for ln in [f"l{i}_{k}" for i in range(layers)
               for k in ("ln1", "ln2")] + ["ln_f"]:
        out[f"{ln}_g"] = (1.0 + r.randn(d) * 0.02).astype(np.float32)
        out[f"{ln}_b"] = n(d)
    return out


def vit_onnx_model(*, layers: int = 12, batch: int = 1, image: int = 224,
                   patch: int = 16, d: int = 768, heads: int = 12,
                   ff: int = 3072, classes: int = 1000, channels: int = 3,
                   eps: float = 1e-12, seed: int = 0) -> bytes:
    """A ViT image classifier ModelProto, laid out as ``torch.onnx.export``
    writes HF's ``ViTForImageClassification``: the patch ``Conv`` (kernel
    and stride ``patch``, with bias) → ``Reshape`` → ``Transpose``; the
    class token ``Expand``ed over the batch from a constant shape and
    ``Concat``enated in front; the position table added; per layer
    ``LayerNormalization``, separate q/k/v ``MatMul`` + ``Add``, the
    head-split / ``MatMul`` / ``Div`` / ``Softmax`` / ``MatMul`` chain with
    no mask, the output ``MatMul`` + ``Add`` and residual, then
    ``LayerNormalization``, ``MatMul`` + ``Add`` → erf-GELU → ``MatMul`` +
    ``Add`` and residual; the final ``LayerNormalization``, ``Gather`` of
    token 0 on axis 1 (a 0-d ``Constant`` index, so the token axis goes)
    and a ``Gemm`` head with ``transB=1``. Input
    ``pixel_values`` (batch, channels, image, image); output ``logits``
    (batch, classes)."""
    hd = d // heads
    grid = image // patch
    tokens = grid * grid + 1
    weights = vit_onnx_weights(layers=layers, image=image, patch=patch, d=d,
                               ff=ff, classes=classes, channels=channels,
                               seed=seed)
    init = dict(weights)
    init.update({
        "patch_shape": np.asarray([batch, d, grid * grid], np.int64),
        "cls_shape": np.asarray([batch, 1, 1], np.int64),
        "shape_split": np.asarray([batch, tokens, heads, hd], np.int64),
        "shape_merge": np.asarray([batch, tokens, d], np.int64),
        "scale": np.float32(np.sqrt(hd)),
        "sqrt2": np.float32(np.sqrt(2.0)),
        "one": np.float32(1.0),
        "half": np.float32(0.5),
    })
    nodes = []

    def n(op, ins, outs, **attrs):
        nodes.append(node_proto(op, ins, outs, **attrs))
        return outs[0]

    def ln(name, x):
        return n("LayerNormalization", [x, f"{name}_g", f"{name}_b"],
                 [f"{name}_out"], axis=-1, epsilon=eps)

    def dense(p, x, w, b):
        mm = n("MatMul", [x, f"{p}_{w}"], [f"{p}_{w}_mm"])
        return n("Add", [mm, f"{p}_{b}"], [f"{p}_{w}_out"])

    x = n("Conv", ["pixel_values", "patch_w", "patch_b"], ["patches"],
          kernel_shape=[patch, patch], strides=[patch, patch])
    x = n("Reshape", [x, "patch_shape"], ["patches_flat"])
    x = n("Transpose", [x], ["patches_t"], perm=[0, 2, 1])
    cls = n("Expand", ["cls_token", "cls_shape"], ["cls_tokens"])
    x = n("Concat", [cls, x], ["embedded"], axis=1)
    x = n("Add", [x, "pos_emb"], ["h0"])
    for i in range(layers):
        p = f"l{i}"
        h = ln(f"{p}_ln1", x)
        heads_of = {}
        for t in ("q", "k", "v"):
            a = dense(p, h, f"w{t}", f"b{t}")
            rs = n("Reshape", [a, "shape_split"], [f"{p}_{t}r"])
            heads_of[t] = n("Transpose", [rs], [f"{p}_{t}h"],
                            perm=[0, 2, 1, 3])
        kt = n("Transpose", [heads_of["k"]], [f"{p}_kt"], perm=[0, 1, 3, 2])
        scores = n("MatMul", [heads_of["q"], kt], [f"{p}_scores"])
        scaled = n("Div", [scores, "scale"], [f"{p}_scaled"])
        probs = n("Softmax", [scaled], [f"{p}_probs"], axis=-1)
        ctx = n("MatMul", [probs, heads_of["v"]], [f"{p}_ctx"])
        ctx = n("Transpose", [ctx], [f"{p}_ctxt"], perm=[0, 2, 1, 3])
        ctx = n("Reshape", [ctx, "shape_merge"], [f"{p}_ctxm"])
        proj = dense(p, ctx, "wo", "bo")
        x = n("Add", [x, proj], [f"{p}_res1"])
        h = ln(f"{p}_ln2", x)
        h1 = dense(p, h, "w1", "b1")
        e = n("Div", [h1, "sqrt2"], [f"{p}_ge_div"])
        e = n("Erf", [e], [f"{p}_ge_erf"])
        e = n("Add", [e, "one"], [f"{p}_ge_add"])
        e = n("Mul", [h1, e], [f"{p}_ge_mul"])
        g = n("Mul", [e, "half"], [f"{p}_gelu"])
        h2 = dense(p, g, "w2", "b2")
        x = n("Add", [x, h2], [f"{p}_out"])
    x = ln("ln_f", x)
    nodes.append(scalar_constant("token0", np.int64(0)))
    x = n("Gather", [x, "token0"], ["pooled"], axis=1)
    n("Gemm", [x, "head_w", "head_b"], ["logits"], transB=1)
    return build_model(nodes, [("pixel_values",
                                (batch, channels, image, image))],
                       [("logits", (batch, classes))], init)


# torchvision's resnet50 (v1.5: the stride in the 3×3 conv): bottlenecks
# (3, 4, 6, 3) at widths 64…512 (×4 out), 1000 classes
RESNET50 = dict(blocks=(3, 4, 6, 3), width=64, image=224, classes=1000)


def resnet50_onnx_model(*, batch: int = 1, image: int = 224,
                        blocks=(3, 4, 6, 3), width: int = 64,
                        classes: int = 1000, channels: int = 3,
                        seed: int = 0) -> bytes:
    """A ResNet-50 (v1.5) ModelProto, laid out as ``torch.onnx.export``
    writes torchvision's ``resnet50`` with BatchNormalization kept
    (``training=TrainingMode.PRESERVE``): ``Conv`` (no bias) →
    ``BatchNormalization`` → ``Relu``; the 3×3 stride-2 ``MaxPool`` with
    pads 1; bottlenecks 1×1 → 3×3 (stride) → 1×1 (×4), each conv with its
    BN, a 1×1 stride-s conv + BN downsample where the shape changes, the
    residual ``Add`` → ``Relu``; ``GlobalAveragePool`` → ``Flatten`` →
    ``Gemm`` (``transB=1``). Weights from numpy ``RandomState(seed)`` in
    graph order: convs N(0, 1/fan_in), BN gains U(0.5, 1), biases and
    running means N(0, 0.05²), running variances U(0.5, 1.5); the head
    N(0, 0.01²) with zero bias. Input ``x`` (batch, channels, image,
    image); output ``logits`` (batch, classes)."""
    r = np.random.RandomState(seed)
    init = {}
    nodes = []

    def n(op, ins, outs, **attrs):
        nodes.append(node_proto(op, ins, outs, **attrs))
        return outs[0]

    def conv_bn(name, x, cin, cout, k, stride, relu):
        w = f"{name}_w"
        init[w] = (r.randn(cout, cin, k, k)
                   / np.sqrt(cin * k * k)).astype(np.float32)
        for nm, arr in [("g", r.uniform(0.5, 1.0, cout)),
                        ("b", r.randn(cout) * 0.05),
                        ("m", r.randn(cout) * 0.05),
                        ("v", r.uniform(0.5, 1.5, cout))]:
            init[f"{name}_bn_{nm}"] = arr.astype(np.float32)
        pad = k // 2
        y = n("Conv", [x, w], [f"{name}_conv"], kernel_shape=[k, k],
              strides=[stride, stride], pads=[pad] * 4)
        y = n("BatchNormalization", [y] + [f"{name}_bn_{s}" for s in "gbmv"],
              [f"{name}_bn"], epsilon=1e-5)
        return n("Relu", [y], [f"{name}_relu"]) if relu else y

    x = conv_bn("stem", "x", channels, width, 7, 2, True)
    x = n("MaxPool", [x], ["stem_pool"], kernel_shape=[3, 3], strides=[2, 2],
          pads=[1, 1, 1, 1])
    cin = width
    for s, count in enumerate(blocks):
        planes = width * 2 ** s
        for b in range(count):
            p = f"s{s}b{b}"
            stride = 2 if (b == 0 and s > 0) else 1
            h = conv_bn(f"{p}_c1", x, cin, planes, 1, 1, True)
            h = conv_bn(f"{p}_c2", h, planes, planes, 3, stride, True)
            h = conv_bn(f"{p}_c3", h, planes, 4 * planes, 1, 1, False)
            sc = x
            if stride != 1 or cin != 4 * planes:
                sc = conv_bn(f"{p}_down", x, cin, 4 * planes, 1, stride,
                             False)
            x = n("Add", [h, sc], [f"{p}_add"])
            x = n("Relu", [x], [f"{p}_out"])
            cin = 4 * planes
    x = n("GlobalAveragePool", [x], ["pool"])
    x = n("Flatten", [x], ["flat"], axis=1)
    init["fc_w"] = (r.randn(classes, cin) * 0.01).astype(np.float32)
    init["fc_b"] = np.zeros(classes, np.float32)
    n("Gemm", [x, "fc_w", "fc_b"], ["logits"], transB=1)
    return build_model(nodes, [("x", (batch, channels, image, image))],
                       [("logits", (batch, classes))], init)


def image_feeds(name: str, batch: int, image: int, channels: int = 3, *,
                seed: int = 1) -> dict:
    """``{name: (batch, channels, image, image)}`` float32 N(0, 1) pixels
    from numpy ``RandomState(seed)`` (normalized images)."""
    r = np.random.RandomState(seed)
    return {name: r.randn(batch, channels, image, image).astype(np.float32)}
