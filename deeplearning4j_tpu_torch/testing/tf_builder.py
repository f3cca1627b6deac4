"""TF GraphDef assembly at the protobuf wire level: a frozen BERT.

The TF counterpart of :mod:`.onnx_builder`, for the card, which has no
TensorFlow: :func:`bert_tf_graph` writes a frozen GraphDef (weights as
``Const`` nodes) with the port's wire codec (:mod:`..imports.protowire`),
in the op layout of google-research/bert ``modeling.py`` as a frozen
``BertModel`` + ``run_classifier.py`` head gives it:

* embeddings: ``GatherV2`` of the flattened ids, the token-type
  embeddings as ``OneHot`` → ``MatMul``, the position embeddings as a
  ``Slice`` of the 512-row table, then LayerNorm; the hidden states then
  live as a ``(batch·seq, hidden)`` matrix;
* per layer: q/k/v as ``MatMul`` + ``BiasAdd``, ``Reshape`` and
  ``Transpose`` into heads, ``BatchMatMulV2(q, k, adj_y=True)`` scaled by
  ``Mul`` with 1/√d, plus ``(1 − mask)·−10000``, ``Softmax``,
  ``BatchMatMulV2(probs, v)``, the output dense, the decomposed LayerNorm
  of ``tf.contrib.layers.layer_norm`` (``Mean``, ``SquaredDifference``,
  ``Rsqrt``, ε 1e-12) and the erf-GELU FFN (``0.5·(1 + erf(x/√2))·x``);
* the pooler (dense + ``Tanh`` on [CLS]) and a 2-way classifier; output
  ``logits``.

One departure from ``modeling.py``: the attention mask is the key mask
``(batch, 1, 1, seq)`` (``modeling.py`` broadcasts it against a ones
tensor to ``(batch, seq, seq)``); the values are the same, and the flash
kernels take key masks. ``dynamic_batch=True`` declares the batch
unknown and takes it from ``tf.shape(input_ids)[0]``, as ``modeling.py``'s
``get_shape_list`` does, so the head-split reshapes read their shape at
run time.

Weights are float32 N(0, 0.02²) from numpy ``RandomState(seed)`` (BERT's
``initializer_range``), LayerNorm gains 1 and biases 0, dense biases 0.
The tensor bytes are joined once: each message is built as a list of
chunks under its length prefix, so a 440 MB graph costs two copies of its
weights (``tobytes`` and the final join).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from deeplearning4j_tpu_torch.imports import protowire as pw

# DataType enum values (types.proto)
DT_FLOAT, DT_INT32, DT_INT64, DT_BOOL = 1, 3, 9, 10
_DT = {np.dtype(np.float32): DT_FLOAT, np.dtype(np.int32): DT_INT32,
       np.dtype(np.int64): DT_INT64, np.dtype(np.bool_): DT_BOOL}
# the GraphDef version of the TensorFlow that reads these graphs' op set
GRAPH_DEF_VERSION = 1882

Chunks = List[bytes]


def _msg(num: int, chunks: Chunks) -> Chunks:
    """Field ``num`` holding the message made of ``chunks``."""
    size = sum(len(c) for c in chunks)
    return [pw._varint(num << 3 | pw.LEN) + pw._varint(size)] + chunks


def shape_proto(dims: Sequence[int]) -> Chunks:
    out: Chunks = []
    for d in dims:
        out += _msg(2, [pw.field_varint(1, int(d))])
    return out


def tensor_proto(arr: np.ndarray) -> Chunks:
    arr = np.asarray(arr)  # tobytes() is C order; a 0-d array stays 0-d
    return ([pw.field_varint(1, _DT[arr.dtype])] + _msg(2, shape_proto(
        arr.shape)) + _msg(4, [arr.tobytes()]))


# AttrValue bodies
def a_type(dt: int) -> Chunks:
    return [pw.field_varint(6, dt)]


def a_int(v: int) -> Chunks:
    return [pw.field_varint(3, int(v))]


def a_bool(v: bool) -> Chunks:
    return [pw.field_varint(5, int(bool(v)))]


def a_str(v: str) -> Chunks:
    return [pw.field_string(2, v)]


def a_ints(vs: Sequence[int]) -> Chunks:
    return _msg(1, [pw.field_packed_varints(3, [int(v) for v in vs])])


def a_shape(dims: Sequence[int]) -> Chunks:
    return _msg(7, shape_proto(dims))


def a_tensor(arr: np.ndarray) -> Chunks:
    return _msg(8, tensor_proto(arr))


def node_def(name: str, op: str, inputs: Sequence[str] = (),
             **attrs: Chunks) -> Chunks:
    out: Chunks = [pw.field_string(1, name), pw.field_string(2, op)]
    out += [pw.field_string(3, i) for i in inputs]
    for k in sorted(attrs):
        out += _msg(5, [pw.field_string(1, k)] + _msg(2, attrs[k]))
    return out


def graph_def(nodes: Sequence[Chunks]) -> bytes:
    chunks: Chunks = []
    for n in nodes:
        chunks += _msg(1, n)
    chunks += _msg(4, [pw.field_varint(1, GRAPH_DEF_VERSION)])
    return b"".join(chunks)


class _Graph:
    """Node list under construction; every op gets ``T`` float32 unless
    told otherwise."""

    def __init__(self):
        self.nodes: List[Chunks] = []

    def node(self, name: str, op: str, inputs: Sequence[str] = (),
             **attrs: Chunks) -> str:
        self.nodes.append(node_def(name, op, inputs, **attrs))
        return name

    def const(self, name: str, arr) -> str:
        arr = np.asarray(arr)
        return self.node(name, "Const", dtype=a_type(_DT[arr.dtype]),
                         value=a_tensor(arr))

    def op(self, name: str, op: str, *inputs: str, t=DT_FLOAT,
           **attrs: Chunks) -> str:
        return self.node(name, op, inputs, T=a_type(t), **attrs)


def bert_tf_weights(*, layers: int = 12, d: int = 768, ff: int = 3072,
                    vocab: int = 30522, max_pos: int = 512,
                    type_vocab: int = 2, labels: int = 2,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """The float32 weights of :func:`bert_tf_graph`, named as its Const
    nodes, drawn in this order from numpy ``RandomState(seed)``: word,
    token-type and position embeddings, per layer q, k, v, output,
    intermediate and output dense kernels, then the pooler and the
    classifier kernels — N(0, 0.02²); biases and LayerNorm betas 0,
    gammas 1."""
    r = np.random.RandomState(seed)

    def w(*shape):
        return (r.randn(*shape) * 0.02).astype(np.float32)

    e = "bert/embeddings"
    out = {f"{e}/word_embeddings": w(vocab, d),
           f"{e}/token_type_embeddings": w(type_vocab, d),
           f"{e}/position_embeddings": w(max_pos, d),
           f"{e}/LayerNorm/gamma": np.ones(d, np.float32),
           f"{e}/LayerNorm/beta": np.zeros(d, np.float32)}
    for i in range(layers):
        p = f"bert/encoder/layer_{i}"
        for nm, shape in [("attention/self/query", (d, d)),
                          ("attention/self/key", (d, d)),
                          ("attention/self/value", (d, d)),
                          ("attention/output/dense", (d, d)),
                          ("intermediate/dense", (d, ff)),
                          ("output/dense", (ff, d))]:
            out[f"{p}/{nm}/kernel"] = w(*shape)
            out[f"{p}/{nm}/bias"] = np.zeros(shape[1], np.float32)
        for ln in ("attention/output/LayerNorm", "output/LayerNorm"):
            out[f"{p}/{ln}/gamma"] = np.ones(d, np.float32)
            out[f"{p}/{ln}/beta"] = np.zeros(d, np.float32)
    out["bert/pooler/dense/kernel"] = w(d, d)
    out["bert/pooler/dense/bias"] = np.zeros(d, np.float32)
    out["output_weights"] = w(d, labels)
    out["output_bias"] = np.zeros(labels, np.float32)
    return out


def bert_tf_graph(*, layers: int = 12, batch: int = 32, seq: int = 128,
                  d: int = 768, heads: int = 12, ff: int = 3072,
                  vocab: int = 30522, max_pos: int = 512,
                  dynamic_batch: bool = False, seed: int = 0) -> bytes:
    """A frozen BERT classifier GraphDef (module docstring). Inputs:
    ``input_ids``, ``input_mask``, ``segment_ids``, int32 (batch, seq)
    (batch -1 with ``dynamic_batch``); output: ``logits`` (batch, 2)."""
    hd = d // heads
    weights = bert_tf_weights(layers=layers, d=d, ff=ff, vocab=vocab,
                              max_pos=max_pos, seed=seed)
    g = _Graph()
    for k, a in weights.items():
        g.const(k, a)
    b_dim = -1 if dynamic_batch else batch
    for name in ("input_ids", "input_mask", "segment_ids"):
        g.node(name, "Placeholder", dtype=a_type(DT_INT32),
               shape=a_shape((b_dim, seq)))

    if dynamic_batch:
        # get_shape_list: tf.shape(input_ids)[0]
        shp = g.node("bert/Shape", "Shape", ["input_ids"],
                     T=a_type(DT_INT32), out_type=a_type(DT_INT32))
        for nm, v in (("begin", [0]), ("end", [1]), ("strides", [1])):
            g.const(f"bert/batch/{nm}", np.int32(v))
        batch_t = g.node("bert/batch", "StridedSlice",
                         [shp, "bert/batch/begin", "bert/batch/end",
                          "bert/batch/strides"],
                         T=a_type(DT_INT32), Index=a_type(DT_INT32),
                         begin_mask=a_int(0), end_mask=a_int(0),
                         ellipsis_mask=a_int(0), new_axis_mask=a_int(0),
                         shrink_axis_mask=a_int(1))

    def shape_of(name: str, dims: Sequence[int]) -> str:
        """A reshape target: a Const, or with ``dynamic_batch`` a Pack of
        the run-time batch and the static dims."""
        if not dynamic_batch:
            return g.const(name, np.int32(list(dims)))
        parts = [batch_t]
        for j, v in enumerate(dims[1:]):
            parts.append(g.const(f"{name}/{j + 1}", np.int32(v)))
        return g.node(name, "Pack", parts, T=a_type(DT_INT32),
                      N=a_int(len(parts)), axis=a_int(0))

    def reshape(name: str, x: str, shape: str, t=DT_FLOAT) -> str:
        return g.node(name, "Reshape", [x, shape], T=a_type(t),
                      Tshape=a_type(DT_INT32))

    def matmul(name: str, a: str, b: str, **flags) -> str:
        return g.op(name, "MatMul", a, b,
                    transpose_a=a_bool(flags.get("transpose_a", False)),
                    transpose_b=a_bool(flags.get("transpose_b", False)))

    def dense(p: str, x: str) -> str:
        mm = matmul(f"{p}/MatMul", x, f"{p}/kernel")
        return g.op(f"{p}/BiasAdd", "BiasAdd", mm, f"{p}/bias",
                    data_format=a_str("NHWC"))

    def scalar(name: str, v: float) -> str:
        return g.const(name, np.float32(v))

    def layer_norm(p: str, x: str, axis: int) -> str:
        """tf.contrib.layers.layer_norm: nn.moments over the last axis,
        then nn.batch_normalization."""
        ax = g.const(f"{p}/moments/axes", np.int32([axis]))
        mean = g.op(f"{p}/moments/mean", "Mean", x, ax, keep_dims=a_bool(True),
                    Tidx=a_type(DT_INT32))
        sg = g.op(f"{p}/moments/StopGradient", "StopGradient", mean)
        sq = g.op(f"{p}/moments/SquaredDifference", "SquaredDifference", x,
                  sg)
        var = g.op(f"{p}/moments/variance", "Mean", sq, ax,
                   keep_dims=a_bool(True), Tidx=a_type(DT_INT32))
        eps = scalar(f"{p}/batchnorm/add/y", 1e-12)
        ve = g.op(f"{p}/batchnorm/add", "AddV2", var, eps)
        inv = g.op(f"{p}/batchnorm/Rsqrt", "Rsqrt", ve)
        inv = g.op(f"{p}/batchnorm/mul", "Mul", inv, f"{p}/gamma")
        xs = g.op(f"{p}/batchnorm/mul_1", "Mul", x, inv)
        ms = g.op(f"{p}/batchnorm/mul_2", "Mul", mean, inv)
        sh = g.op(f"{p}/batchnorm/sub", "Sub", f"{p}/beta", ms)
        return g.op(f"{p}/batchnorm/add_1", "AddV2", xs, sh)

    # ------------------------------------------------------------ embeddings
    e = "bert/embeddings"
    flat = reshape(f"{e}/Reshape", "input_ids",
                   g.const(f"{e}/Reshape/shape", np.int32([-1])), DT_INT32)
    axis0 = g.const(f"{e}/GatherV2/axis", np.int32(0))
    gathered = g.node(f"{e}/GatherV2", "GatherV2",
                      [f"{e}/word_embeddings", flat, axis0],
                      Tparams=a_type(DT_FLOAT), Tindices=a_type(DT_INT32),
                      Taxis=a_type(DT_INT32), batch_dims=a_int(0))
    x = reshape(f"{e}/Reshape_1", gathered,
                shape_of(f"{e}/Reshape_1/shape", (batch, seq, d)))
    seg = reshape(f"{e}/Reshape_2", "segment_ids",
                  g.const(f"{e}/Reshape_2/shape", np.int32([-1])), DT_INT32)
    oh = g.node(f"{e}/one_hot", "OneHot",
                [seg, g.const(f"{e}/one_hot/depth", np.int32(2)),
                 scalar(f"{e}/one_hot/on_value", 1.0),
                 scalar(f"{e}/one_hot/off_value", 0.0)],
                T=a_type(DT_FLOAT), TI=a_type(DT_INT32), axis=a_int(-1))
    tt = matmul(f"{e}/MatMul", oh, f"{e}/token_type_embeddings")
    tt = reshape(f"{e}/Reshape_3", tt,
                 shape_of(f"{e}/Reshape_3/shape", (batch, seq, d)))
    x = g.op(f"{e}/add", "AddV2", x, tt)
    pos = g.node(f"{e}/Slice", "Slice",
                 [f"{e}/position_embeddings",
                  g.const(f"{e}/Slice/begin", np.int32([0, 0])),
                  g.const(f"{e}/Slice/size", np.int32([seq, d]))],
                 T=a_type(DT_FLOAT), Index=a_type(DT_INT32))
    pos = reshape(f"{e}/Reshape_4", pos,
                  g.const(f"{e}/Reshape_4/shape", np.int32([1, seq, d])))
    x = g.op(f"{e}/add_1", "AddV2", x, pos)
    x = layer_norm(f"{e}/LayerNorm", x, 2)

    # create_attention_mask_from_input_mask, as a key mask (docstring)
    enc = "bert/encoder"
    m = reshape(f"{enc}/Reshape", "input_mask",
                shape_of(f"{enc}/Reshape/shape", (batch, 1, seq)), DT_INT32)
    m = g.node(f"{enc}/Cast", "Cast", [m], SrcT=a_type(DT_INT32),
               DstT=a_type(DT_FLOAT), Truncate=a_bool(False))
    x = reshape(f"{enc}/Reshape_1", x,
                g.const(f"{enc}/Reshape_1/shape", np.int32([-1, d])))
    ctx_shape = np.int32([-1 if dynamic_batch else batch * seq, d])

    for i in range(layers):
        p = f"{enc}/layer_{i}"
        a = f"{p}/attention/self"
        heads_ = {}
        for t in ("query", "key", "value"):
            h = dense(f"{a}/{t}", x)
            h = reshape(f"{a}/Reshape_{t}", h, shape_of(
                f"{a}/Reshape_{t}/shape", (batch, seq, heads, hd)))
            heads_[t] = g.op(f"{a}/transpose_{t}", "Transpose", h,
                             g.const(f"{a}/transpose_{t}/perm",
                                     np.int32([0, 2, 1, 3])),
                             Tperm=a_type(DT_INT32))
        scores = g.op(f"{a}/MatMul", "BatchMatMulV2", heads_["query"],
                      heads_["key"], adj_x=a_bool(False), adj_y=a_bool(True))
        scores = g.op(f"{a}/Mul", "Mul", scores,
                      scalar(f"{a}/Mul/y", 1.0 / math.sqrt(hd)))
        em = g.op(f"{a}/ExpandDims", "ExpandDims", m,
                  g.const(f"{a}/ExpandDims/dim", np.int32([1])),
                  Tdim=a_type(DT_INT32))
        inv = g.op(f"{a}/sub", "Sub", scalar(f"{a}/sub/x", 1.0), em)
        adder = g.op(f"{a}/mul_1", "Mul", inv, scalar(f"{a}/mul_1/y",
                                                      -10000.0))
        scores = g.op(f"{a}/add", "AddV2", scores, adder)
        probs = g.op(f"{a}/Softmax", "Softmax", scores)
        ctx = g.op(f"{a}/MatMul_1", "BatchMatMulV2", probs, heads_["value"],
                   adj_x=a_bool(False), adj_y=a_bool(False))
        ctx = g.op(f"{a}/transpose_ctx", "Transpose", ctx,
                   g.const(f"{a}/transpose_ctx/perm",
                           np.int32([0, 2, 1, 3])), Tperm=a_type(DT_INT32))
        ctx = reshape(f"{a}/Reshape_ctx", ctx,
                      g.const(f"{a}/Reshape_ctx/shape", ctx_shape))
        o = dense(f"{p}/attention/output/dense", ctx)
        o = g.op(f"{p}/attention/output/add", "AddV2", o, x)
        x1 = layer_norm(f"{p}/attention/output/LayerNorm", o, 1)
        h = dense(f"{p}/intermediate/dense", x1)
        # gelu: cdf = 0.5 * (1.0 + tf.erf(x / tf.sqrt(2.0))); x * cdf
        gl = f"{p}/intermediate/gelu"
        s2 = g.op(f"{gl}/Sqrt", "Sqrt", scalar(f"{gl}/Sqrt/x", 2.0))
        c = g.op(f"{gl}/truediv", "RealDiv", h, s2)
        c = g.op(f"{gl}/Erf", "Erf", c)
        c = g.op(f"{gl}/add", "AddV2", scalar(f"{gl}/add/x", 1.0), c)
        c = g.op(f"{gl}/mul", "Mul", scalar(f"{gl}/mul/x", 0.5), c)
        h = g.op(f"{gl}/mul_1", "Mul", h, c)
        o2 = dense(f"{p}/output/dense", h)
        o2 = g.op(f"{p}/output/add", "AddV2", o2, x1)
        x = layer_norm(f"{p}/output/LayerNorm", o2, 1)

    seq_out = reshape(f"{enc}/Reshape_2", x,
                      shape_of(f"{enc}/Reshape_2/shape", (batch, seq, d)))
    pl = "bert/pooler"
    first = g.node(f"{pl}/strided_slice", "StridedSlice",
                   [seq_out, g.const(f"{pl}/begin", np.int32([0, 0, 0])),
                    g.const(f"{pl}/end", np.int32([0, 1, 0])),
                    g.const(f"{pl}/strides", np.int32([1, 1, 1]))],
                   T=a_type(DT_FLOAT), Index=a_type(DT_INT32),
                   begin_mask=a_int(5), end_mask=a_int(5),
                   ellipsis_mask=a_int(0), new_axis_mask=a_int(0),
                   shrink_axis_mask=a_int(0))
    first = g.op(f"{pl}/Squeeze", "Squeeze", first, squeeze_dims=a_ints([1]))
    pooled = g.op(f"{pl}/dense/Tanh", "Tanh", dense(f"{pl}/dense", first))
    mm = matmul("loss/MatMul", pooled, "output_weights")
    g.op("logits", "BiasAdd", mm, "output_bias", data_format=a_str("NHWC"))
    return graph_def(g.nodes)


# The TF-import configuration the card runs (chip_smoke.py's tf_bert phase):
# BERT-base widths and vocabulary at the GLUE fine-tune shape, batch 32 ×
# seq 128, as onnx_builder.BERT_BASE_ONNX.
BERT_BASE_TF = dict(layers=12, batch=32, seq=128, d=768, heads=12, ff=3072,
                    vocab=30522)


def tf_feeds(batch: int, seq: int, vocab: int, *, seed: int = 1,
             min_len: int = 16) -> Dict[str, np.ndarray]:
    """Feeds for :func:`bert_tf_graph`, int32 (batch, seq): token ids, an
    end-padded 0/1 key mask with ragged row lengths in ``[min_len, seq]``
    (no row fully masked) and segment ids (0 on the first half of each
    row's real tokens, 1 after)."""
    r = np.random.RandomState(seed)
    lens = r.randint(min(min_len, seq), seq + 1, batch)
    pos = np.arange(seq)[None]
    mask = (pos < lens[:, None]).astype(np.int32)
    return {"input_ids": r.randint(0, vocab, (batch, seq)).astype(np.int32),
            "input_mask": mask,
            "segment_ids": ((pos >= (lens // 2)[:, None]) & (mask > 0)
                            ).astype(np.int32)}


def class_labels(batch: int, labels: int = 2, *, seed: int = 3):
    """One-hot float32 sentence labels (batch, labels) from numpy."""
    ids = np.random.RandomState(seed).randint(0, labels, batch)
    return np.eye(labels, dtype=np.float32)[ids]
