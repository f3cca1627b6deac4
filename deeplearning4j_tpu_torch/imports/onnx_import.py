"""ONNX import → a port SameDiff graph (samediff-import-onnx analog).

Counterpart of ``deeplearning4j_tpu/imports/onnx_import.py``: ONNX
ModelProto bytes are decoded by the in-repo wire codec
(:mod:`.protowire` — no onnx package), normalized to
:class:`~.ir.IRGraph`, and mapped by the dialect table below onto the
port's SameDiff op catalog; :func:`import_onnx` returns a SameDiff whose
arrays live on the card (``device="cpu"`` for tests), optimized on first
execution by the pass pipeline whose fusion tier reaches the hand-written
kernels.

Mapped: the JAX package's 152 rules, with its semantics, restrictions and
rejections — MLP, CNN and RNN graphs (Gemm, MatMul, Conv/ConvTranspose,
pooling, BatchNormalization, LSTM/GRU/RNN, Resize, Einsum), control flow
(Loop/If/Scan onto SameDiff's ``while_loop_multi`` / ``cond_multi`` /
``scan_multi``, with outer-scope subgraph captures), detection
(NonMaxSuppression with a padded static output, exact RoiAlign,
GridSample), the Scatter/Gather families, the QuantizeLinear family,
random draws (``torch.Generator`` streams keyed as the JAX rules key
theirs) and the documented rejections of ops whose output length depends
on the data (NonZero, Unique, Compress). ONNX is NCHW; the rules record
transposes around the catalog's NHWC conv and pool ops. ``Gelu`` maps to
the tanh-approximate ``gelu`` whatever its ``approximate`` attribute, as
the JAX package maps it. An op without a rule raises at import, naming
it.
"""

from __future__ import annotations

import struct
import zlib
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis.values import as_dtype
from deeplearning4j_tpu_torch.autodiff import samediff as _sdmod
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.imports import protowire as pw
from deeplearning4j_tpu_torch.imports.ir import (
    SLICE_TO_END, IRGraph, IRImporter, IRNode,
)

# ---------------------------------------------------------------------------
# ModelProto decoding (field numbers from the public onnx.proto3 schema)
# ---------------------------------------------------------------------------

# TensorProto.DataType
_DT_NP = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
          6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
          11: np.float64, 12: np.uint32, 13: np.uint64}


def _decode_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    f = pw.parse_message(buf)
    dims = pw.get_packed_or_repeated_varints(f, 1)
    dtype = _DT_NP.get(pw.get_varint(f, 2, 1), np.float32)
    name = pw.get_string(f, 8)
    raw = pw.get_byte(f, 9)
    if raw:
        arr = np.frombuffer(raw, dtype=dtype)
    elif dtype == np.float32:
        arr = np.asarray(pw.get_packed_floats(f, 4), np.float32)
    elif dtype in (np.int64, np.uint64):
        arr = np.asarray(pw.get_packed_or_repeated_varints(f, 7), np.int64)
    elif dtype in (np.int32, np.int8, np.int16, np.uint8, np.uint16, np.bool_):
        arr = np.asarray(pw.get_packed_or_repeated_varints(f, 5)).astype(dtype)
    elif dtype == np.float64:
        raw10 = b"".join(v for wt, v in f.get(10, []) if wt == pw.LEN)
        arr = np.frombuffer(raw10, np.float64) if raw10 else np.asarray(
            [struct.unpack("<d", v)[0] for wt, v in f.get(10, []) if wt == pw.I64])
    else:  # pragma: no cover
        raise NotImplementedError(f"tensor dtype {dtype}")
    # no dims is a scalar, as ONNX defines it (the JAX package reads a
    # 0-d tensor as shape (1,); ROADMAP.md records the departure)
    return name, (arr.reshape(dims) if dims
                  else arr.reshape(()) if arr.size == 1 else arr)


def _decode_attr(buf: bytes) -> Tuple[str, Any]:
    f = pw.parse_message(buf)
    name = pw.get_string(f, 1)
    atype = pw.get_varint(f, 20, 0)
    if atype == 1:  # FLOAT
        return name, pw.get_float(f, 2)
    if atype == 2:  # INT
        return name, pw._to_signed64(pw.get_varint(f, 3))
    if atype == 3:  # STRING
        return name, pw.get_byte(f, 4).decode("utf-8", "replace")
    if atype == 4:  # TENSOR
        return name, _decode_tensor(pw.get_byte(f, 5))[1]
    if atype == 5:  # GRAPH (Loop/If/Scan bodies)
        return name, _graph_to_ir(pw.parse_message(pw.get_byte(f, 6)),
                                  name=f"onnx_sub:{name}")
    if atype == 6:  # FLOATS
        return name, pw.get_packed_floats(f, 7)
    if atype == 7:  # INTS
        return name, pw.get_packed_or_repeated_varints(f, 8)
    if atype == 8:  # STRINGS
        return name, [b.decode() for b in pw.get_bytes(f, 9)]
    return name, None


def _decode_value_info(buf: bytes) -> Tuple[str, Optional[Tuple]]:
    f = pw.parse_message(buf)
    name = pw.get_string(f, 1)
    shape = None
    t = pw.get_byte(f, 2)
    if t:
        tt = pw.get_byte(pw.parse_message(t), 1)  # TypeProto.tensor_type
        if tt:
            sh = pw.get_byte(pw.parse_message(tt), 2)  # TensorTypeProto.shape
            if sh:
                dims = []
                for d in pw.get_bytes(pw.parse_message(sh), 1):
                    df = pw.parse_message(d)
                    v = pw.get_varint(df, 1, 0)
                    dims.append(int(v) if v > 0 else None)
                shape = tuple(dims)
    return name, shape


def _graph_to_ir(graph, name: str = "onnx") -> IRGraph:
    """Parsed GraphProto message → IRGraph (used for the top-level graph and
    for GRAPH-typed attributes: Loop/If/Scan bodies)."""
    initializers: Dict[str, np.ndarray] = {}
    for tbuf in pw.get_bytes(graph, 5):
        tname, arr = _decode_tensor(tbuf)
        initializers[tname] = arr
    nodes: List[IRNode] = []
    for nbuf in pw.get_bytes(graph, 1):
        nf = pw.parse_message(nbuf)
        attrs = dict(_decode_attr(a) for a in pw.get_bytes(nf, 5))
        outputs = [b.decode() for b in pw.get_bytes(nf, 2)]
        nodes.append(IRNode(
            name=pw.get_string(nf, 3) or (outputs[0] if outputs else ""),
            op_type=pw.get_string(nf, 4),
            inputs=[b.decode() for b in pw.get_bytes(nf, 1)],
            outputs=outputs,
            attrs=attrs))
    inputs = []
    for vbuf in pw.get_bytes(graph, 11):
        vname, shape = _decode_value_info(vbuf)
        if vname not in initializers:  # opset<9 lists initializers as inputs
            inputs.append((vname, shape))
    outputs = [_decode_value_info(v)[0] for v in pw.get_bytes(graph, 12)]
    return IRGraph(nodes=nodes, initializers=initializers, inputs=inputs,
                   outputs=outputs, name=name)


def parse_model(data: bytes) -> IRGraph:
    """ONNX ModelProto bytes → IRGraph."""
    model = pw.parse_message(data)
    return _graph_to_ir(pw.parse_message(pw.get_byte(model, 7)))


# ---------------------------------------------------------------------------
# ONNX dialect rules
# ---------------------------------------------------------------------------

ONNX_OP_MAPPERS: Dict[str, Callable[..., Any]] = {}

_NEEDS_CONSTS = {"Reshape", "Transpose", "Squeeze", "Unsqueeze", "Gather",
                 "Conv", "ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
                 "Clip", "Pad", "Concat"}


def register_onnx_op(name: str):
    def wrap(fn):
        ONNX_OP_MAPPERS[name] = fn
        return fn

    return wrap


def _graph_op(name: str):
    """Register a graph op the dialect records beyond the catalog, as the
    JAX importer registers its own (first registration wins)."""
    def wrap(fn):
        _sdmod.GRAPH_OPS.setdefault(name, fn)
        return fn

    return wrap


def _unary(sd_op: str):
    def rule(sd, ins, attrs, node):
        return sd._record(sd_op, [ins[0]])

    return rule


def _binary(sd_op: str):
    def rule(sd, ins, attrs, node):
        return sd._record(sd_op, ins)

    return rule


for _onnx, _sd in [("Relu", "relu"), ("Sigmoid", "sigmoid"),
                   ("Tanh", "tanh"), ("Softplus", "softplus"),
                   ("Softsign", "softsign"), ("Exp", "exp"), ("Log", "log"),
                   ("Sqrt", "sqrt"), ("Neg", "neg"), ("Abs", "abs"),
                   ("Floor", "floor"), ("Ceil", "ceil"), ("Round", "round"),
                   ("Erf", "erf"), ("Sign", "sign"),
                   ("Reciprocal", "reciprocal"), ("Sin", "sin"),
                   ("Cos", "cos"), ("Mish", "mish"),
                   ("HardSigmoid", "hardsigmoid"), ("Gelu", "gelu"),
                   ("Tan", "tan"), ("Atan", "atan"), ("Asin", "asin"),
                   ("Acos", "acos"), ("Sinh", "sinh"), ("Cosh", "cosh"),
                   ("Not", "boolean_not"), ("IsNaN", "isnan"),
                   ("Shape", "shape_of"), ("Size", "size"),
                   ("Det", "matrix_determinant")]:
    ONNX_OP_MAPPERS[_onnx] = _unary(_sd)

for _onnx, _sd in [("Add", "add"), ("Sub", "sub"), ("Mul", "mul"),
                   ("Div", "div"), ("Pow", "pow"), ("Max", "maximum"),
                   ("Min", "minimum"), ("Equal", "eq"), ("Greater", "gt"),
                   ("Less", "lt"), ("GreaterOrEqual", "greater_equal"),
                   ("LessOrEqual", "less_equal"), ("And", "boolean_and"),
                   ("Or", "boolean_or"), ("Xor", "boolean_xor"),
                   ("Where", "where")]:
    ONNX_OP_MAPPERS[_onnx] = _binary(_sd)


@register_onnx_op("LeakyRelu")
def _leaky(sd, ins, attrs, node):
    return sd._record("leakyrelu", [ins[0]],
                      {"alpha": float(attrs.get("alpha", 0.01))})


@register_onnx_op("Elu")
def _elu(sd, ins, attrs, node):
    return sd._record("elu", [ins[0]])


@register_onnx_op("Selu")
def _selu(sd, ins, attrs, node):
    return sd._record("selu", [ins[0]])


@register_onnx_op("Softmax")
def _softmax(sd, ins, attrs, node):
    return sd._record("softmax", [ins[0]],
                      {"axis": int(attrs.get("axis", -1))})


@register_onnx_op("LogSoftmax")
def _log_softmax(sd, ins, attrs, node):
    return sd._record("log_softmax", [ins[0]],
                      {"axis": int(attrs.get("axis", -1))})


@register_onnx_op("MatMul")
def _matmul(sd, ins, attrs, node):
    return sd._record("mmul", ins)


@register_onnx_op("Gemm")
def _gemm(sd, ins, attrs, node):
    """Y = alpha·op(A)·op(B) + beta·C."""
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    y = sd._record("mmul", ins[:2], {
        "transpose_a": bool(attrs.get("transA", 0)),
        "transpose_b": bool(attrs.get("transB", 0))})
    if alpha != 1.0:
        y = y * alpha
    if len(ins) > 2:
        c = ins[2] if beta == 1.0 else ins[2] * beta
        y = y + c
    return y


@register_onnx_op("Identity")
@register_onnx_op("Dropout")
def _identity(sd, ins, attrs, node):
    return sd._record("identity", [ins[0]])


@register_onnx_op("Flatten")
def _flatten(sd, ins, attrs, node):
    return sd._record("flatten_from", [ins[0]],
                      {"axis": int(attrs.get("axis", 1))})


@register_onnx_op("Reshape")
def _reshape(sd, ins, attrs, node, const_values=None):
    shape = const_values.get(node.inputs[1])
    if shape is None:
        raise NotImplementedError("Reshape with dynamic shape input")
    return sd._record("reshape", [ins[0]],
                      {"shape": tuple(int(s) for s in shape)})


@register_onnx_op("Transpose")
def _transpose(sd, ins, attrs, node, const_values=None):
    perm = attrs.get("perm")
    return sd._record("transpose", [ins[0]],
                      {"axes": None if perm is None
                       else tuple(int(p) for p in perm)})


@register_onnx_op("Squeeze")
def _squeeze(sd, ins, attrs, node, const_values=None):
    axes = attrs.get("axes")
    if axes is None and len(node.inputs) > 1:
        axes = const_values.get(node.inputs[1])
    ax = None if axes is None else tuple(int(a) for a in axes)
    if ax is not None and len(ax) == 1:
        ax = ax[0]
    return sd._record("squeeze", [ins[0]], {"axis": ax})


@register_onnx_op("Unsqueeze")
def _unsqueeze(sd, ins, attrs, node, const_values=None):
    axes = attrs.get("axes")
    if axes is None and len(node.inputs) > 1:
        axes = const_values.get(node.inputs[1])
    y = ins[0]
    # insert in ascending order so later axes account for earlier inserts
    for ax in sorted(int(a) for a in axes):
        y = sd._record("expand_dims", [y], {"axis": ax})
    return y


@register_onnx_op("Concat")
def _concat(sd, ins, attrs, node, const_values=None):
    return sd._record("concat", ins, {"axis": int(attrs.get("axis", 0))})


@register_onnx_op("Gather")
def _gather(sd, ins, attrs, node, const_values=None):
    return sd._record("gather", ins, {"axis": int(attrs.get("axis", 0))})


def _reduce_rule(sd_op: str):
    """Reductions whose ``axes`` is an attribute or (opset 13+/18) a
    constant input; absent axes reduce every axis."""
    def rule(sd, ins, attrs, node, const_values=None):
        axes = attrs.get("axes")
        if axes is None and len(node.inputs) > 1:
            axes = const_values.get(node.inputs[1])
        return sd._record(sd_op, [ins[0]], {
            "axes": None if axes is None else tuple(int(a) for a in axes),
            "keepdims": bool(attrs.get("keepdims", 1))})

    return rule


for _onnx, _sd in [("ReduceMean", "reduce_mean"), ("ReduceSum", "reduce_sum"),
                   ("ReduceMax", "reduce_max"), ("ReduceMin", "reduce_min"),
                   ("ReduceProd", "reduce_prod")]:
    ONNX_OP_MAPPERS[_onnx] = _reduce_rule(_sd)


@register_onnx_op("Clip")
def _clip(sd, ins, attrs, node, const_values=None):
    lo = attrs.get("min")
    hi = attrs.get("max")
    if lo is None and len(node.inputs) > 1 and node.inputs[1]:
        lo = float(const_values.get(node.inputs[1]))
    if hi is None and len(node.inputs) > 2 and node.inputs[2]:
        hi = float(const_values.get(node.inputs[2]))
    return sd._record("clip_by_value_graph", [ins[0]], {
        "min_value": -np.inf if lo is None else float(lo),
        "max_value": np.inf if hi is None else float(hi)})


@register_onnx_op("Pad")
def _pad(sd, ins, attrs, node, const_values=None):
    pads = attrs.get("pads")
    if pads is None and len(node.inputs) > 1:
        pads = const_values.get(node.inputs[1])
    pads = [int(p) for p in pads]
    ndim = len(pads) // 2
    paddings = tuple((pads[i], pads[i + ndim]) for i in range(ndim))
    return sd._record("pad", [ins[0]], {"paddings": paddings,
                                        "value": float(attrs.get("value",
                                                                 0.0))})


@register_onnx_op("Cast")
def _cast(sd, ins, attrs, node):
    to = _DT_NP.get(int(attrs.get("to", 1)), np.float32)
    return sd._record("cast", [ins[0]], {"dtype": np.dtype(to).name})


@register_onnx_op("Constant")
def _constant(sd, ins, attrs, node):
    val = attrs.get("value")
    return sd.constant(node.outputs[0], np.asarray(val))


@register_onnx_op("LayerNormalization")
def _onnx_layernorm(sd, ins, attrs, node):
    axis = int(attrs.get("axis", -1))
    if axis != -1:
        raise NotImplementedError(
            f"LayerNormalization {node.name}: axis={axis} (only the trailing "
            f"axis maps to the catalog layer_norm)")
    return sd._record("layer_norm",
                      ins[:2] + (list(ins[2:3]) if len(ins) > 2 else []),
                      {"eps": float(attrs.get("epsilon", 1e-5))})


@register_onnx_op("PRelu")
def _prelu(sd, ins, attrs, node):
    x, slope = ins
    pos = sd._record("relu", [x])
    neg = sd._record("minimum", [x, sd.constant(
        node.name + "_z", np.zeros((1,), np.float32))])
    return pos + sd._record("mul", [slope, neg])


def _mod_rule(sd, ins, attrs, node):
    """ONNX Mod: fmod=0 is Python's floor mod (the sign of the divisor),
    fmod=1 C's truncated mod (the sign of the dividend)."""
    if int(attrs.get("fmod", 0)):
        return sd._record("truncatemod", ins)
    return sd._record("floormod", ins)


ONNX_OP_MAPPERS["Mod"] = _mod_rule


def _arg_rule(sd_op: str):
    """ArgMax / ArgMin: int32 indices (the JAX package's 32-bit types);
    ``select_last_index`` is not read, as the JAX rule does not."""
    def rule(sd, ins, attrs, node):
        axis = int(attrs.get("axis", 0))
        v = sd._record(sd_op, [ins[0]], {"axis": axis})
        if int(attrs.get("keepdims", 1)):
            v = sd._record("expand_dims", [v], {"axis": axis})
        return v

    return rule


ONNX_OP_MAPPERS["ArgMax"] = _arg_rule("argmax")
ONNX_OP_MAPPERS["ArgMin"] = _arg_rule("argmin")


def _nary_rule(sd_op: str):
    def rule(sd, ins, attrs, node):
        out = ins[0]
        for i in ins[1:]:
            out = sd._record(sd_op, [out, i])
        return out

    return rule


ONNX_OP_MAPPERS["Sum"] = _nary_rule("add")


@register_onnx_op("Mean")
def _onnx_mean(sd, ins, attrs, node):
    out = ins[0]
    for i in ins[1:]:
        out = sd._record("add", [out, i])
    k = sd.constant(node.name + "_n", np.asarray(float(len(ins)),
                                                 np.float32))
    return sd._record("div", [out, k])


@register_onnx_op("IsInf")
def _isinf_onnx(sd, ins, attrs, node):
    if not int(attrs.get("detect_positive", 1)) or \
            not int(attrs.get("detect_negative", 1)):
        raise NotImplementedError("IsInf with one-sided detection import")
    return sd._record("isinf", [ins[0]])


@register_onnx_op("ThresholdedRelu")
def _thresholded_relu_onnx(sd, ins, attrs, node):
    # the catalog names this activation as the JAX rule does; neither
    # package's graph-op table resolves it (ROADMAP.md, "Not port faults")
    return sd._record("thresholdedrelu", [ins[0]],
                      {"theta": float(attrs.get("alpha", 1.0))})


@register_onnx_op("Hardmax")
def _hardmax_onnx(sd, ins, attrs, node):
    """Ties mark every maximal position (the spec keeps only the first),
    as the JAX rule's eq-based lowering does."""
    axis = int(attrs.get("axis", -1))
    mx = sd._record("reduce_max", [ins[0]], {"axes": (axis,),
                                             "keepdims": True})
    eq = sd._record("eq", [ins[0], mx])
    one = sd.constant(node.name + "_one", np.asarray(1.0, np.float32))
    zero = sd.constant(node.name + "_zero", np.asarray(0.0, np.float32))
    return sd._record("select", [eq, one, zero])


@register_onnx_op("Celu")
def _onnx_celu(sd, ins, attrs, node):
    return sd._record("onnx_celu", [ins[0]],
                      {"alpha": float(attrs.get("alpha", 1.0))})


@_graph_op("onnx_celu")
def _celu_impl(x, *, alpha):
    return (torch.clamp_min(x, 0.0)
            + torch.clamp_max(alpha * (torch.exp(x / alpha) - 1.0), 0.0))


@register_onnx_op("HardSwish")
def _onnx_hardswish(sd, ins, attrs, node):
    return sd._record("onnx_hardswish", [ins[0]])


@_graph_op("onnx_hardswish")
def _hardswish_impl(x):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


@register_onnx_op("Shrink")
def _onnx_shrink(sd, ins, attrs, node):
    return sd._record("onnx_shrink", [ins[0]],
                      {"bias": float(attrs.get("bias", 0.0)),
                       "lambd": float(attrs.get("lambd", 0.5))})


@_graph_op("onnx_shrink")
def _shrink_impl(x, *, bias, lambd):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x < -lambd, x + bias,
                       torch.where(x > lambd, x - bias, zero))


@register_onnx_op("BitShift")
def _onnx_bitshift(sd, ins, attrs, node):
    return sd._record("onnx_bitshift", ins,
                      {"direction": attrs.get("direction", "LEFT") or "LEFT"})


@_graph_op("onnx_bitshift")
def _bitshift_impl(x, y, *, direction):
    if direction == "LEFT":
        return torch.bitwise_left_shift(x, y)
    return torch.bitwise_right_shift(x, y)


# -- reductions with an axes attribute or (opset 18) a constant axes input


def _reduce2(sd_op: str):
    def rule(sd, ins, attrs, node, const_values=None):
        axes = attrs.get("axes")
        if axes is None and len(ins) > 1:  # opset 18 moves axes to input 2
            axes = tuple(int(a) for a in np.asarray(
                const_values[node.inputs[1]]).reshape(-1))
        axes = tuple(int(a) for a in axes) if axes is not None else None
        kd = bool(int(attrs.get("keepdims", 1)))
        return sd._record(sd_op, [ins[0]], {"axes": axes, "keepdims": kd})

    return rule


for _onnx, _sd in [("ReduceL1", "reduce_norm1"), ("ReduceL2", "reduce_norm2"),
                   ("ReduceLogSumExp", "reduce_logsumexp"),
                   ("ReduceSumSquare", "reduce_sqnorm")]:
    ONNX_OP_MAPPERS[_onnx] = _reduce2(_sd)
    _NEEDS_CONSTS.add(_onnx)


@register_onnx_op("ReduceLogSum")
def _reduce_log_sum(sd, ins, attrs, node, const_values=None):
    s = _reduce2("reduce_sum")(sd, ins, attrs, node,
                               const_values=const_values)
    return sd._record("log", [s])


_NEEDS_CONSTS.add("ReduceLogSum")


# ---------------------------------------------------------------------------
# Convolution, pooling, normalization, resampling. ONNX is NCHW and the
# catalog's conv and pool ops are NHWC: each rule records the transposes
# around them, as the JAX rules do.
# ---------------------------------------------------------------------------


def _to_nhwc(sd, x):
    return sd._record("transpose", [x], {"axes": (0, 2, 3, 1)})


def _to_nchw(sd, x):
    return sd._record("transpose", [x], {"axes": (0, 3, 1, 2)})


@register_onnx_op("Conv")
def _conv(sd, ins, attrs, node, const_values=None):
    """NCHW Conv → NHWC ``conv2d`` (``depthwise_conv2d`` for group == C),
    between transposes."""
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    pads = [int(p) for p in attrs.get("pads", [0, 0, 0, 0])]
    dilations = [int(d) for d in attrs.get("dilations", [1, 1])]
    group = int(attrs.get("group", 1))
    if dilations != [1, 1]:
        raise NotImplementedError("dilated Conv import")
    if group > 1 and const_values.get(node.inputs[1]) is not None \
            and const_values[node.inputs[1]].shape[1] != 1:
        raise NotImplementedError(
            f"Conv {node.name}: grouped conv with group={group} and "
            "C/group > 1 (ResNeXt-style) is not supported — only depthwise "
            "(C/group == 1)")
    x = _to_nhwc(sd, ins[0])
    if any(pads):
        x = sd._record("pad", [x], {"paddings": (
            (0, 0), (pads[0], pads[2]), (pads[1], pads[3]), (0, 0))})
    w = ins[1]  # (M, C/g, kH, kW)
    if group == 1:
        wt = sd._record("transpose", [w], {"axes": (2, 3, 1, 0)})  # HWIO
        y = sd._record("conv2d", [x, wt],
                       {"stride": tuple(strides), "padding": "valid"})
    else:
        # depthwise: group == C_in, weights (C, 1, kH, kW) → (kh, kw, C, 1)
        wt = sd._record("transpose", [w], {"axes": (2, 3, 0, 1)})
        y = sd._record("depthwise_conv2d", [x, wt],
                       {"stride": tuple(strides), "padding": "valid"})
    if len(ins) > 2:  # bias (M,) broadcasts over NHWC channels-last
        y = y + ins[2]
    return _to_nchw(sd, y)


def _pool_rule(sd_op: str, is_global: bool):
    def rule(sd, ins, attrs, node):
        x = _to_nhwc(sd, ins[0])
        if is_global:
            y = sd._record(sd_op, [x])  # NHWC global pool → (N, C)
            # ONNX keeps unit spatial dims: (N, C, 1, 1)
            y = sd._record("expand_dims", [y], {"axis": -1})
            return sd._record("expand_dims", [y], {"axis": -1})
        kernel = [int(k) for k in attrs["kernel_shape"]]
        strides = [int(s) for s in attrs.get("strides", kernel)]
        pads = [int(p) for p in attrs.get("pads", [0, 0, 0, 0])]
        if any(pads):
            pp = ((0, 0), (pads[0], pads[2]), (pads[1], pads[3]), (0, 0))
            x = sd._record("pad", [x], {
                "paddings": pp,
                "value": -np.inf if sd_op == "maxpool2d" else 0.0})
        y = sd._record(sd_op, [x], {"kernel": tuple(kernel),
                                    "stride": tuple(strides)})
        if sd_op == "avgpool2d" and any(pads) \
                and not int(attrs.get("count_include_pad", 0)):
            # the ONNX default leaves padding out of the denominator:
            # divide by the pooled share of a ones-mask padded with zeros
            ones = sd._record("ones_like", [_to_nhwc(sd, ins[0])])
            ones = sd._record("pad", [ones], {"paddings": pp})
            frac = sd._record(sd_op, [ones], {"kernel": tuple(kernel),
                                              "stride": tuple(strides)})
            y = sd._record("div", [y, frac])
        return _to_nchw(sd, y)

    return rule


ONNX_OP_MAPPERS["MaxPool"] = _pool_rule("maxpool2d", False)
ONNX_OP_MAPPERS["AveragePool"] = _pool_rule("avgpool2d", False)
ONNX_OP_MAPPERS["GlobalAveragePool"] = _pool_rule("global_avg_pool", True)
ONNX_OP_MAPPERS["GlobalMaxPool"] = _pool_rule("global_max_pool", True)


@register_onnx_op("GlobalLpPool")
def _onnx_global_lp(sd, ins, attrs, node):
    p = int(attrs.get("p", 2))
    op = {1: "reduce_norm1", 2: "reduce_norm2"}.get(p)
    if op is None:
        raise NotImplementedError(f"GlobalLpPool p={p}")
    x = _to_nhwc(sd, ins[0])
    out = sd._record(op, [x], {"axes": (1, 2), "keepdims": True})
    return _to_nchw(sd, out)


@register_onnx_op("BatchNormalization")
def _batchnorm(sd, ins, attrs, node):
    """Inference-mode BN; the parameters reshaped to (C, 1, 1) broadcast
    over NCHW."""
    x, scale, bias, mean, var = ins[:5]
    eps = float(attrs.get("epsilon", 1e-5))

    def chan(v):
        return sd._record("reshape", [v], {"shape": (-1, 1, 1)})

    return sd._record("batch_norm_graph",
                      [x, chan(mean), chan(var), chan(scale), chan(bias)],
                      {"eps": eps})


@register_onnx_op("InstanceNormalization")
def _instance_norm_onnx(sd, ins, attrs, node):
    eps = float(attrs.get("epsilon", 1e-5))
    x, scale, bias = ins
    # NCHW: normalize each (instance, channel) over the spatial dims
    mean = sd._record("reduce_mean", [x], {"axes": (2, 3), "keepdims": True})
    d = sd._record("sub", [x, mean])
    var = sd._record("reduce_mean", [sd._record("square", [d])],
                     {"axes": (2, 3), "keepdims": True})
    denom = sd._record("sqrt", [sd._record(
        "add", [var, sd.constant(node.name + "_eps",
                                 np.asarray(eps, np.float32))])])
    xhat = sd._record("div", [d, denom])
    sc = sd._record("reshape", [scale], {"shape": (1, -1, 1, 1)})
    bi = sd._record("reshape", [bias], {"shape": (1, -1, 1, 1)})
    return sd._record("add", [sd._record("mul", [xhat, sc]), bi])


@register_onnx_op("LRN")
def _lrn(sd, ins, attrs, node):
    x = _to_nhwc(sd, ins[0])
    y = sd._record("lrn", [x], {
        "depth": int(attrs.get("size", 5)),
        "bias": float(attrs.get("bias", 1.0)),
        "alpha": float(attrs.get("alpha", 1e-4)) / int(attrs.get("size", 5)),
        "beta": float(attrs.get("beta", 0.75))})
    return _to_nchw(sd, y)


@register_onnx_op("LpNormalization")
def _lp_norm_onnx(sd, ins, attrs, node):
    if int(attrs.get("p", 2)) != 2:
        raise NotImplementedError("LpNormalization p != 2 import")
    if int(attrs.get("axis", -1)) not in (-1,):
        raise NotImplementedError("LpNormalization axis != -1 import")
    sq = sd._record("mul", [ins[0], ins[0]])
    ssum = sd._record("reduce_sum", [sq], {"axes": (-1,), "keepdims": True})
    norm = sd._record("sqrt", [ssum])
    return sd._record("div", [ins[0], norm])


@register_onnx_op("MeanVarianceNormalization")
def _mvn_onnx(sd, ins, attrs, node):
    axes = tuple(int(a) for a in attrs.get("axes", [0, 2, 3]))
    mean = sd._record("reduce_mean", [ins[0]],
                      {"axes": axes, "keepdims": True})
    cent = sd._record("sub", [ins[0], mean])
    var = sd._record("reduce_mean", [sd._record("mul", [cent, cent])],
                     {"axes": axes, "keepdims": True})
    eps = sd.constant(node.name + "_eps", np.asarray(1e-9, np.float32))
    return sd._record("div", [cent, sd._record(
        "sqrt", [sd._record("add", [var, eps])])])


@register_onnx_op("ConvTranspose")
def _conv_transpose_onnx(sd, ins, attrs, node, const_values=None):
    """NCHW ConvTranspose with (I, O, kH, kW) kernels → NHWC ``deconv2d``
    on HWIO, which scatters the kernel as ONNX does."""
    strides = attrs.get("strides", [1, 1])
    pads = attrs.get("pads", [0, 0, 0, 0])
    if any(int(p) != pads[0] for p in pads):
        raise NotImplementedError("asymmetric ConvTranspose pads import")
    x = _to_nhwc(sd, ins[0])
    w = sd._record("transpose", [ins[1]], {"axes": (2, 3, 0, 1)})
    y = sd._record("deconv2d", [x, w] + ([ins[2]] if len(ins) > 2 else []), {
        "stride": (int(strides[0]), int(strides[1])),
        "padding": ((int(pads[0]), int(pads[2])),
                    (int(pads[1]), int(pads[3])))
        if int(pads[0]) else "valid"})
    return _to_nchw(sd, y)


@register_onnx_op("SpaceToDepth")
def _s2d_onnx(sd, ins, attrs, node):
    x = _to_nhwc(sd, ins[0])
    y = sd._record("space_to_depth", [x],
                   {"block_size": int(attrs["blocksize"])})
    return _to_nchw(sd, y)


@register_onnx_op("DepthToSpace")
def _d2s_onnx(sd, ins, attrs, node):
    if attrs.get("mode", b"DCR") not in (b"DCR", "DCR"):
        raise NotImplementedError("DepthToSpace CRD mode import")
    x = _to_nhwc(sd, ins[0])
    y = sd._record("depth_to_space", [x],
                   {"block_size": int(attrs["blocksize"])})
    return _to_nchw(sd, y)


def _require_const(const_values, node, idx, what):
    name = node.inputs[idx]  # ONNX names are used verbatim (may hold ':')
    val = (const_values or {}).get(name)
    if val is None:
        raise ValueError(
            f"{node.op_type} {node.name}: dynamic (non-initializer) {what} "
            f"operand '{name}' is unsupported")
    return val


@register_onnx_op("Resize")
def _resize_onnx(sd, ins, attrs, node, const_values=None):
    """NCHW X + sizes or scales. The half_pixel coordinate transform (the
    opset-11+ default) is what the catalog's resize ops compute; other
    transforms are rejected. The scales form needs a static input shape
    to derive the output size."""
    mode = attrs.get("mode", b"nearest")
    mode = mode.decode() if isinstance(mode, bytes) else str(mode)
    ct = attrs.get("coordinate_transformation_mode", b"half_pixel")
    ct = ct.decode() if isinstance(ct, bytes) else str(ct)
    if ct not in ("half_pixel", "pytorch_half_pixel"):
        raise NotImplementedError(
            f"ONNX Resize coordinate_transformation_mode={ct} import "
            f"(half_pixel only)")
    op_name = {"nearest": "resize_nearest_neighbor",
               "linear": "resize_bilinear",
               "cubic": "resize_bicubic"}.get(mode)
    if op_name is None:
        raise NotImplementedError(f"ONNX Resize mode={mode}")
    if len(node.inputs) > 3 and node.inputs[3]:
        sz = _require_const(const_values, node, 3, "sizes")
        sizes = (int(sz[2]), int(sz[3]))
    else:
        # opset-11+: (X, roi, scales); opset-10: (X, scales)
        slot = 2 if len(node.inputs) > 2 else 1
        if len(node.inputs) <= slot:
            raise ValueError(f"Resize {node.name}: no scales/sizes input")
        scales = np.asarray(_require_const(const_values, node, slot,
                                           "scales"))
        in_shape = getattr(ins[0], "shape", None)
        if not in_shape or len(in_shape) != 4 or None in in_shape[2:]:
            raise NotImplementedError(
                "ONNX Resize with a scales input needs a static NCHW input "
                "shape to derive the output size")
        sizes = (int(round(in_shape[2] * float(scales[2]))),
                 int(round(in_shape[3] * float(scales[3]))))
    x = _to_nhwc(sd, ins[0])
    y = sd._record(op_name, [x], {"size": sizes})
    return _to_nchw(sd, y)


@register_onnx_op("Upsample")  # the deprecated opset-9 form of Resize
def _onnx_upsample(sd, ins, attrs, node, const_values=None):
    return ONNX_OP_MAPPERS["Resize"](
        sd, [ins[0], None, ins[1] if len(ins) > 1 else None], attrs,
        node, const_values=const_values)


_NEEDS_CONSTS |= {"ConvTranspose", "Resize", "Upsample"}


# ---------------------------------------------------------------------------
# Shape and indexing
# ---------------------------------------------------------------------------


@register_onnx_op("Expand")
def _expand_onnx(sd, ins, attrs, node, const_values=None):
    shape = [int(s) for s in np.atleast_1d(const_values.get(node.inputs[1]))]
    in_shape = ins[0].shape
    if in_shape is None:
        raise NotImplementedError("Expand on an unknown-rank input")
    # ONNX Expand broadcasts both ways: out dim = max(in, shape) with
    # numpy alignment — a shape dim of 1 keeps the input dim
    aligned = ([1] * (len(shape) - len(in_shape)) + [int(d) for d in in_shape]
               if len(shape) >= len(in_shape) else list(in_shape))
    target = list(shape)
    if len(target) < len(aligned):
        target = [1] * (len(aligned) - len(target)) + target
    eff = tuple(max(a, t) for a, t in zip(aligned, target))
    return sd._record("broadcast_to", [ins[0]], {"shape": eff})


@register_onnx_op("Tile")
def _tile_onnx(sd, ins, attrs, node, const_values=None):
    reps = const_values.get(node.inputs[1])
    return sd._record("tile", [ins[0]],
                      {"reps": tuple(int(r) for r in np.atleast_1d(reps))})


@register_onnx_op("Split")
def _split_onnx(sd, ins, attrs, node, const_values=None):
    axis = int(attrs.get("axis", 0))
    sizes = attrs.get("split")
    if sizes is None and len(node.inputs) > 1:
        sizes = const_values.get(node.inputs[1])
        if sizes is None:
            raise ValueError(
                f"Split {node.name}: dynamic sizes input unsupported")
    n = len(node.outputs)
    if sizes is not None:
        return sd._record("split_v", [ins[0]],
                          {"sizes": tuple(int(s) for s in sizes),
                           "axis": axis}, n_out=n)
    return sd._record("split", [ins[0]], {"num_split": n, "axis": axis},
                      n_out=n)


@register_onnx_op("Slice")
def _slice_onnx(sd, ins, attrs, node, const_values=None):
    # opset ≥ 10: starts/ends/axes/steps as constant inputs
    starts = attrs.get("starts")
    ends = attrs.get("ends")
    axes = attrs.get("axes")
    steps = None
    if starts is None:
        starts = const_values.get(node.inputs[1])
        ends = const_values.get(node.inputs[2])
        axes = (const_values.get(node.inputs[3])
                if len(node.inputs) > 3 else None)
        steps = (const_values.get(node.inputs[4])
                 if len(node.inputs) > 4 else None)
    if steps is not None and any(int(s) != 1 for s in np.atleast_1d(steps)):
        raise NotImplementedError("Slice with steps != 1 import")
    starts = [int(s) for s in np.atleast_1d(starts)]
    ends = [int(e) for e in np.atleast_1d(ends)]
    if axes is not None:
        # axes-addressed starts/ends to full rank (strided_slice is
        # full-rank); the rank comes from the input's declared shape
        shape = ins[0].shape
        if shape is None:
            raise NotImplementedError(
                "Slice with axes on an unknown-rank input")
        rank = len(shape)
        b, e = [0] * rank, [SLICE_TO_END] * rank
        for a, s_, t_ in zip(np.atleast_1d(axes), starts, ends):
            b[int(a)], e[int(a)] = s_, t_
        starts, ends = b, e
    return sd._record("strided_slice", [ins[0]], {
        "begin": tuple(starts), "end": tuple(ends)})


@register_onnx_op("TopK")
def _topk_onnx(sd, ins, attrs, node, const_values=None):
    if not int(attrs.get("largest", 1)):
        raise NotImplementedError("TopK largest=0 (k-smallest) import")
    if int(attrs.get("axis", -1)) != -1:
        raise NotImplementedError("TopK with axis != -1 import")
    k = attrs.get("k")
    if k is None:
        k = const_values.get(node.inputs[1])
    if k is None:
        raise ValueError(f"TopK {node.name}: dynamic k input unsupported")
    return sd._record("top_k", [ins[0]], {"k": int(np.asarray(k).item())},
                      n_out=2)


_NEEDS_CONSTS |= {"Expand", "Tile", "Split", "Slice", "TopK"}


@register_onnx_op("GatherND")
def _gather_nd_onnx(sd, ins, attrs, node):
    if int(attrs.get("batch_dims", 0)):
        raise NotImplementedError("GatherND with batch_dims import")
    return sd._record("gather_nd", ins)


@register_onnx_op("CumSum")
def _cumsum_onnx(sd, ins, attrs, node, const_values=None):
    axis = int(np.asarray(_require_const(const_values, node, 1,
                                         "axis")).reshape(-1)[0])
    return sd._record("cumsum", [ins[0]],
                      {"axis": axis,
                       "exclusive": bool(int(attrs.get("exclusive", 0))),
                       "reverse": bool(int(attrs.get("reverse", 0)))})


@register_onnx_op("Trilu")
def _trilu_onnx(sd, ins, attrs, node, const_values=None):
    k = 0
    if len(node.inputs) > 1 and node.inputs[1]:
        k = int(_require_const(const_values, node, 1, "k"))
    op = "triu" if int(attrs.get("upper", 1)) else "tril"
    return sd._record(op, [ins[0]], {"diag": k})


@register_onnx_op("Einsum")
def _einsum_onnx(sd, ins, attrs, node):
    eq = attrs.get("equation", "")
    eq = eq.decode() if isinstance(eq, bytes) else str(eq)
    return sd._record("einsum", ins, {"equation": eq})


_NEEDS_CONSTS |= {"CumSum", "Trilu"}


def _dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name, 64-bit types canonicalized
    as the JAX package's are."""
    return _sdmod.canonical_dtype(as_dtype(name))


@register_onnx_op("ConstantOfShape")
def _onnx_const_of_shape(sd, ins, attrs, node, const_values=None):
    v = attrs.get("value")
    v = np.asarray(0.0, np.float32) if v is None else np.asarray(v).reshape(())
    return sd._record("onnx_constant_of_shape", [ins[0]],
                      {"value": float(v), "dtype": str(v.dtype)})


@_graph_op("onnx_constant_of_shape")
def _const_of_shape(shape_arr, *, value, dtype):
    shp = tuple(int(s) for s in shape_arr.reshape(-1).tolist())
    return torch.full(shp, value, dtype=_dtype_of(dtype),
                      device=shape_arr.device)


@register_onnx_op("Range")
def _onnx_range(sd, ins, attrs, node, const_values=None):
    cv = const_values or {}
    vals = [cv.get(n) for n in node.inputs]
    if any(v is None for v in vals):
        raise NotImplementedError(
            f"Range {node.name}: start/limit/delta must be graph constants "
            f"(the output length is fixed at import)")
    s, l, d = (np.asarray(v).reshape(()) for v in vals)
    return sd.constant(node.name, np.arange(s, l, d))


@register_onnx_op("OneHot")
def _onnx_one_hot(sd, ins, attrs, node, const_values=None):
    cv = const_values or {}
    depth = cv.get(node.inputs[1])
    values = cv.get(node.inputs[2])
    if depth is None or values is None:
        raise NotImplementedError(
            f"OneHot {node.name}: depth and values must be constants")
    off, on = (float(v) for v in np.asarray(values).reshape(-1))
    axis = int(attrs.get("axis", -1))
    out = sd._record("one_hot", [ins[0]],
                     {"depth": int(np.asarray(depth).reshape(())),
                      "on_value": on, "off_value": off})
    if axis != -1:
        # one_hot writes the new axis last; move it where the model asked
        out = sd._record("onnx_move_last_axis", [out], {"axis": axis})
    return out


@_graph_op("onnx_move_last_axis")
def _move_last_axis(x, *, axis):
    perm = list(range(x.ndim - 1))
    perm.insert(axis if axis >= 0 else axis + x.ndim, x.ndim - 1)
    return x.permute(perm)


_NEEDS_CONSTS |= {"ConstantOfShape", "Range", "OneHot"}


@register_onnx_op("EyeLike")
def _onnx_eye_like(sd, ins, attrs, node):
    return sd._record("eye_like", [ins[0]], {"k": int(attrs.get("k", 0))})


@_graph_op("eye_like")
def _eye_like(x, *, k=0):
    rows = torch.arange(x.shape[-2], device=x.device)[:, None]
    cols = torch.arange(x.shape[-1], device=x.device)[None, :]
    return (cols - rows == k).to(x.dtype)


def _wrapped(idx, size: int):
    """int64 indices with the negative ones counted from the end."""
    idx = idx.long()
    return torch.where(idx < 0, idx + size, idx)


@register_onnx_op("GatherElements")
def _onnx_gather_elements(sd, ins, attrs, node):
    return sd._record("gather_elements", ins,
                      {"axis": int(attrs.get("axis", 0))})


@_graph_op("gather_elements")
def _gather_elements(data, idx, *, axis=0):
    return torch.take_along_dim(data, _wrapped(idx, data.shape[axis]),
                                dim=axis)


_SCATTER_REDUCE = {"mul": "prod", "max": "amax", "min": "amin"}


@register_onnx_op("ScatterElements")
@register_onnx_op("Scatter")  # the deprecated opset-9 alias
def _onnx_scatter_elements(sd, ins, attrs, node):
    return sd._record("scatter_elements", ins,
                      {"axis": int(attrs.get("axis", 0)),
                       "reduction": attrs.get("reduction", "none") or "none"})


@_graph_op("scatter_elements")
def _scatter_elements(data, idx, upd, *, axis=0, reduction="none"):
    idx = _wrapped(idx, data.shape[axis])
    upd = upd.to(data.dtype)
    if reduction == "add":
        return data.scatter_add(axis, idx, upd)
    if reduction in _SCATTER_REDUCE:
        return data.scatter_reduce(axis, idx, upd, _SCATTER_REDUCE[reduction])
    return data.scatter(axis, idx, upd)


@register_onnx_op("ScatterND")
def _onnx_scatter_nd(sd, ins, attrs, node):
    return sd._record("onnx_scatter_nd", ins,
                      {"reduction": attrs.get("reduction", "none") or "none"})


@_graph_op("onnx_scatter_nd")
def _onnx_scatter_nd_impl(data, indices, updates, *, reduction="none"):
    """ONNX ScatterND: the last axis of ``indices`` addresses the leading
    dims of ``data``; each addressed slice gets (or reduces in) its row of
    ``updates``."""
    k = indices.shape[-1]
    lead = tuple(data.shape[:k])
    rest = tuple(data.shape[k:])
    lin = torch.zeros(indices.shape[:-1], dtype=torch.long,
                      device=data.device)
    for j in range(k):
        lin = lin * lead[j] + _wrapped(indices[..., j], lead[j])
    lin = lin.reshape(-1)
    flat = data.reshape((-1,) + rest).clone()
    upd = updates.to(data.dtype).reshape((-1,) + rest)
    if reduction == "add":
        flat.index_add_(0, lin, upd)
    elif reduction in _SCATTER_REDUCE:
        at = lin.reshape((-1,) + (1,) * len(rest)).expand(upd.shape)
        flat = flat.scatter_reduce(0, at, upd, _SCATTER_REDUCE[reduction])
    else:
        flat[lin] = upd
    return flat.reshape(data.shape)


# ---------------------------------------------------------------------------
# Recurrent: LSTM / GRU onto the catalog's sequence ops, with the gate and
# axis re-packing recorded as graph ops over the original W/R/B, so an
# imported model fine-tunes through them; RNN as a graph op of its own.
# ---------------------------------------------------------------------------


@register_onnx_op("LSTM")
def _lstm_onnx(sd, ins, attrs, node, const_values=None):
    """ONNX LSTM (one forward direction): X (T, N, I), W (1, 4H, I) in gate
    order i, o, f, c; R (1, 4H, H); B (1, 8H)."""
    _reject_extra_rnn_inputs(node, {4: "sequence_lens", 5: "initial_h",
                                    6: "initial_c", 7: "peepholes (P)"})
    hidden = int(attrs["hidden_size"])
    w_ih = _regate_matrix(sd, ins[1], 4, [0, 2, 3, 1])  # i,o,f,c -> i,f,c,o
    w_hh = _regate_matrix(sd, ins[2], 4, [0, 2, 3, 1])
    b = _rnn_bias(sd, ins, node, 3, 4, [0, 2, 3, 1], hidden)
    x_nt = sd._record("transpose", [ins[0]], {"axes": (1, 0, 2)})
    ys, h_t, c_t = sd._record("lstm_sequence", [x_nt, w_ih, w_hh, b],
                              n_out=3)
    y_tn = sd._record("transpose", [ys], {"axes": (1, 0, 2)})
    y = sd._record("expand_dims", [y_tn], {"axis": 1})
    h_out = sd._record("expand_dims", [h_t], {"axis": 0})
    c_out = sd._record("expand_dims", [c_t], {"axis": 0})
    return (y, h_out, c_out)


@register_onnx_op("GRU")
def _gru_onnx(sd, ins, attrs, node, const_values=None):
    """ONNX GRU (one forward direction): gates z, r, h → the catalog's
    r, z, n; ``linear_before_reset`` maps onto ``gru_sequence``'s."""
    _reject_extra_rnn_inputs(node, {4: "sequence_lens", 5: "initial_h"})
    hidden = int(attrs["hidden_size"])
    lbr = bool(int(attrs.get("linear_before_reset", 0)))
    w_ih = _regate_matrix(sd, ins[1], 3, [1, 0, 2])  # z,r,h -> r,z,h
    w_hh = _regate_matrix(sd, ins[2], 3, [1, 0, 2])
    if len(node.inputs) > 3 and node.inputs[3]:
        bb = sd._record("squeeze", [ins[3]], {"axis": (0,)})
        wb, rb = sd._record("split", [bb], {"num_split": 2, "axis": 0},
                            n_out=2)
        b_ih = _reorder_vector(sd, wb, 3, [1, 0, 2])
        b_hh = _reorder_vector(sd, rb, 3, [1, 0, 2])
    else:
        z = np.zeros(3 * hidden, np.float32)
        b_ih = sd.constant(node.name + "_bih", z)
        b_hh = sd.constant(node.name + "_bhh", z)
    x_nt = sd._record("transpose", [ins[0]], {"axes": (1, 0, 2)})
    ys, h_t = sd._record("gru_sequence", [x_nt, w_ih, w_hh, b_ih, b_hh],
                         {"linear_before_reset": lbr}, n_out=2)
    y_tn = sd._record("transpose", [ys], {"axes": (1, 0, 2)})
    y = sd._record("expand_dims", [y_tn], {"axis": 1})
    h_out = sd._record("expand_dims", [h_t], {"axis": 0})
    return (y, h_out)


def _reject_extra_rnn_inputs(node, slots):
    """Refuse the recurrent options not lowered: checked on the wire slots
    (``node.inputs``), not the compacted ``ins``, so an absent bias cannot
    shift the check off its slot; also the attributes that would change
    the numbers (layout=1, other activations, clip)."""
    attrs = getattr(node, "attrs", {}) or {}
    direction = attrs.get("direction", "forward")
    if isinstance(direction, bytes):
        direction = direction.decode()
    if direction != "forward":
        raise NotImplementedError(
            f"ONNX {node.op_type} direction={direction} import")
    if int(attrs.get("layout", 0)):
        raise NotImplementedError(
            f"ONNX {node.op_type} layout=1 (batch-major) import — "
            f"re-export with the default time-major layout")
    if attrs.get("activations"):
        raise NotImplementedError(
            f"ONNX {node.op_type} with non-default activations import")
    if attrs.get("clip"):
        raise NotImplementedError(
            f"ONNX {node.op_type} with cell clipping import")
    for idx, what in slots.items():
        if len(node.inputs) > idx and node.inputs[idx]:
            raise NotImplementedError(
                f"ONNX {node.op_type} with {what} input import")


def _regate_matrix(sd, v, parts, order):
    """(1, parts·H, D) gate-stacked weight → (D, parts·H) in the catalog's
    gate order, recorded as squeeze/split/concat/transpose graph ops."""
    sq = sd._record("squeeze", [v], {"axis": (0,)})
    pieces = sd._record("split", [sq], {"num_split": parts, "axis": 0},
                        n_out=parts)
    cat = sd._record("concat", [pieces[j] for j in order], {"axis": 0})
    return sd._record("transpose", [cat], {"axes": (1, 0)})


def _reorder_vector(sd, v, parts, order):
    pieces = sd._record("split", [v], {"num_split": parts, "axis": 0},
                        n_out=parts)
    return sd._record("concat", [pieces[j] for j in order], {"axis": 0})


def _rnn_bias(sd, ins, node, slot, parts, order, hidden):
    """LSTM bias: B (1, 2·parts·H) = Wb ++ Rb, both reordered then summed;
    an absent B is zeros."""
    if len(node.inputs) > slot and node.inputs[slot]:
        bb = sd._record("squeeze", [ins[slot]], {"axis": (0,)})
        wb, rb = sd._record("split", [bb], {"num_split": 2, "axis": 0},
                            n_out=2)
        return sd._record("add", [_reorder_vector(sd, wb, parts, order),
                                  _reorder_vector(sd, rb, parts, order)])
    return sd.constant(node.name + "_b",
                       np.zeros(parts * hidden, np.float32))


_NEEDS_CONSTS |= {"LSTM", "GRU"}


@register_onnx_op("RNN")
def _onnx_rnn(sd, ins, attrs, node):
    if attrs.get("direction") == "bidirectional":
        raise NotImplementedError("bidirectional RNN import")
    acts = attrs.get("activations") or ["Tanh"]
    # optional inputs are positional with empty-name gaps: realign
    pos = [i for i, nm in enumerate(node.inputs) if nm]
    slot = dict(zip(pos, ins))
    h = int(attrs["hidden_size"])
    if 4 in slot:
        raise NotImplementedError(
            f"RNN {node.name}: sequence_lens input is not supported "
            f"(variable-length unrolling; pad or mask outside the graph)")
    b = slot.get(3)
    if b is None:
        b = sd.constant(node.name + "_b0", np.zeros((1, 2 * h), np.float32))
    h0 = slot.get(5)
    if h0 is None:
        # a (1, 1, H) zeros state, broadcast over the batch in the op
        h0 = sd.constant(node.name + "_h0", np.zeros((1, 1, h), np.float32))
    use = [slot[0], slot[1], slot[2], b, h0]
    return sd._record("onnx_rnn", use,
                      {"hidden_size": int(attrs["hidden_size"]),
                       "activation": acts[0] if isinstance(acts[0], str)
                       else acts[0].decode()}, n_out=2)


_RNN_ACTS = {"Tanh": torch.tanh, "Relu": torch.relu,
             "Sigmoid": torch.sigmoid}


@_graph_op("onnx_rnn")
def _onnx_rnn_impl(x, w, r, b, h_init, *, hidden_size, activation):
    """ONNX vanilla RNN (Elman), one direction. x (T, B, I), w (1, H, I),
    r (1, H, H), b (1, 2H), h_init (1, B, H) or (1, 1, H). Returns
    (Y (T, 1, B, H), Y_h (1, B, H))."""
    act = _RNN_ACTS[activation]
    wt, rt = w[0].T, r[0].T
    bias = b[0, :hidden_size] + b[0, hidden_size:]
    h = torch.broadcast_to(h_init[0], (x.shape[1], hidden_size)).to(x.dtype)
    ys = []
    for t in range(x.shape[0]):
        h = act(x[t] @ wt + h @ rt + bias)
        ys.append(h)
    return torch.stack(ys)[:, None], h[None]


# ---------------------------------------------------------------------------
# Control flow: Loop / If / Scan onto SameDiff's while_loop_multi /
# cond_multi / scan_multi. ONNX subgraphs capture outer-scope tensors by
# name (TF function bodies do not), so the walker passes these rules its
# live scope (IRImporter's needs_scope) and the captures become extra
# explicit inputs. A while loop or a conditional reads its predicate on
# the host, so a graph holding one runs eagerly (nn.compiled.CONTROL_FLOW).
# ---------------------------------------------------------------------------


def _subgraph_internal_names(ir) -> set:
    own = {o for n in ir.nodes for o in n.outputs}
    own |= set(ir.initializers)
    own |= {nm for nm, _ in ir.inputs}
    return own


def _implicit_inputs(ir) -> List[str]:
    """Names a subgraph reads from the enclosing scope (also those read by
    its nested subgraphs), in first-use order."""
    refs: List[str] = []

    def visit(g, outer_internal):
        for n in g.nodes:
            for i in n.inputs:
                if i and i not in outer_internal:
                    refs.append(i)
            for v in n.attrs.values():
                if isinstance(v, IRGraph):
                    visit(v, outer_internal | _subgraph_internal_names(v))

    visit(ir, _subgraph_internal_names(ir))
    return list(dict.fromkeys(refs))


def _subgraph_callable(ir, extra_inputs: Sequence[str] = (), device=None):
    """Import a subgraph into a private SameDiff on ``device`` and wrap it
    as a callable over tensors (declared inputs…, captured inputs…) →
    tuple of outputs."""
    in_names = [nm for nm, _ in ir.inputs] + list(extra_inputs)
    if extra_inputs:
        # captured outer tensors become placeholders of the subgraph
        ir = IRGraph(nodes=ir.nodes, initializers=ir.initializers,
                     inputs=list(ir.inputs) + [(nm, None)
                                               for nm in extra_inputs],
                     outputs=ir.outputs, name=ir.name)
    walker = IRImporter(ONNX_OP_MAPPERS, needs_consts=_NEEDS_CONSTS,
                        trainable_consts=False, needs_scope=_NEEDS_SCOPE,
                        device=device)
    sub = walker.run_import(ir)
    out_names = list(sub.graph_outputs or ir.outputs)

    def call(*vals):
        env = dict(sub._arrays)
        for nm, v in zip(in_names, vals):
            env[nm] = v
        res = sub._interpret(env, out_names)
        return tuple(res[nm] for nm in out_names)

    # the subgraph's routing flags, which a scan over it inherits
    fns = [sub._local_ops.get(n.op, _sdmod.GRAPH_OPS.get(n.op))
           for n in sub._needed_nodes(out_names)]
    for flag in ("reads_host", "seeds_generator"):
        setattr(call, flag, any(getattr(f, flag, False) for f in fns))
    return call, len(out_names)


def _capture_vars(names, scope, node):
    missing = [nm for nm in names if nm not in scope]
    if missing:
        raise ValueError(
            f"{node.op_type} {node.name}: subgraph captures {missing} which "
            f"are not produced in the enclosing scope")
    return [scope[nm] for nm in names]


def _as_carry(new, old):
    """A body output in its carry's shape and dtype (a body may return a
    (1,)-shaped value or a promoted dtype; a carry keeps its own)."""
    return torch.as_tensor(new, device=old.device).reshape(
        old.shape).to(old.dtype)


def _as_pred(v):
    return torch.as_tensor(v).bool().reshape(())


@register_onnx_op("If")
def _onnx_if(sd, ins, attrs, node, scope=None, const_values=None):
    then_ir, else_ir = attrs["then_branch"], attrs["else_branch"]
    caps = list(dict.fromkeys(_implicit_inputs(then_ir)
                              + _implicit_inputs(else_ir)))
    then_call, n_then = _subgraph_callable(then_ir, caps, sd.device)
    else_call, n_else = _subgraph_callable(else_ir, caps, sd.device)
    if n_then != n_else:
        raise ValueError(f"If {node.name}: branch arities differ "
                         f"({n_then} vs {n_else})")
    operands = _capture_vars(caps, scope or {}, node)

    # both branches take the capture union as their trailing inputs, so
    # each receives every union value (one it does not read is unused)
    def mk(call):
        def fn(*vals):
            out = call(*vals)
            return out[0] if n_then == 1 else out
        return fn

    return sd.cond_multi(ins[0], mk(then_call), mk(else_call), operands,
                         n_out=n_then)


@register_onnx_op("Loop")
def _onnx_loop(sd, ins, attrs, node, scope=None, const_values=None):
    """ONNX Loop → ``while_loop_multi`` (no scan outputs) or a masked
    ``scan_multi`` (scan outputs, a constant trip count).

    Node inputs: M (optional), cond (optional), v_initial…; body:
    (iter_num, cond_in, v_in…) → (cond_out, v_out…, scan_out…); node
    outputs: v_final… + the stacked scan outputs. With scan outputs and an
    early exit the outputs keep length M, the rows past the exit holding
    the last live value, as the JAX rule's static shapes give them.
    """
    body_ir = attrs["body"]
    caps = _implicit_inputs(body_ir)
    body_call, n_body_out = _subgraph_callable(body_ir, caps, sd.device)
    cap_vars = _capture_vars(caps, scope or {}, node)

    node_in = list(node.inputs)  # keep empty-name optional slots
    it = iter(ins)
    m_var = next(it) if node_in and node_in[0] else None
    cond_var = next(it) if len(node_in) > 1 and node_in[1] else None
    v_init = list(it)
    n_v = len(v_init)
    n_scan = n_body_out - 1 - n_v
    if n_scan < 0:
        raise ValueError(f"Loop {node.name}: body returns {n_body_out} "
                         f"values for {n_v} loop-carried deps")

    m_static = None
    if m_var is not None and node_in[0] in (const_values or {}):
        m_static = int(np.asarray(const_values[node_in[0]]).reshape(()))

    zero = sd.constant(node.name + "_i0", np.asarray(0, np.int64))
    cond0 = (cond_var if cond_var is not None
             else sd.constant(node.name + "_true", np.asarray(True)))
    if cond_var is not None:
        # a possibly (1,)-shaped runtime cond as a () bool
        cond0 = sd._record("reshape", [cond0], {"shape": ()})
        cond0 = sd._record("cast", [cond0], {"dtype": "bool"})
    init = [zero, cond0] + v_init + cap_vars

    if n_scan == 0:
        # a while loop: carry = (i, cond, v…, captures…[, M])
        def cond_fn(carry):
            ok = _as_pred(carry[1])
            if m_var is not None:
                # M rides the carry's tail (ONNX trip counts are often
                # shape-(1,) tensors)
                ok = ok & (carry[0] < carry[-1].reshape(()))
            return ok

        def body_fn(carry):
            i, vs = carry[0], carry[2:2 + n_v]
            out = body_call(i, carry[1], *vs, *carry[2 + n_v:2 + n_v
                                                        + len(caps)])
            v_new = tuple(_as_carry(nv, ov)
                          for nv, ov in zip(out[1:1 + n_v], vs))
            return (i + 1, _as_pred(out[0]), *v_new, *carry[2 + n_v:])

        finals = sd.while_loop_multi(
            cond_fn, body_fn, init + ([m_var] if m_var is not None else []))
        if not isinstance(finals, tuple):
            finals = (finals,)
        return [finals[2 + j] for j in range(n_v)]

    # scan outputs: a constant trip count
    if m_static is None:
        raise NotImplementedError(
            f"Loop {node.name}: scan outputs require a constant trip count "
            f"M (the stacked outputs' length is fixed at import); got a "
            f"runtime M or none")

    def step(carry, _):
        i, cond, vs = carry[0], carry[1], carry[2:2 + n_v]
        cap = carry[2 + n_v:]
        out = body_call(i, cond, *vs, *cap)
        # masked advance: once cond goes False the carry freezes and the
        # scan rows repeat the last live value
        v_next = tuple(torch.where(cond, _as_carry(nv, ov), ov)
                       for nv, ov in zip(out[1:1 + n_v], vs))
        return ((i + 1, cond & _as_pred(out[0])) + v_next + tuple(cap),
                tuple(out[1 + n_v:]))

    outs = sd.scan_multi(_sdmod.inherit_routing(step, body_call), init, [],
                         n_scan, length=m_static)
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    n_carry = len(init)
    return ([outs[2 + j] for j in range(n_v)]
            + [outs[n_carry + j] for j in range(n_scan)])


@register_onnx_op("Scan")
def _onnx_scan(sd, ins, attrs, node, scope=None, const_values=None):
    """ONNX Scan → ``scan_multi``: the default axes (0), each input's and
    output's direction (reverse by a flip)."""
    body_ir = attrs["body"]
    n_scan_in = int(attrs["num_scan_inputs"])
    caps = _implicit_inputs(body_ir)
    body_call, n_body_out = _subgraph_callable(body_ir, caps, sd.device)
    cap_vars = _capture_vars(caps, scope or {}, node)

    n_state = len(ins) - n_scan_in
    states, scan_ins = list(ins[:n_state]), list(ins[n_state:])
    n_scan_out = n_body_out - n_state
    in_dirs = list(attrs.get("scan_input_directions", [0] * n_scan_in))
    out_dirs = list(attrs.get("scan_output_directions", [0] * n_scan_out))
    in_axes = list(attrs.get("scan_input_axes", [0] * n_scan_in))
    out_axes = list(attrs.get("scan_output_axes", [0] * n_scan_out))
    if any(a != 0 for a in in_axes) or any(a != 0 for a in out_axes):
        raise NotImplementedError(
            f"Scan {node.name}: non-zero scan axes are not supported")
    for j, d in enumerate(in_dirs):
        if int(d):
            scan_ins[j] = sd._record("reverse", [scan_ins[j]], {"axis": (0,)})

    def fn(carry, xs):
        st, cap = carry[:n_state], carry[n_state:]
        out = body_call(*st, *xs, *cap)
        return tuple(out[:n_state]) + tuple(cap), tuple(out[n_state:])

    outs = sd.scan_multi(_sdmod.inherit_routing(fn, body_call),
                         list(states) + cap_vars, scan_ins, n_scan_out)
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    n_carry = n_state + len(cap_vars)
    ys = [outs[n_carry + j] for j in range(n_scan_out)]
    for j, d in enumerate(out_dirs):
        if int(d):
            ys[j] = sd._record("reverse", [ys[j]], {"axis": (0,)})
    return [outs[j] for j in range(n_state)] + ys


_NEEDS_SCOPE = {"Loop", "If", "Scan"}
_NEEDS_CONSTS |= {"Loop"}


# ---------------------------------------------------------------------------
# Detection, quantization, random draws and the documented rejections
# ---------------------------------------------------------------------------


@register_onnx_op("NonMaxSuppression")
def _onnx_nms(sd, ins, attrs, node, const_values=None):
    cv = const_values or {}
    n_in = list(node.inputs)

    def scalar(k, default, kind):
        if len(n_in) > k and n_in[k]:
            return kind(np.asarray(cv.get(n_in[k], default)).reshape(()))
        return default

    mo = scalar(2, 0, int)
    iou = scalar(3, 0.0, float)
    sc = scalar(4, -np.inf, float)
    if mo <= 0:
        raise NotImplementedError(
            f"NonMaxSuppression {node.name}: max_output_boxes_per_class must "
            f"be a positive constant (static shapes)")
    cpb = int(attrs.get("center_point_box", 0))
    if cpb not in (0, 1):
        raise NotImplementedError(
            f"NonMaxSuppression {node.name}: center_point_box={cpb} "
            f"(spec allows only 0 or 1)")
    return sd._record("onnx_nms", list(ins[:2]),
                      {"max_out": mo, "iou_threshold": iou,
                       "score_threshold": sc, "center_point_box": cpb})


_NEEDS_CONSTS.add("NonMaxSuppression")


@_graph_op("onnx_nms")
def _onnx_nms_impl(boxes, scores, *, max_out, iou_threshold, score_threshold,
                   center_point_box=0):
    """ONNX NonMaxSuppression with a static output: (B·C·max_out, 3) index
    triples [batch, class, box], padded with -1 (the reference emits a
    list of varying length; the pad rows carry the same information).
    ``center_point_box=1`` boxes are [x_center, y_center, width, height],
    converted to the corners the catalog op reads."""
    from deeplearning4j_tpu_torch.ops.image_ops import non_max_suppression

    nms = getattr(non_max_suppression, "fn", non_max_suppression)
    if center_point_box:
        xc, yc, w, h = (boxes[..., 0], boxes[..., 1],
                        boxes[..., 2], boxes[..., 3])
        boxes = torch.stack([yc - h / 2, xc - w / 2,
                             yc + h / 2, xc + w / 2], dim=-1)
    b, c = boxes.shape[0], scores.shape[1]
    rows = []
    for bi in range(b):
        for ci in range(c):
            idx, valid = nms(boxes[bi], scores[bi, ci],
                             max_output_size=max_out,
                             iou_threshold=float(iou_threshold),
                             score_threshold=float(score_threshold))
            sel = torch.stack([torch.full((max_out,), bi, dtype=torch.int32,
                                          device=boxes.device),
                               torch.full((max_out,), ci, dtype=torch.int32,
                                          device=boxes.device),
                               idx.to(torch.int32)], dim=1)
            rows.append(torch.where(valid.bool()[:, None], sel,
                                    torch.full_like(sel, -1)))
    return torch.cat(rows, dim=0)


@register_onnx_op("RoiAlign")
def _onnx_roi_align(sd, ins, attrs, node):
    mode = attrs.get("mode", "avg") or "avg"
    cam = attrs.get("coordinate_transformation_mode", "half_pixel")
    return sd._record("onnx_roi_align", ins, {
        "output_height": int(attrs.get("output_height", 1)),
        "output_width": int(attrs.get("output_width", 1)),
        "sampling_ratio": int(attrs.get("sampling_ratio", 0)),
        "spatial_scale": float(attrs.get("spatial_scale", 1.0)),
        "mode": mode,
        "coord_offset": 0.5 if cam == "half_pixel" else 0.0})


@_graph_op("onnx_roi_align")
def _roi_align_impl(x, rois, batch_idx, *, output_height, output_width,
                    sampling_ratio, spatial_scale, mode, coord_offset):
    """RoiAlign (the exact bilinear-sampled definition, NCHW as ONNX):
    each output bin the mean (or max) of sr × sr bilinear samples."""
    _, c, h, w = x.shape
    sr = sampling_ratio if sampling_ratio > 0 else 2
    oh, ow = output_height, output_width
    dev = x.device
    frac = (torch.arange(sr, device=dev, dtype=x.dtype) + 0.5) / sr
    out = []
    for roi, bi in zip(rois, batch_idx.long()):
        x1, y1, x2, y2 = (roi * spatial_scale - coord_offset).unbind()
        bh = torch.clamp_min(y2 - y1, 1e-6) / oh
        bw = torch.clamp_min(x2 - x1, 1e-6) / ow
        ys = (y1 + (torch.arange(oh, device=dev, dtype=x.dtype)[:, None]
                    + frac[None, :]) * bh).reshape(-1)
        xs = (x1 + (torch.arange(ow, device=dev, dtype=x.dtype)[:, None]
                    + frac[None, :]) * bw).reshape(-1)
        y0 = torch.clamp(torch.floor(ys), 0, h - 1)
        x0 = torch.clamp(torch.floor(xs), 0, w - 1)
        y1i = torch.clamp(y0 + 1, 0, h - 1).long()
        x1i = torch.clamp(x0 + 1, 0, w - 1).long()
        wy = (torch.clamp(ys, 0, h - 1) - y0)[:, None]
        wx = (torch.clamp(xs, 0, w - 1) - x0)[None, :]
        y0, x0 = y0.long(), x0.long()
        img = x[bi]  # (C, H, W)

        def g(yy, xx):
            return img[:, yy[:, None], xx[None, :]]  # (C, Y, X)

        v = (g(y0, x0) * ((1 - wy) * (1 - wx))[None]
             + g(y0, x1i) * ((1 - wy) * wx)[None]
             + g(y1i, x0) * (wy * (1 - wx))[None]
             + g(y1i, x1i) * (wy * wx)[None])
        v = v.reshape(c, oh, sr, ow, sr)
        out.append(v.amax(dim=(2, 4)) if mode == "max"
                   else v.mean(dim=(2, 4)))
    return torch.stack(out)


@register_onnx_op("GridSample")
def _onnx_grid_sample(sd, ins, attrs, node):
    mode = attrs.get("mode", "linear") or "linear"
    mode = {"bilinear": "linear"}.get(mode, mode)
    if mode not in ("linear", "nearest"):
        raise NotImplementedError(f"GridSample mode={mode}")
    pad = attrs.get("padding_mode", "zeros") or "zeros"
    if pad not in ("zeros", "border"):
        raise NotImplementedError(f"GridSample padding_mode={pad}")
    return sd._record("onnx_grid_sample", ins, {
        "mode": "nearest" if mode == "nearest" else "linear",
        "padding_mode": pad,
        "align_corners": bool(int(attrs.get("align_corners", 0)))})


@_graph_op("onnx_grid_sample")
def _grid_sample_impl(x, grid, *, mode, padding_mode, align_corners):
    """ONNX GridSample (NCHW x, (N, Ho, Wo, 2) grid in [-1, 1], xy order):
    bilinear or nearest with zeros or border padding, the
    ``torch.nn.functional.grid_sample`` semantics exports rely on, written
    out as the JAX graph op computes them."""
    if x.ndim != 4:
        raise NotImplementedError(
            f"GridSample: only 4-D NCHW input is supported (got rank "
            f"{x.ndim}; volumetric 5-D GridSample is an opset-16 extension)")
    n, _, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1) * 0.5 * (w - 1)
        fy = (gy + 1) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1) * w - 1) * 0.5
        fy = ((gy + 1) * h - 1) * 0.5
    batch = torch.arange(n, device=x.device)[:, None, None]

    def gather(yy, xx):
        yc = torch.clamp(yy, 0, h - 1).long()
        xc = torch.clamp(xx, 0, w - 1).long()
        vals = x[batch, :, yc, xc].permute(0, 3, 1, 2)  # (N, C, Ho, Wo)
        if padding_mode == "zeros":
            inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            vals = vals * inb[:, None].to(vals.dtype)
        return vals

    if mode == "nearest":
        return gather(torch.round(fy), torch.round(fx))
    y0, x0 = torch.floor(fy), torch.floor(fx)
    wy = (fy - y0)[:, None]
    wx = (fx - x0)[:, None]
    return (gather(y0, x0) * (1 - wy) * (1 - wx)
            + gather(y0, x0 + 1) * (1 - wy) * wx
            + gather(y0 + 1, x0) * wy * (1 - wx)
            + gather(y0 + 1, x0 + 1) * wy * wx)


@register_onnx_op("DequantizeLinear")
def _onnx_dequant(sd, ins, attrs, node):
    x = sd._record("cast", [ins[0]], {"dtype": "float32"})
    if len(ins) > 2:
        zp = sd._record("cast", [ins[2]], {"dtype": "float32"})
        x = sd._record("sub", [x, zp])
    return sd._record("mul", [x, ins[1]])


@register_onnx_op("QuantizeLinear")
def _onnx_quant(sd, ins, attrs, node, const_values=None):
    cv = const_values or {}
    zp_name = node.inputs[2] if len(node.inputs) > 2 and node.inputs[2] \
        else None
    zp_arr = cv.get(zp_name) if zp_name else None
    # the zero point sets the dtype (spec); uint8 is the default
    qdt = (np.asarray(zp_arr).dtype if zp_arr is not None
           else np.dtype(np.uint8))
    lo_v, hi_v = ((0.0, 255.0) if qdt == np.dtype(np.uint8)
                  else (-128.0, 127.0))
    scaled = sd._record("div", [ins[0], ins[1]])
    r = sd._record("round", [scaled])
    if len(ins) > 2:
        zp = sd._record("cast", [ins[2]], {"dtype": "float32"})
        r = sd._record("add", [r, zp])
    lo = sd.constant(node.name + "_lo", np.asarray(lo_v, np.float32))
    hi = sd.constant(node.name + "_hi", np.asarray(hi_v, np.float32))
    r = sd._record("maximum", [r, lo])
    r = sd._record("minimum", [r, hi])
    return sd._record("cast", [r], {"dtype": str(qdt)})


_NEEDS_CONSTS.add("QuantizeLinear")


@register_onnx_op("DynamicQuantizeLinear")
def _onnx_dyn_quant(sd, ins, attrs, node):
    return sd._record("onnx_dynamic_quantize", [ins[0]], n_out=3)


@_graph_op("onnx_dynamic_quantize")
def _dyn_quant_impl(x):
    lo = torch.clamp_max(x.min(), 0.0)
    hi = torch.clamp_min(x.max(), 0.0)
    scale = (hi - lo) / 255.0
    safe = torch.clamp_min(scale, 1e-12)
    zp = torch.clamp(torch.round(-lo / safe), 0, 255)
    q = torch.clamp(torch.round(x / safe) + zp, 0, 255).to(torch.uint8)
    return q, scale, zp.to(torch.uint8)


_ONNX_FLOAT_DT = {1: "float32", 10: "float16", 11: "float64"}


def _onnx_seed(attrs, node) -> int:
    """The stream's seed: the (float) seed attribute when given, else the
    crc32 of the node name (unseeded nodes must not share a stream, and
    ``hash()`` differs between processes), as the JAX rules key theirs."""
    s = attrs.get("seed")
    if s is not None and float(s) != 0.0:
        return int(float(s)) & 0x7FFFFFFF
    return zlib.crc32(node.name.encode()) & 0x7FFFFFFF


def _onnx_float_dtype(attrs, node) -> str:
    code = attrs.get("dtype")
    if code is None:
        return "float32"
    dt = _ONNX_FLOAT_DT.get(int(code))
    if dt is None:
        raise NotImplementedError(
            f"{node.op_type} {node.name}: non-float random dtype code "
            f"{int(code)}")
    return dt


def _generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` keyed by ``seed``: the same
    draws on every run of the graph (the draws cannot equal
    ``jax.random``'s)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


@register_onnx_op("RandomNormal")
def _onnx_random_normal(sd, ins, attrs, node):
    return sd._record("onnx_random_normal", [], {
        "shape": tuple(int(s) for s in attrs["shape"]),
        "mean": float(attrs.get("mean", 0.0)),
        "scale": float(attrs.get("scale", 1.0)),
        "seed": _onnx_seed(attrs, node),
        "dtype": _onnx_float_dtype(attrs, node),
        "device": str(sd.device)})


@_graph_op("onnx_random_normal")
@_sdmod.seeds_generator
def _rand_normal_impl(*, shape, mean, scale, seed, dtype, device="cpu"):
    dt = _dtype_of(dtype)
    return mean + scale * torch.randn(tuple(shape), generator=_generator(
        seed, device), dtype=dt, device=device)


@register_onnx_op("RandomUniform")
def _onnx_random_uniform(sd, ins, attrs, node):
    return sd._record("onnx_random_uniform", [], {
        "shape": tuple(int(s) for s in attrs["shape"]),
        "low": float(attrs.get("low", 0.0)),
        "high": float(attrs.get("high", 1.0)),
        "seed": _onnx_seed(attrs, node),
        "dtype": _onnx_float_dtype(attrs, node),
        "device": str(sd.device)})


@_graph_op("onnx_random_uniform")
@_sdmod.seeds_generator
def _rand_uniform_impl(*, shape, low, high, seed, dtype, device="cpu"):
    dt = _dtype_of(dtype)
    u = torch.rand(tuple(shape), generator=_generator(seed, device),
                   dtype=dt, device=device)
    return low + (high - low) * u


@register_onnx_op("RandomNormalLike")
def _onnx_random_normal_like(sd, ins, attrs, node):
    return sd._record("onnx_random_normal_like", [ins[0]], {
        "mean": float(attrs.get("mean", 0.0)),
        "scale": float(attrs.get("scale", 1.0)),
        "seed": _onnx_seed(attrs, node)})


@_graph_op("onnx_random_normal_like")
@_sdmod.seeds_generator
def _rand_normal_like(x, *, mean, scale, seed):
    return mean + scale * torch.randn(
        x.shape, generator=_generator(seed, x.device), dtype=x.dtype,
        device=x.device)


@register_onnx_op("RandomUniformLike")
def _onnx_random_uniform_like(sd, ins, attrs, node):
    return sd._record("onnx_random_uniform_like", [ins[0]], {
        "low": float(attrs.get("low", 0.0)),
        "high": float(attrs.get("high", 1.0)),
        "seed": _onnx_seed(attrs, node)})


@_graph_op("onnx_random_uniform_like")
@_sdmod.seeds_generator
def _rand_uniform_like(x, *, low, high, seed):
    u = torch.rand(x.shape, generator=_generator(seed, x.device),
                   dtype=x.dtype, device=x.device)
    return low + (high - low) * u


@register_onnx_op("Bernoulli")
def _onnx_bernoulli(sd, ins, attrs, node):
    return sd._record("onnx_bernoulli", [ins[0]],
                      {"seed": _onnx_seed(attrs, node)})


@_graph_op("onnx_bernoulli")
@_sdmod.seeds_generator
def _bernoulli_impl(x, *, seed):
    u = torch.rand(x.shape, generator=_generator(seed, x.device),
                   dtype=torch.float32, device=x.device)
    return (u < x).to(x.dtype)


@register_onnx_op("Multinomial")
def _onnx_multinomial(sd, ins, attrs, node):
    return sd._record("onnx_multinomial", [ins[0]], {
        "sample_size": int(attrs.get("sample_size", 1)),
        "seed": _onnx_seed(attrs, node)})


@_graph_op("onnx_multinomial")
@_sdmod.seeds_generator
def _multinomial_impl(logprobs, *, sample_size, seed):
    """(B, sample_size) int32 class draws from each row's unnormalized
    log-probabilities, with replacement."""
    probs = torch.softmax(logprobs.float(), dim=-1)
    return torch.multinomial(probs, sample_size, replacement=True,
                             generator=_generator(seed, logprobs.device)
                             ).to(torch.int32)


def _documented_reject(op_name: str, why: str):
    def rule(sd, ins, attrs, node):
        raise NotImplementedError(
            f"{op_name} ({node.name}): {why}. The reference's host-side "
            f"interpreter can produce dynamic shapes; an imported graph "
            f"keeps the shapes fixed at import (its plan is captured once "
            f"per input signature) — restructure the model (e.g. "
            f"NonMaxSuppression's padded-output form) or precompute this "
            f"node outside the graph.")
    return rule


for _op_name, _why in [
        ("NonZero", "dynamic-length output (count of nonzeros)"),
        ("Unique", "dynamic-length output (count of distinct values)"),
        ("Compress", "dynamic-length output (count of selected rows)"),
        ("StringNormalizer", "string tensors are unsupported"),
        ("TfIdfVectorizer", "string/sequence processing is unsupported"),
        ("MatMulInteger", "integer matmul with zero points is not "
                          "imported: use DequantizeLinear + MatMul"),
        ("ConvInteger", "integer conv with zero points is not imported: "
                        "use DequantizeLinear + Conv"),
        ("QLinearConv", "fused int8 conv: use DequantizeLinear + Conv"),
        ("QLinearMatMul", "fused int8 matmul: use DequantizeLinear + "
                          "MatMul")]:
    ONNX_OP_MAPPERS[_op_name] = _documented_reject(_op_name, _why)


def _flatten_from(a, *, axis=1):
    """ONNX Flatten: keep the leading ``axis`` dims' product as rows."""
    lead = 1
    for s in a.shape[:axis]:
        lead *= s
    return a.reshape(lead, -1)


# the graph op the dialect records beyond the catalog, registered as the
# JAX importer registers it
_sdmod.GRAPH_OPS.setdefault("flatten_from", _flatten_from)


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


class OnnxImporter(IRImporter):
    """OnnxFrameworkImporter analog."""

    def __init__(self, extra_mappers: Optional[Dict[str, Callable]] = None,
                 optimize: bool = True, validate: bool = True,
                 device: Union[str, torch.device, None] = None):
        rules = dict(ONNX_OP_MAPPERS)
        if extra_mappers:
            rules.update(extra_mappers)
        super().__init__(rules, needs_consts=_NEEDS_CONSTS,
                         needs_scope=_NEEDS_SCOPE, optimize=optimize,
                         validate=validate, device=device)

    def run_import(self, model) -> SameDiff:  # type: ignore[override]
        if isinstance(model, str):
            with open(model, "rb") as f:
                model = f.read()
        if isinstance(model, (bytes, bytearray)):
            model = parse_model(bytes(model))
        return super().run_import(model)


def import_onnx(path_or_bytes, optimize: bool = True, validate: bool = True,
                device: Union[str, torch.device, None] = None) -> SameDiff:
    """One-call facade: ONNX bytes or a file path → a SameDiff on
    ``device`` (the card when None). ``optimize=False`` turns the pass
    pipeline off; ``validate=False`` skips the post-import graftcheck."""
    return OnnxImporter(optimize=optimize, validate=validate,
                        device=device).run_import(path_or_bytes)
