"""ONNX import → a port SameDiff graph (samediff-import-onnx analog).

Counterpart of ``deeplearning4j_tpu/imports/onnx_import.py``: ONNX
ModelProto bytes are decoded by the in-repo wire codec
(:mod:`.protowire` — no onnx package), normalized to
:class:`~.ir.IRGraph`, and mapped by the dialect table below onto the
port's SameDiff op catalog; :func:`import_onnx` returns a SameDiff whose
arrays live on the card (``device="cpu"`` for tests), optimized on first
execution by the pass pipeline whose fusion tier reaches the hand-written
kernels.

Mapped: what an exported BERT encoder needs — Gather, Add, Sub, Mul, Div,
Pow, Sqrt, Erf, MatMul, Reshape, Transpose, Unsqueeze, Cast, Softmax,
Dropout, Identity, ReduceMean — and Gemm, Relu, Tanh, Sigmoid, Gelu,
LayerNormalization, Constant, Flatten, Concat and Squeeze. ``Gelu`` maps
to the tanh-approximate ``gelu`` whatever its ``approximate`` attribute,
as the JAX package maps it. The JAX package's other ~125 rules (conv and
pooling, recurrent, control flow, detection, quantization, random ops) are
not ported yet (ROADMAP.md, Queue 1 item 6); an op without a rule raises
at import, naming it.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff import samediff as _sdmod
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.imports import protowire as pw
from deeplearning4j_tpu_torch.imports.ir import IRGraph, IRImporter, IRNode

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
    return name, arr.reshape(dims) if dims else arr


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
                 "ReduceMean", "Concat"}


def register_onnx_op(name: str):
    def wrap(fn):
        ONNX_OP_MAPPERS[name] = fn
        return fn

    return wrap


def _unary(sd_op: str):
    def rule(sd, ins, attrs, node):
        return sd._record(sd_op, [ins[0]])

    return rule


for _onnx, _sd in [("Relu", "relu"), ("Sigmoid", "sigmoid"),
                   ("Tanh", "tanh"), ("Sqrt", "sqrt"), ("Erf", "erf"),
                   ("Gelu", "gelu")]:
    ONNX_OP_MAPPERS[_onnx] = _unary(_sd)

for _onnx, _sd in [("Add", "add"), ("Sub", "sub"), ("Mul", "mul"),
                   ("Div", "div"), ("Pow", "pow")]:
    def _bin_rule(sd, ins, attrs, node, _op=_sd):
        return sd._record(_op, ins)

    ONNX_OP_MAPPERS[_onnx] = _bin_rule


@register_onnx_op("Softmax")
def _softmax(sd, ins, attrs, node):
    return sd._record("softmax", [ins[0]],
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


@register_onnx_op("ReduceMean")
def _reduce_mean(sd, ins, attrs, node, const_values=None):
    axes = attrs.get("axes")
    if axes is None and len(node.inputs) > 1:
        axes = const_values.get(node.inputs[1])
    return sd._record("reduce_mean", [ins[0]], {
        "axes": None if axes is None else tuple(int(a) for a in axes),
        "keepdims": bool(attrs.get("keepdims", 1))})


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
                 optimize: bool = True, validate: bool = False,
                 device: Union[str, torch.device, None] = None):
        rules = dict(ONNX_OP_MAPPERS)
        if extra_mappers:
            rules.update(extra_mappers)
        super().__init__(rules, needs_consts=_NEEDS_CONSTS,
                         optimize=optimize, validate=validate, device=device)

    def run_import(self, model) -> SameDiff:  # type: ignore[override]
        if isinstance(model, str):
            with open(model, "rb") as f:
                model = f.read()
        if isinstance(model, (bytes, bytearray)):
            model = parse_model(bytes(model))
        return super().run_import(model)


def import_onnx(path_or_bytes, optimize: bool = True, validate: bool = False,
                device: Union[str, torch.device, None] = None) -> SameDiff:
    """One-call facade: ONNX bytes or a file path → a SameDiff on
    ``device`` (the card when None). ``optimize=False`` turns the pass
    pipeline off; ``validate=True`` raises (post-import graph checking is
    not ported)."""
    return OnnxImporter(optimize=optimize, validate=validate,
                        device=device).run_import(path_or_bytes)
