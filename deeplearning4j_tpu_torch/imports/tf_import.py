"""TF import → a port SameDiff graph, read without TensorFlow.

Counterpart of ``deeplearning4j_tpu/imports/tf_import.py``: the same
dialect table (``TF_OP_MAPPERS``, 204 rules under the same names,
``register_tf_op`` to extend it), the same IR lowering (``graphdef_to_ir``
onto :mod:`.ir`'s walker), the same TF2 function-graph control flow
(While/If through the library's FunctionDefs, PartitionedCall inlining)
and TF1 frame collapsing, the same SavedModel variable restore.

What differs from the JAX package:

* No ``tensorflow``: GraphDefs, FunctionDefs and SavedModels are decoded
  by :mod:`.tf_proto` on the port's wire codec, ``Const`` tensors with
  ``MakeNdarray``'s semantics, dtypes from its DataType table, and the
  checkpoint by :mod:`.tensor_bundle` (the LevelDB-format index and the
  data shards).
* Entry points build on the card unless the caller passes
  ``device="cpu"``; ``validate=True`` raises (graph checking is not
  ported).
* While loops and conditionals read their predicate on the host and run
  only the branch it picks (``SameDiff.while_loop_multi`` /
  ``cond_multi``); a graph holding one runs eagerly, by rule.
* The seeded random rules draw from a ``torch.Generator`` seeded as the
  JAX rule seeds its key: the same seed gives the same draw on one device,
  in torch's stream, not JAX's.
"""

from __future__ import annotations

import warnings
import os
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.samediff import (
    GRAPH_OPS as _GRAPH_OPS, SameDiff,
)
from deeplearning4j_tpu_torch.imports import tensor_bundle, tf_proto
from deeplearning4j_tpu_torch.imports.ir import IRGraph, IRImporter, IRNode

# op-name -> mapper(sd, node_inputs: List[SDVariable], attrs, tf_node) -> SDVariable
TF_OP_MAPPERS: Dict[str, Callable[..., Any]] = {}


def register_tf_op(name: str):
    def wrap(fn):
        TF_OP_MAPPERS[name] = fn
        return fn

    return wrap


# ---------------------------------------------------------------------------
# Mapping rules (TensorflowOpDeclarations analog)
# ---------------------------------------------------------------------------


@register_tf_op("MatMul")
def _matmul(sd, ins, attrs, node):
    return sd._record("mmul", ins, {
        "transpose_a": bool(attrs.get("transpose_a", False)),
        "transpose_b": bool(attrs.get("transpose_b", False))})


@register_tf_op("BatchMatMulV2")
@register_tf_op("BatchMatMul")
def _batch_matmul(sd, ins, attrs, node):
    return sd._record("mmul", ins, {
        "transpose_a": bool(attrs.get("adj_x", False)),
        "transpose_b": bool(attrs.get("adj_y", False))})


@register_tf_op("BiasAdd")
@register_tf_op("AddV2")
@register_tf_op("Add")
def _add(sd, ins, attrs, node):
    return sd._record("add", ins)


@register_tf_op("Sub")
def _sub(sd, ins, attrs, node):
    return sd._record("sub", ins)


@register_tf_op("Mul")
def _mul(sd, ins, attrs, node):
    return sd._record("mul", ins)


@register_tf_op("RealDiv")
@register_tf_op("Div")
def _div(sd, ins, attrs, node):
    return sd._record("div", ins)


@register_tf_op("Pow")
def _pow(sd, ins, attrs, node):
    return sd._record("pow", ins)


@register_tf_op("SquaredDifference")
def _sqdiff(sd, ins, attrs, node):
    return sd._record("squared_difference", ins)


@register_tf_op("Maximum")
def _max(sd, ins, attrs, node):
    return sd._record("maximum", ins)


@register_tf_op("Minimum")
def _min(sd, ins, attrs, node):
    return sd._record("minimum", ins)


for _tf, _ours in [
    ("Relu", "relu"), ("Relu6", "relu6"), ("Elu", "elu"), ("Selu", "selu"),
    ("Tanh", "tanh"), ("Sigmoid", "sigmoid"), ("Softplus", "softplus"),
    ("Softsign", "softsign"), ("Exp", "exp"), ("Log", "log"),
    ("Log1p", "log1p"), ("Sqrt", "sqrt"), ("Rsqrt", "rsqrt"),
    ("Square", "square"), ("Abs", "abs"), ("Neg", "neg"), ("Sign", "sign"),
    ("Floor", "floor"), ("Ceil", "ceil"), ("Round", "round"),
    ("Sin", "sin"), ("Cos", "cos"), ("Tan", "tan"), ("Erf", "erf"),
    ("Reciprocal", "reciprocal"), ("Atan", "atan"), ("Asin", "asin"),
    ("Acos", "acos"), ("Sinh", "sinh"), ("Cosh", "cosh"),
]:
    def _make(ours):
        def f(sd, ins, attrs, node):
            return sd._record(ours, ins)

        return f

    TF_OP_MAPPERS[_tf] = _make(_ours)


@register_tf_op("Softmax")
def _softmax(sd, ins, attrs, node):
    return sd._record("softmax", ins, {"axis": -1})


@register_tf_op("LogSoftmax")
def _log_softmax(sd, ins, attrs, node):
    return sd._record("log_softmax", ins, {"axis": -1})


@register_tf_op("Identity")
@register_tf_op("StopGradient")
@register_tf_op("NoOp")
@register_tf_op("CheckNumerics")
def _identity(sd, ins, attrs, node):
    return ins[0] if ins else None


@register_tf_op("Reshape")
def _reshape(sd, ins, attrs, node, const_values=None):
    shape = const_values.get(node.input[1]) if const_values else None
    if shape is None:
        # tf.shape(...)-derived target: stays trace-time concrete through
        # the shape_of chain, so reshape_dynamic recovers the ints there
        return sd._record("reshape_dynamic", [ins[0], ins[1]])
    return sd._record("reshape", [ins[0]], {"shape": tuple(int(s) for s in shape)})


@register_tf_op("Transpose")
def _transpose(sd, ins, attrs, node, const_values=None):
    perm = _require_const(const_values, node, 1, "perm")
    return sd._record("transpose", [ins[0]], {"axes": tuple(int(p) for p in perm)})


@register_tf_op("ExpandDims")
def _expand(sd, ins, attrs, node, const_values=None):
    axis = _require_const(const_values, node, 1, "dim")
    return sd._record("expand_dims", [ins[0]], {"axis": int(axis)})


@register_tf_op("Squeeze")
def _squeeze(sd, ins, attrs, node):
    dims = attrs.get("squeeze_dims") or None
    axis = tuple(dims) if dims else None
    return sd._record("squeeze", ins, {"axis": axis})


@register_tf_op("ConcatV2")
def _concat(sd, ins, attrs, node, const_values=None):
    axis = const_values.get(node.input[-1])
    data_ins = [i for i in node.input[:-1] if not i.startswith("^")]
    if all(n in const_values for n in data_ins):
        # const-fold shape chains (Fill/Range → Concat → Reshape)
        const_values[node.name] = np.concatenate(
            [np.atleast_1d(const_values[n]) for n in data_ins],
            axis=int(axis))
    return sd._record("concat", ins[:-1], {"axis": int(axis)})


@register_tf_op("Mean")
def _mean(sd, ins, attrs, node, const_values=None):
    axes = const_values.get(node.input[1])
    keep = bool(attrs.get("keep_dims", False))
    axes = tuple(int(a) for a in np.atleast_1d(axes))
    return sd._record("reduce_mean", [ins[0]], {"axes": axes, "keepdims": keep})


@register_tf_op("Sum")
def _sum(sd, ins, attrs, node, const_values=None):
    axes = const_values.get(node.input[1])
    keep = bool(attrs.get("keep_dims", False))
    axes = tuple(int(a) for a in np.atleast_1d(axes))
    return sd._record("reduce_sum", [ins[0]], {"axes": axes, "keepdims": keep})


@register_tf_op("Max")
def _reduce_max(sd, ins, attrs, node, const_values=None):
    axes = const_values.get(node.input[1])
    keep = bool(attrs.get("keep_dims", False))
    axes = tuple(int(a) for a in np.atleast_1d(axes))
    return sd._record("reduce_max", [ins[0]], {"axes": axes, "keepdims": keep})


@register_tf_op("GatherV2")
def _gather(sd, ins, attrs, node, const_values=None):
    axis = const_values.get(node.input[2], 0)
    return sd._record("gather", ins[:2], {"axis": int(axis)})


@register_tf_op("Conv2D")
def _conv2d(sd, ins, attrs, node):
    strides = attrs.get("strides", [1, 1, 1, 1])
    padding = attrs.get("padding", b"SAME")
    pad = padding.decode().lower() if isinstance(padding, bytes) else str(padding).lower()
    if attrs.get("data_format", b"NHWC") not in (b"NHWC", "NHWC"):
        raise ValueError("only NHWC Conv2D import supported")
    return sd._record("conv2d", ins, {"stride": (int(strides[1]), int(strides[2])),
                                      "padding": pad})


@register_tf_op("MaxPool")
def _maxpool(sd, ins, attrs, node):
    k = attrs.get("ksize", [1, 2, 2, 1])
    s = attrs.get("strides", [1, 2, 2, 1])
    padding = attrs.get("padding", b"VALID")
    pad = padding.decode().lower() if isinstance(padding, bytes) else str(padding).lower()
    return sd._record("maxpool2d", ins, {"kernel": (int(k[1]), int(k[2])),
                                         "stride": (int(s[1]), int(s[2])),
                                         "padding": pad})


@register_tf_op("AvgPool")
def _avgpool(sd, ins, attrs, node):
    k = attrs.get("ksize", [1, 2, 2, 1])
    s = attrs.get("strides", [1, 2, 2, 1])
    padding = attrs.get("padding", b"VALID")
    pad = padding.decode().lower() if isinstance(padding, bytes) else str(padding).lower()
    return sd._record("avgpool2d", ins, {"kernel": (int(k[1]), int(k[2])),
                                         "stride": (int(s[1]), int(s[2])),
                                         "padding": pad})


@register_tf_op("Cast")
def _cast(sd, ins, attrs, node, const_values=None):
    dst = attrs.get("DstT")
    if const_values is not None and node.input[0] in const_values:
        # constant-fold: shape/limit chains (e.g. Range's Cast'ed bounds)
        # stay resolvable as const operands downstream
        folded = np.asarray(const_values[node.input[0]]).astype(
            tf_proto.numpy_dtype(dst) if dst is not None else np.float32)
        const_values[node.name] = folded
    return sd._record("cast", ins, {
        "dtype": tf_proto.numpy_dtype_name(dst) if dst is not None
        else "float32"})


@register_tf_op("Pack")
def _pack(sd, ins, attrs, node, const_values=None):
    data_ins = [i for i in node.input if not i.startswith("^")]
    if const_values is not None and all(n in const_values for n in data_ins):
        # const-fold shape chains (scalar dims → Pack → Reshape)
        const_values[node.name] = np.stack(
            [np.asarray(const_values[n]) for n in data_ins],
            axis=int(attrs.get("axis", 0)))
    return sd._record("stack", ins, {"axis": int(attrs.get("axis", 0))})


@register_tf_op("Tile")
def _tile(sd, ins, attrs, node, const_values=None):
    reps = _require_const(const_values, node, 1, "multiples")
    return sd._record("tile", [ins[0]], {"reps": tuple(int(r) for r in reps)})


@register_tf_op("Select")
@register_tf_op("SelectV2")
def _select(sd, ins, attrs, node):
    return sd._record("where", ins)


@register_tf_op("Greater")
def _greater(sd, ins, attrs, node):
    return sd._record("gt", ins)


@register_tf_op("Less")
def _less(sd, ins, attrs, node):
    return sd._record("lt", ins)


@register_tf_op("Equal")
def _equal(sd, ins, attrs, node):
    return sd._record("eq", ins)


@register_tf_op("DepthwiseConv2dNative")
def _depthwise_conv(sd, ins, attrs, node):
    if attrs.get("data_format", b"NHWC") not in (b"NHWC", "NHWC"):
        raise ValueError("only NHWC DepthwiseConv2dNative import supported")
    if [int(d) for d in attrs.get("dilations", [1, 1, 1, 1])] != [1, 1, 1, 1]:
        raise NotImplementedError("dilated DepthwiseConv2dNative import")
    strides = attrs.get("strides", [1, 1, 1, 1])
    padding = attrs.get("padding", b"SAME")
    pad = padding.decode().lower() if isinstance(padding, bytes) else str(padding).lower()
    return sd._record("depthwise_conv2d", ins,
                      {"stride": (int(strides[1]), int(strides[2])),
                       "padding": pad})


@register_tf_op("FusedBatchNormV3")
@register_tf_op("FusedBatchNorm")
def _fused_bn(sd, ins, attrs, node):
    """inference-mode fused BN: inputs x, scale, offset, mean, var (NHWC)."""
    if attrs.get("data_format", b"NHWC") not in (b"NHWC", "NHWC"):
        raise ValueError("only NHWC FusedBatchNorm import supported")
    x, scale, offset, mean, var = ins[:5]
    return sd._record("batch_norm_graph", [x, mean, var, scale, offset],
                      {"eps": float(attrs.get("epsilon", 1e-3))})


@register_tf_op("LeakyRelu")
def _tf_leaky(sd, ins, attrs, node):
    return sd._record("leakyrelu", ins,
                      {"alpha": float(attrs.get("alpha", 0.2))})


@register_tf_op("Pad")
@register_tf_op("PadV2")
def _tf_pad(sd, ins, attrs, node, const_values=None):
    pads = _require_const(const_values, node, 1, "paddings")
    value = 0.0
    if len(node.input) > 2:
        cv = const_values.get(node.input[2].split(":")[0])
        if cv is not None:
            value = float(cv)
    return sd._record("pad", [ins[0]],
                      {"paddings": tuple((int(a), int(b)) for a, b in pads),
                       "value": value})


@register_tf_op("StridedSlice")
def _tf_strided_slice(sd, ins, attrs, node, const_values=None):
    """Full mask support (begin/end/shrink/new_axis/ellipsis) — everything
    Python slicing compiles to, resolved at trace time by the
    strided_slice_spec op (so ellipsis works on operands whose rank is
    only known at execution)."""
    begin = [int(b) for b in _require_const(const_values, node, 1, "begin")]
    end = [int(e) for e in _require_const(const_values, node, 2, "end")]
    strides = [int(s) for s in
               _require_const(const_values, node, 3, "strides")]
    return sd._record("strided_slice_spec", [ins[0]], {
        "begin": begin, "end": end, "strides": strides,
        "begin_mask": int(attrs.get("begin_mask", 0)),
        "end_mask": int(attrs.get("end_mask", 0)),
        "shrink_mask": int(attrs.get("shrink_axis_mask", 0)),
        "new_axis_mask": int(attrs.get("new_axis_mask", 0)),
        "ellipsis_mask": int(attrs.get("ellipsis_mask", 0))})


@register_tf_op("Unpack")
def _tf_unpack(sd, ins, attrs, node):
    # single-output use only: the common tf.unstack(x)[0] pattern — with
    # num > 1 every :k consumer would silently receive element 0
    if int(attrs.get("num", 1)) > 1 or int(attrs.get("axis", 0)) != 0:
        raise NotImplementedError(
            f"Unpack {node.name}: num={attrs.get('num')}/axis="
            f"{attrs.get('axis', 0)} — only single-element axis-0 unstack "
            "imports")
    return sd._record("unstack_first", ins)


@register_tf_op("ArgMax")
def _tf_argmax(sd, ins, attrs, node, const_values=None):
    axis = _require_const(const_values, node, 1, "dimension") \
        if len(node.input) > 1 else -1
    return sd._record("argmax", [ins[0]], {"axis": int(axis)})


@register_tf_op("ArgMin")
def _tf_argmin(sd, ins, attrs, node, const_values=None):
    axis = _require_const(const_values, node, 1, "dimension") \
        if len(node.input) > 1 else -1
    return sd._record("argmin", [ins[0]], {"axis": int(axis)})


@register_tf_op("Prod")
def _tf_prod(sd, ins, attrs, node, const_values=None):
    axes = _require_const(const_values, node, 1, "reduction axes")
    return sd._record("reduce_prod", [ins[0]], {
        "axes": tuple(int(a) for a in np.atleast_1d(axes)),
        "keepdims": bool(attrs.get("keep_dims", False))})


@register_tf_op("Min")
def _tf_reduce_min(sd, ins, attrs, node, const_values=None):
    axes = _require_const(const_values, node, 1, "reduction axes")
    return sd._record("reduce_min", [ins[0]], {
        "axes": tuple(int(a) for a in np.atleast_1d(axes)),
        "keepdims": bool(attrs.get("keep_dims", False))})


@register_tf_op("ClipByValue")
def _tf_clip(sd, ins, attrs, node, const_values=None):
    lo = float(_require_const(const_values, node, 1, "clip_value_min"))
    hi = float(_require_const(const_values, node, 2, "clip_value_max"))
    return sd._record("clip_by_value_graph", [ins[0]],
                      {"min_value": lo, "max_value": hi})


@register_tf_op("Cumsum")
def _tf_cumsum(sd, ins, attrs, node, const_values=None):
    axis = _require_const(const_values, node, 1, "axis")
    return sd._record("cumsum", [ins[0]], {
        "axis": int(axis),
        "exclusive": bool(attrs.get("exclusive", False)),
        "reverse": bool(attrs.get("reverse", False))})


@register_tf_op("GreaterEqual")
def _tf_gte(sd, ins, attrs, node):
    return sd._record("gte", ins)


@register_tf_op("LessEqual")
def _tf_lte(sd, ins, attrs, node):
    return sd._record("lte", ins)


@register_tf_op("NotEqual")
def _tf_neq(sd, ins, attrs, node):
    return sd._record("neq", ins)


@register_tf_op("ZerosLike")
def _tf_zeros_like(sd, ins, attrs, node):
    return sd._record("zeros_like", ins)


@register_tf_op("OnesLike")
def _tf_ones_like(sd, ins, attrs, node):
    return sd._record("ones_like", ins)


def _require_const(const_values, node, idx, what):
    name = node.input[idx].split(":")[0]
    val = (const_values or {}).get(name)
    if val is None:
        raise ValueError(
            f"{node.op_type} {node.name}: dynamic (non-Const) {what} operand "
            f"'{node.input[idx]}' is unsupported")
    return val


@register_tf_op("AvgPool3D")
@register_tf_op("MaxPool3D")
def _tf_pool3d_unsupported(sd, ins, attrs, node):
    raise NotImplementedError("3-D pooling import is not supported yet")


# ---------------------------------------------------------------------------
# The importer
# ---------------------------------------------------------------------------

_CONST_ONLY_OPS = {"Const", "Placeholder", "PlaceholderWithDefault"}
# mappers that need raw const operand values (shape/perm/axis inputs)
_NEEDS_CONSTS = {"Cast", "Pack", "Reshape", "Transpose", "ExpandDims", "ConcatV2", "Mean",
                 "Sum", "Max", "Min", "Prod", "GatherV2", "Tile", "Pad",
                 "PadV2", "StridedSlice", "ArgMax", "ArgMin", "ClipByValue",
                 "Cumsum"}


def graphdef_to_ir(graph_def, variable_values=None) -> IRGraph:
    """TF GraphDef (a :class:`~.tf_proto.GraphDef`) → framework-neutral
    IRGraph (imports/ir.py): Const nodes become initializers, Placeholders
    become graph inputs, everything else an IRNode with normalized
    attrs."""
    nodes: List = []
    initializers: Dict[str, np.ndarray] = {}
    inputs: List = []
    library = {f.signature.name: f for f in graph_def.library.function}
    for node in graph_def.node:
        if node.op == "Const":
            initializers[node.name] = node.attr["value"].tensor
            continue
        if node.op in ("Placeholder", "PlaceholderWithDefault"):
            shape = None
            if "shape" in node.attr:
                dims = node.attr["shape"].shape.dim
                shape = tuple(d.size if d.size > 0 else None for d in dims)
            inputs.append((node.name, shape))
            continue
        attrs = {k: _attr_value(v) for k, v in node.attr.items()}

        def norm(i):
            # keep multi-output slot addressing ("op:1"); the default ":0"
            # slot normalizes to the bare name
            if ":" in i:
                base, slot = i.rsplit(":", 1)
                if slot == "0":
                    return base
            return i

        # control-dep inputs ("^name") are ordering-only — the graph's
        # dataflow subsumes them; they are NOT data operands
        in_names = [norm(i) for i in node.input if not i.startswith("^")]
        if node.op in _CONTROL_FLOW_OPS or node.op in _CALL_OPS:
            attrs["_library"] = library  # branch/body lookup for the mapper
        if node.op in _VARIABLE_OPS:
            attrs["_var_values"] = variable_values or {}
        nodes.append(IRNode(name=node.name, op_type=node.op,
                            inputs=in_names, outputs=[node.name],
                            attrs=attrs))
    return IRGraph(nodes=nodes, initializers=initializers, inputs=inputs,
                   outputs=[], name="tensorflow")


class TensorflowImporter:
    """FrameworkImporter analog for TF frozen GraphDefs — a thin frontend
    over the shared IR walker (imports/ir.IRImporter): parse to IRGraph,
    dispatch the TF dialect rule table. ``device``: where the imported
    SameDiff keeps its arrays (the card unless the caller passes
    ``"cpu"``); ``optimize`` / ``validate``: the walker's defaults for
    :meth:`run_import` (``validate=True`` raises: graph checking is not
    ported)."""

    def __init__(self, extra_mappers: Optional[Dict[str, Callable]] = None,
                 *, optimize: bool = True, validate: bool = False,
                 device: Union[str, torch.device, None] = None):
        self.mappers = dict(TF_OP_MAPPERS)
        if extra_mappers:
            self.mappers.update(extra_mappers)
        self.optimize = optimize
        self.validate = validate
        self.device = device

    def supported_ops(self) -> List[str]:
        return sorted(self.mappers)

    def run_import(self, graph_def, *, trainable_consts: bool = True,
                   variable_values=None, outputs=None,
                   optimize: Optional[bool] = None,
                   validate: Optional[bool] = None) -> SameDiff:
        """GraphDef (serialized bytes, a .pb path, a parsed
        :class:`~.tf_proto.GraphDef`, or any message with
        ``SerializeToString``) → SameDiff.

        ``variable_values``: name → ndarray table for VarHandleOp /
        VariableV2 nodes (the TFGraphMapper checkpoint-restore path) —
        restored values become VARIABLE-role SDVariables, so fine-tuning
        starts from the trained weights. ``optimize`` / ``validate``
        override the importer's own."""
        graph_def = _coerce_graph_def(graph_def)
        ir = graphdef_to_ir(graph_def, variable_values=variable_values)
        if outputs:
            ir.outputs = list(outputs)
        ir = _inline_function_calls(ir, variable_values)
        ir = _collapse_tf1_control_flow(ir)
        walker = IRImporter(
            self.mappers, needs_consts=_NEEDS_CONSTS,
            trainable_consts=trainable_consts,
            optimize=self.optimize if optimize is None else optimize,
            validate=self.validate if validate is None else validate,
            device=self.device)
        return walker.run_import(ir)


def _coerce_graph_def(g):
    if isinstance(g, tf_proto.GraphDef):
        return g
    if isinstance(g, str):
        with open(g, "rb") as f:
            g = f.read()
    elif hasattr(g, "SerializeToString"):
        g = g.SerializeToString()
    return tf_proto.parse_graph_def(g)


def _attr_value(v):
    kind = v.WhichOneof("value")
    if kind == "func":
        return v.func.name  # function-library reference (While/If branches)
    if kind == "i":
        return v.i
    if kind == "f":
        return v.f
    if kind == "b":
        return v.b
    if kind == "s":
        return v.s
    if kind == "list":
        lst = v.list
        for field in ("i", "f", "b", "s"):
            vals = list(getattr(lst, field))
            if vals:
                return vals
        return []
    if kind == "type":
        return v.type
    if kind == "shape":
        return v.shape
    return v


def import_frozen_graph(path_or_bytes, *, optimize: bool = True,
                        validate: bool = False,
                        device: Union[str, torch.device, None] = None
                        ) -> SameDiff:
    """Convenience one-call import (KerasModelImport-style facade): a
    frozen GraphDef's bytes or a .pb path → a SameDiff on ``device`` (the
    card when None)."""
    return TensorflowImporter(optimize=optimize, validate=validate,
                              device=device).run_import(path_or_bytes)


# ---------------------------------------------------------------------------
# Shape/indexing + math + image ops.
# ---------------------------------------------------------------------------


@register_tf_op("Split")
def _split(sd, ins, attrs, node, const_values=None):
    # TF Split: (axis, value); num_split is an attr
    axis = _require_const(const_values, node, 0, "axis")
    n = int(attrs.get("num_split"))
    return sd._record("split", [ins[-1]],
                      {"num_split": n, "axis": int(axis)}, n_out=n)


@register_tf_op("SplitV")
def _split_v(sd, ins, attrs, node, const_values=None):
    sizes = _require_const(const_values, node, 1, "size_splits")
    axis = _require_const(const_values, node, 2, "axis")
    sizes = tuple(int(s) for s in np.atleast_1d(sizes))
    return sd._record("split_v", [ins[0]],
                      {"sizes": sizes, "axis": int(axis)},
                      n_out=len(sizes))


@register_tf_op("OneHot")
def _one_hot(sd, ins, attrs, node, const_values=None):
    depth = _require_const(const_values, node, 1, "depth")
    on = _require_const(const_values, node, 2, "on_value") \
        if len(node.input) > 2 else None
    off = _require_const(const_values, node, 3, "off_value") \
        if len(node.input) > 3 else None
    if int(attrs.get("axis", -1)) != -1:
        raise NotImplementedError("OneHot with axis != -1 import")
    oh = sd._record("one_hot_graph", [ins[0]], {"depth": int(depth)})
    on_v = 1.0 if on is None else float(np.asarray(on).item())
    off_v = 0.0 if off is None else float(np.asarray(off).item())
    if on_v == 1.0 and off_v == 0.0:
        return oh
    # label-smoothing style: off + (on - off) * onehot
    scaled = sd._record("mul", [oh, sd.constant(
        node.name + "_scale", np.asarray(on_v - off_v, np.float32))])
    return sd._record("add", [scaled, sd.constant(
        node.name + "_off", np.asarray(off_v, np.float32))])


@register_tf_op("Range")
def _range(sd, ins, attrs, node, const_values=None):
    start = _require_const(const_values, node, 0, "start")
    limit = _require_const(const_values, node, 1, "limit")
    delta = _require_const(const_values, node, 2, "delta") \
        if len(node.input) > 2 else 1
    arr = np.arange(np.asarray(start).item(), np.asarray(limit).item(),
                    np.asarray(delta).item())
    const_values[node.name] = arr  # keep shape chains const-resolvable
    return sd.constant(node.name + "_range", arr)


@register_tf_op("Fill")
def _fill(sd, ins, attrs, node, const_values=None):
    dims = _require_const(const_values, node, 0, "dims")
    value = _require_const(const_values, node, 1, "value")
    arr = np.full(tuple(int(d) for d in np.atleast_1d(dims)),
                  np.asarray(value).item())
    const_values[node.name] = arr  # keep shape chains const-resolvable
    return sd.constant(node.name + "_fill", arr)


@register_tf_op("Slice")
def _slice(sd, ins, attrs, node, const_values=None):
    begin = _require_const(const_values, node, 1, "begin")
    size = _require_const(const_values, node, 2, "size")
    return sd._record("slice", [ins[0]],
                      {"begin": tuple(int(b) for b in np.atleast_1d(begin)),
                       "size": tuple(int(s) for s in np.atleast_1d(size))})


@register_tf_op("BroadcastTo")
def _broadcast_to(sd, ins, attrs, node, const_values=None):
    shape = _require_const(const_values, node, 1, "shape")
    return sd._record("broadcast_to", [ins[0]],
                      {"shape": tuple(int(s) for s in np.atleast_1d(shape))})


@register_tf_op("FloorDiv")
def _floordiv(sd, ins, attrs, node):
    return sd._record("floordiv", ins)


@register_tf_op("FloorMod")
def _floormod(sd, ins, attrs, node):
    return sd._record("floormod", ins)


@register_tf_op("Atan2")
def _atan2(sd, ins, attrs, node):
    return sd._record("atan2", ins)


@register_tf_op("SpaceToDepth")
def _space_to_depth(sd, ins, attrs, node):
    fmt = attrs.get("data_format", b"NHWC")
    fmt = fmt.decode() if isinstance(fmt, bytes) else str(fmt)
    return sd._record("space_to_depth", ins,
                      {"block_size": int(attrs["block_size"]),
                       "data_format": fmt})


@register_tf_op("DepthToSpace")
def _depth_to_space(sd, ins, attrs, node):
    fmt = attrs.get("data_format", b"NHWC")
    fmt = fmt.decode() if isinstance(fmt, bytes) else str(fmt)
    return sd._record("depth_to_space", ins,
                      {"block_size": int(attrs["block_size"]),
                       "data_format": fmt})


@register_tf_op("ResizeBilinear")
def _resize_bilinear_tf(sd, ins, attrs, node, const_values=None):
    if not bool(attrs.get("half_pixel_centers", False)):
        raise NotImplementedError(
            "legacy ResizeBilinear (half_pixel_centers=false) import — "
            "re-export with tf.image.resize (TF2 semantics)")
    size = _require_const(const_values, node, 1, "size")
    return sd._record("resize_bilinear", [ins[0]],
                      {"size": tuple(int(s) for s in np.atleast_1d(size))})


@register_tf_op("ResizeNearestNeighbor")
def _resize_nn_tf(sd, ins, attrs, node, const_values=None):
    if not bool(attrs.get("half_pixel_centers", False)) \
            or bool(attrs.get("align_corners", False)):
        raise NotImplementedError(
            "legacy ResizeNearestNeighbor (half_pixel_centers=false or "
            "align_corners=true) import — re-export with tf.image.resize "
            "(TF2 semantics)")
    size = _require_const(const_values, node, 1, "size")
    return sd._record("resize_nearest_neighbor", [ins[0]],
                      {"size": tuple(int(s) for s in np.atleast_1d(size))})


_NEEDS_CONSTS |= {"Split", "SplitV", "OneHot", "Range", "Fill", "Slice",
                  "BroadcastTo", "ResizeBilinear", "ResizeNearestNeighbor"}


@register_tf_op("TopKV2")
def _topk(sd, ins, attrs, node, const_values=None):
    k = _require_const(const_values, node, 1, "k")
    return sd._record("top_k", [ins[0]], {"k": int(k)}, n_out=2)


_NEEDS_CONSTS.add("TopKV2")


# ---------------------------------------------------------------------------
# TF2 function-graph control flow.
#
# Reference parity: org/nd4j/imports/graphmapper/tf/TFGraphMapper.java +
# org/nd4j/autodiff/samediff/internal/AbstractSession.java loop frames —
# the reference executes While/If by interpreting frames; here each branch
# FunctionDef imports into its own SameDiff and runs through
# SameDiff.while_loop_multi / cond_multi (the predicate read on the host).
# ---------------------------------------------------------------------------

_CONTROL_FLOW_OPS = {"While", "StatelessWhile", "If", "StatelessIf"}


def _function_ir(fdef, library):
    """FunctionDef → IRGraph. Function-body tensor addressing is
    'node:out_arg:idx' (vs the main graph's 'node:idx'); both normalize to
    the bare node name for slot 0 and 'node:idx' otherwise — ``idx`` taken
    as the slot, as the JAX package takes it (exact for ops whose outputs
    are one arg each)."""

    def norm(t):
        parts = t.split(":")
        if len(parts) == 1:
            return t  # plain input-arg reference
        if len(parts) == 3:
            base, _out_arg, idx = parts
            return base if idx == "0" else f"{base}:{idx}"
        base, idx = parts
        return base if idx == "0" else t

    nodes: List = []
    initializers: Dict[str, np.ndarray] = {}
    inputs = [(arg.name, None) for arg in fdef.signature.input_arg]
    for node in fdef.node_def:
        if node.op == "Const":
            initializers[node.name] = node.attr["value"].tensor
            continue
        attrs = {k: _attr_value(v) for k, v in node.attr.items()}
        if node.op in _CONTROL_FLOW_OPS or node.op in _CALL_OPS:
            attrs["_library"] = library  # nested control flow recurses
        in_names = [norm(i) for i in node.input if not i.startswith("^")]
        nodes.append(IRNode(name=node.name, op_type=node.op,
                            inputs=in_names, outputs=[node.name],
                            attrs=attrs))
    outputs = [norm(fdef.ret[arg.name]) for arg in fdef.signature.output_arg]
    return IRGraph(nodes=nodes, initializers=initializers, inputs=inputs,
                   outputs=outputs, name="tf_function")


def _function_callable(fname, library, device=None):
    """Import a library FunctionDef and wrap it as a callable over tensors
    (*vals) -> value | tuple(values) — a thin FunctionDef frontend over
    _ir_callable (the shared sub-graph execution wrapper)."""
    fdef = library.get(fname)
    if fdef is None:
        raise ValueError(f"control-flow branch function '{fname}' is not in "
                         f"the GraphDef function library")
    in_names = [a.name for a in fdef.signature.input_arg]
    return _ir_callable(_function_ir(fdef, library), in_names, device)


@register_tf_op("While")
@register_tf_op("StatelessWhile")
def _tf_while(sd, ins, attrs, node):
    library = attrs["_library"]
    cond_call, _ = _function_callable(attrs["cond"], library, sd.device)
    body_call, n_body_out = _function_callable(attrs["body"], library,
                                               sd.device)
    if n_body_out != len(ins):
        raise ValueError(
            f"While {node.name}: body returns {n_body_out} values for "
            f"{len(ins)} loop variables")

    def cond_fn(carry):
        return cond_call(*carry)

    def body_fn(carry):
        out = body_call(*carry)
        return out if isinstance(out, tuple) else (out,)

    return sd.while_loop_multi(cond_fn, body_fn, ins)


@register_tf_op("If")
@register_tf_op("StatelessIf")
def _tf_if(sd, ins, attrs, node):
    library = attrs["_library"]
    then_call, n_then = _function_callable(attrs["then_branch"], library,
                                           sd.device)
    else_call, n_else = _function_callable(attrs["else_branch"], library,
                                           sd.device)
    if n_then != n_else:
        raise ValueError(f"If {node.name}: branch arities differ "
                         f"({n_then} vs {n_else})")

    if n_then == 1:
        # single-output branches return the bare value (a 1-tuple would
        # leak into the recorded node's single output slot)
        return sd.cond_multi(ins[0], then_call, else_call, ins[1:], n_out=1)

    def tuple_of(call):
        def fn(*vals):
            out = call(*vals)
            return out if isinstance(out, tuple) else (out,)

        return fn

    return sd.cond_multi(ins[0], tuple_of(then_call), tuple_of(else_call),
                         ins[1:], n_out=n_then)


# ---------------------------------------------------------------------------
# TF1 frame control flow: the form `convert_variables_to_constants_v2`
# emits by DEFAULT (lower_control_flow=True) and the form every legacy
# frozen .pb carries. Enter/Merge/Switch/Exit/NextIteration/LoopCond frames
# collapse into one synthetic while node per frame; frameless Switch/Merge
# conditionals collapse into pred-selects (both branches run — pure frozen
# graphs make that safe).
#
# Reference parity: org/nd4j/autodiff/samediff/internal/AbstractSession.java
# interprets these frames at runtime; here each frame is one while loop.
# ---------------------------------------------------------------------------


def _base(t: str) -> str:
    return t.split(":")[0]


def _collect_subgraph(roots, leaf_names, producer, initializers):
    """Backward ancestor walk from ``roots`` stopping at ``leaf_names``
    (exact tensor refs or bare node names) and at initializers. Returns
    (nodes in topological order, initializer subset)."""
    nodes, inits, seen = [], {}, set()
    # iterative post-order (deep sequential graphs blow the Python
    # recursion limit) — the `expanded` flag marks the second visit,
    # after all ancestors are emitted, preserving topological order
    stack = [(r, False) for r in reversed(list(roots))]
    while stack:
        t, expanded = stack.pop()
        if expanded:
            nodes.append(producer[_base(t)])
            continue
        if t in leaf_names:
            continue
        base = _base(t)
        if base in leaf_names or base in seen:
            continue
        if base in initializers:
            inits[base] = initializers[base]
            continue
        n = producer.get(base)
        if n is None:
            continue  # main-graph placeholder or unresolvable — walker errors later
        seen.add(base)
        stack.append((t, True))
        for i in reversed(n.inputs):
            stack.append((i, False))
    return nodes, inits


def _collapse_tf1_control_flow(ir):
    """IRGraph → IRGraph with TF1 frames and frameless conds collapsed."""
    ops = {n.op_type for n in ir.nodes}
    if not ({"Enter", "Switch", "Merge"} & ops):
        return ir

    producer = {n.name: n for n in ir.nodes}
    consumers: Dict[str, List] = {}
    for n in ir.nodes:
        for i in n.inputs:
            consumers.setdefault(_base(i), []).append(n)

    # ---- frames ------------------------------------------------------------
    frames: Dict[str, List] = {}
    for n in ir.nodes:
        if n.op_type == "Enter":
            fname = n.attrs.get("frame_name", b"")
            fname = fname.decode() if isinstance(fname, bytes) else str(fname)
            frames.setdefault(fname, []).append(n)

    removed: set = set()
    synthetic: List[Tuple[int, IRNode]] = []  # (insert position, node)
    order = {n.name: i for i, n in enumerate(ir.nodes)}

    for fname, enters in frames.items():
        # forward BFS from the Enter outputs to find the frame's control nodes
        member: set = set()
        frontier = [e.name for e in enters]
        loopcond = None
        while frontier:
            nm = frontier.pop()
            for c in consumers.get(nm, []):
                if c.name in member:
                    continue
                if c.op_type == "Enter":
                    raise NotImplementedError(
                        f"nested TF1 loop frames (frame '{fname}' feeds "
                        f"Enter '{c.name}') are not supported")
                member.add(c.name)
                if c.op_type == "LoopCond":
                    loopcond = c
                if c.op_type != "Exit":  # frame boundary: don't cross
                    frontier.append(c.name)
        if loopcond is None:
            raise ValueError(f"TF1 frame '{fname}' has no LoopCond node")

        # per-variable chains: Enter -> Merge -> Switch -> (Exit?, NextIteration)
        real_vars, invariants = [], []
        for e in enters:
            merge = next((c for c in consumers.get(e.name, [])
                          if c.op_type == "Merge"), None)
            if merge is None:
                invariants.append(e)  # loop-invariant (is_constant) Enter
                continue
            switch = next((c for c in consumers.get(merge.name, [])
                           if c.op_type == "Switch"), None)
            if switch is None:
                raise ValueError(f"frame '{fname}': Merge {merge.name} has "
                                 f"no Switch consumer")
            exit_n = next((c for c in consumers.get(switch.name, [])
                           if c.op_type == "Exit"), None)
            ni_name = _base(merge.inputs[1])
            next_it = producer.get(ni_name)
            if next_it is None or next_it.op_type != "NextIteration":
                raise ValueError(f"frame '{fname}': Merge {merge.name} second "
                                 f"input is not a NextIteration")
            real_vars.append((e, merge, switch, exit_n, next_it))

        cond_inputs = [m.name for _, m, _, _, _ in real_vars] + \
            [e.name for e in invariants]
        body_inputs = [f"{s.name}:1" for _, _, s, _, _ in real_vars] + \
            [e.name for e in invariants]

        cond_root = loopcond.inputs[0]
        body_roots = [ni.inputs[0] for _, _, _, _, ni in real_vars]
        leafset = set(cond_inputs) | set(body_inputs)
        cond_nodes, cond_inits = _collect_subgraph(
            [cond_root], leafset, producer, ir.initializers)
        body_nodes, body_inits = _collect_subgraph(
            body_roots, leafset, producer, ir.initializers)

        cond_ir = IRGraph(nodes=cond_nodes, initializers=cond_inits,
                          inputs=[(nm, None) for nm in cond_inputs],
                          outputs=[cond_root], name="tf1_cond")
        body_ir = IRGraph(nodes=body_nodes, initializers=body_inits,
                          inputs=[(nm, None) for nm in body_inputs],
                          outputs=list(body_roots), name="tf1_body")

        init_inputs = [e.inputs[0] for e, _, _, _, _ in real_vars] + \
            [e.inputs[0] for e in invariants]
        exit_outputs, exit_slots = [], []
        for j, (_, _, _, exit_n, _) in enumerate(real_vars):
            if exit_n is not None:
                exit_outputs.append(exit_n.name)
                exit_slots.append(j)
        if not exit_outputs:
            raise ValueError(f"frame '{fname}' has no Exit outputs")

        syn = IRNode(
            name=fname or exit_outputs[0], op_type="_TF1While",
            inputs=init_inputs, outputs=exit_outputs,
            attrs={"cond_ir": cond_ir, "body_ir": body_ir,
                   "cond_inputs": cond_inputs, "body_inputs": body_inputs,
                   "n_real": len(real_vars), "exit_slots": exit_slots})

        frame_removed = member | {e.name for e in enters} | \
            {n.name for n in cond_nodes} | {n.name for n in body_nodes}
        removed |= frame_removed
        pos = min(order[nm] for nm in frame_removed if nm in order)
        synthetic.append((pos, syn))

    # ---- frameless conds ---------------------------------------------------
    def switch_crossings(t, seen, out):
        """Collect pred -> {slots} for every Switch crossed on any path
        upstream of tensor ``t``. The walk continues THROUGH a Switch's
        data input (so outer conds are visible past inner ones) but not
        into its pred input (the pred is evaluated before branching).
        Iterative (deep graphs overflow Python recursion)."""
        stack = [t]
        while stack:
            t = stack.pop()
            base = _base(t)
            # memo on the full tensor ref: the same Switch may be crossed at
            # BOTH slots within one branch (a cond nested inside it) and
            # each slot must be recorded
            if t in seen or base in removed:
                continue
            seen.add(t)
            n = producer.get(base)
            if n is None:
                continue
            if n.op_type == "Switch":
                slot = t.split(":")[1] if ":" in t else "0"
                out.setdefault(n.inputs[1], set()).add(slot)
                stack.append(n.inputs[0])
                continue
            stack.extend(n.inputs)

    def resolve_merge_pred(merge):
        """The cond a Merge closes is the pred whose switches are crossed
        with slot 1 on exactly one input and slot 0 on the other — a pred
        crossed with BOTH slots inside one input belongs to a cond nested
        within that branch, not to this Merge."""
        cA: Dict[str, set] = {}
        cB: Dict[str, set] = {}
        switch_crossings(merge.inputs[0], set(), cA)
        switch_crossings(merge.inputs[1], set(), cB)
        for pred in set(cA) | set(cB):
            sA, sB = cA.get(pred, set()), cB.get(pred, set())
            if sA == {"1"} and sB == {"0"}:
                return pred, 0
            if sA == {"0"} and sB == {"1"}:
                return pred, 1
        # one branch never crosses a switch (e.g. constant-only branch):
        # the other branch's single consistent slot decides
        for cX, idx in ((cA, 0), (cB, 1)):
            other = cB if idx == 0 else cA
            for pred, slots in cX.items():
                if len(slots) == 1 and pred not in other:
                    s = next(iter(slots))
                    return pred, idx if s == "1" else 1 - idx
        return None, None

    new_nodes: List[IRNode] = []
    for n in ir.nodes:
        if n.name in removed:
            continue
        if n.op_type == "Switch":
            n = IRNode(name=n.name, op_type="_TFSwitchPassthrough",
                       inputs=[n.inputs[0]],
                       outputs=[n.name, f"{n.name}:1"], attrs={})
        elif n.op_type == "Merge":
            for c in consumers.get(n.name, []):
                if any(i == f"{n.name}:1" for i in c.inputs):
                    raise NotImplementedError(
                        f"Merge {n.name}: value_index output is consumed")
            pred, true_idx = resolve_merge_pred(n)
            if pred is None:
                raise NotImplementedError(
                    f"frameless Merge {n.name}: no switch predicate with "
                    f"consistent branch slots; cannot recover the cond")
            n = IRNode(name=n.name, op_type="_TFMergeSelect",
                       inputs=[n.inputs[0], n.inputs[1], pred],
                       outputs=[n.name], attrs={"true_idx": true_idx})
        new_nodes.append(n)

    for pos, syn in sorted(synthetic, key=lambda x: x[0]):
        # insert before the first surviving node whose original position
        # follows the frame, so consumers of the Exit names come later
        idx = 0
        for idx, nn in enumerate(new_nodes):
            if order.get(nn.name, -1) > pos:
                break
        else:
            idx = len(new_nodes)
        new_nodes.insert(idx, syn)

    return IRGraph(nodes=new_nodes, initializers=ir.initializers,
                   inputs=ir.inputs, outputs=ir.outputs, name=ir.name)


def _ir_callable(ir, in_names, device=None):
    """Import a sub-IRGraph into a private SameDiff on ``device`` and wrap
    it as a callable over tensors (*vals) -> value | tuple(values)."""
    ir = _inline_function_calls(ir)  # helper tf.functions inside bodies
    ir = _collapse_tf1_control_flow(ir)  # conds nested inside loop bodies
    walker = IRImporter(TF_OP_MAPPERS, needs_consts=_NEEDS_CONSTS,
                        trainable_consts=False, device=device)
    sub = walker.run_import(ir)
    out_names = list(sub.graph_outputs)

    def call(*vals):
        env = dict(sub._arrays)
        for n, v in zip(in_names, vals):
            env[n] = v
        res = sub._interpret(env, out_names)
        outs = [res[n] for n in out_names]
        return outs[0] if len(outs) == 1 else tuple(outs)

    return call, len(out_names)


@register_tf_op("_TF1While")
def _tf1_while(sd, ins, attrs, node):
    cond_call, _ = _ir_callable(attrs["cond_ir"], attrs["cond_inputs"],
                                sd.device)
    body_call, _ = _ir_callable(attrs["body_ir"], attrs["body_inputs"],
                                sd.device)
    n_real = attrs["n_real"]

    def cond_fn(carry):
        return cond_call(*carry)

    def body_fn(carry):
        out = body_call(*carry)
        out = out if isinstance(out, tuple) else (out,)
        return tuple(out) + tuple(carry[n_real:])  # invariants pass through

    finals = sd.while_loop_multi(cond_fn, body_fn, ins)
    if not isinstance(finals, tuple):
        finals = (finals,)
    return [finals[j] for j in attrs["exit_slots"]]


@register_tf_op("_TFSwitchPassthrough")
def _tf_switch_passthrough(sd, ins, attrs, node):
    # both branches run eagerly; the paired _TFMergeSelect picks by pred
    a = sd._record("identity", [ins[0]])
    b = sd._record("identity", [ins[0]])
    return (a, b)


@register_tf_op("_TFMergeSelect")
def _tf_merge_select(sd, ins, attrs, node):
    t = attrs["true_idx"]
    return sd._record("select", [ins[2], ins[t], ins[1 - t]])


# ---------------------------------------------------------------------------
# SavedModel import with variable restore.
#
# Reference parity: TFGraphMapper step (1) — restore TF checkpoint variables
# into VARIABLE-role arrays before mapping ops, so fine-tuning
# an imported model starts from its trained weights. TF2 SavedModels route
# the serving computation through StatefulPartitionedCall into the function
# library with VarHandleOp resource captures; the importer inlines the call
# tree into one flat graph, turns each VarHandleOp into a trainable
# SDVariable holding its checkpoint value, and ReadVariableOp into a
# pass-through.
# ---------------------------------------------------------------------------

_CALL_OPS = {"PartitionedCall", "StatefulPartitionedCall"}
_VARIABLE_OPS = {"VarHandleOp", "VariableV2", "VarIsInitializedOp"}


def _inline_function_calls(ir, variable_values=None):
    """Expand PartitionedCall/StatefulPartitionedCall nodes in place: the
    callee's nodes join the graph under a '<call>/' name prefix, its input
    args remap to the call operands, and a tuple alias keeps the call's own
    output names ('call', 'call:1', ...) resolvable. Repeats until no call
    nodes remain (nested wrapper functions)."""
    for _ in range(32):  # nesting depth bound
        if not any(n.op_type in _CALL_OPS for n in ir.nodes):
            return ir
        new_nodes: List[IRNode] = []
        for n in ir.nodes:
            if n.op_type not in _CALL_OPS:
                new_nodes.append(n)
                continue
            library = n.attrs.get("_library") or {}
            fname = n.attrs.get("f")
            fdef = library.get(fname)
            if fdef is None:
                raise ValueError(
                    f"{n.op_type} {n.name}: function '{fname}' is not in "
                    f"the GraphDef library")
            fir = _function_ir(fdef, library)
            prefix = n.name + "/"
            arg_names = [a.name for a in fdef.signature.input_arg]
            argmap = dict(zip(arg_names, n.inputs))
            local = {fn.name for fn in fir.nodes} | set(fir.initializers)

            def remap(t, _argmap=argmap, _local=local, _prefix=prefix):
                base, sep, slot = t.partition(":")
                if base in _argmap:
                    mapped = _argmap[base]
                    return mapped + sep + slot if slot else mapped
                if base in _local:
                    return _prefix + t
                return t  # outer-graph reference (rare; left as-is)

            for iname, arr in fir.initializers.items():
                ir.initializers[prefix + iname] = arr
            for fn_node in fir.nodes:
                attrs = fn_node.attrs
                if fn_node.op_type in _VARIABLE_OPS:
                    # a variable op living INSIDE a function body still
                    # needs the checkpoint table the outer call carried
                    attrs = dict(attrs)
                    attrs.setdefault("_var_values", variable_values or {})
                new_nodes.append(IRNode(
                    name=prefix + fn_node.name, op_type=fn_node.op_type,
                    inputs=[remap(i) for i in fn_node.inputs],
                    outputs=[prefix + fn_node.name], attrs=attrs))
            rets = [remap(o) for o in fir.outputs]
            if not rets:
                continue  # side-effect-only call (init path): nothing to alias
            new_nodes.append(IRNode(name=n.name, op_type="_TFTuple",
                                    inputs=rets, outputs=[n.name], attrs={}))
        ir = IRGraph(nodes=new_nodes, initializers=ir.initializers,
                     inputs=ir.inputs, outputs=ir.outputs, name=ir.name)
    raise ValueError("function-call nesting exceeds 32 levels")


@register_tf_op("_TFTuple")
def _tf_tuple(sd, ins, attrs, node):
    # alias node: exposes an inlined call's return values under the call's
    # own output names (slot addressing included)
    return ins[0] if len(ins) == 1 else tuple(ins)


@register_tf_op("VarHandleOp")
@register_tf_op("VariableV2")
def _var_handle(sd, ins, attrs, node):
    values = attrs.get("_var_values") or {}
    shared = attrs.get("shared_name", b"") or node.name
    shared = shared.decode() if isinstance(shared, bytes) else str(shared)
    if shared in values:
        return sd.var(node.name, np.asarray(values[shared]))
    # object-based checkpoints key by attribute path, not variable name:
    # fall back to a UNIQUE shape match
    want = attrs.get("shape")
    shape = tuple(d.size for d in want.dim) if want is not None else None
    matches = [k for k, v in values.items() if np.shape(v) == shape]
    if len(matches) == 1:
        # a silent mis-bind here would fine-tune from the wrong weights, so
        # name the matched key loudly
        warnings.warn(
            f"{node.op_type} {node.name}: variable '{shared}' not in the "
            f"checkpoint by name; bound by unique shape {shape} to "
            f"checkpoint key '{matches[0]}' — verify this is the intended "
            f"weight", stacklevel=2)
        return sd.var(node.name, np.asarray(values[matches[0]]))
    raise ValueError(
        f"{node.op_type} {node.name}: no checkpoint value for variable "
        f"'{shared}' (shape {shape}); checkpoint has "
        f"{sorted(values)[:10]}{'…' if len(values) > 10 else ''} — pass "
        f"variable_values= with matching names")


@register_tf_op("ReadVariableOp")
def _read_variable(sd, ins, attrs, node):
    return ins[0]


def _prune_to_outputs(graph_def, output_names):
    """Drop nodes that are not ancestors of the requested outputs — the
    SavedModel init/restore subgraph (RestoreV2, AssignVariableOp) must not
    reach the importer."""
    keep = set()
    by_name = {n.name: n for n in graph_def.node}
    stack = [o.split(":")[0] for o in output_names]
    while stack:
        nm = stack.pop()
        if nm in keep:
            continue
        keep.add(nm)
        node = by_name.get(nm)
        if node is None:
            continue
        for i in node.input:
            stack.append(i.lstrip("^").split(":")[0])
    return tf_proto.GraphDef([n for n in graph_def.node if n.name in keep],
                             graph_def.library)


def load_saved_model_variables(path: str) -> Dict[str, np.ndarray]:
    """Read every variable value from a SavedModel's object-based
    checkpoint, keyed by the variable's ``full_name`` (e.g. 'dense/kernel'
    — what VarHandleOp.shared_name carries) when the trackable object
    graph provides it, with the raw object path as a fallback key.
    Optimizer slot variables (Adam m/v, momentum) and the save_counter are
    excluded — they are not model weights and would poison shape-based
    matching. The checkpoint is read by :mod:`.tensor_bundle`."""
    reader = tensor_bundle.load_checkpoint(os.path.join(path, "variables",
                                                        "variables"))
    suffix = "/.ATTRIBUTES/VARIABLE_VALUE"
    values: Dict[str, np.ndarray] = {}
    for key in reader.get_variable_to_shape_map():
        if (key.endswith(suffix) and "/.OPTIMIZER_SLOT/" not in key
                and key != "save_counter" + suffix):
            obj_path = key[: -len(suffix)]
            if obj_path != "save_counter":
                values[obj_path] = reader.get_tensor(key)
    og = tensor_bundle.object_graph(reader)
    # a checkpoint written without the object graph: object paths only
    for node in (og.nodes if og is not None else ()):
        for attr in node.attributes:
            if attr.full_name and attr.checkpoint_key.endswith(suffix):
                values[attr.full_name] = reader.get_tensor(
                    attr.checkpoint_key)
    return values


def import_saved_model(path: str, *, signature: str = "serving_default",
                       extra_variable_values=None, optimize: bool = True,
                       validate: bool = False,
                       device: Union[str, torch.device, None] = None
                       ) -> SameDiff:
    """SavedModel directory → SameDiff on ``device`` (the card when None)
    with trained weights restored as VARIABLE-role SDVariables
    (TFGraphMapper checkpoint restore + SameDiffServlet-style signature IO
    resolution)."""
    with open(os.path.join(path, "saved_model.pb"), "rb") as f:
        sm = tf_proto.parse_saved_model(f.read())
    mg = sm.meta_graphs[0]
    if signature not in mg.signature_def:
        raise ValueError(f"SavedModel has no signature '{signature}'; "
                         f"found {sorted(mg.signature_def)}")
    sig = mg.signature_def[signature]
    # protobuf map iteration order is not contractual — sort by signature key
    # so multi-output order is stable across environments
    out_tensors = [t.name for _, t in sorted(sig.outputs.items())]
    in_tensors = [t.name for _, t in sorted(sig.inputs.items())]

    def norm(t):
        base, _, slot = t.partition(":")
        return base if slot in ("", "0") else f"{base}:{slot}"

    gd = _prune_to_outputs(mg.graph_def, out_tensors)
    values = load_saved_model_variables(path)
    if extra_variable_values:
        values.update(extra_variable_values)
    # slot-qualified outputs ('call:1') ride ir.outputs so the walker
    # aliases them to fetchable variables instead of collapsing to slot 0
    sd = TensorflowImporter(optimize=optimize, validate=validate,
                            device=device).run_import(
        gd, variable_values=values, outputs=[norm(t) for t in out_tensors])
    sd.graph_inputs = [t.split(":")[0] for t in in_tensors]
    sd.graph_outputs = [norm(t) for t in out_tensors]
    return sd


# ---------------------------------------------------------------------------
# The remaining common-frozen-graph ops (Einsum, GatherNd, AddN, logical
# reductions, MirrorPad, Conv2DBackpropInput, ...).
# ---------------------------------------------------------------------------


@register_tf_op("Einsum")
def _einsum_tf(sd, ins, attrs, node):
    eq = attrs.get("equation", b"")
    eq = eq.decode() if isinstance(eq, bytes) else str(eq)
    return sd._record("einsum", ins, {"equation": eq})


@register_tf_op("GatherNd")
def _gather_nd_tf(sd, ins, attrs, node):
    return sd._record("gather_nd", ins)


@register_tf_op("AddN")
def _add_n(sd, ins, attrs, node):
    out = ins[0]
    for x in ins[1:]:
        out = sd._record("add", [out, x])
    return out


@register_tf_op("Cumprod")
def _cumprod_tf(sd, ins, attrs, node, const_values=None):
    axis = int(np.asarray(_require_const(const_values, node, 1,
                                         "axis")).reshape(-1)[0])
    return sd._record("cumprod", [ins[0]],
                      {"axis": axis,
                       "exclusive": bool(attrs.get("exclusive", False)),
                       "reverse": bool(attrs.get("reverse", False))})


@register_tf_op("MirrorPad")
def _mirror_pad_tf(sd, ins, attrs, node, const_values=None):
    pads = _require_const(const_values, node, 1, "paddings")
    mode = attrs.get("mode", b"REFLECT")
    mode = mode.decode() if isinstance(mode, bytes) else str(mode)
    return sd._record("mirror_pad", [ins[0]],
                      {"paddings": tuple((int(a), int(b)) for a, b in pads),
                       "mode": mode.lower()})


for _tf, _ours in [("Erfc", "erfc"), ("Atanh", "atanh"), ("Asinh", "asinh"),
                   ("Acosh", "acosh"), ("Expm1", "expm1")]:
    def _mk_unary(ours):
        def f(sd, ins, attrs, node):
            return sd._record(ours, ins)

        return f

    TF_OP_MAPPERS[_tf] = _mk_unary(_ours)


@register_tf_op("LogicalAnd")
def _logical_and(sd, ins, attrs, node):
    return sd._record("boolean_and", ins)


@register_tf_op("LogicalOr")
def _logical_or(sd, ins, attrs, node):
    return sd._record("boolean_or", ins)


@register_tf_op("LogicalNot")
def _logical_not(sd, ins, attrs, node):
    return sd._record("boolean_not", ins)


@register_tf_op("Xdivy")
def _xdivy(sd, ins, attrs, node):
    # x/y where x != 0, else 0 — composed from recorded catalog ops
    zero = sd._record("zeros_like", [ins[0]])
    safe_y = sd._record("select", [sd._record("eq", [ins[0], zero]),
                                   sd._record("ones_like", [ins[1]]),
                                   ins[1]])
    quot = sd._record("div", [ins[0], safe_y])
    return sd._record("select", [sd._record("eq", [ins[0], zero]),
                                 zero, quot])


@register_tf_op("SelectV2")
def _select_v2_tf(sd, ins, attrs, node):
    return sd._record("select", ins)


@register_tf_op("Select")
def _select_tf(sd, ins, attrs, node):
    # TF v1 Select: rank-1 cond broadcasts over the FIRST dim of x/y
    return sd._record("select_v1", ins)


@register_tf_op("Where")
def _where_tf(sd, ins, attrs, node):
    raise NotImplementedError(
        "1-arg tf.where (argwhere) has a data-dependent output shape static "
        "shapes cannot express — use tf.where(cond, x, y), which imports as "
        "Select/SelectV2")


@register_tf_op("All")
def _reduce_all_tf(sd, ins, attrs, node, const_values=None):
    axes = _require_const(const_values, node, 1, "reduction axes")
    return sd._record("reduce_all", [ins[0]],
                      {"axis": tuple(int(a) for a in np.atleast_1d(axes)),
                       "keepdims": bool(attrs.get("keep_dims", False))})


@register_tf_op("Any")
def _reduce_any_tf(sd, ins, attrs, node, const_values=None):
    axes = _require_const(const_values, node, 1, "reduction axes")
    return sd._record("reduce_any", [ins[0]],
                      {"axis": tuple(int(a) for a in np.atleast_1d(axes)),
                       "keepdims": bool(attrs.get("keep_dims", False))})


@register_tf_op("Conv2DBackpropInput")
def _conv2d_backprop_input(sd, ins, attrs, node, const_values=None):
    """tf.nn.conv2d_transpose lowers to this op: (output_shape, filter,
    value) with the FORWARD filter (kh, kw, out, in) — exactly keras
    Conv2DTranspose, so it lowers onto deconv2d the same way."""
    strides = attrs.get("strides", [1, 1, 1, 1])
    padding = attrs.get("padding", b"SAME")
    pad = padding.decode() if isinstance(padding, bytes) else str(padding)
    if pad not in ("SAME", "VALID"):
        raise NotImplementedError(f"Conv2DBackpropInput padding={pad}")
    if attrs.get("data_format", b"NHWC") not in (b"NHWC", "NHWC"):
        raise NotImplementedError("only NHWC Conv2DBackpropInput import")
    dil = [int(d) for d in attrs.get("dilations", [1, 1, 1, 1])]
    if dil != [1, 1, 1, 1]:
        raise NotImplementedError(
            f"Conv2DBackpropInput with dilations={dil} import")
    if int(strides[0]) != 1 or int(strides[3]) != 1:
        raise NotImplementedError(
            "Conv2DBackpropInput with batch/channel strides import")
    w = sd._record("transpose", [ins[1]], {"axes": (0, 1, 3, 2)})
    return sd._record("deconv2d", [ins[2], w],
                      {"stride": (int(strides[1]), int(strides[2])),
                       "padding": pad.lower() if pad == "SAME" else "valid"})


_NEEDS_CONSTS |= {"Cumprod", "MirrorPad", "All", "Any",
                  "Conv2DBackpropInput"}


@register_tf_op("ResourceGather")
def _resource_gather(sd, ins, attrs, node):
    """tf.gather on a resource variable (embedding lookup path): the
    VarHandleOp mapper already resolved the resource to its value."""
    if int(attrs.get("batch_dims", 0)):
        raise NotImplementedError("ResourceGather with batch_dims import")
    return sd._record("gather", [ins[0], ins[1]], {"axis": 0})


@register_tf_op("Shape")
def _shape_tf(sd, ins, attrs, node):
    return sd._record("shape_of", ins)


@register_tf_op("SpaceToBatchND")
def _space_to_batch_nd_tf(sd, ins, attrs, node, const_values=None):
    block = _require_const(const_values, node, 1, "block_shape")
    pads = _require_const(const_values, node, 2, "paddings")
    return sd._record("space_to_batch", [ins[0]], {
        "block_shape": tuple(int(b) for b in np.atleast_1d(block)),
        "paddings": tuple((int(a), int(b)) for a, b in np.atleast_2d(pads))})


@register_tf_op("BatchToSpaceND")
def _batch_to_space_nd_tf(sd, ins, attrs, node, const_values=None):
    block = _require_const(const_values, node, 1, "block_shape")
    crops = _require_const(const_values, node, 2, "crops")
    return sd._record("batch_to_space", [ins[0]], {
        "block_shape": tuple(int(b) for b in np.atleast_1d(block)),
        "crops": tuple((int(a), int(b)) for a, b in np.atleast_2d(crops))})


_NEEDS_CONSTS |= {"SpaceToBatchND", "BatchToSpaceND"}


# ---------------------------------------------------------------------------
# Segment/scatter/linalg/image/math tails toward the reference tensorflow
# mapping ruleset (samediff-import-tensorflow). All map 1:1 onto catalog
# declarables.
# ---------------------------------------------------------------------------

for _tf2, _ours2 in [("Rint", "rint"), ("Digamma", "digamma"),
                     ("Lgamma", "lgamma"), ("Cholesky", "cholesky"),
                     ("MatrixInverse", "matrix_inverse"),
                     ("MatrixSolve", "solve"), ("Diag", "diag"),
                     ("DiagPart", "diag_part"),
                     ("MatrixDiag", "matrix_diag"),
                     ("InvertPermutation", "invert_permutation"),
                     ("Betainc", "betainc"), ("Igamma", "igamma"),
                     ("Igammac", "igammac"), ("Polygamma", "polygamma")]:
    def _mk_direct(ours):
        def f(sd, ins, attrs, node):
            return sd._record(ours, ins)

        return f

    TF_OP_MAPPERS[_tf2] = _mk_direct(_ours2)


def _mk_segment(ours, needs_num: bool):
    def f(sd, ins, attrs, node, const_values=None):
        if needs_num:
            num = int(np.asarray(
                _require_const(const_values, node, 2, "num_segments")))
            return sd._record(ours, ins[:2], {"num_segments": num})
        # sorted Segment* ops carry no num_segments input — it must come
        # from the (constant) segment id tensor itself
        ids = (const_values or {}).get(node.input[1].split(":")[0])
        if ids is None:
            raise ValueError(
                f"{node.op_type} {node.name}: segment_ids must be constant "
                f"(a static segment count is needed)")
        return sd._record(ours, ins[:2],
                          {"num_segments": int(np.asarray(ids).max()) + 1})

    return f


for _tf2, _ours2 in [("SegmentSum", "segment_sum"),
                     ("SegmentMax", "segment_max"),
                     ("SegmentMin", "segment_min"),
                     ("SegmentMean", "segment_mean"),
                     ("SegmentProd", "segment_prod")]:
    TF_OP_MAPPERS[_tf2] = _mk_segment(_ours2, needs_num=False)
    _NEEDS_CONSTS.add(_tf2)

for _tf2, _ours2 in [("UnsortedSegmentSum", "unsorted_segment_sum"),
                     ("UnsortedSegmentMax", "unsorted_segment_max"),
                     ("UnsortedSegmentMin", "unsorted_segment_min"),
                     ("UnsortedSegmentProd", "unsorted_segment_prod")]:
    TF_OP_MAPPERS[_tf2] = _mk_segment(_ours2, needs_num=True)
    _NEEDS_CONSTS.add(_tf2)


@register_tf_op("ScatterNd")
def _tf_scatter_nd(sd, ins, attrs, node, const_values=None):
    shape = tuple(int(s) for s in np.asarray(
        _require_const(const_values, node, 2, "shape")).reshape(-1))
    return sd._record("scatter_nd", ins[:2], {"shape": shape})


_NEEDS_CONSTS.add("ScatterNd")


@register_tf_op("TensorScatterUpdate")
def _tf_tensor_scatter_update(sd, ins, attrs, node):
    return sd._record("scatter_nd_update", ins)


@register_tf_op("TensorScatterAdd")
def _tf_tensor_scatter_add(sd, ins, attrs, node):
    return sd._record("scatter_nd_add", ins)


@register_tf_op("ReverseV2")
def _tf_reverse(sd, ins, attrs, node, const_values=None):
    axis = np.asarray(_require_const(const_values, node, 1, "axis")).reshape(-1)
    return sd._record("reverse", [ins[0]],
                      {"axis": tuple(int(a) for a in axis)})


@register_tf_op("Reverse")
def _tf_reverse_v1(sd, ins, attrs, node, const_values=None):
    # TF1 Reverse's second operand is a PER-DIMENSION bool mask
    dims = np.asarray(_require_const(const_values, node, 1, "dims")).reshape(-1)
    axes = tuple(i for i, flag in enumerate(dims) if bool(flag))
    if not axes:
        return sd._record("identity", [ins[0]])
    return sd._record("reverse", [ins[0]], {"axis": axes})


_NEEDS_CONSTS.add("Reverse")


_NEEDS_CONSTS.add("ReverseV2")


@register_tf_op("Roll")
def _tf_roll(sd, ins, attrs, node, const_values=None):
    shift = np.asarray(_require_const(const_values, node, 1, "shift")).reshape(-1)
    axis = np.asarray(_require_const(const_values, node, 2, "axis")).reshape(-1)
    return sd._record("roll", [ins[0]],
                      {"shift": tuple(int(s) for s in shift),
                       "axis": tuple(int(a) for a in axis)})


_NEEDS_CONSTS.add("Roll")


@register_tf_op("MatrixBandPart")
def _tf_band_part(sd, ins, attrs, node, const_values=None):
    lo = int(np.asarray(_require_const(const_values, node, 1, "num_lower")))
    hi = int(np.asarray(_require_const(const_values, node, 2, "num_upper")))
    return sd._record("matrix_band_part", [ins[0]],
                      {"num_lower": lo, "num_upper": hi})


_NEEDS_CONSTS.add("MatrixBandPart")


@register_tf_op("MatrixSetDiag")
@register_tf_op("MatrixSetDiagV3")
def _tf_set_diag(sd, ins, attrs, node):
    return sd._record("matrix_set_diag", ins[:2])


if "pad_to_matrix_shape" not in _GRAPH_OPS:
    def _pad_to_matrix_shape(a, *, rows, cols):
        pr = rows - a.shape[-2]
        pc = cols - a.shape[-1]
        if pr < 0 or pc < 0:
            raise ValueError(
                f"pad_to_matrix_shape: target ({rows},{cols}) smaller than "
                f"diag matrix {a.shape[-2:]}")
        return F.pad(a, (0, pc, 0, pr))

    _GRAPH_OPS["pad_to_matrix_shape"] = _pad_to_matrix_shape


@register_tf_op("MatrixDiagV3")
def _tf_matrix_diag_v3(sd, ins, attrs, node, const_values=None):
    # 5-operand form (diagonal, k, num_rows, num_cols, padding_value) —
    # what tf.eye/tf.linalg.diag lower to. Supported: main diagonal,
    # default/square sizing, zero padding.
    def cval(i):
        return (const_values or {}).get(node.input[i].split(":")[0])

    k = cval(1)
    if k is not None and np.any(np.asarray(k) != 0):
        raise NotImplementedError(
            f"MatrixDiagV3 {node.name}: off-main diagonals (k != 0)")
    rows, cols = cval(2), cval(3)
    pad = cval(4)
    if pad is not None and np.any(np.asarray(pad) != 0):
        raise NotImplementedError(
            f"MatrixDiagV3 {node.name}: non-zero padding_value")
    out = sd._record("matrix_diag", [ins[0]])
    if rows is not None and int(np.asarray(rows)) != -1:
        if cols is None:
            raise NotImplementedError(
                f"MatrixDiagV3 {node.name}: constant num_rows with dynamic "
                f"num_cols")
        r_ = int(np.asarray(rows))
        c_ = int(np.asarray(cols)) if int(np.asarray(cols)) != -1 else r_
        # matrix_diag emits (…, d, d) for a length-d diagonal; a larger
        # requested shape zero-pads on the high side (tf.linalg.diag
        # num_rows/num_cols semantics with the main diagonal)
        out = sd._record("pad_to_matrix_shape", [out],
                         {"rows": r_, "cols": c_})
    return out


_NEEDS_CONSTS.add("MatrixDiagV3")


@register_tf_op("Qr")
def _tf_qr(sd, ins, attrs, node):
    return sd._record("qr", ins, {"full_matrices":
                                  bool(attrs.get("full_matrices", False))},
                      n_out=2)


@register_tf_op("LinSpace")
def _tf_linspace(sd, ins, attrs, node, const_values=None):
    start = float(np.asarray(_require_const(const_values, node, 0, "start")))
    stop = float(np.asarray(_require_const(const_values, node, 1, "stop")))
    num = int(np.asarray(_require_const(const_values, node, 2, "num")))
    return sd._record("linspace", [], {"start": start, "stop": stop,
                                       "num": num})


_NEEDS_CONSTS.add("LinSpace")


@register_tf_op("HistogramFixedWidth")
def _tf_hist(sd, ins, attrs, node, const_values=None):
    rng = np.asarray(_require_const(const_values, node, 1, "value_range")
                     ).reshape(-1)
    nbins = int(np.asarray(_require_const(const_values, node, 2, "nbins"))) \
        if len(node.input) > 2 else 100
    return sd._record("histogram_fixed_width", [ins[0]],
                      {"range": (float(rng[0]), float(rng[1])),
                       "num_bins": nbins})


_NEEDS_CONSTS.add("HistogramFixedWidth")


@register_tf_op("ExtractImagePatches")
def _tf_patches(sd, ins, attrs, node):
    ksizes = [int(k) for k in attrs["ksizes"]]
    strides = [int(s) for s in attrs["strides"]]
    rates = [int(r) for r in attrs.get("rates", [1, 1, 1, 1])]
    pad = attrs.get("padding", b"VALID")
    pad = pad.decode() if isinstance(pad, bytes) else str(pad)
    return sd._record("extract_image_patches", [ins[0]],
                      {"kernel": (ksizes[1], ksizes[2]),
                       "strides": (strides[1], strides[2]),
                       "rates": (rates[1], rates[2]), "padding": pad})


@register_tf_op("InTopKV2")
def _tf_in_top_k(sd, ins, attrs, node, const_values=None):
    k = int(np.asarray(_require_const(const_values, node, 2, "k")))
    return sd._record("in_top_k", ins[:2], {"k": k})


_NEEDS_CONSTS.add("InTopKV2")


@register_tf_op("NthElement")
def _tf_nth_element(sd, ins, attrs, node, const_values=None):
    n = int(np.asarray(_require_const(const_values, node, 1, "n")))
    return sd._record("nth_element", [ins[0]],
                      {"n": n, "reverse": bool(attrs.get("reverse", False))})


_NEEDS_CONSTS.add("NthElement")


@register_tf_op("CropAndResize")
def _tf_crop_and_resize(sd, ins, attrs, node, const_values=None):
    size = np.asarray(_require_const(const_values, node, 3, "crop_size")
                      ).reshape(-1)
    return sd._record("crop_and_resize", ins[:3],
                      {"crop_size": (int(size[0]), int(size[1]))})


_NEEDS_CONSTS.add("CropAndResize")


@register_tf_op("ListDiff")
def _tf_listdiff(sd, ins, attrs, node, const_values=None):
    # dynamic output length: supported only when both operands are Const
    x = (const_values or {}).get(node.input[0].split(":")[0])
    y = (const_values or {}).get(node.input[1].split(":")[0])
    if x is None or y is None:
        raise ValueError(
            f"ListDiff {node.name}: dynamic-length output needs constant "
            f"operands under static shapes")
    xa = np.asarray(x).reshape(-1)
    ys = set(np.asarray(y).reshape(-1).tolist())
    keep = [i for i, v in enumerate(xa.tolist()) if v not in ys]
    # TF semantics: preserve x's order AND duplicates (np.setdiff1d sorts
    # and dedups — wrong here)
    return (sd.constant(node.name + "_out", xa[keep]),
            sd.constant(node.name + "_idx", np.asarray(keep, np.int32)))


_NEEDS_CONSTS.add("ListDiff")


@register_tf_op("Bincount")
@register_tf_op("DenseBincount")
def _tf_bincount(sd, ins, attrs, node, const_values=None):
    size = (const_values or {}).get(node.input[1].split(":")[0])
    if size is None:
        raise ValueError(f"Bincount {node.name}: size must be constant")
    n = int(np.asarray(size))
    if len(node.input) > 2 and node.input[2]:
        w = (const_values or {}).get(node.input[2].split(":")[0])
        # reject ANY weights operand unless it is a constant empty tensor
        # (silently dropping runtime weights would yield unweighted counts)
        if w is None or np.asarray(w).size:
            raise NotImplementedError(
                f"Bincount {node.name}: weighted bincount import is not "
                f"supported — precompute outside the graph")
    out = sd._record("bincount", [ins[0]], {"minlength": n, "maxlength": n})
    if bool(attrs.get("binary_output", False)):
        zero = sd.constant(node.name + "_z", np.asarray(0, np.int32))
        out = sd._record("cast", [sd._record("gt", [out, zero])],
                         {"dtype": "int32"})
    return out


_NEEDS_CONSTS.add("Bincount")
_NEEDS_CONSTS.add("DenseBincount")


@register_tf_op("BroadcastArgs")
def _tf_broadcast_args(sd, ins, attrs, node, const_values=None):
    # shape-arithmetic helper tf.linspace/broadcasting emit; both operands
    # are shape tensors — constant in frozen graphs
    s0 = (const_values or {}).get(node.input[0].split(":")[0])
    s1 = (const_values or {}).get(node.input[1].split(":")[0])
    if s0 is None or s1 is None:
        raise ValueError(
            f"BroadcastArgs {node.name}: dynamic shape operands unsupported")
    out = np.broadcast_shapes(tuple(np.asarray(s0).reshape(-1)),
                              tuple(np.asarray(s1).reshape(-1)))
    arr = np.asarray(out, np.int32)
    if const_values is not None:
        # downstream shape consumers (BroadcastTo/Reshape) resolve their
        # shape operand through const_values — publish the folded result
        const_values[node.name] = arr
    return sd.constant(node.name, arr)


_NEEDS_CONSTS.add("BroadcastArgs")


# -- linalg decompositions, Conv3D, seeded random ops ------------------------

TF_OP_MAPPERS["BatchMatMulV3"] = TF_OP_MAPPERS["BatchMatMulV2"]


if "matrix_transpose" not in _GRAPH_OPS:
    _GRAPH_OPS["matrix_transpose"] = lambda a: a.transpose(-1, -2)


@register_tf_op("Svd")
def _tf_svd(sd, ins, attrs, node):
    # TF Svd outputs (s, u, v); the catalog op (numpy convention) returns
    # (u, s, vh) — reorder and un-hermitian v
    cuv = bool(attrs.get("compute_uv", True))
    if not cuv:
        return sd._record("svd", ins, {"full_matrices": False,
                                       "compute_uv": False})
    u, s_, vh = sd._record("svd", ins, {
        "full_matrices": bool(attrs.get("full_matrices", False)),
        "compute_uv": True}, n_out=3)
    v = sd._record("matrix_transpose", [vh])
    return [s_, u, v]


@register_tf_op("MatrixTriangularSolve")
def _tf_tri_solve(sd, ins, attrs, node):
    return sd._record("triangular_solve", ins, {
        "lower": bool(attrs.get("lower", True)),
        "adjoint": bool(attrs.get("adjoint", False))})


@register_tf_op("Cross")
def _tf_cross(sd, ins, attrs, node):
    return sd._record("cross", ins)


if "lu_tf_outputs" not in _GRAPH_OPS:
    def _lu_tf_outputs(a):
        lu_, piv = torch.linalg.lu_factor(a)
        # LAPACK ipiv (1-based; row i swapped with ipiv[i], sequential) →
        # TF's permutation-of-rows vector
        n = a.shape[-1]
        ipiv = piv.to(torch.int64) - 1
        perm = torch.arange(n, device=a.device).expand(ipiv.shape).clone()
        for i in range(n):
            j = ipiv[..., i:i + 1]
            pi = perm[..., i:i + 1].clone()
            perm[..., i:i + 1] = torch.gather(perm, -1, j)
            perm.scatter_(-1, j, pi)
        return lu_, perm.to(torch.int32)

    _GRAPH_OPS["lu_tf_outputs"] = _lu_tf_outputs


@register_tf_op("Lu")
def _tf_lu(sd, ins, attrs, node):
    return sd._record("lu_tf_outputs", ins, n_out=2)


if "eigh_pair" not in _GRAPH_OPS:
    def _eigh_pair(a):
        e, v = torch.linalg.eigh(a)
        return e, v

    _GRAPH_OPS["eigh_pair"] = _eigh_pair


@register_tf_op("SelfAdjointEigV2")
def _tf_eigh(sd, ins, attrs, node):
    if not attrs.get("compute_v", True):
        return sd._record("eigh_pair", ins, n_out=2)[0]
    return sd._record("eigh_pair", ins, n_out=2)


@register_tf_op("Conv3D")
def _tf_conv3d(sd, ins, attrs, node):
    fmt = attrs.get("data_format", b"NDHWC")
    fmt = fmt.decode() if isinstance(fmt, bytes) else str(fmt)
    if fmt != "NDHWC":
        raise ValueError(
            f"Conv3D {node.name}: only NDHWC import supported (got {fmt})")
    strides = [int(s) for s in attrs["strides"]]
    pad = attrs.get("padding", b"SAME")
    pad = pad.decode() if isinstance(pad, bytes) else str(pad)
    dil = [int(d) for d in attrs.get("dilations", [1, 1, 1, 1, 1])]
    return sd._record("conv3d", ins[:2], {
        "stride": tuple(strides[1:4]), "padding": pad.lower(),
        "dilation": tuple(dil[1:4])})


def _seeded_random(op_kind):
    """TF stateful random ops with static semantics: a fixed stream keyed
    by the op's seed attrs (seed=0 falls back to a name hash), the same
    contract the ONNX random mappers use. The draw seeds a
    ``torch.Generator`` on the graph's device with that seed at every
    run."""
    def rule(sd, ins, attrs, node, const_values=None):
        import zlib

        shape = (const_values or {}).get(node.input[0].split(":")[0])
        if shape is None:
            raise ValueError(
                f"{node.op_type} {node.name}: shape operand must be constant")
        shp = tuple(int(s) for s in np.asarray(shape).reshape(-1))
        s1 = int(attrs.get("seed", 0))
        s2 = int(attrs.get("seed2", 0))
        if s1 or s2:
            # TF puts the graph seed in `seed` and the per-op seed in
            # `seed2` — COMBINE them (first-nonzero would collapse every
            # op in a seeded graph onto one stream)
            seed = (s1 * 1000003 + s2) & 0x7FFFFFFF
        else:
            # unseeded: stable per-name stream (hash() is
            # PYTHONHASHSEED-randomized across processes)
            seed = zlib.crc32(node.name.encode()) & 0x7FFFFFFF
        dt = attrs.get("dtype")
        kw = {"shape": shp, "seed": seed, "device": str(sd.device)}
        if dt is not None:
            name = tf_proto.numpy_dtype_name(dt)
            if name not in ("float16", "bfloat16", "float32", "float64"):
                raise NotImplementedError(
                    f"{node.op_type} {node.name}: non-float random dtype "
                    f"{name} import")
            kw["dtype"] = name
        return sd._record(op_kind, [], kw)

    return rule


if "tf_random_normal" not in _GRAPH_OPS:
    from deeplearning4j_tpu_torch.ops import random as _random

    def _tf_draw(draw):
        def fn(*, shape, seed, dtype="float32", device=None):
            return draw.fn(int(seed), shape=tuple(shape), dtype=dtype,
                           device=device)

        return fn

    _GRAPH_OPS["tf_random_normal"] = _tf_draw(_random.random_normal)
    _GRAPH_OPS["tf_random_uniform"] = _tf_draw(_random.random_uniform)
    # truncated at ±2σ, as the JAX rule draws it
    _GRAPH_OPS["tf_truncated_normal"] = _tf_draw(
        _random.random_truncated_normal)

TF_OP_MAPPERS["RandomStandardNormal"] = _seeded_random("tf_random_normal")
TF_OP_MAPPERS["RandomUniform"] = _seeded_random("tf_random_uniform")
TF_OP_MAPPERS["TruncatedNormal"] = _seeded_random("tf_truncated_normal")
for _r in ("RandomStandardNormal", "RandomUniform", "TruncatedNormal"):
    _NEEDS_CONSTS.add(_r)


if "tf_softmax_xent" not in _GRAPH_OPS:
    def _tf_softmax_xent_impl(logits, labels):
        loss = -torch.sum(labels * torch.log_softmax(logits, dim=-1), dim=-1)
        grad = torch.softmax(logits, dim=-1) - labels
        return loss, grad

    def _tf_sparse_softmax_xent_impl(logits, labels):
        oh = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
        return _tf_softmax_xent_impl(logits, oh)

    _GRAPH_OPS["tf_softmax_xent"] = _tf_softmax_xent_impl
    _GRAPH_OPS["tf_sparse_softmax_xent"] = _tf_sparse_softmax_xent_impl


@register_tf_op("SoftmaxCrossEntropyWithLogits")
def _tf_softmax_xent(sd, ins, attrs, node):
    # outputs (loss, backprop-gradient) — training-graph freezes carry both
    return sd._record("tf_softmax_xent", ins[:2], n_out=2)


@register_tf_op("SparseSoftmaxCrossEntropyWithLogits")
def _tf_sparse_softmax_xent(sd, ins, attrs, node):
    return sd._record("tf_sparse_softmax_xent", ins[:2], n_out=2)


# -- image-adjustment / resize / dynamic-partition tail ---------------------

@register_tf_op("RGBToHSV")
def _tf_rgb_to_hsv(sd, ins, attrs, node):
    return sd._record("rgb_to_hsv", ins)


@register_tf_op("HSVToRGB")
def _tf_hsv_to_rgb(sd, ins, attrs, node):
    return sd._record("hsv_to_rgb", ins)


def _mk_scalar_image_op(ours, what):
    def rule(sd, ins, attrs, node, const_values=None):
        v = float(np.asarray(_require_const(const_values, node, 1, what)))
        return sd._record(ours, [ins[0]], {what: v})

    return rule


TF_OP_MAPPERS["AdjustContrastv2"] = _mk_scalar_image_op("adjust_contrast",
                                                        "factor")
TF_OP_MAPPERS["AdjustHue"] = _mk_scalar_image_op("adjust_hue", "delta")
TF_OP_MAPPERS["AdjustSaturation"] = _mk_scalar_image_op("adjust_saturation",
                                                        "factor")
for _r in ("AdjustContrastv2", "AdjustHue", "AdjustSaturation"):
    _NEEDS_CONSTS.add(_r)


@register_tf_op("ResizeBicubic")
def _tf_resize_bicubic(sd, ins, attrs, node, const_values=None):
    if not bool(attrs.get("half_pixel_centers", False)) \
            or bool(attrs.get("align_corners", False)):
        raise NotImplementedError(
            "legacy ResizeBicubic (half_pixel_centers=false or "
            "align_corners=true) import — re-export with tf.image.resize "
            "(TF2 semantics)")
    size = np.asarray(_require_const(const_values, node, 1, "size")).reshape(-1)
    return sd._record("resize_bicubic", [ins[0]],
                      {"size": (int(size[0]), int(size[1]))})


_NEEDS_CONSTS.add("ResizeBicubic")


@register_tf_op("DynamicPartition")
def _tf_dynamic_partition(sd, ins, attrs, node):
    raise NotImplementedError(
        f"DynamicPartition {node.name}: per-partition output sizes are "
        f"data-dependent, which static shapes cannot express. The "
        f"catalog op 'dynamic_partition' offers the padded+mask form for "
        f"hand-built graphs; restructure the imported model (boolean "
        f"masking or segment ops usually substitute).")


if "stitch_pair" not in _GRAPH_OPS:
    def _stitch_pair_impl(*args):
        from deeplearning4j_tpu_torch.ops.registry import exec_op

        half = len(args) // 2
        return exec_op("dynamic_stitch", list(args[:half]),
                       list(args[half:]))

    _GRAPH_OPS["stitch_pair"] = _stitch_pair_impl


@register_tf_op("DynamicStitch")
@register_tf_op("ParallelDynamicStitch")
def _tf_dynamic_stitch(sd, ins, attrs, node, const_values=None):
    n = int(attrs.get("N", len(ins) // 2))
    # the catalog op sizes the output by TOTAL index count; that matches TF
    # only when the indices form a dense 0..n-1 permutation — validate when
    # the index operands are constants (the frozen-graph norm), reject
    # otherwise rather than silently mis-shape
    idx_vals = [(const_values or {}).get(node.input[i].split(":")[0])
                for i in range(n)]
    if all(v is not None for v in idx_vals):
        flat = np.concatenate([np.asarray(v).reshape(-1) for v in idx_vals]) \
            if idx_vals else np.zeros(0, np.int64)
        if sorted(flat.tolist()) != list(range(len(flat))):
            raise NotImplementedError(
                f"DynamicStitch {node.name}: indices {sorted(flat.tolist())} "
                f"are not a dense permutation — duplicate/sparse index "
                f"semantics (later-wins, implicit zero rows) are unsupported")
    else:
        raise NotImplementedError(
            f"DynamicStitch {node.name}: non-constant index operands — "
            f"cannot validate the dense-permutation requirement at import")
    return sd._record("stitch_pair", list(ins[:n]) + list(ins[n:2 * n]))


_NEEDS_CONSTS.add("DynamicStitch")
_NEEDS_CONSTS.add("ParallelDynamicStitch")
