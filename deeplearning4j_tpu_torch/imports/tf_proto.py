"""TensorFlow's wire schemas, decoded without TensorFlow or protobuf.

The JAX package's TF importer takes three things from ``tensorflow``: its
protobuf classes (``GraphDef``, ``SavedModel``, ``TrackableObjectGraph``),
its dtype table (``tf.dtypes.as_dtype``) and ``tensor_util.MakeNdarray``.
This module is the port's counterpart of all three, on the port's own wire
codec (:mod:`.protowire`), with field numbers from TensorFlow's public
``.proto`` files (``graph.proto``, ``node_def.proto``, ``attr_value.proto``,
``tensor.proto``, ``tensor_shape.proto``, ``function.proto``,
``op_def.proto``, ``saved_model.proto``, ``meta_graph.proto``,
``trackable_object_graph.proto``). Messages decode into small Python
objects whose attribute names are the protobuf fields' own, so the
importer reads ``node.attr["shape"].shape.dim[0].size`` as it would on a
protobuf message.

Large tensors are read without copying the wire bytes: the parse runs over
a ``memoryview`` of the input, so a ``tensor_content`` is sliced once and
copied once, into the array :func:`make_ndarray` returns (as
``MakeNdarray`` copies it).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.imports import protowire as pw

# ---------------------------------------------------------------------------
# DataType (types.proto)
# ---------------------------------------------------------------------------

DTYPE_NAMES: Dict[int, str] = {
    1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16",
    6: "int8", 7: "string", 8: "complex64", 9: "int64", 10: "bool",
    11: "qint8", 12: "quint8", 13: "qint32", 14: "bfloat16", 15: "qint16",
    16: "quint16", 17: "uint16", 18: "complex128", 19: "float16",
    20: "resource", 21: "variant", 22: "uint32", 23: "uint64",
    24: "float8_e5m2", 25: "float8_e4m3fn"}

# quantized types hold their base integers (TF wraps them in a one-field
# structured dtype; the values are the same)
_QUANTIZED = {"qint8": "int8", "quint8": "uint8", "qint32": "int32",
              "qint16": "int16", "quint16": "uint16"}


def dtype_name(dt: int) -> str:
    """The name of DataType ``dt`` (a ``_REF`` type, ``dt`` + 100, names its
    base type)."""
    dt = int(dt)
    if dt > 100:
        dt -= 100
    try:
        return DTYPE_NAMES[dt]
    except KeyError:
        raise TypeError(f"unsupported TF DataType enum {dt}") from None


def numpy_dtype_name(dt: int) -> str:
    """``str(np.dtype(tf.dtypes.as_dtype(dt).as_numpy_dtype))`` for
    DataType ``dt``, read from the table (``"object"`` for strings)."""
    name = dtype_name(dt)
    if name in ("resource", "variant"):
        raise TypeError(f"TF DataType {name} has no array form")
    return "object" if name == "string" else _QUANTIZED.get(name, name)


def numpy_dtype(dt: int) -> np.dtype:
    """``tf.dtypes.as_dtype(dt).as_numpy_dtype`` for DataType ``dt``:
    strings are ``object``; bfloat16 and the float8 types are ml_dtypes'
    (imported here only, when such a tensor is met)."""
    name = numpy_dtype_name(dt)
    if name in ("bfloat16", "float8_e5m2", "float8_e4m3fn"):
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, name))
    return np.dtype(name)


# ---------------------------------------------------------------------------
# field access over memoryviews
# ---------------------------------------------------------------------------


def _parse(buf) -> Dict[int, List]:
    if not isinstance(buf, memoryview):
        buf = memoryview(buf)
    return pw.parse_message(buf)


def _str(v) -> str:
    return bytes(v).decode("utf-8", "replace")


def _string(f, num: int) -> str:
    vs = pw.get_bytes(f, num)
    return _str(vs[-1]) if vs else ""


def _strings(f, num: int) -> List[str]:
    return [_str(v) for v in pw.get_bytes(f, num)]


def _message(f, num: int):
    vs = pw.get_bytes(f, num)
    return vs[-1] if vs else None


def _bool(f, num: int) -> bool:
    return bool(pw.get_varint(f, num, 0))


def _signed(f, num: int) -> int:
    return pw._to_signed64(pw.get_varint(f, num, 0))


def _fixed(f, num: int, fmt: str) -> List:
    """A repeated fixed-width field (packed or one value a tag)."""
    size = struct.calcsize(fmt)
    out: List = []
    for wt, v in f.get(num, []):
        if wt == pw.LEN:
            out.extend(struct.unpack(f"<{len(v) // size}{fmt}", v))
        elif wt in (pw.I32, pw.I64):
            out.extend(struct.unpack(f"<{fmt}", v))
    return out


def _varints(f, num: int) -> List[int]:
    """A repeated varint field, unsigned (packed or one value a tag)."""
    out: List[int] = []
    for wt, v in f.get(num, []):
        if wt == pw.VARINT:
            out.append(v)
        elif wt == pw.LEN:
            i = 0
            while i < len(v):
                x, i = pw.read_varint(v, i)
                out.append(x)
    return out


def _map(f, num: int, value_fn) -> Dict[str, Any]:
    """A ``map<string, V>`` field: entries with key 1 and value 2."""
    out: Dict[str, Any] = {}
    for entry in pw.get_bytes(f, num):
        ef = _parse(entry)
        out[_string(ef, 1)] = value_fn(_message(ef, 2) or b"")
    return out


# ---------------------------------------------------------------------------
# TensorShapeProto, TensorProto
# ---------------------------------------------------------------------------


class Dim:
    __slots__ = ("size", "name")

    def __init__(self, size: int, name: str = ""):
        self.size = size
        self.name = name

    def __repr__(self):
        return f"Dim({self.size})"


class TensorShape:
    """``TensorShapeProto``: ``dim`` (sizes, -1 unknown) and
    ``unknown_rank``."""

    __slots__ = ("dim", "unknown_rank")

    def __init__(self, dim: List[Dim], unknown_rank: bool = False):
        self.dim = dim
        self.unknown_rank = unknown_rank

    def __repr__(self):
        return f"TensorShape({[d.size for d in self.dim]})"


def parse_tensor_shape(buf) -> TensorShape:
    if buf is None:
        return TensorShape([])
    f = _parse(buf)
    dims = []
    for d in pw.get_bytes(f, 2):
        df = _parse(d)
        dims.append(Dim(_signed(df, 1), _string(df, 2)))
    return TensorShape(dims, _bool(f, 3))


def make_ndarray(buf) -> np.ndarray:
    """TensorProto bytes → ``np.ndarray``, with the semantics of
    ``tensor_util.MakeNdarray``: ``tensor_content`` read as raw
    little-endian bytes; otherwise the typed ``*_val`` field, padded with
    its last value when it holds fewer values than the shape (an empty
    field gives zeros); ``half_val`` carries float16/bfloat16 bit
    patterns; strings are ``bytes`` in an object array."""
    f = _parse(buf)
    dt = pw.get_varint(f, 1, 0)
    shape = [d.size for d in parse_tensor_shape(_message(f, 2)).dim]
    num_elements = int(np.prod(shape, dtype=np.int64))
    name = dtype_name(dt)
    dtype = numpy_dtype(dt)
    content = _message(f, 4)
    if content is not None and len(content):
        return np.frombuffer(content, dtype=dtype).copy().reshape(shape)
    if name == "string":
        values: List[Any] = [bytes(v) for v in pw.get_bytes(f, 8)]
        padding = num_elements - len(values)
        if padding > 0:
            values.extend([values[-1] if values else ""] * padding)
        return np.array(values, dtype=dtype).reshape(shape)
    if name in ("float16", "bfloat16"):
        arr = np.asarray(_varints(f, 13), np.uint16).view(dtype)
    elif name in ("float8_e5m2", "float8_e4m3fn"):
        arr = np.frombuffer(b"".join(bytes(v) for v in pw.get_bytes(f, 18)),
                            np.uint8).view(dtype)
    elif name == "float32":
        arr = np.asarray(_fixed(f, 5, "f"), dtype)
    elif name == "float64":
        arr = np.asarray(_fixed(f, 6, "d"), dtype)
    elif name in ("int32", "uint8", "uint16", "int16", "int8", "qint32",
                  "quint8", "qint8", "qint16", "quint16"):
        arr = np.asarray([pw._to_signed64(v) for v in _varints(f, 7)],
                         np.int64).astype(dtype)
    elif name == "int64":
        arr = np.asarray([pw._to_signed64(v) for v in _varints(f, 10)],
                         dtype)
    elif name == "uint32":
        arr = np.asarray(_varints(f, 16), dtype)
    elif name == "uint64":
        arr = np.asarray(_varints(f, 17), dtype)
    elif name == "complex64":
        v = _fixed(f, 9, "f")
        arr = np.asarray([complex(a, b) for a, b in zip(v[::2], v[1::2])],
                         dtype)
    elif name == "complex128":
        v = _fixed(f, 12, "d")
        arr = np.asarray([complex(a, b) for a, b in zip(v[::2], v[1::2])],
                         dtype)
    elif name == "bool":
        arr = np.asarray(_varints(f, 11), dtype)
    else:
        raise TypeError(f"unsupported tensor type: {name}")
    if arr.size == 0:
        return np.zeros(shape, dtype)
    if arr.size != num_elements:
        arr = np.pad(arr, (0, num_elements - arr.size), "edge")
    return arr.reshape(shape)


# ---------------------------------------------------------------------------
# AttrValue, NameAttrList, NodeDef
# ---------------------------------------------------------------------------


class ListValue:
    """``AttrValue.ListValue``: the eight repeated fields."""

    __slots__ = ("s", "i", "f", "b", "type", "shape", "tensor", "func")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k, []))


class NameAttrList:
    __slots__ = ("name", "attr")

    def __init__(self, name: str, attr: Dict[str, "AttrValue"]):
        self.name = name
        self.attr = attr


class AttrValue:
    """``AttrValue``: ``kind`` names the set member of its ``value`` oneof
    (``WhichOneof("value")``: list, s, i, f, b, type, shape, tensor,
    placeholder, func, or None), ``value`` holds it decoded (``tensor`` as
    an ndarray, ``shape`` as a :class:`TensorShape`, ``func`` as a
    :class:`NameAttrList`)."""

    __slots__ = ("kind", "value")

    def __init__(self, kind: Optional[str], value: Any):
        self.kind = kind
        self.value = value

    def WhichOneof(self, _group: str = "value") -> Optional[str]:
        return self.kind

    def __getattr__(self, name):
        if name in ("list", "s", "i", "f", "b", "type", "shape", "tensor",
                    "placeholder", "func"):
            return self.value if self.kind == name else None
        raise AttributeError(name)

    def __repr__(self):
        return f"AttrValue({self.kind}={self.value!r})"


def _parse_list(buf) -> ListValue:
    f = _parse(buf)
    return ListValue(
        s=[bytes(v) for v in pw.get_bytes(f, 2)],
        i=[pw._to_signed64(v) for v in _varints(f, 3)],
        f=_fixed(f, 4, "f"),
        b=[bool(v) for v in _varints(f, 5)],
        type=_varints(f, 6),
        shape=[parse_tensor_shape(v) for v in pw.get_bytes(f, 7)],
        tensor=[make_ndarray(v) for v in pw.get_bytes(f, 8)],
        func=[parse_name_attr_list(v) for v in pw.get_bytes(f, 9)])


def parse_name_attr_list(buf) -> NameAttrList:
    f = _parse(buf)
    return NameAttrList(_string(f, 1), _map(f, 2, parse_attr_value))


def parse_attr_value(buf) -> AttrValue:
    """AttrValue bytes → :class:`AttrValue` (a writer sets one member of
    the oneof; of several, the one met last wins)."""
    kind, value = None, None
    for num, entries in _parse(buf).items():
        if num in _ATTR_FIELDS:
            name, fn = _ATTR_FIELDS[num]
            kind, value = name, fn(entries[-1][1])
    return AttrValue(kind, value)


_ATTR_FIELDS = {
    1: ("list", lambda v: _parse_list(v)),
    2: ("s", lambda v: bytes(v)),
    3: ("i", lambda v: pw._to_signed64(v)),
    4: ("f", lambda v: struct.unpack("<f", v)[0]),
    5: ("b", lambda v: bool(v)),
    6: ("type", lambda v: int(v)),
    7: ("shape", lambda v: parse_tensor_shape(v)),
    8: ("tensor", lambda v: make_ndarray(v)),
    9: ("placeholder", lambda v: _str(v)),
    10: ("func", lambda v: parse_name_attr_list(v)),
}


class NodeDef:
    __slots__ = ("name", "op", "input", "device", "attr")

    def __init__(self, name: str, op: str, input: List[str], device: str,
                 attr: Dict[str, AttrValue]):
        self.name = name
        self.op = op
        self.input = input
        self.device = device
        self.attr = attr

    def __repr__(self):
        return f"NodeDef({self.name!r}, {self.op!r}, {self.input})"


def parse_node_def(buf) -> NodeDef:
    f = _parse(buf)
    return NodeDef(_string(f, 1), _string(f, 2), _strings(f, 3),
                   _string(f, 4), _map(f, 5, parse_attr_value))


# ---------------------------------------------------------------------------
# FunctionDef, GraphDef
# ---------------------------------------------------------------------------


class ArgDef:
    __slots__ = ("name", "type", "type_attr", "number_attr",
                 "type_list_attr")

    def __init__(self, name, type, type_attr, number_attr, type_list_attr):
        self.name = name
        self.type = type
        self.type_attr = type_attr
        self.number_attr = number_attr
        self.type_list_attr = type_list_attr


class OpDef:
    __slots__ = ("name", "input_arg", "output_arg")

    def __init__(self, name: str, input_arg: List[ArgDef],
                 output_arg: List[ArgDef]):
        self.name = name
        self.input_arg = input_arg
        self.output_arg = output_arg


def _parse_arg(buf) -> ArgDef:
    f = _parse(buf)
    return ArgDef(_string(f, 1), pw.get_varint(f, 3, 0), _string(f, 4),
                  _string(f, 5), _string(f, 6))


def parse_op_def(buf) -> OpDef:
    f = _parse(buf)
    return OpDef(_string(f, 1), [_parse_arg(v) for v in pw.get_bytes(f, 2)],
                 [_parse_arg(v) for v in pw.get_bytes(f, 3)])


class FunctionDef:
    """``FunctionDef``: ``signature`` (an :class:`OpDef`), ``node_def``,
    ``ret`` (output arg → ``node:out_arg:idx`` tensor) and ``attr``."""

    __slots__ = ("signature", "node_def", "ret", "attr")

    def __init__(self, signature: OpDef, node_def: List[NodeDef],
                 ret: Dict[str, str], attr: Dict[str, AttrValue]):
        self.signature = signature
        self.node_def = node_def
        self.ret = ret
        self.attr = attr


def parse_function_def(buf) -> FunctionDef:
    f = _parse(buf)
    return FunctionDef(
        parse_op_def(_message(f, 1) or b""),
        [parse_node_def(v) for v in pw.get_bytes(f, 3)],
        _map(f, 4, _str), _map(f, 5, parse_attr_value))


class FunctionDefLibrary:
    __slots__ = ("function",)

    def __init__(self, function: List[FunctionDef]):
        self.function = function


class GraphDef:
    """``GraphDef``: ``node`` and ``library`` (``versions`` is not read)."""

    __slots__ = ("node", "library")

    def __init__(self, node: List[NodeDef], library: FunctionDefLibrary):
        self.node = node
        self.library = library


def parse_graph_def(data) -> GraphDef:
    """Serialized GraphDef bytes (or a memoryview of them) →
    :class:`GraphDef`."""
    f = _parse(data)
    lib = _message(f, 2)
    functions = ([parse_function_def(v)
                  for v in pw.get_bytes(_parse(lib), 1)]
                 if lib is not None else [])
    return GraphDef([parse_node_def(v) for v in pw.get_bytes(f, 1)],
                    FunctionDefLibrary(functions))


# ---------------------------------------------------------------------------
# SavedModel, MetaGraphDef, SignatureDef, TensorInfo
# ---------------------------------------------------------------------------


class TensorInfo:
    __slots__ = ("name", "dtype", "tensor_shape")

    def __init__(self, name: str, dtype: int, tensor_shape: TensorShape):
        self.name = name
        self.dtype = dtype
        self.tensor_shape = tensor_shape


def _parse_tensor_info(buf) -> TensorInfo:
    f = _parse(buf)
    return TensorInfo(_string(f, 1), pw.get_varint(f, 2, 0),
                      parse_tensor_shape(_message(f, 3)))


class SignatureDef:
    __slots__ = ("inputs", "outputs", "method_name")

    def __init__(self, inputs: Dict[str, TensorInfo],
                 outputs: Dict[str, TensorInfo], method_name: str):
        self.inputs = inputs
        self.outputs = outputs
        self.method_name = method_name


def _parse_signature(buf) -> SignatureDef:
    f = _parse(buf)
    return SignatureDef(_map(f, 1, _parse_tensor_info),
                        _map(f, 2, _parse_tensor_info), _string(f, 3))


class MetaGraphDef:
    __slots__ = ("graph_def", "signature_def")

    def __init__(self, graph_def: GraphDef,
                 signature_def: Dict[str, SignatureDef]):
        self.graph_def = graph_def
        self.signature_def = signature_def


class SavedModel:
    __slots__ = ("saved_model_schema_version", "meta_graphs")

    def __init__(self, version: int, meta_graphs: List[MetaGraphDef]):
        self.saved_model_schema_version = version
        self.meta_graphs = meta_graphs


def parse_saved_model(data) -> SavedModel:
    """``saved_model.pb`` bytes → :class:`SavedModel`."""
    f = _parse(data)
    metas = []
    for mbuf in pw.get_bytes(f, 2):
        mf = _parse(mbuf)
        metas.append(MetaGraphDef(parse_graph_def(_message(mf, 2) or b""),
                                  _map(mf, 5, _parse_signature)))
    return SavedModel(pw.get_varint(f, 1, 0), metas)


# ---------------------------------------------------------------------------
# TrackableObjectGraph
# ---------------------------------------------------------------------------


class SerializedTensor:
    __slots__ = ("name", "full_name", "checkpoint_key")

    def __init__(self, name: str, full_name: str, checkpoint_key: str):
        self.name = name
        self.full_name = full_name
        self.checkpoint_key = checkpoint_key


class TrackableObject:
    __slots__ = ("children", "attributes")

    def __init__(self, children: List[tuple],
                 attributes: List[SerializedTensor]):
        self.children = children  # (node_id, local_name)
        self.attributes = attributes


class TrackableObjectGraph:
    __slots__ = ("nodes",)

    def __init__(self, nodes: List[TrackableObject]):
        self.nodes = nodes


def parse_trackable_object_graph(data) -> TrackableObjectGraph:
    f = _parse(data)
    nodes = []
    for nbuf in pw.get_bytes(f, 1):
        nf = _parse(nbuf)
        children = []
        for c in pw.get_bytes(nf, 1):
            cf = _parse(c)
            children.append((pw.get_varint(cf, 1, 0), _string(cf, 2)))
        attrs = []
        for a in pw.get_bytes(nf, 2):
            af = _parse(a)
            attrs.append(SerializedTensor(_string(af, 1), _string(af, 2),
                                          _string(af, 3)))
        nodes.append(TrackableObject(children, attrs))
    return TrackableObjectGraph(nodes)
