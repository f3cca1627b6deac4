"""Minimal protobuf wire-format codec (no protobuf dependency).

A copy of ``deeplearning4j_tpu/imports/protowire.py``: the port keeps its
own, as it imports nothing of the JAX package.

Reference parity: the reference's import stack links protobuf to read TF
GraphDefs and ONNX ModelProtos (nd4j-backends protobuf shading;
samediff-import-onnx's onnx.proto bindings). This environment has no onnx
package, so the ONNX front end decodes the wire format directly — which is
small and stable: varint tags, four wire types, length-delimited messages
(https://protobuf.dev/programming-guides/encoding/ — public spec).

The writer exists for the golden tests: they hand-assemble ONNX ModelProto
bytes (the reference generates goldens with real frameworks; here the env
has no ONNX producer either, so tests build models at the byte level and
check the imported graph against an independently coded numpy forward).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

# wire types
VARINT, I64, LEN, I32 = 0, 1, 2, 5


def read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def parse_message(buf: bytes) -> Dict[int, List[Tuple[int, Any]]]:
    """Decode one message into {field_number: [(wire_type, raw_value), ...]}.

    LEN fields stay as bytes (caller interprets as sub-message, string, or
    packed scalars); VARINT as int; I32/I64 as raw 4/8 bytes.
    """
    fields: Dict[int, List[Tuple[int, Any]]] = {}
    i = 0
    n = len(buf)
    while i < n:
        tag, i = read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == VARINT:
            v, i = read_varint(buf, i)
        elif wt == LEN:
            ln, i = read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == I64:
            v = buf[i:i + 8]
            i += 8
        elif wt == I32:
            v = buf[i:i + 4]
            i += 4
        else:  # pragma: no cover - groups are long-dead
            raise ValueError(f"unsupported wire type {wt}")
        fields.setdefault(field, []).append((wt, v))
    return fields


# -- typed accessors ---------------------------------------------------------


def get_varints(fields, num) -> List[int]:
    return [v for wt, v in fields.get(num, []) if wt == VARINT]


def get_varint(fields, num, default=0) -> int:
    vs = get_varints(fields, num)
    return vs[-1] if vs else default


def get_bytes(fields, num) -> List[bytes]:
    return [v for wt, v in fields.get(num, []) if wt == LEN]


def get_byte(fields, num, default=b"") -> bytes:
    vs = get_bytes(fields, num)
    return vs[-1] if vs else default


def get_string(fields, num, default="") -> str:
    return get_byte(fields, num, default.encode()).decode("utf-8", "replace")


def get_float(fields, num, default=0.0) -> float:
    for wt, v in fields.get(num, []):
        if wt == I32:
            return struct.unpack("<f", v)[0]
    return default


def get_packed_or_repeated_varints(fields, num) -> List[int]:
    """int64/int32 repeated fields arrive packed (proto3) or one-per-tag."""
    out: List[int] = []
    for wt, v in fields.get(num, []):
        if wt == VARINT:
            out.append(v)
        elif wt == LEN:
            i = 0
            while i < len(v):
                x, i = read_varint(v, i)
                out.append(x)
    return [_to_signed64(x) for x in out]


def get_packed_floats(fields, num) -> List[float]:
    out: List[float] = []
    for wt, v in fields.get(num, []):
        if wt == I32:
            out.append(struct.unpack("<f", v)[0])
        elif wt == LEN:
            out.extend(struct.unpack(f"<{len(v) // 4}f", v))
    return out


def _to_signed64(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


# -- writer (for golden-test model assembly) ---------------------------------


def _varint(x: int) -> bytes:
    if x < 0:
        x += 1 << 64
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_varint(num: int, val: int) -> bytes:
    return _varint(num << 3 | VARINT) + _varint(val)


def field_bytes(num: int, val: bytes) -> bytes:
    return _varint(num << 3 | LEN) + _varint(len(val)) + val


def field_string(num: int, val: str) -> bytes:
    return field_bytes(num, val.encode())


def field_float(num: int, val: float) -> bytes:
    return _varint(num << 3 | I32) + struct.pack("<f", val)


def field_packed_varints(num: int, vals) -> bytes:
    body = b"".join(_varint(v if v >= 0 else v + (1 << 64)) for v in vals)
    return field_bytes(num, body)
