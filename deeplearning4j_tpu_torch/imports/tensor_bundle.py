"""TF2 checkpoint reader: a tensor bundle read without TensorFlow.

The port's counterpart of ``tf.train.load_checkpoint`` for what the TF
importer reads from a SavedModel: ``variables/variables.index`` and its
``variables.data-0000k-of-0000n`` shards (TensorFlow's
``core/util/tensor_bundle`` format).

* The index is a LevelDB-format table: a 48-byte footer (the metaindex and
  index block handles, then the magic ``0xdb4775248b80fb57``), an index
  block whose values are the data blocks' handles, and data blocks of
  prefix-compressed keys with restart points. Every block is followed by a
  5-byte trailer: its compression type and a masked crc32c. TensorFlow
  writes bundles uncompressed; a compressed block raises.
* Each key's value is a ``BundleEntryProto`` (dtype, shape, shard,
  offset, size, crc32c); the key ``""`` holds the ``BundleHeaderProto``
  (the number of shards). A numeric tensor is its raw little-endian
  bytes; a string tensor is the varint64 lengths of its elements, a 4-byte
  checksum of the lengths, then the bytes.
* ``verify=True`` checks each block's and each tensor's crc32c
  (:func:`crc32c`, vectorized over numpy lanes).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.imports import protowire as pw
from deeplearning4j_tpu_torch.imports import tf_proto

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
TRAILER_BYTES = 5

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), masked as LevelDB and the bundle writer store it
# ---------------------------------------------------------------------------


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def _crc_bytes(crc: int, data) -> int:
    """The raw register after ``data`` (no pre or post inversion)."""
    table = _CRC_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def _zeros_operator(n: int) -> List[int]:
    """The register map of ``n`` zero bytes, a linear map over GF(2):
    column ``i`` is the image of bit ``i`` (by repeated squaring)."""
    def apply(op, v):
        out, i = 0, 0
        while v:
            if v & 1:
                out ^= op[i]
            v >>= 1
            i += 1
        return out

    one = [_crc_bytes(1 << i, b"\0") for i in range(32)]
    out = [1 << i for i in range(32)]
    while n:
        if n & 1:
            out = [apply(one, c) for c in out]
        one = [apply(one, c) for c in one]
        n >>= 1
    return out


_LANES = 16384


def crc32c(data, crc: int = 0) -> int:
    """crc32c (Castagnoli) of ``data``, continuing from ``crc``. Past
    1 MiB the bytes run as 16384 lanes in numpy, one byte of every lane a
    step, and the lanes' registers are joined by the register map of a
    lane's length of zeros (the register is linear in its input), so a
    large tensor is not a Python loop over its bytes."""
    data = memoryview(data).cast("B")
    reg = crc ^ 0xFFFFFFFF
    n = len(data) // _LANES
    if n < 64:
        return _crc_bytes(reg, data) ^ 0xFFFFFFFF
    lanes = np.frombuffer(data[:n * _LANES], np.uint8).reshape(_LANES, n)
    cols = np.ascontiguousarray(lanes.T)  # row j: byte j of every lane
    table = np.asarray(_CRC_TABLE, np.uint32)
    r = np.zeros(_LANES, np.uint32)
    for j in range(n):
        r = table[(r ^ cols[j]) & 0xFF] ^ (r >> 8)
    shift = _zeros_operator(n)
    for lane in r.tolist():
        out, i, v = 0, 0, reg
        while v:
            if v & 1:
                out ^= shift[i]
            v >>= 1
            i += 1
        reg = out ^ lane
    return _crc_bytes(reg, data[n * _LANES:]) ^ 0xFFFFFFFF


def unmask_crc(masked: int) -> int:
    rot = (masked - 0xA282EAD8) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the LevelDB table
# ---------------------------------------------------------------------------


def _handle(buf, i: int = 0) -> Tuple[int, int, int]:
    """A BlockHandle at ``buf[i:]``: (offset, size, next index)."""
    off, i = pw.read_varint(buf, i)
    size, i = pw.read_varint(buf, i)
    return off, size, i


def _block(data: memoryview, off: int, size: int, verify: bool,
           where: str) -> memoryview:
    """The contents of the block at (``off``, ``size``), its trailer
    checked."""
    if off + size + TRAILER_BYTES > len(data):
        raise ValueError(f"{where}: block at {off}+{size} runs past the "
                         f"end of the file ({len(data)} bytes)")
    ctype = data[off + size]
    if ctype != 0:
        raise ValueError(
            f"{where}: block at {off} is compressed (type {ctype}); "
            f"TensorFlow writes tensor bundles uncompressed and this reader "
            f"takes only those")
    if verify:
        (stored,) = struct.unpack_from("<I", data, off + size + 1)
        got = crc32c(data[off:off + size + 1])
        if unmask_crc(stored) != got:
            raise ValueError(f"{where}: block at {off} fails its crc32c")
    return data[off:off + size]


def _block_entries(block: memoryview) -> Iterator[Tuple[bytes, memoryview]]:
    """The (key, value) pairs of one block, keys rebuilt from their shared
    prefixes."""
    (n_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    end = len(block) - 4 - 4 * n_restarts
    i, key = 0, b""
    while i < end:
        shared, i = pw.read_varint(block, i)
        non_shared, i = pw.read_varint(block, i)
        vlen, i = pw.read_varint(block, i)
        key = key[:shared] + bytes(block[i:i + non_shared])
        i += non_shared
        yield key, block[i:i + vlen]
        i += vlen


def read_table(data, *, verify: bool = True,
               where: str = "table") -> Dict[bytes, memoryview]:
    """Every (key, value) of a LevelDB-format table file's bytes."""
    data = memoryview(data)
    if len(data) < FOOTER_BYTES:
        raise ValueError(f"{where}: {len(data)} bytes is shorter than a "
                         f"table footer")
    footer = data[len(data) - FOOTER_BYTES:]
    (magic,) = struct.unpack_from("<Q", footer, FOOTER_BYTES - 8)
    if magic != TABLE_MAGIC:
        raise ValueError(f"{where}: bad table magic {magic:#x}")
    _, _, i = _handle(footer)  # the metaindex block: empty in bundles
    idx_off, idx_size, _ = _handle(footer, i)
    out: Dict[bytes, memoryview] = {}
    index = _block(data, idx_off, idx_size, verify, where)
    for _, handle in _block_entries(index):
        off, size, _ = _handle(handle)
        for key, value in _block_entries(_block(data, off, size, verify,
                                                where)):
            out[key] = value
    return out


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------


class BundleEntry:
    """``BundleEntryProto``."""

    __slots__ = ("dtype", "shape", "shard_id", "offset", "size", "crc32c",
                 "sliced")

    def __init__(self, buf):
        f = pw.parse_message(buf)
        self.dtype = pw.get_varint(f, 1, 0)
        self.shape = tuple(d.size for d in tf_proto.parse_tensor_shape(
            tf_proto._message(f, 2)).dim)
        self.shard_id = pw.get_varint(f, 3, 0)
        self.offset = pw.get_varint(f, 4, 0)
        self.size = pw.get_varint(f, 5, 0)
        crc = [v for wt, v in f.get(6, []) if wt == pw.I32]
        self.crc32c = struct.unpack("<I", crc[-1])[0] if crc else None
        self.sliced = bool(f.get(7))


class BundleReader:
    """A TF2 checkpoint ``prefix`` (``.../variables/variables``): the
    index read when constructed, each shard's bytes when first needed.
    :meth:`get_variable_to_shape_map` and :meth:`get_tensor` answer as
    ``tf.train.load_checkpoint``'s reader does."""

    def __init__(self, prefix: str, *, verify: bool = True):
        self.prefix = prefix
        self.verify = verify
        with open(prefix + ".index", "rb") as f:
            table = read_table(f.read(), verify=verify,
                               where=prefix + ".index")
        header = table.pop(b"", None)
        self.num_shards = (pw.get_varint(pw.parse_message(header), 1, 1)
                           if header is not None else 1)
        self.entries: Dict[str, BundleEntry] = {
            k.decode("utf-8"): BundleEntry(v) for k, v in table.items()}
        self._shards: Dict[int, memoryview] = {}

    def _shard(self, k: int) -> memoryview:
        data = self._shards.get(k)
        if data is None:
            path = f"{self.prefix}.data-{k:05d}-of-{self.num_shards:05d}"
            with open(path, "rb") as f:
                data = self._shards[k] = memoryview(f.read())
        return data

    def get_variable_to_shape_map(self) -> Dict[str, Tuple[int, ...]]:
        return {k: e.shape for k, e in self.entries.items()}

    def has_tensor(self, key: str) -> bool:
        return key in self.entries

    def get_tensor(self, key: str) -> np.ndarray:
        e = self.entries.get(key)
        if e is None:
            raise KeyError(f"{key!r} is not in checkpoint {self.prefix}")
        if e.sliced:
            raise NotImplementedError(
                f"{key!r}: a partitioned (sliced) variable; this reader "
                f"takes whole tensors only")
        raw = self._shard(e.shard_id)[e.offset:e.offset + e.size]
        dtype = tf_proto.numpy_dtype(e.dtype)
        n = int(np.prod(e.shape, dtype=np.int64))
        if dtype == object:
            out, crc = _string_tensor(raw, n)
        else:
            out = np.frombuffer(raw, dtype=dtype).copy()
            crc = crc32c(raw) if self.verify else None
        if self.verify and e.crc32c is not None \
                and unmask_crc(e.crc32c) != crc:
            raise ValueError(f"{key!r}: tensor bytes fail their crc32c")
        return out.reshape(e.shape)


def _string_tensor(raw: memoryview, n: int) -> Tuple[np.ndarray, int]:
    """A string tensor's elements and the crc32c the writer computed: over
    each length as a little-endian uint32 (uint64 past 2**32 - 1), the 4
    checksum bytes, then the bytes."""
    lengths, i = [], 0
    for _ in range(n):
        ln, i = pw.read_varint(raw, i)
        lengths.append(ln)
    crc = crc32c(b"".join(struct.pack("<I" if ln <= 0xFFFFFFFF else "<Q", ln)
                          for ln in lengths) + bytes(raw[i:i + 4]))
    i += 4
    out = np.empty(n, dtype=object)
    for k, ln in enumerate(lengths):
        out[k] = bytes(raw[i:i + ln])
        crc = crc32c(out[k], crc)
        i += ln
    return out, crc


def load_checkpoint(prefix: str, *, verify: bool = True) -> BundleReader:
    """``tf.train.load_checkpoint`` for a checkpoint prefix, or a
    directory holding ``variables/variables.index``."""
    if os.path.isdir(prefix):
        prefix = os.path.join(prefix, "variables", "variables")
    return BundleReader(prefix, verify=verify)


def object_graph(reader: BundleReader) -> Optional[
        tf_proto.TrackableObjectGraph]:
    """The checkpoint's ``_CHECKPOINTABLE_OBJECT_GRAPH``, or None in a
    checkpoint written without one."""
    key = "_CHECKPOINTABLE_OBJECT_GRAPH"
    if not reader.has_tensor(key):
        return None
    return tf_proto.parse_trackable_object_graph(
        reader.get_tensor(key).reshape(-1)[0])
