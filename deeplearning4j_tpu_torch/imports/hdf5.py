"""Read-only HDF5 reader: the files Keras and h5py write, read without
h5py.

The port's counterpart of the reference's ``Hdf5Archive`` and of what the
JAX Keras importer takes from ``h5py``. It covers the format that HDF5
writes by default ("earliest" library version), which is what a legacy
Keras ``.h5`` file and the ``model.weights.h5`` inside a ``.keras`` zip
hold:

* superblock versions 0 and 1 (8-byte offsets and lengths or smaller);
* version-1 object headers, with continuation blocks;
* symbol-table groups: a version-1 B-tree (``TREE``) of any depth over
  symbol-table nodes (``SNOD``), names in the local heap (``HEAP``);
* dataspaces: scalar, simple (a dimension may be 0);
* datatypes: fixed-point (signed and unsigned, 1-8 bytes), IEEE floats of
  16, 32 and 64 bits in either byte order, fixed-length strings, and
  variable-length strings and sequences, whose elements live in global
  heap collections (``GCOL``), each collection parsed once;
* data layout version 3, contiguous and compact;
* attribute messages versions 1-3.

Anything else raises :class:`NotImplementedError` naming the feature and
the object's path: chunked or filtered data, superblock versions 2 and 3
and their ``OHDR`` object headers, new-style (link-message) groups,
dense attribute storage, shared messages, references, compound, enum and
array types. The reader never guesses.

The file is read through ``mmap`` (a path) or a ``memoryview`` (bytes);
arrays come out of ``np.frombuffer`` as native-order copies. The API is
the subset of h5py's that the Keras importer uses: :class:`File` (a
:class:`Group`), ``Group.keys()`` / iteration / ``in`` / ``[path]`` /
``get``, :class:`Dataset` with ``shape``, ``dtype`` and
``np.asarray(ds)``, and ``attrs`` (a dict). String attributes read as h5py
reads them: a variable-length string as ``str``, an array of them as an
object array of ``str``, a fixed-length string as ``np.bytes_`` (an array
of them with an ``S`` dtype).
"""

from __future__ import annotations

import mmap
import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
MSG_DATASPACE = 0x0001
MSG_LINK_INFO = 0x0002
MSG_DATATYPE = 0x0003
MSG_FILL = 0x0005
MSG_LINK = 0x0006
MSG_EXTERNAL = 0x0007
MSG_LAYOUT = 0x0008
MSG_FILTERS = 0x000B
MSG_ATTRIBUTE = 0x000C
MSG_CONTINUATION = 0x0010
MSG_SYMBOL_TABLE = 0x0011
MSG_ATTRIBUTE_INFO = 0x0015

# datatype classes
CLS_FIXED = 0
CLS_FLOAT = 1
CLS_STRING = 3
CLS_VLEN = 9
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 10: "array", 11: "complex"}

# the standard IEEE layouts: size -> (exponent location, exponent size,
# mantissa size, exponent bias)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


def _align8(n: int) -> int:
    return (n + 7) & ~7


class _DType:
    """A parsed datatype message: ``np`` is the numpy dtype of one element
    as stored (byte order included), or None for variable-length types."""

    def __init__(self, cls: int, size: int, np_dtype=None, *,
                 vlen_string: bool = False, base: "Optional[_DType]" = None,
                 utf8: bool = False):
        self.cls = cls
        self.size = size
        self.np = np_dtype
        self.vlen_string = vlen_string
        self.base = base
        self.utf8 = utf8


class _Reader:
    """The open file: its buffer, sizes and the parsed-once caches."""

    def __init__(self, buf, where: str):
        self.buf = buf
        self.where = where
        if bytes(buf[:8]) != SIGNATURE:
            raise ValueError(f"{where}: not an HDF5 file (or one with a "
                             f"user block)")
        version = buf[8]
        if version not in (0, 1):
            raise NotImplementedError(
                f"{where}: HDF5 superblock version {version} (files written "
                f"with libver='latest' or 'v108'+; their version-2 object "
                f"headers are not read)")
        self.so = buf[13]   # size of offsets
        self.sl = buf[14]   # size of lengths
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise NotImplementedError(
                f"{where}: offset size {self.so} / length size {self.sl}")
        p = 24 + (4 if version == 1 else 0)
        self.base = self.addr(p)  # every address is relative to it
        p += 4 * self.so  # past the four superblock addresses
        self.root_entry = p
        self.undef = (1 << (8 * self.so)) - 1
        self._heaps: Dict[int, Dict[int, memoryview]] = {}
        self._headers: Dict[int, List[Tuple[int, int, int]]] = {}

    # -- scalars --------------------------------------------------------
    def uint(self, p: int, n: int) -> int:
        return int.from_bytes(self.buf[p:p + n], "little")

    def addr(self, p: int) -> int:
        return self.uint(p, self.so)

    def length(self, p: int) -> int:
        return self.uint(p, self.sl)

    def at(self, a: int) -> int:
        """A file address as a buffer offset."""
        return a + self.base

    def cstr(self, p: int) -> bytes:
        end = p
        buf = self.buf
        n = len(buf)
        while end < n and buf[end] != 0:
            end += 1
        return bytes(buf[p:end])

    # -- object headers -------------------------------------------------
    def messages(self, oaddr: int, path: str) -> List[Tuple[int, int, int]]:
        """(type, flags, data offset) of every message of the version-1
        object header at ``oaddr``, continuation blocks followed."""
        got = self._headers.get(oaddr)
        if got is not None:
            return got
        p = self.at(oaddr)
        if bytes(self.buf[p:p + 4]) == b"OHDR":
            raise NotImplementedError(
                f"{self.where}:{path}: version-2 object header (OHDR)")
        version = self.buf[p]
        if version != 1:
            raise NotImplementedError(
                f"{self.where}:{path}: object header version {version}")
        nmsgs = self.uint(p + 2, 2)
        size = self.uint(p + 8, 4)
        out: List[Tuple[int, int, int]] = []
        blocks = [(p + 16, size)]
        while blocks and len(out) < nmsgs:
            start, size = blocks.pop(0)
            q, end = start, start + size
            while q + 8 <= end and len(out) < nmsgs:
                mtype = self.uint(q, 2)
                msize = self.uint(q + 2, 2)
                flags = self.buf[q + 4]
                data = q + 8
                if mtype == MSG_CONTINUATION:
                    blocks.append((self.at(self.addr(data)),
                                   self.length(data + self.so)))
                out.append((mtype, flags, data))
                q = data + msize
        self._headers[oaddr] = out
        return out

    # -- datatypes ------------------------------------------------------
    def dtype(self, p: int, path: str) -> _DType:
        b0 = self.buf[p]
        cls, version = b0 & 0x0F, b0 >> 4
        bits = self.uint(p + 1, 3)
        size = self.uint(p + 4, 4)
        props = p + 8
        if cls == CLS_FIXED:
            if size not in (1, 2, 4, 8):
                raise NotImplementedError(
                    f"{self.where}:{path}: {size}-byte integer")
            offset, precision = struct.unpack_from("<HH", self.buf, props)
            if offset != 0 or precision != 8 * size:
                raise NotImplementedError(
                    f"{self.where}:{path}: integer with bit offset {offset},"
                    f" precision {precision}")
            order = ">" if bits & 1 else "<"
            kind = "i" if bits & 0x08 else "u"
            return _DType(cls, size, np.dtype(f"{order}{kind}{size}"))
        if cls == CLS_FLOAT:
            if size not in _IEEE or bits & 0x40:
                raise NotImplementedError(
                    f"{self.where}:{path}: {size}-byte float (byte order "
                    f"bits {bits & 0x41:#x})")
            offset, precision = struct.unpack_from("<HH", self.buf, props)
            eloc, esize, mloc, msize = self.buf[props + 4:props + 8]
            bias = self.uint(props + 8, 4)
            if (offset, precision, mloc) != (0, 8 * size, 0) or \
                    (eloc, esize, msize, bias) != _IEEE[size]:
                raise NotImplementedError(
                    f"{self.where}:{path}: non-IEEE {size}-byte float")
            order = ">" if bits & 1 else "<"
            return _DType(cls, size, np.dtype(f"{order}f{size}"))
        if cls == CLS_STRING:
            return _DType(cls, size, np.dtype(f"S{size}"),
                          utf8=((bits >> 4) & 0x0F) == 1)
        if cls == CLS_VLEN:
            vtype = bits & 0x0F
            base = self.dtype(props, path)
            if vtype == 1:
                return _DType(cls, size, None, vlen_string=True, base=base,
                              utf8=((bits >> 8) & 0x0F) == 1)
            if vtype == 0:
                if base.np is None:
                    raise NotImplementedError(
                        f"{self.where}:{path}: nested variable-length type")
                return _DType(cls, size, None, base=base)
            raise NotImplementedError(
                f"{self.where}:{path}: variable-length type {vtype}")
        name = _CLASS_NAMES.get(cls, f"class {cls}")
        raise NotImplementedError(
            f"{self.where}:{path}: {name} datatype (version {version})")

    # -- dataspaces -----------------------------------------------------
    def dataspace(self, p: int, path: str) -> Tuple[int, ...]:
        version, rank, flags = self.buf[p], self.buf[p + 1], self.buf[p + 2]
        if version == 1:
            q = p + 8
        elif version == 2:
            kind = self.buf[p + 3]
            if kind == 2:
                raise NotImplementedError(
                    f"{self.where}:{path}: null dataspace")
            q = p + 4
        else:
            raise NotImplementedError(
                f"{self.where}:{path}: dataspace version {version}")
        return tuple(self.length(q + i * self.sl) for i in range(rank))

    # -- global heap ----------------------------------------------------
    def collection(self, caddr: int) -> Dict[int, memoryview]:
        """Every object of the global heap collection at ``caddr`` (index
        -> bytes), parsed once."""
        got = self._heaps.get(caddr)
        if got is not None:
            return got
        p = self.at(caddr)
        if bytes(self.buf[p:p + 4]) != b"GCOL":
            raise ValueError(f"{self.where}: no global heap collection at "
                             f"{caddr:#x}")
        size = self.length(p + 8)
        end = p + size
        q = p + 8 + self.sl
        hdr = 8 + self.sl
        objs: Dict[int, memoryview] = {}
        while q + hdr <= end:
            idx = self.uint(q, 2)
            osize = self.length(q + 8)
            if idx == 0:
                break  # the free space runs to the collection's end
            objs[idx] = self.buf[q + hdr:q + hdr + osize]
            q += hdr + _align8(osize)
        self._heaps[caddr] = objs
        return objs

    def vlen(self, raw: memoryview, dt: _DType, count: int, path: str):
        """The ``count`` variable-length elements whose heap ids (length,
        collection address, index) are in ``raw``."""
        rec = np.dtype([("n", "<u4"), ("coll", f"<u{self.so}"),
                        ("idx", "<u4")])
        if self.so not in (4, 8):
            raise NotImplementedError(
                f"{self.where}:{path}: variable-length data with "
                f"{self.so}-byte offsets")
        ids = np.frombuffer(raw, rec, count)
        out = np.empty(count, dtype=object)
        for coll in np.unique(ids["coll"]):
            objs = self.collection(int(coll)) if coll else {}
            for i in np.nonzero(ids["coll"] == coll)[0]:
                n, idx = int(ids["n"][i]), int(ids["idx"][i])
                if n == 0 or not coll:
                    data = b""
                else:
                    data = objs[idx]
                if dt.vlen_string:
                    s = bytes(data[:n])
                    out[i] = s.decode("utf-8" if dt.utf8 else "ascii",
                                      errors="surrogateescape")
                else:
                    base = dt.base.np
                    out[i] = np.frombuffer(data, base, n).astype(
                        base.newbyteorder("="))
        return out

    def values(self, raw, dt: _DType, shape: Tuple[int, ...], path: str):
        """The array (or scalar, for shape ()) stored in ``raw``."""
        count = int(np.prod(shape)) if shape else 1
        if dt.np is None:
            out = self.vlen(raw, dt, count, path)
        else:
            out = np.frombuffer(raw, dt.np, count)
            if dt.np.kind in "iuf":
                out = out.astype(dt.np.newbyteorder("="))
            else:
                out = out.copy()
        if shape:
            return out.reshape(shape)
        return out[0]


class Dataset:
    """A dataset: ``shape``, ``dtype``, ``attrs``; ``np.asarray(ds)`` or
    ``ds[()]`` reads it."""

    def __init__(self, r: _Reader, oaddr: int, path: str):
        self._r = r
        self._path = path
        self.attrs: Dict[str, Any] = {}
        self._layout = None
        dt = shape = None
        for mtype, flags, p in r.messages(oaddr, path):
            if flags & 0x02 and mtype in (MSG_DATATYPE, MSG_DATASPACE,
                                          MSG_FILL, MSG_LAYOUT):
                raise NotImplementedError(
                    f"{r.where}:{path}: shared message (type {mtype:#x}, a "
                    f"committed datatype)")
            if mtype == MSG_DATASPACE:
                shape = r.dataspace(p, path)
            elif mtype == MSG_DATATYPE:
                dt = r.dtype(p, path)
            elif mtype == MSG_LAYOUT:
                self._layout = p
            elif mtype in (MSG_FILTERS, MSG_EXTERNAL):
                raise NotImplementedError(
                    f"{r.where}:{path}: "
                    f"{'filtered' if mtype == MSG_FILTERS else 'external'} "
                    f"storage")
        _read_attrs(r, oaddr, path, self.attrs)
        if dt is None or shape is None or self._layout is None:
            raise ValueError(f"{r.where}:{path}: dataset without a "
                             f"datatype, dataspace or layout message")
        self._dt = dt
        self.shape = shape
        self.dtype = (dt.np.newbyteorder("=") if dt.np is not None
                      and dt.np.kind in "iuf" else
                      dt.np if dt.np is not None else np.dtype(object))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def _raw(self) -> Optional[memoryview]:
        r, p, path = self._r, self._layout, self._path
        version, cls = r.buf[p], r.buf[p + 1]
        if version != 3:
            raise NotImplementedError(
                f"{r.where}:{path}: data layout message version {version}")
        nbytes = self.size * self._dt.size
        if cls == 0:  # compact
            n = r.uint(p + 2, 2)
            return r.buf[p + 4:p + 4 + min(n, nbytes)]
        if cls == 1:  # contiguous
            a = r.addr(p + 2)
            if a == r.undef:
                return None  # never written: the fill value (zeros)
            start = r.at(a)
            return r.buf[start:start + nbytes]
        raise NotImplementedError(
            f"{r.where}:{path}: {'chunked' if cls == 2 else 'virtual'} "
            f"data layout")

    def read(self):
        raw = self._raw()
        if raw is None:
            if self._dt.np is None:
                raise NotImplementedError(
                    f"{self._r.where}:{self._path}: unwritten "
                    f"variable-length dataset")
            out = np.zeros(self.shape, self.dtype)
            return out if self.shape else out[()]
        return self._r.values(raw, self._dt, self.shape, self._path)

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self.read())
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        out = self.read()
        return out if key == () else np.asarray(out)[key]

    def __repr__(self) -> str:
        return f"<hdf5.Dataset {self._path!r} {self.shape} {self.dtype}>"


class Group:
    """A symbol-table group: ``keys()``, iteration and ``in`` in name
    order (h5py's for such groups), ``[path]`` (relative, ``a/b/c``),
    ``get``, ``attrs``."""

    def __init__(self, r: _Reader, oaddr: int, path: str):
        self._r = r
        self._path = path
        self.attrs: Dict[str, Any] = {}
        self._links: Optional[Dict[str, int]] = None
        self._stab = None
        for mtype, flags, p in r.messages(oaddr, path):
            if mtype == MSG_SYMBOL_TABLE:
                self._stab = (r.addr(p), r.addr(p + r.so))
            elif mtype in (MSG_LINK, MSG_LINK_INFO):
                raise NotImplementedError(
                    f"{r.where}:{path}: new-style group (link messages)")
        if self._stab is None:
            raise ValueError(f"{r.where}:{path}: not a group")
        _read_attrs(r, oaddr, path, self.attrs)

    def _children(self) -> Dict[str, int]:
        if self._links is None:
            r = self._r
            btree, heap = self._stab
            hp = r.at(heap)
            if bytes(r.buf[hp:hp + 4]) != b"HEAP":
                raise ValueError(f"{r.where}:{self._path}: bad local heap")
            data = r.at(r.addr(hp + 8 + 2 * r.sl))
            links: Dict[str, int] = {}
            self._walk(btree, data, links)
            self._links = links
        return self._links

    def _walk(self, node: int, heap_data: int, links: Dict[str, int]):
        """Children of the group B-tree node at ``node`` (any level), in
        key order."""
        r = self._r
        p = r.at(node)
        if bytes(r.buf[p:p + 4]) != b"TREE" or r.buf[p + 4] != 0:
            raise ValueError(f"{r.where}:{self._path}: bad group B-tree "
                             f"node at {node:#x}")
        level = r.buf[p + 5]
        used = r.uint(p + 6, 2)
        q = p + 8 + 2 * r.so + r.sl  # past the header and key 0
        for _ in range(used):
            child = r.addr(q)
            if level > 0:
                self._walk(child, heap_data, links)
            else:
                self._snod(child, heap_data, links)
            q += r.so + r.sl
        return links

    def _snod(self, node: int, heap_data: int, links: Dict[str, int]):
        r = self._r
        p = r.at(node)
        if bytes(r.buf[p:p + 4]) != b"SNOD":
            raise ValueError(f"{r.where}:{self._path}: bad symbol table "
                             f"node at {node:#x}")
        n = r.uint(p + 6, 2)
        entry = 2 * r.so + 24
        q = p + 8
        for _ in range(n):
            name = r.cstr(heap_data + r.addr(q)).decode("utf-8")
            links[name] = r.addr(q + r.so)
            q += entry

    def keys(self) -> List[str]:
        return list(self._children())

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._children())

    def _lookup(self, path: str):
        node: Any = self
        for part in [s for s in path.split("/") if s and s != "."]:
            if not isinstance(node, Group):
                raise KeyError(path)
            oaddr = node._children().get(part)
            if oaddr is None:
                raise KeyError(path)
            node = _open(self._r, oaddr,
                         f"{node._path.rstrip('/')}/{part}")
        return node

    def __getitem__(self, path: str):
        return self._lookup(path)

    def get(self, path: str, default=None):
        try:
            return self[path]
        except KeyError:
            return default

    def __contains__(self, path: str) -> bool:
        node: Any = self
        for part in [s for s in path.split("/") if s and s != "."]:
            if not isinstance(node, Group) or part not in node._children():
                return False
            node = node[part]
        return True

    def __repr__(self) -> str:
        return f"<hdf5.Group {self._path!r} ({len(self)} members)>"


def _open(r: _Reader, oaddr: int, path: str):
    for mtype, _, _ in r.messages(oaddr, path):
        if mtype in (MSG_SYMBOL_TABLE, MSG_LINK, MSG_LINK_INFO):
            return Group(r, oaddr, path)
    for mtype, _, _ in r.messages(oaddr, path):
        if mtype == MSG_LAYOUT:
            return Dataset(r, oaddr, path)
    raise NotImplementedError(f"{r.where}:{path}: object that is neither a "
                              f"group nor a dataset (a committed datatype)")


def _read_attrs(r: _Reader, oaddr: int, path: str, into: Dict[str, Any]):
    for mtype, flags, p in r.messages(oaddr, path):
        if mtype == MSG_ATTRIBUTE_INFO:
            # version, flags, [max creation index], fractal heap address
            aflags = r.buf[p + 1]
            q = p + 2 + (2 if aflags & 1 else 0)
            if r.addr(q) != r.undef:
                raise NotImplementedError(
                    f"{r.where}:{path}: dense attribute storage (fractal "
                    f"heap)")
        if mtype != MSG_ATTRIBUTE:
            continue
        if flags & 0x02:
            raise NotImplementedError(
                f"{r.where}:{path}: shared attribute message")
        version = r.buf[p]
        aflags = r.buf[p + 1]
        name_n, type_n, space_n = struct.unpack_from("<HHH", r.buf, p + 2)
        if version == 1:
            q = p + 8
            pad = _align8
        elif version in (2, 3):
            q = p + 8 + (1 if version == 3 else 0)
            pad = int
        else:
            raise NotImplementedError(
                f"{r.where}:{path}: attribute message version {version}")
        if aflags & 0x03:
            raise NotImplementedError(
                f"{r.where}:{path}: attribute with a shared datatype or "
                f"dataspace")
        name = r.cstr(q).decode("utf-8")
        q += pad(name_n)
        where = f"{path} attribute {name!r}"
        dt = r.dtype(q, where)
        q += pad(type_n)
        shape = r.dataspace(q, where)
        q += pad(space_n)
        count = int(np.prod(shape)) if shape else 1
        raw = r.buf[q:q + count * dt.size]
        into[name] = r.values(raw, dt, shape, where)


class File(Group):
    """An HDF5 file opened read-only from a path, ``bytes`` or a
    file-like object's contents; a context manager, as ``h5py.File``."""

    def __init__(self, source, mode: str = "r"):
        if mode != "r":
            raise ValueError("the HDF5 reader is read-only")
        self._mmap = None
        self._fh = None
        if isinstance(source, (bytes, bytearray, memoryview)):
            buf = memoryview(source)
            where = "<bytes>"
        elif hasattr(source, "read"):
            buf = memoryview(source.read())
            where = getattr(source, "name", "<stream>")
        else:
            where = str(source)
            self._fh = open(source, "rb")
            self._mmap = mmap.mmap(self._fh.fileno(), 0,
                                   access=mmap.ACCESS_READ)
            buf = memoryview(self._mmap)
        self._buf = buf
        r = _Reader(buf, where)
        super().__init__(r, r.addr(r.root_entry + r.so), "/")

    def close(self) -> None:
        """Drop the buffer. Arrays already read are copies and stay
        valid."""
        if self._r is not None:
            self._r._heaps.clear()  # slices of the buffer
            self._r = None  # type: ignore[assignment]
        try:
            self._buf.release()
            if self._mmap is not None:
                self._mmap.close()
        except BufferError:
            pass  # a caller still holds a view: the map goes with it
        if self._fh is not None:
            self._fh.close()
        self._mmap = self._fh = None

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
