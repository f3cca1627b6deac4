"""Keras ``.h5`` files written without h5py or Keras: an HDF5 writer and
builders of legacy Keras models.

:class:`H5Writer` writes the subset of HDF5 that
:mod:`deeplearning4j_tpu_torch.imports.hdf5` reads: superblock version 0,
version-1 object headers, symbol-table groups (a group's members split
over as many ``SNOD`` nodes and version-1 B-tree levels as it needs),
contiguous datasets of numeric arrays, and attributes (numeric arrays,
variable-length strings and arrays of them, kept in global heap
collections). h5py and Keras read what it writes.

:func:`bert_keras_h5` writes the legacy ``.h5`` file that Keras 3 writes
for a BERT-like functional encoder (``model_config`` with
``__keras_tensor__`` inbound nodes, ``model_weights/<layer>`` groups with
``weight_names`` in ``get_weights()`` order, ``keras_version`` and
``backend``): token and position ids, each through an ``Embedding``,
joined by ``Add``, ``LayerNormalization``, ``Dropout``; per layer
``MultiHeadAttention`` → ``Dropout`` → ``Add`` → ``LayerNormalization``
→ ``Dense(ff, gelu)`` → ``Dense(hidden)`` → ``Dropout`` → ``Add`` →
``LayerNormalization``; then ``GlobalAveragePooling1D`` →
``Dense(hidden, tanh)`` → ``Dense(2, softmax)``. :func:`conv1d_keras_h5`
writes a Sequential text classifier (``Embedding`` → ``Conv1D`` →
``MaxPooling1D`` → ``GlobalMaxPooling1D`` → ``Dense``). Weights are drawn
from a seed with numpy; both return the bytes (or write ``path``) and the
arrays by layer, in ``weight_names`` order.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K = 4        # a SNOD holds 2 * LEAF_K members
INTERNAL_K = 16   # a B-tree node holds 2 * INTERNAL_K children
GCOL_MIN = 4096   # the smallest global heap collection HDF5 writes
GCOL_PACK = 1 << 16

KERAS_VERSION = "3.13.1"
KERAS_BACKEND = "tensorflow"

BERT_BASE_KERAS = dict(layers=12, hidden=768, heads=12, ff=3072,
                       vocab=30522, max_positions=512)


def _align(n: int, a: int = 8) -> int:
    return (n + a - 1) // a * a


def _pad(b: bytes, a: int = 8) -> bytes:
    return b + b"\0" * (_align(len(b), a) - len(b))


# ---------------------------------------------------------------------------
# HDF5 encodings
# ---------------------------------------------------------------------------


def _dtype_message(dt: np.dtype) -> bytes:
    dt = np.dtype(dt)
    order = 1 if dt.byteorder == ">" else 0
    if dt.kind in "iu":
        bits = order | (0x08 if dt.kind == "i" else 0)
        return (struct.pack("<B3sI", 0x10, bytes([bits, 0, 0]), dt.itemsize)
                + struct.pack("<HH", 0, 8 * dt.itemsize))
    if dt.kind == "f":
        eloc, esize, msize, bias = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127),
                                    8: (52, 11, 52, 1023)}[dt.itemsize]
        sign = 8 * dt.itemsize - 1
        return (struct.pack("<B3sI", 0x11, bytes([order | 0x20, sign, 0]),
                            dt.itemsize)
                + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, eloc, esize, 0,
                              msize, bias))
    raise NotImplementedError(f"H5Writer: dtype {dt}")


def _vlen_string_type(utf8: bool) -> bytes:
    base = struct.pack("<B3sI", 0x10, b"\0\0\0", 1) + struct.pack("<HH", 0, 8)
    return struct.pack("<B3sI", 0x19, bytes([0x01, 1 if utf8 else 0, 0]),
                       16) + base


def _dataspace(shape: Tuple[int, ...]) -> bytes:
    return (struct.pack("<BBBB4x", 1, len(shape), 0, 0)
            + b"".join(struct.pack("<Q", int(d)) for d in shape))


def _message(mtype: int, data: bytes) -> bytes:
    data = _pad(data)
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Strings:
    """Variable-length strings packed into global heap collections: a heap
    id (length, collection address, index) for each."""

    def __init__(self):
        self.items: List[bytes] = []
        self.ids: List[Tuple[int, int, int]] = []

    def add(self, s: bytes) -> int:
        self.items.append(s)
        return len(self.items) - 1

    def write(self, out) -> None:
        i = 0
        n = len(self.items)
        self.ids = [None] * n  # type: ignore[list-item]
        while i < n:
            # one collection: strings until GCOL_PACK bytes (a larger one
            # alone)
            group = [i]
            used = 16 + _align(len(self.items[i]))
            i += 1
            while i < n and used + 16 + _align(len(self.items[i])) <= \
                    GCOL_PACK and len(group) < 65535:
                used += 16 + _align(len(self.items[i]))
                group.append(i)
                i += 1
            size = max(GCOL_MIN, 16 + used)
            addr = out.tell()
            buf = bytearray(struct.pack("<4sB3xQ", b"GCOL", 1, size))
            for idx, j in enumerate(group, start=1):
                s = self.items[j]
                buf += struct.pack("<HH4xQ", idx, 0, len(s)) + _pad(s)
                self.ids[j] = (len(s), addr, idx)
            free = size - len(buf)
            if free >= 16:
                buf += struct.pack("<HH4xQ", 0, 0, free)
            buf += b"\0" * (size - len(buf))
            out.write(bytes(buf))


class _Attr:
    def __init__(self, name: str, value):
        self.name = name
        if isinstance(value, (str, bytes)):
            self.kind, self.shape, self.value = "str", (), [value]
        elif (isinstance(value, (list, tuple)) and value
              and all(isinstance(v, (str, bytes)) for v in value)):
            self.kind, self.shape, self.value = "str", (len(value),), \
                list(value)
        else:
            arr = np.asarray(value)
            self.kind, self.shape, self.value = "num", arr.shape, arr
        self.refs: List[int] = []

    def collect(self, strings: _Strings) -> None:
        if self.kind == "str":
            self.refs = [strings.add(v.encode("utf-8") if isinstance(v, str)
                                     else bytes(v)) for v in self.value]

    def message(self, strings: _Strings) -> bytes:
        name = self.name.encode("utf-8") + b"\0"
        if self.kind == "str":
            utf8 = any(isinstance(v, str) for v in self.value)
            dtype = _vlen_string_type(utf8)
            data = b"".join(struct.pack("<IQI", *strings.ids[r])
                            for r in self.refs)
        else:
            arr = np.ascontiguousarray(self.value)
            dtype = _dtype_message(arr.dtype)
            data = arr.tobytes()
        space = _dataspace(self.shape)
        body = (struct.pack("<BBHHH", 1, 0, len(name), len(dtype), len(space))
                + _pad(name) + _pad(dtype) + _pad(space) + data)
        if len(body) > 0xFFF0:
            raise ValueError(f"attribute {self.name!r}: {len(body)} bytes "
                             f"is past an object header message's limit")
        return _message(0x000C, body)


class H5Writer:
    """An HDF5 file built in memory as a tree and written in one pass:
    ``dataset(path, array)``, ``group(path)``, ``attr(path, name,
    value)``, then ``write(path_or_file)`` or ``tobytes()``."""

    def __init__(self):
        self.root: Dict[str, Any] = {"kind": "group", "children": {},
                                     "attrs": []}

    def _node(self, path: str, create: bool = True) -> Dict[str, Any]:
        node = self.root
        for part in [p for p in path.split("/") if p]:
            kids = node["children"]
            if part not in kids:
                if not create:
                    raise KeyError(path)
                kids[part] = {"kind": "group", "children": {}, "attrs": []}
            node = kids[part]
        return node

    def group(self, path: str) -> "H5Writer":
        self._node(path)
        return self

    def dataset(self, path: str, array) -> "H5Writer":
        parent, _, name = path.strip("/").rpartition("/")
        arr = np.asarray(array)
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
        self._node(parent)["children"][name] = {
            "kind": "dataset", "data": arr, "attrs": []}
        return self

    def attr(self, path: str, name: str, value) -> "H5Writer":
        self._node(path)["attrs"].append(_Attr(name, value))
        return self

    # -- writing ---------------------------------------------------------
    def tobytes(self) -> bytes:
        buf = io.BytesIO()
        self.write(buf)
        return buf.getvalue()

    def write(self, target) -> None:
        if isinstance(target, (str, bytes)) or hasattr(target, "__fspath__"):
            with open(target, "wb") as f:
                self._write(f)
        else:
            self._write(target)

    def _write(self, out) -> None:
        start = out.tell()

        class _Rel:  # addresses relative to the superblock
            def __init__(self, f):
                self.f = f

            def tell(self):
                return self.f.tell() - start

            def write(self, b):
                self.f.write(b)

        rel = _Rel(out)
        rel.write(b"\0" * 96)  # the superblock, written last
        strings = _Strings()
        self._collect(self.root, strings)
        strings.write(rel)
        root_addr, btree, heap = self._write_group(self.root, rel, strings)
        eof = rel.tell()
        sb = (b"\x89HDF\r\n\x1a\n" + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
              + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
              + struct.pack("<QQII", 0, root_addr, 1, 0)
              + struct.pack("<QQ", btree, heap))
        end = out.tell()
        out.seek(start)
        out.write(sb)
        out.seek(end)

    def _collect(self, node, strings: _Strings) -> None:
        for a in node["attrs"]:
            a.collect(strings)
        for child in node.get("children", {}).values():
            self._collect(child, strings)

    def _write_dataset(self, node, out, strings) -> int:
        arr = node["data"]
        if arr.size:
            pad = _align(out.tell(), 64) - out.tell()
            out.write(b"\0" * pad)
            addr = out.tell()
            out.write(arr.tobytes())
        else:
            addr = UNDEF
        msgs = [_message(0x0001, _dataspace(arr.shape)),
                _message(0x0003, _dtype_message(arr.dtype)),
                _message(0x0005, bytes([2, 2, 2, 0])),
                _message(0x0008, struct.pack("<BBQQ", 3, 1, addr,
                                             arr.nbytes))]
        msgs += [a.message(strings) for a in node["attrs"]]
        here = out.tell()
        out.write(_object_header(msgs))
        return here

    def _write_group(self, node, out, strings) -> Tuple[int, int, int]:
        """(object header, B-tree, local heap) addresses of ``node``,
        its members written first."""
        names = sorted(node["children"], key=lambda s: s.encode("utf-8"))
        addrs = {}
        for name in names:
            child = node["children"][name]
            if child["kind"] == "dataset":
                addrs[name] = (self._write_dataset(child, out, strings),
                               None)
            else:
                oaddr, btree, heap = self._write_group(child, out, strings)
                addrs[name] = (oaddr, (btree, heap))
        # the local heap: "" at 0, then each name
        offsets, data = {}, bytearray(b"\0" * 8)
        for name in names:
            offsets[name] = len(data)
            data += _pad(name.encode("utf-8") + b"\0")
        heap = out.tell()
        out.write(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(data), 1,
                              heap + 32) + bytes(data))
        # symbol table nodes of up to 2 * LEAF_K members
        entry_bytes = 40
        snod_bytes = 8 + 2 * LEAF_K * entry_bytes
        level: List[Tuple[int, str]] = []  # (node address, its last name)
        for i in range(0, len(names), 2 * LEAF_K):
            chunk = names[i:i + 2 * LEAF_K]
            body = bytearray(struct.pack("<4sBBH", b"SNOD", 1, 0,
                                         len(chunk)))
            for name in chunk:
                oaddr, stab = addrs[name]
                if stab is None:
                    body += struct.pack("<QQII16x", offsets[name], oaddr, 0,
                                        0)
                else:
                    body += struct.pack("<QQIIQQ", offsets[name], oaddr, 1,
                                        0, stab[0], stab[1])
            body += b"\0" * (snod_bytes - len(body))
            level.append((out.tell(), chunk[-1]))
            out.write(bytes(body))
        # B-tree levels of up to 2 * INTERNAL_K children, up to one root
        height = 0
        while True:
            nodes = []
            for i in range(0, max(len(level), 1), 2 * INTERNAL_K):
                kids = level[i:i + 2 * INTERNAL_K]
                body = bytearray(struct.pack("<4sBBHQQ", b"TREE", 0, height,
                                             len(kids), UNDEF, UNDEF))
                body += struct.pack("<Q", 0)  # key 0: ""
                for addr, last in kids:
                    body += struct.pack("<QQ", addr, offsets[last])
                full = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
                body += b"\0" * (full - len(body))
                nodes.append((out.tell(), kids[-1][1] if kids else ""))
                out.write(bytes(body))
            if len(nodes) == 1:
                btree = nodes[0][0]
                break
            level, height = nodes, height + 1
        msgs = [_message(0x0011, struct.pack("<QQ", btree, heap))]
        msgs += [a.message(strings) for a in node["attrs"]]
        here = out.tell()
        out.write(_object_header(msgs))
        return here, btree, heap


# ---------------------------------------------------------------------------
# Keras 3 layer configurations, as ``model.save("m.h5")`` writes them
# ---------------------------------------------------------------------------


def _policy() -> dict:
    return {"module": "keras", "class_name": "DTypePolicy",
            "config": {"name": "float32"}, "registered_name": None}


def _init(name: str, **config) -> dict:
    return {"module": "keras.initializers", "class_name": name,
            "config": config, "registered_name": None}


def _tensor(layer: str, shape, dtype: str) -> dict:
    return {"class_name": "__keras_tensor__",
            "config": {"shape": list(shape), "dtype": dtype,
                       "keras_history": [layer, 0, 0]}}


def _dense_config(name, units, activation):
    return {"name": name, "trainable": True, "dtype": _policy(),
            "units": units, "activation": activation, "use_bias": True,
            "kernel_initializer": _init("GlorotUniform", seed=None),
            "bias_initializer": _init("Zeros"), "kernel_regularizer": None,
            "bias_regularizer": None, "kernel_constraint": None,
            "bias_constraint": None, "quantization_config": None}


def _embedding_config(name, vocab, width):
    return {"name": name, "trainable": True, "dtype": _policy(),
            "input_dim": vocab, "output_dim": width,
            "embeddings_initializer": _init("RandomUniform", seed=None,
                                            minval=-0.05, maxval=0.05),
            "embeddings_regularizer": None, "activity_regularizer": None,
            "embeddings_constraint": None, "mask_zero": False,
            "quantization_config": None}


def _layer_norm_config(name, eps):
    return {"name": name, "trainable": True, "dtype": _policy(),
            "axis": [-1], "epsilon": eps, "center": True, "scale": True,
            "rms_scaling": False, "beta_initializer": _init("Zeros"),
            "gamma_initializer": _init("Ones"), "beta_regularizer": None,
            "gamma_regularizer": None, "beta_constraint": None,
            "gamma_constraint": None}


def _mha_config(name, heads, key_dim):
    return {"name": name, "trainable": True, "dtype": _policy(),
            "num_heads": heads, "key_dim": key_dim, "value_dim": key_dim,
            "dropout": 0.0, "use_bias": True, "output_shape": None,
            "attention_axes": [1],
            "kernel_initializer": _init("GlorotUniform", seed=None),
            "bias_initializer": _init("Zeros"), "kernel_regularizer": None,
            "bias_regularizer": None, "activity_regularizer": None,
            "kernel_constraint": None, "bias_constraint": None,
            "seed": None}


class _Functional:
    """Layers of a functional model's config, in order, with their
    weights (``weight_names`` relative to the layer's group)."""

    def __init__(self):
        self.layers: List[dict] = []
        self.weights: Dict[str, List[Tuple[str, np.ndarray]]] = {}
        self.shapes: Dict[str, tuple] = {}
        self.dtypes: Dict[str, str] = {}

    def add(self, cls: str, config: dict, inputs: List[str], shape,
            weights=(), kwargs=None, list_args: bool = False):
        name = config["name"]
        args = [_tensor(i, self.shapes[i], self.dtypes.get(i, "float32"))
                for i in inputs]
        self.layers.append({
            "class_name": cls, "config": config, "name": name,
            "inbound_nodes": [{"args": [args] if list_args else args,
                               "kwargs": kwargs or {}}]})
        self.shapes[name] = tuple(shape)
        self.weights[name] = list(weights)
        return name

    def input(self, name: str, shape, dtype: str = "int32"):
        self.layers.append({
            "class_name": "InputLayer",
            "config": {"batch_shape": [None] + list(shape), "dtype": dtype,
                       "sparse": False, "ragged": False, "name": name,
                       "optional": False},
            "name": name, "inbound_nodes": []})
        self.shapes[name] = (None,) + tuple(shape)
        self.dtypes[name] = dtype
        self.weights[name] = []
        return name


def bert_keras_model(*, layers: int, hidden: int, heads: int, ff: int,
                     vocab: int, max_positions: int, seq: int = 128,
                     seed: int = 0, std: float = 0.02,
                     dropout: float = 0.1) -> Tuple[dict, "_Functional"]:
    """The BERT-like encoder's ``model_config`` and weights (numpy
    ``RandomState(seed)`` normal draws × ``std``, LayerNorm gains 1 and
    biases 0; LayerNorm epsilon 1e-12 and dropout 0.1, BERT's, unless
    ``dropout`` says otherwise)."""
    eps = 1e-12
    rs = np.random.RandomState(seed)

    def w(*shape):
        return (rs.standard_normal(shape) * std).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    kd = hidden // heads
    f = _Functional()
    seq_shape = (None, seq)
    tok = f.input("input_ids", (seq,))
    pos = f.input("position_ids", (seq,))
    te = f.add("Embedding", _embedding_config("token_embedding", vocab,
                                              hidden),
               [tok], seq_shape + (hidden,),
               [("token_embedding/embeddings", w(vocab, hidden))])
    pe = f.add("Embedding", _embedding_config("position_embedding",
                                              max_positions, hidden),
               [pos], seq_shape + (hidden,),
               [("position_embedding/embeddings", w(max_positions, hidden))])
    hs = seq_shape + (hidden,)

    def add(name, a, b):
        return f.add("Add", {"name": name, "trainable": True,
                             "dtype": _policy()}, [a, b], hs, list_args=True)

    def norm(name, x):
        return f.add("LayerNormalization", _layer_norm_config(name, eps),
                     [x], hs, [(f"{name}/gamma", np.ones(hidden, np.float32)),
                               (f"{name}/beta", zeros(hidden))])

    def drop(name, x):
        return f.add("Dropout", {"name": name, "trainable": True,
                                 "dtype": _policy(), "rate": dropout,
                                 "seed": None, "noise_shape": None},
                     [x], f.shapes[x], kwargs={"training": False})

    def dense(name, x, units, activation, shape):
        return f.add("Dense", _dense_config(name, units, activation), [x],
                     shape, [(f"{name}/kernel", w(f.shapes[x][-1], units)),
                             (f"{name}/bias", zeros(units))])

    h = add("embeddings_add", te, pe)
    h = norm("embeddings_norm", h)
    h = drop("embeddings_dropout", h)
    for i in range(layers):
        p = f"layer_{i}"
        mha = []
        for part in ("query", "key", "value"):
            mha += [(f"{p}_attention/{part}/kernel", w(hidden, heads, kd)),
                    (f"{p}_attention/{part}/bias", zeros(heads, kd))]
        mha += [(f"{p}_attention/attention_output/kernel",
                 w(heads, kd, hidden)),
                (f"{p}_attention/attention_output/bias", zeros(hidden))]
        a = f.add("MultiHeadAttention", _mha_config(f"{p}_attention", heads,
                                                    kd),
                  [h, h], hs, mha)
        a = drop(f"{p}_attention_dropout", a)
        h = norm(f"{p}_attention_norm", add(f"{p}_attention_add", h, a))
        x = dense(f"{p}_intermediate", h, ff, "gelu", seq_shape + (ff,))
        x = dense(f"{p}_output", x, hidden, "linear", hs)
        x = drop(f"{p}_output_dropout", x)
        h = norm(f"{p}_output_norm", add(f"{p}_output_add", h, x))
    pooled = f.add("GlobalAveragePooling1D",
                   {"name": "pooling", "trainable": True, "dtype": _policy(),
                    "data_format": "channels_last", "keepdims": False},
                   [h], (None, hidden), kwargs={"mask": None})
    pooled = dense("pooler", pooled, hidden, "tanh", (None, hidden))
    out = dense("classifier", pooled, 2, "softmax", (None, 2))
    config = {"class_name": "Functional", "config": {
        "name": "bert_encoder", "trainable": True,
        "layers": f.layers,
        "input_layers": [[tok, 0, 0], [pos, 0, 0]],
        "output_layers": [out, 0, 0]}}
    return config, f


def _keras_file(config: dict, layer_names: List[str],
                weights: Dict[str, List[Tuple[str, np.ndarray]]],
                sub: Optional[str] = None) -> H5Writer:
    """The legacy Keras ``.h5`` layout of ``config`` and ``weights``
    (``sub``: the prefix directory Keras puts the layer's variables in for
    a Sequential model)."""
    h = H5Writer()
    h.attr("/", "backend", KERAS_BACKEND)
    h.attr("/", "keras_version", KERAS_VERSION)
    h.attr("/", "model_config", json.dumps(config))
    h.group("model_weights")
    h.attr("model_weights", "backend", KERAS_BACKEND.encode())
    h.attr("model_weights", "keras_version", KERAS_VERSION.encode())
    h.attr("model_weights", "layer_names",
           [n.encode() for n in layer_names])
    for name in layer_names + ["top_level_model_weights"]:
        g = f"model_weights/{name}"
        h.group(g)
        ws = weights.get(name, [])
        if not ws:
            h.attr(g, "weight_names", np.zeros((0,), np.float64))
            continue
        h.attr(g, "weight_names", [n.encode() for n, _ in ws])
        for n, arr in ws:
            h.dataset(f"{g}/{n}", arr)
    return h


def bert_keras_h5(path=None, **cfg) -> Tuple[Optional[bytes],
                                               Dict[str, List[np.ndarray]]]:
    """Write the BERT-like encoder's legacy ``.h5`` (``path``, or return
    its bytes); also return its arrays by layer, in ``weight_names``
    order. ``cfg``: layers, hidden, heads, ff, vocab, max_positions, and
    optionally seq, seed, std, dropout."""
    config, f = bert_keras_model(**cfg)
    names = [layer["name"] for layer in f.layers]
    h = _keras_file(config, names, f.weights)
    arrays = {n: [a for _, a in f.weights[n]] for n in names}
    if path is None:
        return h.tobytes(), arrays
    h.write(path)
    return None, arrays


def conv1d_keras_h5(path=None, *, vocab: int = 1000, seq: int = 20,
                    width: int = 32, filters: int = 16, kernel: int = 5,
                    pool: int = 2, classes: int = 4, seed: int = 0
                    ) -> Tuple[Optional[bytes], Dict[str, List[np.ndarray]]]:
    """The Sequential Conv1D text classifier as Keras 3 writes it to a
    legacy ``.h5``."""
    rs = np.random.RandomState(seed)

    def w(*shape, std=0.1):
        return (rs.standard_normal(shape) * std).astype(np.float32)

    def base(name):
        return {"name": name, "trainable": True, "dtype": _policy()}

    layers = [
        {"class_name": "InputLayer", "config": {
            "batch_shape": [None, seq], "dtype": "int32", "sparse": False,
            "ragged": False, "name": "input_layer", "optional": False}},
        {"class_name": "Embedding",
         "config": _embedding_config("embedding", vocab, width)},
        {"class_name": "Conv1D", "config": dict(
            base("conv1d"), filters=filters, kernel_size=[kernel],
            strides=[1], padding="valid", data_format="channels_last",
            dilation_rate=[1], groups=1, activation="relu", use_bias=True,
            kernel_initializer=_init("GlorotUniform", seed=None),
            bias_initializer=_init("Zeros"), kernel_regularizer=None,
            bias_regularizer=None, activity_regularizer=None,
            kernel_constraint=None, bias_constraint=None)},
        {"class_name": "MaxPooling1D", "config": dict(
            base("max_pooling1d"), pool_size=[pool], padding="valid",
            strides=[pool], data_format="channels_last")},
        {"class_name": "GlobalMaxPooling1D", "config": dict(
            base("global_max_pooling1d"), data_format="channels_last",
            keepdims=False)},
        {"class_name": "Dense",
         "config": _dense_config("dense", classes, "softmax")}]
    config = {"class_name": "Sequential", "config": dict(
        base("sequential"), layers=layers, build_input_shape=[None, seq])}
    weights = {
        "embedding": [("sequential/embedding/embeddings",
                       w(vocab, width, std=0.5))],
        "conv1d": [("sequential/conv1d/kernel", w(kernel, width, filters)),
                   ("sequential/conv1d/bias", w(filters))],
        "dense": [("sequential/dense/kernel", w(filters, classes, std=0.5)),
                  ("sequential/dense/bias", w(classes))]}
    names = [layer["config"]["name"] for layer in layers[1:]]
    h = _keras_file(config, names, weights)
    arrays = {n: [a for _, a in weights.get(n, [])] for n in names}
    if path is None:
        return h.tobytes(), arrays
    h.write(path)
    return None, arrays


def bert_inputs(batch: int, seq: int, vocab: int, seed: int = 0):
    """Token ids (numpy ``RandomState(seed)``) and positions 0..seq-1, as
    int32 (batch, seq) arrays."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (batch, seq))
    return ids, np.ascontiguousarray(pos)

