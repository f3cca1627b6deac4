"""Shape, layout and indexing ops of the port.

Counterpart of ``deeplearning4j_tpu/ops/shape_ops.py``: reshape, permute,
concat / stack / split, slicing (``slice`` clamps its starts as
``lax.dynamic_slice`` does, ``strided_slice`` and the full-mask
``strided_slice_spec`` take negative strides), padding (constant, reflect,
symmetric), the space/batch/depth rearrangements, the diagonal and band
ops, the fills and ranges and the sequence ops, under the same names and
keywords.

``shape_of``, ``rank``, ``size`` and ``stack`` are host-static, as the JAX
package keeps them for its shape chains (``samediff.py:359``): ``shape_of``
returns a numpy array, ``stack`` of host values (numpy arrays, Python
numbers) stays in numpy, ``rank`` and ``size`` are filled from the static
shape (``torch.full``: no host read and no host-to-device copy, so they run
inside a CUDA-graph capture). The ops with no tensor input (``fill``,
``linspace``, ``range``, ``eye``) take ``device`` (the card unless the
caller asks for the CPU) and a ``dtype`` given as a torch dtype, a numpy
dtype or its name.

Every op registers a validation spec (:mod:`.validation`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.ops import validation as V
from deeplearning4j_tpu_torch.ops.reductions import int_acc
from deeplearning4j_tpu_torch.ops.registry import op


def _dt(dtype) -> torch.dtype:
    from deeplearning4j_tpu_torch.analysis.values import as_dtype

    return as_dtype(dtype)


@op("reshape")
def reshape(x, *, shape):
    """reshape (generic/shape/reshape.cpp)."""
    return torch.reshape(x, tuple(int(s) for s in shape))


@op("permute")
def permute(x, *, axes):
    """permute/transpose with explicit axes (generic/shape/permute.cpp)."""
    return x.permute(tuple(int(a) for a in axes))


@op("transpose")
def transpose(x):
    """full transpose — reverse all axes (generic/shape/transpose.cpp)."""
    return x.permute(tuple(reversed(range(x.ndim))))


@op("expand_dims")
def expand_dims(x, *, axis: int):
    """expand_dims (generic/shape/expand_dims.cpp)."""
    return torch.unsqueeze(x, int(axis))


@op("squeeze")
def squeeze(x, *, axis=None):
    """squeeze (generic/shape/squeeze.cpp)."""
    if axis is None:
        return x.squeeze()
    return torch.squeeze(x, dim=axis if isinstance(axis, int)
                         else tuple(axis))


@op("concat")
def concat(*xs, axis: int = 0):
    """concat (generic/transforms/concat.cpp)."""
    return torch.cat(xs, dim=axis)


@op("stack")
def stack(*xs, axis: int = 0):
    """stack (generic/parity_ops/stack.cpp). Stays in NUMPY when no input
    is a tensor (shape-chain arithmetic stays host-static)."""
    if not any(isinstance(x, torch.Tensor) for x in xs):
        return np.stack([np.asarray(x) for x in xs], axis=axis)
    ref = next(x for x in xs if isinstance(x, torch.Tensor))
    return torch.stack([x if isinstance(x, torch.Tensor) else
                        torch.as_tensor(x, device=ref.device) for x in xs],
                       dim=axis)


@op("unstack")
def unstack(x, *, axis: int = 0):
    """unstack → tuple of arrays (generic/parity_ops/unstack.cpp)."""
    return tuple(torch.unbind(x, dim=axis))


@op("split")
def split(x, *, num_split: int, axis: int = 0):
    """split into equal parts (generic/parity_ops/split.cpp)."""
    return tuple(torch.chunk(x, num_split, dim=axis))


@op("split_v")
def split_v(x, *, sizes, axis: int = 0):
    """split by explicit sizes (generic/parity_ops/split_v.cpp)."""
    return tuple(torch.split(x, [int(s) for s in sizes], dim=axis))


@op("slice")
def slice_op(x, *, begin, size):
    """slice by begin/size (generic/parity_ops/slice.cpp); size -1 takes
    the rest, and each start is clamped so the slice stays in bounds, as
    ``lax.dynamic_slice`` does."""
    for d, (b, s) in enumerate(zip(begin, size)):
        s = x.shape[d] - int(b) if int(s) == -1 else int(s)
        b = min(max(int(b), 0), x.shape[d] - s)
        x = x.narrow(d, b, s)
    return x


def _take_range(x, d: int, idx: range):
    """``x`` along dim ``d`` at the positions of ``idx`` (any step)."""
    if idx.step > 0:
        if idx.step == 1:
            return x.narrow(d, idx.start, len(idx))
        return x[(slice(None),) * d + (slice(idx.start, idx.stop,
                                              idx.step),)]
    # torch slicing takes no negative step: an index built on the device
    rows = idx.start + idx.step * torch.arange(len(idx), device=x.device)
    return torch.index_select(x, d, rows)


@op("strided_slice")
def strided_slice(x, *, begin, end, strides=None):
    """strided_slice (generic/parity_ops/strided_slice.cpp) — basic form."""
    strides = strides or [1] * len(begin)
    for d, (b, e, s) in enumerate(zip(begin, end, strides)):
        x = _take_range(x, d, range(*slice(b, e, s).indices(x.shape[d])))
    return x


@op("gather_nd")
def gather_nd(x, indices):
    """gather_nd (generic/parity_ops/gather_nd.cpp): negative indices count
    from the end and out-of-range ones are clamped, as the reference's
    gather does."""
    idx = indices.to(torch.int64)
    parts = []
    for d in range(idx.shape[-1]):
        i = idx[..., d]
        n = x.shape[d]
        parts.append(torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1))
    return x[tuple(parts)]


@op("repeat")
def repeat(x, *, repeats: int, axis: int = 0):
    """repeat elements along axis (NDArray::repeat analog)."""
    return torch.repeat_interleave(x, int(repeats), dim=axis)


@op("tile")
def tile(x, *, reps):
    """tile (generic/transforms/tile.cpp)."""
    return torch.tile(x, tuple(int(r) for r in reps))


def mirror_index(n: int, lo: int, hi: int, mode: str,
                 device) -> torch.Tensor:
    """The source positions of a reflect / symmetric pad of one axis of
    length ``n`` by (``lo``, ``hi``), built on the device."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "reflect":
        i = torch.abs(i)
        return torch.where(i >= n, 2 * (n - 1) - i, i)
    i = torch.where(i < 0, -i - 1, i)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def pad_mirror(x, paddings, mode: str):
    for d, (lo, hi) in enumerate(paddings):
        if lo or hi:
            x = torch.index_select(
                x, d, mirror_index(x.shape[d], int(lo), int(hi), mode,
                                   x.device))
    return x


@op("pad")
def pad(x, *, paddings, mode: str = "constant", constant: float = 0.0):
    """pad with CONSTANT/REFLECT/SYMMETRIC modes (generic/transforms/pad.cpp)."""
    mode = mode.lower()
    paddings = [tuple(int(v) for v in p) for p in paddings]
    if mode == "constant":
        flat = []
        for lo, hi in reversed(paddings):
            flat += [lo, hi]
        return F.pad(x, flat, value=constant)
    return pad_mirror(x, paddings, {"reflect": "reflect",
                                    "symmetric": "symmetric"}[mode])


@op("reverse")
def reverse(x, *, axis):
    """reverse along axes (generic/transforms/reverse.cpp)."""
    return torch.flip(x, dims=(axis,) if isinstance(axis, int)
                      else tuple(axis))


@op("rank")
def rank(x):
    """rank (generic/shape/rank.cpp): int32, from the static shape."""
    return torch.full((), x.ndim, dtype=torch.int32, device=x.device)


@op("shape_of")
def shape_of(x):
    """shape_of (generic/shape/shape.cpp). Returns NUMPY: shapes are static,
    and keeping the result on the host lets imported shape→pack→reshape
    chains recover concrete ints (reshape_dynamic)."""
    dt = np.int64 if max(x.shape, default=0) > 2 ** 31 else np.int32
    return np.asarray(tuple(x.shape), dt)


@op("size")
def size(x):
    """total element count (generic/shape/size.cpp): int32, from the
    static shape."""
    return torch.full((), x.numel(), dtype=torch.int32, device=x.device)


@op("zeros_like")
def zeros_like(x):
    """zeros_like (generic/parity_ops/zeros_as.cpp)."""
    return torch.zeros_like(x)


@op("ones_like")
def ones_like(x):
    """ones_like (generic/parity_ops/ones_as.cpp)."""
    return torch.ones_like(x)


@op("fill")
def fill(*, shape, value, dtype="float32", device=None):
    """fill (generic/parity_ops/fill.cpp)."""
    return torch.full(tuple(int(s) for s in shape), value, dtype=_dt(dtype),
                      device=resolve_device(device))


@op("linspace")
def linspace(*, start, stop, num, dtype="float32", device=None):
    """linspace (Nd4j.linspace analog)."""
    return torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                          device=resolve_device(device))


@op("range")
def range_op(*, start, limit, delta=1, dtype="float32", device=None):
    """range (generic/parity_ops/range.cpp)."""
    return torch.arange(start, limit, delta, dtype=_dt(dtype),
                        device=resolve_device(device))


@op("broadcast_to")
def broadcast_to(x, *, shape):
    """broadcast_to (generic/shape/broadcast_to.cpp)."""
    return torch.broadcast_to(x, tuple(int(s) for s in shape))


@op("space_to_depth")
def space_to_depth(x, *, block_size: int, data_format: str = "NHWC"):
    """space_to_depth (generic/parity_ops/space_to_depth.cpp): each b×b
    block of pixels becomes b·b·C channels, in (row, col, channel) order."""
    if data_format == "NCHW":
        x = x.permute(0, 2, 3, 1)
    n, h, w, c = x.shape
    b = block_size
    x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, h // b, w // b, b * b * c)
    if data_format == "NCHW":
        x = x.permute(0, 3, 1, 2)
    return x


@op("depth_to_space")
def depth_to_space(x, *, block_size: int, data_format: str = "NHWC"):
    """depth_to_space (generic/parity_ops/depth_to_space.cpp)."""
    if data_format == "NCHW":
        x = x.permute(0, 2, 3, 1)
    n, h, w, c = x.shape
    b = block_size
    x = x.reshape(n, h, w, b, b, c // (b * b)).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, h * b, w * b, c // (b * b))
    if data_format == "NCHW":
        x = x.permute(0, 3, 1, 2)
    return x


@op("batch_to_space")
def batch_to_space(x, *, block_shape, crops):
    """batch_to_space_nd (generic/parity_ops/batch_to_space_nd.cpp)."""
    n = x.shape[0]
    block = [int(b) for b in block_shape]
    prod = int(np.prod(block))
    spatial = tuple(x.shape[1:1 + len(block)])
    rest = tuple(x.shape[1 + len(block):])
    x = x.reshape(tuple(block) + (n // prod,) + spatial + rest)
    perm = [len(block)]
    for i in range(len(block)):
        perm += [len(block) + 1 + i, i]
    perm += list(range(2 * len(block) + 1, x.ndim))
    x = x.permute(perm)
    shape = (n // prod,) + tuple(s * b for s, b in zip(spatial, block)) + rest
    x = x.reshape(shape)
    for d, ((lo, hi), dim) in enumerate(zip(crops, shape[1:1 + len(block)])):
        x = x.narrow(d + 1, int(lo), dim - int(hi) - int(lo))
    return x


@op("space_to_batch")
def space_to_batch(x, *, block_shape, paddings):
    """space_to_batch_nd (generic/parity_ops/space_to_batch_nd.cpp)."""
    block = [int(b) for b in block_shape]
    pads = [(0, 0)] + [tuple(p) for p in paddings] + \
        [(0, 0)] * (x.ndim - 1 - len(block))
    x = pad.fn(x, paddings=pads)
    n = x.shape[0]
    spatial = x.shape[1:1 + len(block)]
    rest = tuple(x.shape[1 + len(block):])
    shape = (n,)
    for s, b in zip(spatial, block):
        shape += (s // b, b)
    x = x.reshape(shape + rest)
    perm = [2 + 2 * i for i in range(len(block))] + [0] + \
        [1 + 2 * i for i in range(len(block))] + \
        list(range(1 + 2 * len(block), x.ndim))
    x = x.permute(perm)
    return x.reshape((n * int(np.prod(block)),) +
                     tuple(s // b for s, b in zip(spatial, block)) + rest)


@op("diag")
def diag(x):
    """vector → diagonal matrix (generic/parity_ops/diag.cpp)."""
    return torch.diag(x)


@op("diag_part")
def diag_part(x):
    """matrix diagonal (generic/parity_ops/diag_part.cpp)."""
    return torch.diagonal(x, dim1=0, dim2=1)


@op("matrix_diag")
def matrix_diag(x):
    """batched vector → diagonal matrices (parity_ops/matrix_diag.cpp)."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return x[..., None] * eye


def band_mask(m: int, n: int, num_lower: int, num_upper: int, device):
    rows = torch.arange(m, device=device)[:, None]
    cols = torch.arange(n, device=device)[None, :]
    keep = torch.ones((m, n), dtype=torch.bool, device=device)
    if num_lower >= 0:
        keep = keep & (rows - cols <= num_lower)
    if num_upper >= 0:
        keep = keep & (cols - rows <= num_upper)
    return keep


@op("matrix_band_part")
def matrix_band_part(x, *, num_lower: int, num_upper: int):
    """keep a band of the matrix (parity_ops/matrix_band_part.cpp);
    negative bound = keep whole triangle."""
    keep = band_mask(x.shape[-2], x.shape[-1], num_lower, num_upper,
                     x.device)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


@op("trace")
def trace(x):
    """matrix trace (NDArray trace analog)."""
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1, dtype=int_acc(x))


@op("eye")
def eye(*, rows: int, cols=None, dtype="float32", device=None):
    """identity matrix (generic/parity_ops/eye.cpp)."""
    return torch.eye(int(rows), int(rows if cols is None else cols),
                     dtype=_dt(dtype), device=resolve_device(device))


@op("sequence_mask")
def sequence_mask(lengths, *, maxlen: int, dtype="float32"):
    """sequence_mask (generic/parity_ops/sequence_mask.cpp)."""
    steps = torch.arange(int(maxlen), device=lengths.device)
    return (steps[None, :] < lengths[:, None]).to(_dt(dtype))


@op("reverse_sequence")
def reverse_sequence(x, lengths, *, seq_axis: int = 1, batch_axis: int = 0):
    """reverse the first lengths[i] entries of every sequence
    (generic/parity_ops/reverse_sequence.cpp)."""
    xm = torch.movedim(x, (batch_axis, seq_axis), (0, 1))
    t = xm.shape[1]
    idx = torch.arange(t, device=x.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    take = torch.where(idx < lens, lens - 1 - idx, idx)
    take = take.reshape(take.shape + (1,) * (xm.ndim - 2)).expand(xm.shape)
    out = torch.gather(xm, 1, take)
    return torch.movedim(out, (0, 1), (batch_axis, seq_axis))


@op("strided_slice_spec")
def strided_slice_spec(x, *, begin, end, strides, begin_mask: int = 0,
                       end_mask: int = 0, shrink_mask: int = 0,
                       new_axis_mask: int = 0, ellipsis_mask: int = 0):
    """TF StridedSlice with the FULL mask set, resolved from x.ndim —
    supports t[None], t[..., None], shrink indexing, negative strides and
    every Python-slicing combination (TFGraphMapper strided-slice parity)."""
    idx = []
    for i in range(len(begin)):
        if ellipsis_mask & (1 << i):
            idx.append(Ellipsis)
        elif new_axis_mask & (1 << i):
            idx.append(None)
        elif shrink_mask & (1 << i):
            idx.append(int(begin[i]))
        else:
            b = None if (begin_mask & (1 << i)) else int(begin[i])
            e = None if (end_mask & (1 << i)) else int(end[i])
            idx.append(slice(b, e, int(strides[i])))
    # resolve the ellipsis and walk the input dims: each slice keeps an
    # output dim, an int drops one, None adds one
    n_real = sum(1 for t in idx if t is not None and t is not Ellipsis)
    if Ellipsis in idx:
        k = idx.index(Ellipsis)
        idx = idx[:k] + [slice(None)] * (x.ndim - n_real) + idx[k + 1:]
    out_dim, in_dim, flips, plain = 0, 0, [], []
    for t in idx:
        if t is None:
            plain.append(None)
            out_dim += 1
            continue
        if isinstance(t, slice):
            r = range(*t.indices(x.shape[in_dim]))
            if r.step < 0:
                flips.append((out_dim, r))
                plain.append(slice(None))
            else:
                plain.append(t)
            out_dim += 1
        else:
            plain.append(t)
        in_dim += 1
    x = x[tuple(plain)]
    for d, r in flips:
        x = _take_range(x, d, r)
    return x


@op("reshape_dynamic")
def reshape_dynamic(x, shape):
    """Reshape where the target arrives as an operand (TF Reshape with a
    shape(...)-derived input). The shape must be concrete: a host array
    (from ``shape_of`` and constants) or a tensor, read on the host."""
    if isinstance(shape, torch.Tensor):
        dims = tuple(int(s) for s in shape.tolist())
    else:
        dims = tuple(int(s) for s in np.asarray(shape))
    return x.reshape(dims)


# ---- validation specs -------------------------------------------------------


def _x(*shape):
    return lambda r: [r.randn(*shape).astype(np.float32)]


V.case("reshape", _x(3, 4), kwargs={"shape": (2, 6)}, dtypes=V.HALF,
       grad=True)
V.case("reshape", lambda r: [np.arange(12, dtype=np.int32)],
       kwargs={"shape": (3, -1)}, label="int32")
V.case("permute", _x(2, 3, 4), kwargs={"axes": (2, 0, 1)}, dtypes=V.HALF,
       grad=True)
V.case("transpose", _x(2, 5), dtypes=V.HALF, grad=True)
V.case("expand_dims", _x(4), kwargs={"axis": 0})
V.case("expand_dims", _x(2, 4), kwargs={"axis": -1}, label="last")
V.case("squeeze", _x(2, 1, 3))
V.case("squeeze", _x(1, 2, 1), kwargs={"axis": 0}, label="axis")
V.case("concat", lambda r: [r.randn(2, 2).astype(np.float32),
                            r.randn(1, 2).astype(np.float32)],
       kwargs={"axis": 0}, dtypes=V.HALF, grad=True)
V.case("stack", lambda r: [r.randn(3).astype(np.float32),
                           r.randn(3).astype(np.float32)],
       kwargs={"axis": 1}, dtypes=V.HALF, grad=True)
V.case("unstack", _x(3, 4), kwargs={"axis": 1}, grad=True)
V.case("split", _x(6, 4), kwargs={"num_split": 3}, grad=True)
V.case("split_v", _x(2, 7), kwargs={"sizes": (2, 4, 1), "axis": 1},
       grad=True)
V.case("slice", _x(4, 6), kwargs={"begin": (1, 2), "size": (2, -1)},
       dtypes=V.HALF, grad=True)
V.case("slice", _x(4, 6), kwargs={"begin": (3, 5), "size": (2, 3)},
       label="clamped")
V.case("strided_slice", _x(5, 6), kwargs={"begin": (0, 1), "end": (5, 6),
                                          "strides": (2, 2)},
       dtypes=V.HALF, grad=True)
V.case("strided_slice", _x(5, 6), kwargs={"begin": (4, 5), "end": (-6, 0),
                                          "strides": (-1, -2)},
       label="negative")
V.case("gather_nd", lambda r: [r.randn(4, 5, 3).astype(np.float32),
                               np.asarray([[0, 1], [3, 4], [-1, 2]],
                                          np.int32)],
       dtypes=V.HALF, grad=True)
V.case("repeat", _x(2, 3), kwargs={"repeats": 2, "axis": 1}, grad=True)
V.case("tile", _x(2, 3), kwargs={"reps": (2, 1)}, grad=True)
for _mode in ("constant", "reflect", "symmetric"):
    V.case("pad", _x(3, 4), kwargs={"paddings": ((1, 2), (2, 1)),
                                    "mode": _mode},
           dtypes=V.HALF, grad=True, label=_mode)
V.case("pad", _x(2, 3), kwargs={"paddings": ((0, 1), (1, 1)),
                                "constant": 2.5}, label="value")
V.case("reverse", _x(3, 4), kwargs={"axis": 1}, dtypes=V.HALF, grad=True)
V.case("reverse", _x(3, 4, 2), kwargs={"axis": (0, 2)}, label="axes")
V.case("rank", _x(2, 3, 4))
V.case("shape_of", _x(2, 3, 4))
V.case("size", _x(2, 3, 4))
V.case("zeros_like", _x(2, 3), dtypes=V.HALF)
V.case("ones_like", lambda r: [r.randint(0, 4, (2, 3)).astype(np.int32)])
V.case("ones_like", _x(2, 3), dtypes=V.HALF, label="float")
V.case("fill", lambda r: [], kwargs={"shape": (2, 3), "value": 1.5})
V.case("fill", lambda r: [], kwargs={"shape": (4,), "value": 7,
                                     "dtype": "int32"}, label="int32")
V.case("linspace", lambda r: [], kwargs={"start": -1.0, "stop": 2.0,
                                         "num": 7})
V.case("range", lambda r: [], kwargs={"start": 0.5, "limit": 4.0,
                                      "delta": 0.5})
V.case("range", lambda r: [], kwargs={"start": 2, "limit": 11, "delta": 3,
                                      "dtype": "int32"}, label="int32")
V.case("broadcast_to", _x(1, 3), kwargs={"shape": (4, 3)}, grad=True)
V.case("space_to_depth", _x(2, 4, 6, 3), kwargs={"block_size": 2},
       grad=True)
V.case("space_to_depth", _x(1, 3, 4, 6), kwargs={"block_size": 2,
                                                 "data_format": "NCHW"},
       label="NCHW")
V.case("depth_to_space", _x(2, 2, 3, 8), kwargs={"block_size": 2},
       grad=True)
V.case("depth_to_space", _x(1, 8, 2, 3), kwargs={"block_size": 2,
                                                 "data_format": "NCHW"},
       label="NCHW")
V.case("space_to_batch", _x(2, 4, 6, 3),
       kwargs={"block_shape": (2, 2), "paddings": ((0, 0), (1, 1))},
       grad=True)
V.case("batch_to_space", _x(8, 2, 3, 3),
       kwargs={"block_shape": (2, 2), "crops": ((0, 1), (1, 0))},
       grad=True)
V.case("diag", _x(4), grad=True)
V.case("diag", _x(4, 4), label="part")
V.case("diag_part", _x(4, 4), grad=True)
V.case("matrix_diag", _x(2, 3), dtypes=V.HALF, grad=True)
for _lo, _hi in ((1, 0), (0, -1), (-1, 2)):
    V.case("matrix_band_part", _x(2, 4, 5),
           kwargs={"num_lower": _lo, "num_upper": _hi}, grad=True,
           label=f"{_lo},{_hi}")
V.case("trace", _x(2, 4, 4), dtypes=V.HALF, grad=True)
V.case("trace", lambda r: [r.randint(-3, 4, (3, 3)).astype(np.int32)],
       label="int32")
V.case("eye", lambda r: [], kwargs={"rows": 3, "cols": 5})
V.case("eye", lambda r: [], kwargs={"rows": 4, "dtype": "int32"},
       label="square")
V.case("sequence_mask", lambda r: [np.asarray([1, 3, 0, 4], np.int32)],
       kwargs={"maxlen": 5})
V.case("sequence_mask", lambda r: [np.asarray([2, 5], np.int32)],
       kwargs={"maxlen": 5, "dtype": "bool"}, label="bool")
V.case("reverse_sequence", lambda r: [r.randn(3, 5, 2).astype(np.float32),
                                      np.asarray([2, 5, 0], np.int32)],
       grad=True)
V.case("reverse_sequence", lambda r: [r.randn(4, 3).astype(np.float32),
                                      np.asarray([1, 4, 3], np.int32)],
       kwargs={"seq_axis": 0, "batch_axis": 1}, label="time-major")
V.case("strided_slice_spec", _x(3, 4, 5),
       kwargs={"begin": (0, 0), "end": (0, 0), "strides": (1, 1),
               "ellipsis_mask": 0b01, "new_axis_mask": 0b10},
       label="ellipsis,new")
V.case("strided_slice_spec", _x(3, 4, 5),
       kwargs={"begin": (0, 0, 1, 0), "end": (0, 0, 0, 0),
               "strides": (1, 1, 1, 1), "begin_mask": 0b0001,
               "end_mask": 0b0101, "new_axis_mask": 0b0010,
               "shrink_mask": 0b1000}, label="shrink", grad=True)
V.case("strided_slice_spec", _x(3, 4, 5),
       kwargs={"begin": (0, 3), "end": (0, 0), "strides": (-1, -2),
               "begin_mask": 0b01, "end_mask": 0b01}, label="negative")
V.case("reshape_dynamic", lambda r: [r.randn(2, 6).astype(np.float32),
                                     np.asarray([3, 4], np.int32)])
