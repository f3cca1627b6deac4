"""Scatter and segment ops of the port.

Counterpart of ``deeplearning4j_tpu/ops/scatter.py``: the row scatters
(``scatter_add`` … ``scatter_upd``), the nd scatters, the sorted and
unsorted segment reductions and ``dynamic_partition`` /
``dynamic_stitch``, under the same names.

Semantics kept from the reference (XLA's scatter):

* indices out of range are dropped, negative ones count from the end;
* duplicate indices combine for add/sub/mul/div/max/min, and
  ``scatter_upd`` picks ONE of the updates (which one is not specified, as
  ``scatter.py:11-13`` documents);
* an empty segment of ``segment_max`` / ``segment_min`` holds the dtype's
  identity (−inf / +inf for floats, the integer extremes), as
  ``jax.ops.segment_max`` gives — ``index_reduce_`` with ``include_self``
  over a tensor filled with that identity, never its own default;
  ``segment_prod`` holds 1 and the sums 0.

Every op registers a validation spec (:mod:`.validation`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import validation as V
from deeplearning4j_tpu_torch.ops.registry import registry

_REG = registry()


def _rows(ref, indices):
    """Flat row indices into ``ref`` (negative from the end) and the mask
    of those in range."""
    n = ref.shape[0]
    idx = indices.reshape(-1).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, idx, 0), ok


def _row_updates(ref, indices, updates):
    return updates.reshape((-1,) + tuple(ref.shape[1:])).to(ref.dtype)


def identity(dtype: torch.dtype, reduce: str):
    """The identity of a segment reduction in ``dtype``."""
    if reduce in ("sum", "mean"):
        return 0
    if reduce == "prod":
        return 1
    if dtype.is_floating_point:
        return float("-inf") if reduce == "amax" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if reduce == "amax" else info.max


def _scatter(method, ref, indices, updates):
    idx, ok = _rows(ref, indices)
    upd = _row_updates(ref, indices, updates)
    keep = ok.reshape((-1,) + (1,) * (ref.ndim - 1))
    if method in ("add", "subtract"):
        upd = torch.where(keep, upd, torch.zeros((), dtype=upd.dtype,
                                                 device=upd.device))
        return ref.index_add(0, idx, -upd if method == "subtract" else upd)
    if method == "set":
        # dropped rows write their own current values back
        upd = torch.where(keep, upd, ref.index_select(0, idx))
        return ref.index_copy(0, idx, upd)
    reduce = {"multiply": "prod", "divide": "prod", "max": "amax",
              "min": "amin"}[method]
    if method == "divide":
        upd = 1.0 / upd
    upd = torch.where(keep, upd, torch.full((), identity(ref.dtype, reduce),
                                            dtype=upd.dtype,
                                            device=upd.device))
    return ref.index_reduce(0, idx, upd, reduce, include_self=True)


_SCATTER = ("scatter_add", "add"), ("scatter_sub", "subtract"), \
    ("scatter_mul", "multiply"), ("scatter_div", "divide"), \
    ("scatter_max", "max"), ("scatter_min", "min"), ("scatter_upd", "set")


def _scatter_inputs(name):
    def draw(r):
        ref = r.randn(6, 4).astype(np.float32)
        upd = r.randn(3, 4).astype(np.float32)
        if name == "scatter_div":
            upd = (np.abs(upd) + 0.5).astype(np.float32)
        return [ref, np.asarray([5, 0, 2], np.int32), upd]

    return draw


def _dup_inputs(r):
    ref = r.randn(5, 3).astype(np.float32)
    upd = (np.abs(r.randn(6, 3)) + 0.5).astype(np.float32)
    return [ref, np.asarray([1, 3, 1, -1, 3, 1], np.int32), upd]


def _check_upd_duplicates(outs, spec, dtype):
    """scatter_upd with duplicates: each written row equals ONE of its
    updates, the other rows are untouched."""
    ref, idx, upd = spec.draw()
    out = np.asarray(outs[0], np.float32)
    n = ref.shape[0]
    rows = np.where(idx < 0, idx + n, idx)
    for row in range(n):
        cands = upd[rows == row]
        if len(cands) == 0:
            np.testing.assert_array_equal(out[row], ref[row])
        else:
            assert any(np.array_equal(out[row], c) for c in cands), (
                f"row {row} is none of its updates")


for _name, _method in _SCATTER:
    _REG.register(_name, functools.partial(_scatter, _method),
                  doc=f"{_name}(ref, indices, updates) — row-indexed scatter "
                      "(generic/parity_ops/scatter_*.cpp)")
    V.case(_name, _scatter_inputs(_name), dtypes=V.HALF,
           grad=_method in ("add", "subtract", "set"))
    if _method == "set":
        V.case(_name, _dup_inputs, check=_check_upd_duplicates,
               label="duplicates")
    else:
        # duplicates combine; 16-bit products round after each combine
        V.case(_name, _dup_inputs, label="duplicates")
V.case("scatter_add", lambda r: [np.zeros((4, 2), np.int32),
                                 np.asarray([3, 9, 0, 3], np.int32),
                                 np.ones((4, 2), np.int32)],
       label="int32,out-of-range")


def _nd_index(x, indices):
    idx = indices.to(torch.int64)
    return tuple(idx[..., d] for d in range(idx.shape[-1]))


def _scatter_nd(indices, updates, *, shape):
    """scatter_nd: build a zeros(shape) tensor with updates at nd-indices
    (generic/parity_ops/scatter_nd.cpp); duplicates add."""
    z = torch.zeros(tuple(int(s) for s in shape), dtype=updates.dtype,
                    device=updates.device)
    return z.index_put(_nd_index(z, indices), updates, accumulate=True)


def _scatter_nd_add(ref, indices, updates):
    """scatter_nd_add (generic/parity_ops/scatter_nd_add.cpp)."""
    return ref.index_put(_nd_index(ref, indices), updates.to(ref.dtype),
                         accumulate=True)


def _scatter_nd_update(ref, indices, updates):
    """scatter_nd_update (generic/parity_ops/scatter_nd_update.cpp)."""
    return ref.index_put(_nd_index(ref, indices), updates.to(ref.dtype))


_REG.register("scatter_nd", _scatter_nd, doc=_scatter_nd.__doc__)
_REG.register("scatter_nd_add", _scatter_nd_add, doc=_scatter_nd_add.__doc__)
_REG.register("scatter_nd_update", _scatter_nd_update,
              doc=_scatter_nd_update.__doc__)

_ND_IDX = np.asarray([[0, 1], [2, 3], [1, 0], [0, 1]], np.int32)
V.case("scatter_nd", lambda r: [_ND_IDX, r.randn(4).astype(np.float32)],
       kwargs={"shape": (3, 4)}, dtypes=V.HALF, grad=True)
V.case("scatter_nd", lambda r: [_ND_IDX[:, :1], r.randn(4, 2).astype(
    np.float32)], kwargs={"shape": (3, 2)}, label="rows")
V.case("scatter_nd_add", lambda r: [r.randn(3, 4).astype(np.float32),
                                    _ND_IDX, r.randn(4).astype(np.float32)],
       dtypes=V.HALF, grad=True)
V.case("scatter_nd_update", lambda r: [r.randn(3, 4).astype(np.float32),
                                       _ND_IDX[:3],
                                       r.randn(3).astype(np.float32)],
       dtypes=V.HALF, grad=True)


# ---- segment reductions ----------------------------------------------------


def _segment(reduce, data, segment_ids, *, num_segments: int):
    ids = segment_ids.reshape(-1).to(torch.int64)
    ok = (ids >= 0) & (ids < num_segments)
    flat = data.reshape((ids.shape[0],) + tuple(data.shape[segment_ids.ndim:]))
    keep = ok.reshape((-1,) + (1,) * (flat.ndim - 1))
    ident = identity(data.dtype, reduce)
    flat = torch.where(keep, flat, torch.full((), ident, dtype=flat.dtype,
                                              device=flat.device))
    ids = torch.where(ok, ids, 0)
    out = torch.full((num_segments,) + tuple(flat.shape[1:]), ident,
                     dtype=data.dtype, device=data.device)
    if reduce == "sum":
        return out.index_add(0, ids, flat)
    return out.index_reduce(0, ids, flat, reduce, include_self=True)


def _counts(data, segment_ids, num_segments):
    ones = torch.ones(data.shape, dtype=torch.float32, device=data.device)
    return _segment("sum", ones, segment_ids, num_segments=num_segments)


def _segment_mean(data, segment_ids, *, num_segments: int):
    """segment_mean (generic/parity_ops/segment_mean.cpp)."""
    s = _segment("sum", data, segment_ids, num_segments=num_segments)
    n = _counts(data, segment_ids, num_segments)
    return s / torch.clamp_min(n, 1)


def _unsorted_segment_sqrt_n(data, segment_ids, *, num_segments: int):
    """unsorted_segment_sqrt_n: sum / sqrt(count)
    (generic/parity_ops/unsorted_segment_sqrt_n.cpp)."""
    s = _segment("sum", data, segment_ids, num_segments=num_segments)
    n = _counts(data, segment_ids, num_segments)
    return s / torch.sqrt(torch.clamp_min(n, 1))


def _segment_inputs(r):
    return [r.randn(8, 3).astype(np.float32),
            np.asarray([0, 0, 1, 1, 1, 3, 3, 0], np.int32)]


_SEGMENT = {"segment_sum": "sum", "segment_max": "amax",
            "segment_min": "amin", "segment_prod": "prod"}

for _name, _reduce in _SEGMENT.items():
    _fn = functools.partial(_segment, _reduce)
    _REG.register(_name, _fn,
                  doc=f"{_name}(data, segment_ids, num_segments) — "
                      "(generic/parity_ops segment family); ids need not be "
                      "sorted (unsorted_segment_* alias)")
    _REG.register("unsorted_" + _name, _fn,
                  doc=f"unsorted_{_name} — the same scatter-reduce")
    for _n in (_name, "unsorted_" + _name):
        # segment 2 is empty: the reduction's identity
        V.case(_n, _segment_inputs, kwargs={"num_segments": 4},
               dtypes=V.HALF, grad=_reduce == "sum")
V.case("segment_max", lambda r: [r.randint(-5, 5, (6,)).astype(np.int32),
                                 np.asarray([0, 0, 2, 2, 2, 7], np.int32)],
       kwargs={"num_segments": 4}, label="int32,out-of-range")
V.case("unsorted_segment_min", lambda r: [
    r.randint(-5, 5, (6,)).astype(np.int32),
    np.asarray([3, 0, 3, 0, 1, 0], np.int32)],
    kwargs={"num_segments": 5}, label="int32")

_REG.register("segment_mean", _segment_mean, doc=_segment_mean.__doc__)
_REG.register("unsorted_segment_mean", _segment_mean,
              doc="unsorted segment mean — same lowering")
_REG.register("unsorted_segment_sqrt_n", _unsorted_segment_sqrt_n,
              doc=_unsorted_segment_sqrt_n.__doc__)
for _n in ("segment_mean", "unsorted_segment_mean", "unsorted_segment_sqrt_n"):
    V.case(_n, _segment_inputs, kwargs={"num_segments": 4}, dtypes=V.HALF,
           grad=True)


# ---- dynamic partition / stitch -------------------------------------------


def _dynamic_partition(data, partitions, *, num_partitions: int):
    """dynamic_partition (generic/parity_ops/dynamic_parition.cpp [sic]).
    Static shapes: each partition is returned padded to the full data
    length with a parallel 0/1 validity mask (int32):
    returns ([part_0..part_{P-1}], [mask_0..mask_{P-1}])."""
    outs, masks = [], []
    n = data.shape[0]
    steps = torch.arange(n, device=data.device)
    for p in range(num_partitions):
        sel = partitions == p
        order = torch.argsort((~sel).to(torch.int8), stable=True)
        outs.append(data[order])
        masks.append((steps < sel.sum()).to(torch.int32))
    return outs, masks


def _dynamic_stitch(indices, parts):
    """dynamic_stitch (generic/parity_ops/dynamic_stitch.cpp)."""
    idx = torch.cat([i.reshape(-1) for i in indices]).to(torch.int64)
    flat = torch.cat([p.reshape((-1,) + tuple(p.shape[i.ndim:]))
                      for i, p in zip(indices, parts)])
    out = torch.zeros((idx.shape[0],) + tuple(flat.shape[1:]),
                      dtype=flat.dtype, device=flat.device)
    return out.index_copy(0, idx, flat)


_REG.register("dynamic_partition", _dynamic_partition,
              doc=_dynamic_partition.__doc__)
_REG.register("dynamic_stitch", _dynamic_stitch, doc=_dynamic_stitch.__doc__)

V.case("dynamic_partition", lambda r: [r.randn(6, 2).astype(np.float32),
                                       np.asarray([1, 0, 2, 1, 0, 1],
                                                  np.int32)],
       kwargs={"num_partitions": 3}, dtypes=V.HALF, grad=True)
V.case("dynamic_stitch", lambda r: [
    [np.asarray([0, 2], np.int32), np.asarray([[1], [3]], np.int32)],
    [r.randn(2, 3).astype(np.float32), r.randn(2, 1, 3).astype(np.float32)]],
    dtypes=V.HALF)
