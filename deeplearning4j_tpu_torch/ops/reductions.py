"""Reduction and accumulation ops of the port.

Counterpart of ``deeplearning4j_tpu/ops/reductions.py``: the reduce table
(``_REDUCE``, registered through ``_reduce_apply`` at :56 / :78),
``reduce_logsumexp``, the index reductions, the counting, moments and
cumulative ops and ``bincount``, under the same names and keywords
(``axis`` None, an int or a tuple; ``keepdims``).

dtypes are jnp's with 64-bit types off: integer and bool sums, products
and cumulative sums accumulate in int32, counts and argmax/argmin are
int32, means and variances of integers are float32.

Every op registers a validation spec (:mod:`.validation`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import validation as V
from deeplearning4j_tpu_torch.ops.registry import registry
from deeplearning4j_tpu_torch.ops.transforms import inexact

_REG = registry()


def dims(x, axis):
    """``axis`` (None, an int or a sequence) as a tuple of dims of ``x``."""
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, int):
        return (axis % max(x.ndim, 1),)
    return tuple(int(a) % max(x.ndim, 1) for a in axis)


def int_acc(x):
    """The accumulation dtype of a sum or product: int32 for integer and
    bool tensors (the default int, x32), None (keep) for floats."""
    return None if (x.is_floating_point() or x.is_complex()) else torch.int32


def sum_(x, axis=None, keepdims=False):
    return torch.sum(x, dim=dims(x, axis), keepdim=keepdims,
                     dtype=int_acc(x))


def mean_(x, axis=None, keepdims=False):
    return torch.mean(inexact(x), dim=dims(x, axis), keepdim=keepdims)


def amax_(x, axis=None, keepdims=False):
    return torch.amax(x, dim=dims(x, axis), keepdim=keepdims)


def amin_(x, axis=None, keepdims=False):
    return torch.amin(x, dim=dims(x, axis), keepdim=keepdims)


def prod_(x, axis=None, keepdims=False):
    out = x if int_acc(x) is None else x.to(torch.int32)
    for d in sorted(dims(x, axis), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims, dtype=int_acc(x))
    return out


def var_(x, axis=None, keepdims=False):
    return torch.var(inexact(x), dim=dims(x, axis), unbiased=False,
                     keepdim=keepdims)


def std_(x, axis=None, keepdims=False):
    return torch.std(inexact(x), dim=dims(x, axis), unbiased=False,
                     keepdim=keepdims)


def _any(x, axis=None, keepdims=False):
    return torch.any(x.bool(), dim=dims(x, axis), keepdim=keepdims)


def _all(x, axis=None, keepdims=False):
    return torch.all(x.bool(), dim=dims(x, axis), keepdim=keepdims)


def _of_abs(fn):
    return lambda x, axis=None, keepdims=False: fn(torch.abs(x), axis,
                                                   keepdims)


# name -> (torch fn(x, axis, keepdims), differentiable)
_REDUCE = {
    "reduce_sum": (sum_, True),
    "reduce_mean": (mean_, True),
    "reduce_max": (amax_, True),
    "reduce_min": (amin_, True),
    "reduce_prod": (prod_, True),
    "reduce_norm1": (_of_abs(sum_), True),
    "reduce_norm2": (lambda x, axis=None, keepdims=False: torch.sqrt(
        sum_(torch.square(x), axis, keepdims)), True),
    "reduce_norm_max": (_of_abs(amax_), True),
    "reduce_sqnorm": (lambda x, axis=None, keepdims=False: sum_(
        torch.square(x), axis, keepdims), True),
    "reduce_variance": (var_, True),
    "reduce_stdev": (std_, True),
    "amax": (_of_abs(amax_), True),
    "amin": (_of_abs(amin_), True),
    "amean": (_of_abs(mean_), True),
    "asum": (_of_abs(sum_), True),
    "reduce_any": (_any, False),
    "reduce_all": (_all, False),
}


def _reduce_apply(fn, x, *, axis=None, keepdims: bool = False):
    return fn(x, axis, keepdims)


def _reduce_inputs(name):
    def draw(r):
        x = r.randn(4, 6, 5).astype(np.float32)
        return [x > 0.5 if name in ("reduce_any", "reduce_all") else x]

    return draw


# 16-bit reductions (over 6 terms): both accumulate in float32 and round
# once, but the variance and the norms go through a 16-bit square or mean
for _name, (_fn, _diff) in _REDUCE.items():
    _REG.register(_name, functools.partial(_reduce_apply, _fn),
                  doc=f"{_name} reduction (libnd4j legacy reduce op)")
    for _axis in (None, 1, (0, 2)):
        V.case(_name, _reduce_inputs(_name), kwargs={"axis": _axis},
               dtypes=V.HALF if _axis == 1 and _diff else V.FLOAT,
               grad=_diff, rtol=2e-5, atol=1e-6, label=f"axis={_axis}")
    V.case(_name, _reduce_inputs(_name), kwargs={"axis": 1, "keepdims": True},
           label="keepdims")
for _name in ("reduce_sum", "reduce_prod", "reduce_max", "reduce_mean"):
    V.case(_name, lambda r: [r.randint(-3, 4, (4, 5)).astype(np.int32)],
           kwargs={"axis": 1}, label="int32")


def _logsumexp(x, *, axis=None, keepdims: bool = False):
    """reduce_logsumexp — stable log-sum-exp (generic/reduce family)."""
    return torch.logsumexp(inexact(x), dim=dims(x, axis), keepdim=keepdims)


_REG.register("reduce_logsumexp", _logsumexp, doc=_logsumexp.__doc__)
V.case("reduce_logsumexp",
       lambda r: [r.randn(5, 7).astype(np.float32) * 10],
       kwargs={"axis": 1}, dtypes=V.HALF, grad=True)
V.case("reduce_logsumexp", lambda r: [r.randn(3, 4).astype(np.float32)],
       label="all")


# ---- index reductions ------------------------------------------------------


def _arg(fn, x, axis, keepdims):
    if axis is None:
        out = fn(x.reshape(-1), dim=0)
        if keepdims:
            out = out.reshape((1,) * x.ndim)
    else:
        out = fn(x, dim=int(axis), keepdim=keepdims)
    return out.to(torch.int32)


def _argmax(x, *, axis=None, keepdims: bool = False):
    """argmax (libnd4j indexreduce IMax), int32."""
    return _arg(torch.argmax, x, axis, keepdims)


def _argmin(x, *, axis=None, keepdims: bool = False):
    """argmin (libnd4j indexreduce IMin), int32."""
    return _arg(torch.argmin, x, axis, keepdims)


_REG.register("argmax", _argmax, doc=_argmax.__doc__)
_REG.register("argmin", _argmin, doc=_argmin.__doc__)
V.case("argmax", lambda r: [r.randn(6, 9).astype(np.float32)],
       kwargs={"axis": 1}, dtypes=V.HALF)
V.case("argmax", lambda r: [r.randn(3, 4).astype(np.float32)],
       kwargs={"keepdims": True}, label="all")
V.case("argmin", lambda r: [r.randn(6, 9).astype(np.float32)],
       kwargs={"axis": 0}, dtypes=V.HALF, seed=3)


# ---- counting / moments / cumulative --------------------------------------


def _count_nonzero(x, *, axis=None, keepdims: bool = False):
    """count_nonzero (generic/reduce/countNonZero analog), int32."""
    return torch.sum(x != 0, dim=dims(x, axis), keepdim=keepdims,
                     dtype=torch.int32)


def _count_zero(x, *, axis=None, keepdims: bool = False):
    """count_zero (generic/reduce/countZero analog), int32."""
    return torch.sum(x == 0, dim=dims(x, axis), keepdim=keepdims,
                     dtype=torch.int32)


def _moments(x, *, axis=None, keepdims: bool = False):
    """moments: (mean, variance) pair (generic/reduce/moments.cpp analog)."""
    return mean_(x, axis, keepdims), var_(x, axis, keepdims)


def _cumsum(x, *, axis: int = 0, exclusive: bool = False,
            reverse: bool = False):
    """cumsum with the reference's exclusive/reverse flags
    (generic/parity_ops/cumsum.cpp analog)."""
    if reverse:
        x = torch.flip(x, dims=(axis,))
    out = torch.cumsum(x, dim=axis, dtype=int_acc(x))
    if exclusive:
        out = out - x
    if reverse:
        out = torch.flip(out, dims=(axis,))
    return out


def _cumprod(x, *, axis: int = 0, exclusive: bool = False,
             reverse: bool = False):
    """cumprod with exclusive/reverse flags (generic/parity_ops/cumprod).
    Exclusive form shifts the input right by one (identity=1) before the
    scan — robust to zeros, unlike the divide-out trick."""
    axis = axis % x.ndim
    if reverse:
        x = torch.flip(x, dims=(axis,))
    if exclusive:
        one = torch.ones_like(x.narrow(axis, 0, 1))
        x = torch.cat([one, x.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)
    out = torch.cumprod(x, dim=axis, dtype=int_acc(x))
    if reverse:
        out = torch.flip(out, dims=(axis,))
    return out


_REG.register("count_nonzero", _count_nonzero, doc=_count_nonzero.__doc__)
_REG.register("count_zero", _count_zero, doc=_count_zero.__doc__)
_REG.register("moments", _moments, doc=_moments.__doc__)
cumsum = _REG.register("cumsum", _cumsum, doc=_cumsum.__doc__)
_REG.register("cumprod", _cumprod, doc=_cumprod.__doc__)


def _with_zeros(r):
    return [np.where(r.rand(4, 6) > 0.5, r.randn(4, 6), 0).astype(np.float32)]


V.case("count_nonzero", _with_zeros)
V.case("count_nonzero", _with_zeros, kwargs={"axis": 1}, label="axis=1")
V.case("count_zero", _with_zeros, kwargs={"axis": 0})
V.case("moments", lambda r: [r.randn(8, 5).astype(np.float32)],
       kwargs={"axis": 0}, dtypes=V.HALF, grad=True)
for _kw in ({"axis": 1}, {"axis": 1, "exclusive": True},
            {"axis": 1, "reverse": True},
            {"axis": 0, "exclusive": True, "reverse": True}):
    V.case("cumsum", lambda r: [r.randn(4, 6).astype(np.float32)],
           kwargs=_kw, grad=True, rtol=1e-5, atol=1e-5,
           label=",".join(sorted(_kw)))
    V.case("cumprod", lambda r: [r.rand(3, 5).astype(np.float32) + 0.5],
           kwargs=_kw, grad=True, label=",".join(sorted(_kw)))
V.case("cumsum", lambda r: [r.randn(4, 6).astype(np.float32)],
       kwargs={"axis": 1}, dtypes=("bfloat16", "float16"),
       tol={"bfloat16": (2.0 ** -5, 2.0 ** -5),
            "float16": (2.0 ** -8, 2.0 ** -8)}, label="16-bit")
V.case("cumsum", lambda r: [r.randint(-3, 4, (3, 5)).astype(np.int32)],
       kwargs={"axis": 1}, label="int32")


def _bincount(x, *, weights=None, minlength: int = 0, maxlength: int = None):
    """bincount (generic/parity_ops/bincount.cpp analog).

    The output length is static: pass minlength (or maxlength) >=
    max(x)+1. Counts of values outside [0, length) are dropped, as the
    reference's scatter drops them, so an unbounded call is an error
    rather than a wrong answer."""
    if maxlength is None and minlength <= 0:
        raise ValueError(
            "bincount needs a static length: pass minlength (or maxlength) "
            ">= max(x)+1 — the output cannot be sized from data")
    length = minlength if maxlength is None else maxlength
    flat = x.reshape(-1).to(torch.int64)
    ok = (flat >= 0) & (flat < length)
    if weights is None:
        vals = ok.to(torch.int32)
    else:
        w = weights.reshape(-1)
        vals = torch.where(ok, w, torch.zeros((), dtype=w.dtype,
                                              device=w.device))
    out = torch.zeros(length, dtype=vals.dtype, device=x.device)
    return out.index_add(0, torch.where(ok, flat, 0), vals)


_REG.register("bincount", _bincount, doc=_bincount.__doc__)
V.case("bincount", lambda r: [np.asarray([0, 1, 1, 3, 2, 1, 7], np.int32)],
       kwargs={"minlength": 5})
V.case("bincount", lambda r: [r.randint(0, 6, 20).astype(np.int32)],
       kwargs={"maxlength": 6,
               "weights": np.linspace(0.0, 1.0, 20, dtype=np.float32)},
       label="weights")
