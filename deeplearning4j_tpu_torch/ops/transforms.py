"""Elementwise transform ops of the port.

Counterpart of ``deeplearning4j_tpu/ops/transforms.py``: the unary table
(``_UNARY``, :40), the pairwise table (``_BINARY``, :89), the comparisons
and logical ops (``_COMPARE``, :108) and ``select`` / ``select_v1`` /
``where``, under the same names. Each body is the torch counterpart of the
jnp / lax / jax.nn function the JAX package lowers to, with jnp's dtype
results: the floating functions promote integer and bool inputs to
float32, comparisons and logical ops give bool, true division of integers
gives float32.

The registry's ``gelu`` is the EXACT (erf) form, as the JAX package has it
(``transforms.py:80``); SameDiff's graph-op ``gelu`` (the tanh form) shadows
it inside graphs through ``REGISTRY_SHADOW_WHITELIST``.

Every table entry registers a validation spec (:mod:`.validation`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import validation as V
from deeplearning4j_tpu_torch.ops.registry import registry

_REG = registry()


def inexact(x):
    """``x`` as jnp's floating functions see it: integer and bool tensors
    promoted to float32 (the default float with 64-bit types off)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(torch.float32)


def _fl(fn):
    return lambda x: fn(inexact(x))


def _relu6(x):
    # jnp.minimum(jnp.maximum(x, 0), 6.): the float 6. promotes integers
    return torch.clamp(inexact(x), 0.0, 6.0)


def _hard_tanh(x):
    x = inexact(x)
    return torch.where(x > 1, torch.ones_like(x),
                       torch.where(x < -1, -torch.ones_like(x), x))


def _softplus(x):
    x = inexact(x)  # jnp.logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gelu_exact(x):
    return F.gelu(inexact(x), approximate="none")


def _posify(x):
    return np.abs(x) + 0.5


def _unit(x):
    return np.clip(x, -0.95, 0.95)


# name -> (torch fn, input-domain transform, differentiable)
_UNARY = {
    "abs": (torch.abs, None, True),
    "ceil": (torch.ceil, None, False),
    "floor": (torch.floor, None, False),
    "rint": (torch.round, None, False),
    "round": (torch.round, None, False),
    "exp": (_fl(torch.exp), None, True),
    "expm1": (_fl(torch.expm1), None, True),
    "log": (_fl(torch.log), _posify, True),
    "log1p": (_fl(torch.log1p), _posify, True),
    "log2": (_fl(torch.log2), _posify, True),
    "sqrt": (_fl(torch.sqrt), _posify, True),
    "rsqrt": (_fl(torch.rsqrt), _posify, True),
    "square": (torch.square, None, True),
    "cube": (lambda x: x * x * x, None, True),
    "reciprocal": (_fl(torch.reciprocal), _posify, True),
    "neg": (torch.neg, None, True),
    "sign": (torch.sign, None, False),
    "sin": (_fl(torch.sin), None, True),
    "cos": (_fl(torch.cos), None, True),
    "tan": (_fl(torch.tan), _unit, True),
    "asin": (_fl(torch.asin), _unit, True),
    "acos": (_fl(torch.acos), _unit, True),
    "atan": (_fl(torch.atan), None, True),
    "sinh": (_fl(torch.sinh), None, True),
    "cosh": (_fl(torch.cosh), None, True),
    "tanh": (_fl(torch.tanh), None, True),
    "asinh": (_fl(torch.asinh), None, True),
    "acosh": (_fl(torch.acosh), lambda x: np.abs(x) + 1.5, True),
    "atanh": (_fl(torch.atanh), _unit, True),
    "erf": (_fl(torch.erf), None, True),
    "erfc": (_fl(torch.erfc), None, True),
    "sigmoid": (_fl(torch.sigmoid), None, True),
    "softsign": (_fl(F.softsign), None, True),
    "softplus": (_softplus, None, True),
    "relu6": (_relu6, None, True),
    "hard_sigmoid": (lambda x: _relu6(x + 3.0) / 6.0, None, True),
    "hard_tanh": (_hard_tanh, None, True),
    "selu": (_fl(F.selu), None, True),
    "elu": (_fl(F.elu), None, True),
    "gelu": (_gelu_exact, None, True),
    "swish": (_fl(F.silu), None, True),
    "mish": (_fl(F.mish), None, True),
    "identity": (lambda x: x, None, True),
    "isnan": (torch.isnan, None, False),
    "isinf": (torch.isinf, None, False),
    "isfinite": (torch.isfinite, None, False),
}


def _truncatediv(x, y):
    return torch.trunc(torch.true_divide(x, y))


# name -> (torch fn, input mode, differentiable); mode True keeps the
# divisor away from zero, "pow" the base positive
_BINARY = {
    "add": (torch.add, False, True),
    "subtract": (torch.sub, False, True),
    "multiply": (torch.mul, False, True),
    "divide": (torch.true_divide, True, True),  # integers give float32
    "reversesubtract": (lambda x, y: y - x, False, True),
    "reversedivide": (lambda x, y: torch.true_divide(y, x), True, True),
    "maximum": (torch.maximum, False, True),
    "minimum": (torch.minimum, False, True),
    "squaredsubtract": (lambda x, y: torch.square(x - y), False, True),
    "atan2": (lambda x, y: torch.atan2(inexact(x), inexact(y)), False, True),
    "mod": (torch.remainder, True, False),
    "floormod": (torch.remainder, True, False),
    "truncatemod": (torch.fmod, True, False),
    "floordiv": (torch.floor_divide, True, False),
    "truncatediv": (_truncatediv, True, False),
    "pow": (torch.pow, "pow", True),
}

_COMPARE = {
    "equals": torch.eq,
    "not_equals": torch.ne,
    "less": torch.lt,
    "less_equal": torch.le,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "boolean_and": torch.logical_and,
    "boolean_or": torch.logical_or,
    "boolean_xor": torch.logical_xor,
}


def registry_fn(name: str):
    """The plain function of a registered unary transform (SameDiff's graph
    ops share them: one definition, jnp's dtype rule)."""
    return _UNARY[name][0]


def _unary_apply(fn, x):
    return fn(x)


def _binary_apply(fn, x, y):
    return fn(x, y)


def _unary_inputs(domain):
    def draw(r):
        x = r.randn(4, 33).astype(np.float32)
        return [x if domain is None else domain(x).astype(np.float32)]

    return draw


def _binary_inputs(mode):
    def draw(r):
        x = r.randn(3, 17).astype(np.float32)
        y = r.randn(3, 17).astype(np.float32)
        if mode is True:  # divisor-safe
            y = (np.abs(y) + 0.5).astype(np.float32)
        elif mode == "pow":
            x = (np.abs(x) + 0.1).astype(np.float32)
        return [x, y]

    return draw


# erf-based gelu: the two packages' formulas round differently near the
# erf's steep part (2e-4 relative, as the JAX package's own case allows)
_UNARY_TOL = {"gelu": (2e-4, 1e-5)}

for _name, (_fn, _domain, _diff) in _UNARY.items():
    _REG.register(_name, functools.partial(_unary_apply, _fn),
                  doc=f"elementwise {_name} (libnd4j legacy transform)")
    _rt, _at = _UNARY_TOL.get(_name, (1e-5, 1e-6))
    V.case(_name, _unary_inputs(_domain), dtypes=V.HALF, grad=_diff,
           rtol=_rt, atol=_at)

for _name, (_fn, _mode, _diff) in _BINARY.items():
    _REG.register(_name, functools.partial(_binary_apply, _fn),
                  doc=f"elementwise pairwise {_name} (libnd4j pairwise "
                      "transform)")
    V.case(_name, _binary_inputs(_mode), dtypes=V.HALF, grad=_diff)


def _compare_inputs(name):
    def draw(r):
        if name.startswith("boolean"):
            return [r.rand(4, 9) > 0.5, r.rand(4, 9) > 0.5]
        return [r.randint(-3, 3, (4, 9)).astype(np.float32),
                r.randint(-3, 3, (4, 9)).astype(np.float32)]

    return draw


for _name, _fn in _COMPARE.items():
    _REG.register(_name, functools.partial(_binary_apply, _fn),
                  doc=f"elementwise comparison {_name} (libnd4j broadcast "
                      "comparison)")
    V.case(_name, _compare_inputs(_name),
           dtypes=V.FLOAT if _name.startswith("boolean") else V.HALF)

_REG.register("boolean_not", torch.logical_not, doc="elementwise logical not")
V.case("boolean_not", lambda r: [r.rand(5, 7) > 0.5])


# ---- select / where -------------------------------------------------------


def select(cond, x, y):
    """reference Select op (generic/transforms/select.cpp analog)."""
    return torch.where(cond.bool(), x, y)


def select_v1(cond, x, y):
    """TF v1 Select semantics: a rank-1 cond broadcasts over the FIRST
    dimension of higher-rank x/y (unlike SelectV2's numpy-style trailing
    broadcast)."""
    if cond.ndim == 1 and x.ndim > 1:
        cond = cond.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(cond.bool(), x, y)


def where_op(cond):
    """reference Where (index form): the indices of the nonzero entries,
    int32 (n, rank), padded to every entry with -1 rows — the static shape
    of ``jnp.argwhere(cond, size=cond.size, fill_value=-1)``; computed on
    the device with no host read of the count."""
    flat = cond.reshape(-1) != 0
    n = flat.numel()
    order = torch.argsort((~flat).to(torch.int8), stable=True)
    valid = flat[order]
    rows = []
    rem = order
    for d in reversed(cond.shape):
        rows.append(rem % d)
        rem = rem // d
    idx = torch.stack(rows[::-1], dim=-1).reshape(n, cond.ndim)
    return torch.where(valid[:, None], idx,
                       torch.full((), -1, dtype=idx.dtype,
                                  device=idx.device)).to(torch.int32)


_REG.register("select", select, doc=select.__doc__)
_REG.register("select_v1", select_v1, doc=select_v1.__doc__)
_REG.register("where", where_op, doc=where_op.__doc__)

V.case("select", lambda r: [r.rand(4, 5) > 0.5,
                            r.randn(4, 5).astype(np.float32),
                            r.randn(4, 5).astype(np.float32)],
       dtypes=V.HALF, grad=True)
V.case("select_v1", lambda r: [r.rand(3) > 0.5,
                               r.randn(3, 4).astype(np.float32),
                               r.randn(3, 4).astype(np.float32)],
       dtypes=V.HALF)
V.case("select_v1", lambda r: [r.rand(3, 4) > 0.5,
                               r.randn(3, 4).astype(np.float32),
                               r.randn(3, 4).astype(np.float32)],
       label="rank-matched")
V.case("where", lambda r: [r.rand(3, 4) > 0.5])
V.case("where", lambda r: [r.randint(0, 2, (2, 3, 2)).astype(np.float32)],
       label="float-3d")
