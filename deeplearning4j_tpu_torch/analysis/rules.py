"""Per-op inference rules of the shape/dtype evidence, over the
GRAPH_OPS surface.

A copy of ``deeplearning4j_tpu/analysis/rules.py`` with the port's dtypes
(``torch.dtype``) and imports: the fused-op rules read
``FUSED_MATMUL_ACTIVATIONS`` from the port's ``ops.nn_ops``, and the
``fused_updater_step`` rule the port's updaters. Each rule maps
``(node, in_avals, emit)`` to a list of output :class:`AVal`s, reporting
GC-coded findings through ``emit(code, message)``. Soundness contract:
error findings only on *provable* mismatches (concrete ints disagree);
symbolic (:class:`Dim`) and unknown entries degrade the output, never
fire errors — a ``placeholder(shape=(None, 128))`` batch must flow
through the whole BERT graph with zero findings.

Ops not covered here fall back to the interpreter's probe (a run of the
impl on ``meta`` tensors, concrete shapes only) and then to the sound
unknown + GC006 path.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

import torch

from deeplearning4j_tpu_torch.analysis.broadcast import (
    BroadcastError, broadcast_shapes, is_float_dtype, is_int_dtype,
    promote_dtypes, promotion_surprise)
from deeplearning4j_tpu_torch.analysis.values import (
    AVal, DimEntry, Shape, as_dtype, dims_provably_unequal, fmt_shape)

RULES: Dict[str, Callable[..., List[AVal]]] = {}

_F32 = torch.float32
_I32 = torch.int32


def op_rule(*names: str):
    def deco(fn):
        for n in names:
            RULES[n] = fn
        return fn

    return deco


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------


def _norm_axis(axis: int, rank: int) -> Optional[int]:
    """Normalize a (possibly negative) axis; None when out of range."""
    ax = axis + rank if axis < 0 else axis
    return ax if 0 <= ax < rank else None


def _shapes_str(ins: Sequence[AVal]) -> str:
    return " and ".join(fmt_shape(a.shape) for a in ins)


def _float_result(dt: Optional[torch.dtype]) -> Optional[torch.dtype]:
    """dtype of a float-producing unary (exp/log/…): floats pass through,
    ints/bools become float32 (the JAX package's x32 default), unknown
    stays unknown."""
    if dt is None:
        return None
    return dt if is_float_dtype(dt) else _F32


def _broadcast_or_emit(ins: Sequence[AVal], emit, what: str) -> Shape:
    try:
        return broadcast_shapes([a.shape for a in ins])
    except BroadcastError as e:
        emit("GC002", f"{what}: operands {_shapes_str(ins)} do not "
                      f"broadcast ({e.detail})")
        return None


def _maybe_promo_warn(ins: Sequence[AVal], emit) -> None:
    reason = promotion_surprise([a.dtype for a in ins])
    if reason:
        emit("GC003", f"dtype promotion surprise: {reason}")


def _prod(entries) -> Optional[int]:
    out = 1
    for d in entries:
        if not isinstance(d, int):
            return None
        out *= d
    return out


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------


@op_rule("add", "sub", "mul", "maximum", "minimum", "pow", "floormod",
         "squared_difference")
def _ew_binary(node, ins, emit):
    shape = _broadcast_or_emit(ins[:2], emit, f"'{node.op}'")
    _maybe_promo_warn(ins[:2], emit)
    return [AVal(shape, promote_dtypes([a.dtype for a in ins[:2]]))]


@op_rule("div")
def _ew_div(node, ins, emit):
    shape = _broadcast_or_emit(ins[:2], emit, "'div'")
    _maybe_promo_warn(ins[:2], emit)
    dt = promote_dtypes([a.dtype for a in ins[:2]])
    if dt is not None and not is_float_dtype(dt):
        dt = _F32  # true division promotes integral operands
    return [AVal(shape, dt)]


@op_rule("gt", "lt", "gte", "lte", "eq", "neq")
def _ew_compare(node, ins, emit):
    # GRAPH_OPS comparisons cast the bool result to float32
    shape = _broadcast_or_emit(ins[:2], emit, f"'{node.op}'")
    return [AVal(shape, _F32)]


_PRESERVING_UNARY = (
    "neg", "abs", "sign", "floor", "ceil", "round", "square", "relu",
    "relu6", "leakyrelu", "hardtanh", "clip_by_value_graph",
    "dropout_graph", "zeros_like", "ones_like", "identity", "cumsum",
)

_FLOAT_UNARY = (
    "exp", "log", "log1p", "sqrt", "rsqrt", "sin", "cos", "tan", "asin",
    "acos", "atan", "sinh", "cosh", "tanh", "erf", "sigmoid", "softplus",
    "softsign", "swish", "mish", "gelu", "elu", "selu", "hardsigmoid",
    "reciprocal",
)


@op_rule(*_PRESERVING_UNARY)
def _unary_preserve(node, ins, emit):
    return [AVal(ins[0].shape, ins[0].dtype)]


@op_rule(*_FLOAT_UNARY)
def _unary_float(node, ins, emit):
    return [AVal(ins[0].shape, _float_result(ins[0].dtype))]


@op_rule("softmax", "log_softmax")
def _softmax(node, ins, emit):
    axis = int(node.kwargs.get("axis", -1))
    r = ins[0].rank
    if r is not None and _norm_axis(axis, r) is None:
        emit("GC001", f"softmax axis {axis} out of range for rank {r} "
                      f"input {fmt_shape(ins[0].shape)}")
    return [AVal(ins[0].shape, _float_result(ins[0].dtype))]


@op_rule("cast")
def _cast(node, ins, emit):
    try:
        dt = as_dtype(node.kwargs.get("dtype"))
    except TypeError:
        dt = None
    return [AVal(ins[0].shape, dt)]


@op_rule("where", "select")
def _where(node, ins, emit):
    shape = _broadcast_or_emit(ins[:3], emit, f"'{node.op}'")
    _maybe_promo_warn(ins[1:3], emit)
    return [AVal(shape, promote_dtypes([a.dtype for a in ins[1:3]]))]


# ---------------------------------------------------------------------------
# matmul family
# ---------------------------------------------------------------------------


def _matmul_shape(a: Shape, b: Shape, emit, what: str) -> Shape:
    """numpy matmul semantics over symbolic shapes."""
    if a is None or b is None:
        return None
    if len(a) == 0 or len(b) == 0:
        emit("GC001", f"{what}: matmul operand is 0-d "
                      f"({fmt_shape(a)} @ {fmt_shape(b)})")
        return None
    av = (1,) + tuple(a) if len(a) == 1 else tuple(a)
    bv = tuple(b) + (1,) if len(b) == 1 else tuple(b)
    if dims_provably_unequal(av[-1], bv[-2]):
        emit("GC002", f"{what}: contraction mismatch — inner dims "
                      f"{av[-1]} vs {bv[-2]} ({fmt_shape(a)} @ {fmt_shape(b)})")
        return None
    try:
        batch = broadcast_shapes([av[:-2] or (), bv[:-2] or ()])
    except BroadcastError as e:
        emit("GC002", f"{what}: batch dims do not broadcast ({e.detail}) "
                      f"({fmt_shape(a)} @ {fmt_shape(b)})")
        return None
    if batch is None:
        return None
    out = tuple(batch) + (av[-2], bv[-1])
    if len(a) == 1:
        out = out[:-2] + (out[-1],)
    if len(b) == 1:
        out = out[:-1]
    return out


def _swap_last2(s: Shape, emit, what: str) -> Shape:
    if s is None:
        return None
    if len(s) < 2:
        emit("GC001", f"{what}: transpose flag needs rank >= 2, got "
                      f"{fmt_shape(s)}")
        return None
    return s[:-2] + (s[-1], s[-2])


@op_rule("mmul")
def _mmul(node, ins, emit):
    a, b = ins[0].shape, ins[1].shape
    if node.kwargs.get("transpose_a"):
        a = _swap_last2(a, emit, "'mmul'")
    if node.kwargs.get("transpose_b"):
        b = _swap_last2(b, emit, "'mmul'")
    _maybe_promo_warn(ins[:2], emit)
    return [AVal(_matmul_shape(a, b, emit, "'mmul'"),
                 promote_dtypes([ins[0].dtype, ins[1].dtype]))]


@op_rule("matrix_transpose")
def _matrix_transpose(node, ins, emit):
    return [AVal(_swap_last2(ins[0].shape, emit, "'matrix_transpose'"),
                 ins[0].dtype)]


@op_rule("linear")
def _linear(node, ins, emit):
    _maybe_promo_warn(ins[:2], emit)
    shape = _matmul_shape(ins[0].shape, ins[1].shape, emit, "'linear'")
    if len(ins) > 2 and shape is not None:
        try:
            shape = broadcast_shapes([shape, ins[2].shape])
        except BroadcastError as e:
            emit("GC002", f"'linear': bias {fmt_shape(ins[2].shape)} does "
                          f"not broadcast onto {fmt_shape(shape)} ({e.detail})")
            shape = None
    return [AVal(shape, promote_dtypes([a.dtype for a in ins[:2]]))]


@op_rule("tensordot")
def _tensordot(node, ins, emit):
    axes = node.kwargs.get("axes")
    a, b = ins[0].shape, ins[1].shape
    if a is None or b is None:
        return [AVal(None, promote_dtypes([ins[0].dtype, ins[1].dtype]))]
    if isinstance(axes, int):
        ax_a = list(range(len(a) - axes, len(a)))
        ax_b = list(range(axes))
    else:
        try:
            ax_a = [int(x) for x in np.atleast_1d(axes[0])]
            ax_b = [int(x) for x in np.atleast_1d(axes[1])]
        except (TypeError, IndexError):
            return [AVal(None, promote_dtypes([ins[0].dtype, ins[1].dtype]))]
    ax_a = [x + len(a) if x < 0 else x for x in ax_a]
    ax_b = [x + len(b) if x < 0 else x for x in ax_b]
    if any(not 0 <= x < len(a) for x in ax_a) or \
            any(not 0 <= x < len(b) for x in ax_b):
        emit("GC001", f"'tensordot': axes {axes} out of range for "
                      f"{_shapes_str(ins[:2])}")
        return [AVal()]
    for x, y in zip(ax_a, ax_b):
        if dims_provably_unequal(a[x], b[y]):
            emit("GC002", f"'tensordot': contracted dims {a[x]} vs {b[y]} "
                          f"differ ({_shapes_str(ins[:2])}, axes={axes})")
    shape = tuple(d for i, d in enumerate(a) if i not in ax_a) + \
        tuple(d for i, d in enumerate(b) if i not in ax_b)
    return [AVal(shape, promote_dtypes([ins[0].dtype, ins[1].dtype]))]


# ---------------------------------------------------------------------------
# shape / layout
# ---------------------------------------------------------------------------


def _reshape_target(src: AVal, target, emit, what: str) -> Shape:
    tgt = [int(d) for d in target]
    n_minus = sum(1 for d in tgt if d < 0)
    if n_minus > 1:
        emit("GC001", f"{what}: more than one -1 in target shape {tgt}")
        return None
    src_n = src.num_elements()
    tgt_known = _prod(d for d in tgt if d >= 0)
    if n_minus == 0:
        if src_n is not None and src_n != tgt_known:
            emit("GC005", f"{what}: cannot reshape {fmt_shape(src.shape)} "
                          f"({src_n} elements) to {tuple(tgt)} "
                          f"({tgt_known} elements)")
            return None
        return tuple(tgt)
    # one -1: infer when the source count is concrete
    if src_n is None or tgt_known in (None, 0):
        return tuple(d if d >= 0 else None for d in tgt)
    if src_n % tgt_known != 0:
        emit("GC005", f"{what}: cannot reshape {fmt_shape(src.shape)} "
                      f"({src_n} elements) to {tuple(tgt)} "
                      f"(-1 is not integral: {src_n} / {tgt_known})")
        return None
    return tuple(d if d >= 0 else src_n // tgt_known for d in tgt)


@op_rule("reshape")
def _reshape(node, ins, emit):
    target = node.kwargs.get("shape")
    if target is None:
        return [AVal(None, ins[0].dtype)]
    return [AVal(_reshape_target(ins[0], target, emit, "'reshape'"),
                 ins[0].dtype)]


@op_rule("reshape_dynamic")
def _reshape_dyn(node, ins, emit):
    tgt = ins[1].value
    if tgt is not None:
        return [AVal(_reshape_target(ins[0], tgt.reshape(-1).tolist(),
                                     emit, "'reshape_dynamic'"),
                     ins[0].dtype)]
    ts = ins[1].shape
    if ts is not None and len(ts) == 1 and isinstance(ts[0], int):
        return [AVal((None,) * ts[0], ins[0].dtype)]
    return [AVal(None, ins[0].dtype)]


@op_rule("transpose", "permute")
def _transpose(node, ins, emit):
    axes = node.kwargs.get("axes")
    s = ins[0].shape
    if axes is None:
        return [AVal(None if s is None else tuple(reversed(s)),
                     ins[0].dtype)]
    axes = tuple(int(a) for a in axes)
    if s is None:
        return [AVal(None, ins[0].dtype)]
    r = len(s)
    norm = [_norm_axis(a, r) for a in axes]
    if len(axes) != r or None in norm or sorted(norm) != list(range(r)):
        emit("GC001", f"'{node.op}': axes {axes} is not a permutation of "
                      f"rank-{r} input {fmt_shape(s)}")
        return [AVal(None, ins[0].dtype)]
    return [AVal(tuple(s[a] for a in norm), ins[0].dtype)]


@op_rule("expand_dims")
def _expand_dims(node, ins, emit):
    s = ins[0].shape
    axis = int(node.kwargs.get("axis", 0))
    if s is None:
        return [AVal(None, ins[0].dtype)]
    r = len(s)
    ax = axis + r + 1 if axis < 0 else axis
    if not 0 <= ax <= r:
        emit("GC001", f"'expand_dims': axis {axis} out of range for "
                      f"rank-{r} input {fmt_shape(s)}")
        return [AVal(None, ins[0].dtype)]
    return [AVal(s[:ax] + (1,) + s[ax:], ins[0].dtype)]


@op_rule("squeeze")
def _squeeze(node, ins, emit):
    s = ins[0].shape
    axis = node.kwargs.get("axis")
    if s is None:
        return [AVal(None, ins[0].dtype)]
    r = len(s)
    if axis is None:
        if all(isinstance(d, int) for d in s):
            return [AVal(tuple(d for d in s if d != 1), ins[0].dtype)]
        return [AVal(None, ins[0].dtype)]  # symbolic dims might be 1
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    norm = []
    for a in axes:
        na = _norm_axis(int(a), r)
        if na is None:
            emit("GC001", f"'squeeze': axis {a} out of range for rank-{r} "
                          f"input {fmt_shape(s)}")
            return [AVal(None, ins[0].dtype)]
        if isinstance(s[na], int) and s[na] != 1:
            emit("GC001", f"'squeeze': axis {a} has size {s[na]} != 1 in "
                          f"{fmt_shape(s)}")
            return [AVal(None, ins[0].dtype)]
        norm.append(na)
    return [AVal(tuple(d for i, d in enumerate(s) if i not in norm),
                 ins[0].dtype)]


@op_rule("concat")
def _concat(node, ins, emit):
    axis = int(node.kwargs.get("axis", 0))
    ranks = {a.rank for a in ins if a.rank is not None}
    if len(ranks) > 1:
        emit("GC001", f"'concat': inputs of different ranks "
                      f"{_shapes_str(ins)}")
        return [AVal(None, promote_dtypes([a.dtype for a in ins]))]
    _maybe_promo_warn(ins, emit)
    dt = promote_dtypes([a.dtype for a in ins])
    if not ranks:
        return [AVal(None, dt)]
    r = ranks.pop()
    if r == 0:
        emit("GC001", "'concat': zero-dimensional inputs cannot be "
                      "concatenated")
        return [AVal(None, dt)]
    ax = _norm_axis(axis, r)
    if ax is None:
        emit("GC001", f"'concat': axis {axis} out of range for rank {r}")
        return [AVal(None, dt)]
    out: List[DimEntry] = []
    for i in range(r):
        if i == ax:
            total = 0
            for a in ins:
                d = None if a.shape is None else a.shape[i]
                if isinstance(d, int) and total is not None:
                    total += d
                else:
                    total = None
            out.append(total)
            continue
        entry: DimEntry = None
        for a in ins:
            d = None if a.shape is None else a.shape[i]
            if d is None:
                continue
            if entry is None:
                entry = d
            elif dims_provably_unequal(entry, d):
                emit("GC002", f"'concat': non-axis dim {i} differs "
                              f"({entry} vs {d}) across {_shapes_str(ins)}")
                return [AVal(None, dt)]
            elif isinstance(d, int):
                entry = d  # prefer concrete over symbolic
        out.append(entry)
    return [AVal(tuple(out), dt)]


@op_rule("stack")
def _stack(node, ins, emit):
    axis = int(node.kwargs.get("axis", 0))
    base: Shape = None
    for a in ins:
        if a.shape is None:
            continue
        if base is None:
            base = a.shape
        elif len(base) != len(a.shape) or any(
                dims_provably_unequal(x, y) for x, y in zip(base, a.shape)):
            emit("GC002", f"'stack': inputs must share one shape, got "
                          f"{_shapes_str(ins)}")
            return [AVal(None, promote_dtypes([a.dtype for a in ins]))]
    dt = promote_dtypes([a.dtype for a in ins])
    if base is None:
        return [AVal(None, dt)]
    r = len(base) + 1
    ax = _norm_axis(axis, r)
    if ax is None:
        emit("GC001", f"'stack': axis {axis} out of range for result "
                      f"rank {r}")
        return [AVal(None, dt)]
    return [AVal(base[:ax] + (len(ins),) + base[ax:], dt)]


@op_rule("unstack")
def _unstack(node, ins, emit):
    s = ins[0].shape
    axis = int(node.kwargs.get("axis", 0))
    n_out = len(node.outputs)
    if s is None:
        return [AVal(None, ins[0].dtype) for _ in range(n_out)]
    ax = _norm_axis(axis, len(s))
    if ax is None:
        emit("GC001", f"'unstack': axis {axis} out of range for "
                      f"{fmt_shape(s)}")
        return [AVal(None, ins[0].dtype) for _ in range(n_out)]
    if isinstance(s[ax], int) and s[ax] != n_out:
        emit("GC001", f"'unstack': axis {axis} has size {s[ax]} but the "
                      f"node declares {n_out} outputs")
    rest = s[:ax] + s[ax + 1:]
    return [AVal(rest, ins[0].dtype) for _ in range(n_out)]


@op_rule("unstack_first")
def _unstack_first(node, ins, emit):
    s = ins[0].shape
    if s is not None and len(s) == 0:
        emit("GC001", "'unstack_first': input is 0-d")
        return [AVal()]
    return [AVal(None if s is None else s[1:], ins[0].dtype)]


@op_rule("gather")
def _gather(node, ins, emit):
    params, idx = ins[0], ins[1]
    axis = int(node.kwargs.get("axis", 0))
    if params.shape is None:
        return [AVal(None, params.dtype)]
    ax = _norm_axis(axis, len(params.shape))
    if ax is None:
        emit("GC001", f"'gather': axis {axis} out of range for "
                      f"{fmt_shape(params.shape)}")
        return [AVal(None, params.dtype)]
    if idx.shape is None:
        return [AVal(None, params.dtype)]
    return [AVal(params.shape[:ax] + idx.shape + params.shape[ax + 1:],
                 params.dtype)]


@op_rule("tile")
def _tile(node, ins, emit):
    s = ins[0].shape
    reps = node.kwargs.get("reps")
    if s is None or reps is None:
        return [AVal(None, ins[0].dtype)]
    reps = [int(r) for r in np.atleast_1d(reps)]
    r = max(len(s), len(reps))
    full_s = (1,) * (r - len(s)) + tuple(s)
    full_r = [1] * (r - len(reps)) + reps
    out = tuple(d * m if isinstance(d, int) else (d if m == 1 else None)
                for d, m in zip(full_s, full_r))
    return [AVal(out, ins[0].dtype)]


@op_rule("pad")
def _pad(node, ins, emit):
    s = ins[0].shape
    paddings = node.kwargs.get("paddings")
    if s is None or paddings is None:
        return [AVal(None, ins[0].dtype)]
    try:
        pads = [(int(lo), int(hi)) for lo, hi in paddings]
    except (TypeError, ValueError):
        return [AVal(None, ins[0].dtype)]
    if len(pads) != len(s):
        emit("GC001", f"'pad': {len(pads)} padding pairs for rank-{len(s)} "
                      f"input {fmt_shape(s)}")
        return [AVal(None, ins[0].dtype)]
    out = tuple(d + lo + hi if isinstance(d, int) else
                (d if lo == 0 and hi == 0 else None)
                for d, (lo, hi) in zip(s, pads))
    return [AVal(out, ins[0].dtype)]


@op_rule("slice")
def _slice(node, ins, emit):
    s = ins[0].shape
    begin = node.kwargs.get("begin")
    size = node.kwargs.get("size")
    if s is None or size is None:
        return [AVal(None, ins[0].dtype)]
    size = [int(x) for x in size]
    if len(size) != len(s):
        emit("GC001", f"'slice': size has {len(size)} entries for "
                      f"rank-{len(s)} input {fmt_shape(s)}")
        return [AVal(None, ins[0].dtype)]
    for i, (d, sz) in enumerate(zip(s, size)):
        if isinstance(d, int) and sz > d:
            emit("GC001", f"'slice': size[{i}]={sz} exceeds input dim {d} "
                          f"in {fmt_shape(s)}")
            return [AVal(None, ins[0].dtype)]
    del begin  # dynamic_slice clamps the start; size alone fixes the shape
    return [AVal(tuple(size), ins[0].dtype)]


@op_rule("strided_slice")
def _strided_slice(node, ins, emit):
    s = ins[0].shape
    begin = node.kwargs.get("begin")
    end = node.kwargs.get("end")
    strides = node.kwargs.get("strides")
    if s is None or begin is None or end is None:
        return [AVal(None, ins[0].dtype)]
    begin = [int(b) for b in begin]
    end = [int(e) for e in end]
    strides = [int(x) for x in strides] if strides else [1] * len(begin)
    if len(begin) > len(s):
        emit("GC001", f"'strided_slice': {len(begin)} slice specs for "
                      f"rank-{len(s)} input {fmt_shape(s)}")
        return [AVal(None, ins[0].dtype)]
    out: List[DimEntry] = []
    for i, d in enumerate(s):
        if i >= len(begin):
            out.append(d)
        elif isinstance(d, int):
            out.append(len(range(*slice(begin[i], end[i],
                                        strides[i]).indices(d))))
        else:
            out.append(None)  # clamped bounds depend on the symbolic dim
    return [AVal(tuple(out), ins[0].dtype)]


@op_rule("flatten_from")
def _flatten_from(node, ins, emit):
    s = ins[0].shape
    axis = int(node.kwargs.get("axis", 1))
    if s is None:
        return [AVal(None, ins[0].dtype)]
    ax = axis + len(s) if axis < 0 else axis
    if not 0 <= ax <= len(s):
        emit("GC001", f"'flatten_from': axis {axis} out of range for "
                      f"{fmt_shape(s)}")
        return [AVal(None, ins[0].dtype)]

    def seg(entries):
        if len(entries) == 1:
            return entries[0]
        return _prod(entries)

    return [AVal((seg(s[:ax]) if ax else 1, seg(s[ax:]) if ax < len(s) else 1),
                 ins[0].dtype)]


@op_rule("broadcast_to")
def _broadcast_to(node, ins, emit):
    target = node.kwargs.get("shape")
    if target is None:
        return [AVal(None, ins[0].dtype)]
    tgt = tuple(int(d) for d in target)
    s = ins[0].shape
    if s is not None:
        if len(s) > len(tgt):
            emit("GC002", f"'broadcast_to': input {fmt_shape(s)} has higher "
                          f"rank than target {tgt}")
        else:
            for i in range(1, len(s) + 1):
                d = s[-i]
                if isinstance(d, int) and d != 1 and d != tgt[-i]:
                    emit("GC002", f"'broadcast_to': dim {d} does not "
                                  f"broadcast to {tgt[-i]} "
                                  f"({fmt_shape(s)} -> {tgt})")
                    break
    return [AVal(tgt, ins[0].dtype)]


@op_rule("shape_of")
def _shape_of(node, ins, emit):
    r = ins[0].rank
    # impl returns numpy int32 (int64 only for >2**31 dims — rare)
    return [AVal(None if r is None else (r,), _I32)]


@op_rule("size")
def _size(node, ins, emit):
    return [AVal((), _I32)]


@op_rule("one_hot_graph")
def _one_hot(node, ins, emit):
    depth = int(node.kwargs.get("depth", 0))
    s = ins[0].shape
    return [AVal(None if s is None else s + (depth,), _F32)]


@op_rule("fill")
def _fill(node, ins, emit):
    shape = node.kwargs.get("shape")
    try:
        dt = as_dtype(node.kwargs.get("dtype", "float32"))
    except TypeError:
        dt = _F32
    return [AVal(None if shape is None else tuple(int(d) for d in shape),
                 dt)]


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def _reduce_shape(s: Shape, axes, keepdims: bool, emit, what: str) -> Shape:
    if s is None:
        return None
    r = len(s)
    if axes is None:
        return (1,) * r if keepdims else ()
    norm = []
    for a in axes:
        na = _norm_axis(int(a), r)
        if na is None:
            emit("GC001", f"{what}: axis {a} out of range for rank-{r} "
                          f"input {fmt_shape(s)}")
            return None
        norm.append(na)
    if keepdims:
        return tuple(1 if i in norm else d for i, d in enumerate(s))
    return tuple(d for i, d in enumerate(s) if i not in norm)


@op_rule("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
         "reduce_prod", "reduce_std", "reduce_var")
def _reduce(node, ins, emit):
    axes = node.kwargs.get("axes") or None
    keep = bool(node.kwargs.get("keepdims", False))
    shape = _reduce_shape(ins[0].shape, axes, keep, emit, f"'{node.op}'")
    dt = ins[0].dtype
    if node.op in ("reduce_mean", "reduce_std", "reduce_var"):
        dt = _float_result(dt)
    return [AVal(shape, dt)]


@op_rule("argmax", "argmin")
def _argminmax(node, ins, emit):
    axis = int(node.kwargs.get("axis", -1))
    s = ins[0].shape
    if s is None:
        return [AVal(None, _I32)]
    ax = _norm_axis(axis, len(s))
    if ax is None:
        emit("GC001", f"'{node.op}': axis {axis} out of range for "
                      f"{fmt_shape(s)}")
        return [AVal(None, _I32)]
    return [AVal(s[:ax] + s[ax + 1:], _I32)]


@op_rule("norm2")
def _norm2(node, ins, emit):
    axes = node.kwargs.get("axes") or None
    shape = _reduce_shape(ins[0].shape, axes, False, emit, "'norm2'")
    return [AVal(shape, _float_result(ins[0].dtype))]


# ---------------------------------------------------------------------------
# nn composites + losses
# ---------------------------------------------------------------------------


@op_rule("layer_norm_graph")
def _layer_norm(node, ins, emit):
    x = ins[0]
    if len(ins) > 1 and x.shape is not None and ins[1].shape is not None:
        try:
            broadcast_shapes([x.shape, ins[1].shape])
        except BroadcastError as e:
            emit("GC002", f"'layer_norm_graph': gain "
                          f"{fmt_shape(ins[1].shape)} does not broadcast "
                          f"onto x {fmt_shape(x.shape)} ({e.detail})")
    return [AVal(x.shape, _float_result(x.dtype))]


@op_rule("batch_norm_graph")
def _batch_norm(node, ins, emit):
    return [AVal(ins[0].shape, _float_result(ins[0].dtype))]


_SCALAR_LOSSES = ("softmax_cross_entropy", "sigmoid_cross_entropy",
                  "mean_squared_error", "absolute_difference", "log_loss",
                  "huber_loss", "cosine_distance")


@op_rule(*_SCALAR_LOSSES)
def _loss(node, ins, emit):
    if len(ins) >= 2:
        _broadcast_or_emit(ins[:2], emit, f"'{node.op}'")
    return [AVal((), _F32)]


@op_rule("sparse_softmax_cross_entropy")
def _sparse_loss(node, ins, emit):
    logits, ids = ins[0], ins[1]
    if logits.shape is not None and ids.shape is not None:
        want = logits.shape[:-1]
        if len(want) == len(ids.shape) and any(
                dims_provably_unequal(a, b)
                for a, b in zip(want, ids.shape)):
            emit("GC002", f"'sparse_softmax_cross_entropy': label ids "
                          f"{fmt_shape(ids.shape)} do not match logits "
                          f"batch dims {fmt_shape(want)}")
    return [AVal((), _F32)]


# ---------------------------------------------------------------------------
# fused attention / matmul registry ops (the optimizer's fusion targets —
# docs/OPTIMIZER.md § Fusion tier). First-class rules so the pass
# invariant checker verifies fused graphs natively (symbolic batch dims
# included) instead of through the concrete-only meta-tensor probe.
# ---------------------------------------------------------------------------


@op_rule("dot_product_attention")
def _dot_product_attention(node, ins, emit):
    q, k, v = ins[0], ins[1], ins[2]
    # scores promote q with k (f32 weights after softmax), the output then
    # promotes with v — k participates in the result dtype
    dt = _float_result(promote_dtypes([q.dtype, k.dtype, v.dtype]))
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.rank is not None and a.rank < 2:
            emit("GC001", f"'dot_product_attention': {name} must be rank "
                          f">= 2 ([..., L, D]), got {fmt_shape(a.shape)}")
            return [AVal(None, dt)]
    if q.shape is not None and k.shape is not None and \
            dims_provably_unequal(q.shape[-1], k.shape[-1]):
        emit("GC002", f"'dot_product_attention': q/k head dims differ — "
                      f"{q.shape[-1]} vs {k.shape[-1]} "
                      f"({fmt_shape(q.shape)} vs {fmt_shape(k.shape)})")
        return [AVal(None, dt)]
    if k.shape is not None and v.shape is not None and \
            dims_provably_unequal(k.shape[-2], v.shape[-2]):
        emit("GC002", f"'dot_product_attention': k/v sequence lengths "
                      f"differ — {k.shape[-2]} vs {v.shape[-2]} "
                      f"({fmt_shape(k.shape)} vs {fmt_shape(v.shape)})")
        return [AVal(None, dt)]
    # `causal=` needs no extra shape constraint: the generic op's
    # end-aligned tril is defined for any (Lq, Lk) pair; the flash helper's
    # t_q == t_kv restriction is a dispatch gate, not a graph invariant
    if q.shape is None or v.shape is None:
        return [AVal(None, dt)]
    if len(ins) > 3 and ins[3].shape is not None and k.shape is not None:
        m = ins[3]
        if len(m.shape) == 0:
            emit("GC001", "'dot_product_attention': mask is 0-d — expected "
                          "a key mask broadcastable over [..., Lq, Lkv]")
        elif isinstance(m.shape[-1], int) and m.shape[-1] != 1 and \
                dims_provably_unequal(m.shape[-1], k.shape[-2]):
            emit("GC002", f"'dot_product_attention': mask trailing dim "
                          f"{m.shape[-1]} matches neither 1 nor the kv "
                          f"length {k.shape[-2]}")
    return [AVal(q.shape[:-1] + (v.shape[-1],), dt)]


@op_rule("paged_decode_attention")
def _paged_decode_attention(node, ins, emit):
    q, kp, vp, pt, sl = ins[0], ins[1], ins[2], ins[3], ins[4]
    dt = q.dtype  # impl casts the f32 accumulator back to q's dtype
    want_ranks = (("q", q, 3), ("k_pages", kp, 4), ("v_pages", vp, 4),
                  ("page_table", pt, 2), ("seq_lens", sl, 1))
    for name, a, want in want_ranks:
        if a.rank is not None and a.rank != want:
            emit("GC001", f"'paged_decode_attention': {name} must be rank "
                          f"{want}, got {fmt_shape(a.shape)}")
            return [AVal(None, dt)]
    if q.shape is not None and kp.shape is not None:
        for axis_q, axis_p, what in ((1, 2, "heads"), (2, 3, "head dim")):
            if dims_provably_unequal(q.shape[axis_q], kp.shape[axis_p]):
                emit("GC002", f"'paged_decode_attention': {what} differ — "
                              f"q {fmt_shape(q.shape)} vs k_pages "
                              f"{fmt_shape(kp.shape)}")
                return [AVal(None, dt)]
    if q.shape is not None and pt.shape is not None and \
            dims_provably_unequal(q.shape[0], pt.shape[0]):
        emit("GC002", f"'paged_decode_attention': slot counts differ — "
                      f"q {fmt_shape(q.shape)} vs page_table "
                      f"{fmt_shape(pt.shape)}")
        return [AVal(None, dt)]
    if pt.dtype is not None and not is_int_dtype(pt.dtype):
        emit("GC003", f"'paged_decode_attention': page_table dtype "
                      f"{pt.dtype} is not integral")
    return [AVal(q.shape, q.dtype)]


@op_rule("fused_matmul_bias_act")
def _fused_matmul_bias_act(node, ins, emit):
    from deeplearning4j_tpu_torch.ops.nn_ops import FUSED_MATMUL_ACTIVATIONS

    x, w = ins[0], ins[1]
    act = node.kwargs.get("activation", "none")
    if act not in FUSED_MATMUL_ACTIVATIONS:
        emit("GC001", f"'fused_matmul_bias_act': unknown activation "
                      f"'{act}'; valid: {list(FUSED_MATMUL_ACTIVATIONS)}")
    a, b = x.shape, w.shape
    if node.kwargs.get("transpose_a"):
        a = _swap_last2(a, emit, "'fused_matmul_bias_act'")
    if node.kwargs.get("transpose_b"):
        b = _swap_last2(b, emit, "'fused_matmul_bias_act'")
    _maybe_promo_warn(ins[:2], emit)
    shape = _matmul_shape(a, b, emit, "'fused_matmul_bias_act'")
    dt = promote_dtypes([x.dtype, w.dtype])
    if len(ins) > 2 and shape is not None and ins[2].shape is not None:
        try:
            shape = broadcast_shapes([shape, ins[2].shape])
        except BroadcastError as e:
            emit("GC002", f"'fused_matmul_bias_act': bias "
                          f"{fmt_shape(ins[2].shape)} does not broadcast "
                          f"onto {fmt_shape(shape)} ({e.detail})")
            shape = None
    if len(ins) > 2:
        dt = promote_dtypes([dt, ins[2].dtype])
    if act in ("tanh", "gelu", "gelu_exact"):
        dt = _float_result(dt)  # these activations produce floats; "none"
    return [AVal(shape, dt)]    # and "relu" keep integer inputs integral


@op_rule("fused_layer_norm")
def _fused_layer_norm(node, ins, emit):
    from deeplearning4j_tpu_torch.ops.nn_ops import FUSED_MATMUL_ACTIVATIONS

    x = ins[0]
    act = node.kwargs.get("activation", "none")
    if act not in FUSED_MATMUL_ACTIVATIONS:
        emit("GC001", f"'fused_layer_norm': unknown activation '{act}'; "
                      f"valid: {list(FUSED_MATMUL_ACTIVATIONS)}")
    axis = node.kwargs.get("axis", -1)
    if x.rank is not None and axis not in (-1, x.rank - 1):
        emit("GC001", f"'fused_layer_norm': trailing-axis only (the impl "
                      f"raises for axis={axis} at rank {x.rank}); use the "
                      f"catalog layer_norm for other axes")
    for what, a in [("gain", ins[1])] + \
            ([("bias", ins[2])] if len(ins) > 2 else []):
        if a.rank is not None and a.rank != 1:
            emit("GC001", f"'fused_layer_norm': {what} must be rank 1, "
                          f"got {fmt_shape(a.shape)}")
        elif x.shape is not None and a.shape is not None and \
                dims_provably_unequal(a.shape[0], x.shape[-1]):
            emit("GC002", f"'fused_layer_norm': {what} "
                          f"{fmt_shape(a.shape)} does not match the "
                          f"normalized dim of x {fmt_shape(x.shape)}")
    return [AVal(x.shape, _float_result(x.dtype))]


@op_rule("fused_updater_step")
def _fused_updater_step(node, ins, emit):
    # (param, grad, lr, step, *state) -> (new_param, *new_state): every
    # array leaf keeps the param's shape/dtype; lr/step are traced scalars
    p = ins[0]
    state = ins[4:]
    kind = node.kwargs.get("kind", "Sgd")
    from deeplearning4j_tpu_torch.nn.updater import UPDATERS

    if kind not in UPDATERS:
        emit("GC001", f"'fused_updater_step': unknown updater kind "
                      f"'{kind}'; valid: {sorted(UPDATERS)}")
    else:
        from deeplearning4j_tpu_torch.ops.cuda_updater import _updater_and_keys

        try:
            _, keys, _ = _updater_and_keys(
                kind, tuple(sorted((k, v) for k, v in node.kwargs.items()
                                   if k != "kind")))
        except (ValueError, TypeError):
            keys = None  # bad hyperparams: the impl raises its own error
        if keys is not None and len(state) != len(keys):
            emit("GC001", f"'fused_updater_step[{kind}]': expected "
                          f"{len(keys)} state arrays {list(keys)}, got "
                          f"{len(state)} — the trace will raise")
    for what, a in [("grad", ins[1])] + \
            [(f"state[{i}]", s) for i, s in enumerate(state)]:
        if p.shape is None or a.shape is None:
            continue
        # rank first — zip would silently truncate a rank mismatch
        if len(a.shape) != len(p.shape) or any(
                dims_provably_unequal(d1, d2)
                for d1, d2 in zip(p.shape, a.shape)):
            emit("GC002", f"'fused_updater_step': {what} "
                          f"{fmt_shape(a.shape)} does not match param "
                          f"{fmt_shape(p.shape)}")
    for what, a in (("lr", ins[2]), ("step", ins[3])):
        if a.rank is not None and a.rank != 0:
            emit("GC001", f"'fused_updater_step': {what} must be a scalar, "
                          f"got {fmt_shape(a.shape)}")
    return [AVal(p.shape, p.dtype)] + \
        [AVal(s.shape if s.shape is not None else p.shape,
              s.dtype if s.dtype is not None else p.dtype) for s in state]


@op_rule("quantize_int8")
def _quantize_int8(node, ins, emit):
    x = ins[0]
    axis = node.kwargs.get("axis")
    if axis is None:
        scale_shape: Optional[Shape] = ()
    elif x.shape is not None:
        # the impl accepts an int or a tuple of axes (max-over-axes semantics)
        axes = axis if isinstance(axis, (tuple, list)) else (axis,)
        normed = [_norm_axis(int(a), len(x.shape)) for a in axes]
        if any(a is None for a in normed):
            emit("GC001", f"'quantize_int8': axis {axis} out of range for "
                          f"{fmt_shape(x.shape)}")
            scale_shape = None
        else:
            keep = set(normed)
            scale_shape = tuple(1 if i in keep else d
                                for i, d in enumerate(x.shape))
    else:
        scale_shape = None
    return [AVal(x.shape, torch.int8), AVal(scale_shape, _F32)]


@op_rule("dequantize_int8")
def _dequantize_int8(node, ins, emit):
    q, scale = ins[0], ins[1]
    shape = q.shape
    if q.shape is not None and scale.shape is not None:
        try:
            shape = broadcast_shapes([q.shape, scale.shape])
        except BroadcastError as e:
            emit("GC002", f"'dequantize_int8': scale "
                          f"{fmt_shape(scale.shape)} does not broadcast "
                          f"onto q {fmt_shape(q.shape)} ({e.detail})")
            shape = None
    return [AVal(shape, _F32)]


@op_rule("matmul_int8")
def _matmul_int8(node, ins, emit):
    x, wq = ins[0], ins[1]
    if wq.dtype is not None and wq.dtype != torch.int8:
        emit("GC003", f"'matmul_int8': weights must be int8, got {wq.dtype}")
    if len(ins) > 2 and ins[2].rank is not None:
        ws = ins[2]
        # (N,) or the keepdims (1, N) that quantize_int8(axis=0) emits —
        # the impl reshapes to (1, N) either way
        ok = ws.rank == 1 or (
            ws.rank == 2 and ws.shape is not None
            and not dims_provably_unequal(ws.shape[0], 1))
        if not ok:
            emit("GC001", f"'matmul_int8': w_scale must be (N,) or (1, N), "
                          f"got {fmt_shape(ws.shape)}")
    shape = _matmul_shape(x.shape, wq.shape, emit, "'matmul_int8'")
    return [AVal(shape, x.dtype)]  # de-scale casts back to x's dtype


# ---------------------------------------------------------------------------
# conv / pool (NHWC, matching ops/nn_ops.py)
# ---------------------------------------------------------------------------


def _pair(v):
    return (tuple(int(a) for a in v) if isinstance(v, (tuple, list))
            else (int(v), int(v)))


def _conv_dim(n: DimEntry, k: int, s: int, d: int, same: bool) -> DimEntry:
    if not isinstance(n, int):
        return n if s == 1 and (same or k == 1) else None
    if same:
        return -(-n // s)  # ceil
    eff = (k - 1) * d + 1
    return max(0, (n - eff) // s + 1)


@op_rule("conv2d")
def _conv2d(node, ins, emit):
    x, w = ins[0], ins[1]
    for a, what, want in ((x, "input", 4), (w, "kernel", 4)):
        if a.rank is not None and a.rank != want:
            emit("GC001", f"'conv2d': {what} must be rank {want} "
                          f"(NHWC/HWIO), got {fmt_shape(a.shape)}")
            return [AVal(None, _float_result(x.dtype))]
    if x.shape is None or w.shape is None:
        return [AVal(None, _float_result(x.dtype))]
    groups = int(node.kwargs.get("feature_group_count", 1))
    cin, win = x.shape[3], w.shape[2]
    if isinstance(cin, int) and isinstance(win, int) and cin != win * groups:
        emit("GC002", f"'conv2d': input channels {cin} != kernel input "
                      f"channels {win} x groups {groups} "
                      f"({fmt_shape(x.shape)} * {fmt_shape(w.shape)})")
        return [AVal(None, _float_result(x.dtype))]
    s = _pair(node.kwargs.get("stride", 1))
    d = _pair(node.kwargs.get("dilation", 1))
    padding = node.kwargs.get("padding", "same")
    same = isinstance(padding, str) and padding.upper() == "SAME"
    if not isinstance(padding, str):
        return [AVal((x.shape[0], None, None, w.shape[3]),
                     _float_result(x.dtype))]
    kh, kw = w.shape[0], w.shape[1]
    h = _conv_dim(x.shape[1], kh, s[0], d[0], same) \
        if isinstance(kh, int) else None
    ww = _conv_dim(x.shape[2], kw, s[1], d[1], same) \
        if isinstance(kw, int) else None
    return [AVal((x.shape[0], h, ww, w.shape[3]), _float_result(x.dtype))]


@op_rule("maxpool2d", "avgpool2d", "pnormpool2d")
def _pool2d(node, ins, emit):
    x = ins[0]
    if x.rank is not None and x.rank != 4:
        emit("GC001", f"'{node.op}': input must be rank 4 (NHWC), got "
                      f"{fmt_shape(x.shape)}")
        return [AVal(None, x.dtype)]
    if x.shape is None:
        return [AVal(None, x.dtype)]
    kernel = _pair(node.kwargs.get("kernel", 1))
    stride = node.kwargs.get("stride")
    s = _pair(stride if stride is not None else kernel)
    padding = node.kwargs.get("padding", "valid")
    same = isinstance(padding, str) and padding.upper() == "SAME"
    if not isinstance(padding, str):
        return [AVal((x.shape[0], None, None, x.shape[3]), x.dtype)]
    h = _conv_dim(x.shape[1], kernel[0], s[0], 1, same)
    w = _conv_dim(x.shape[2], kernel[1], s[1], 1, same)
    return [AVal((x.shape[0], h, w, x.shape[3]), x.dtype)]


@op_rule("upsampling2d")
def _upsampling2d(node, ins, emit):
    x = ins[0]
    if x.rank is not None and x.rank != 4:
        emit("GC001", f"'upsampling2d': input must be rank 4 (NHWC), got "
                      f"{fmt_shape(x.shape)}")
        return [AVal(None, x.dtype)]
    if x.shape is None:
        return [AVal(None, x.dtype)]
    sh, sw = _pair(node.kwargs.get("size", 2))
    h = x.shape[1] * sh if isinstance(x.shape[1], int) else None
    w = x.shape[2] * sw if isinstance(x.shape[2], int) else None
    return [AVal((x.shape[0], h, w, x.shape[3]), x.dtype)]


@op_rule("global_avg_pool", "global_max_pool")
def _global_pool(node, ins, emit):
    x = ins[0]
    if x.shape is None:
        return [AVal(None, x.dtype)]
    if len(x.shape) != 4:
        emit("GC001", f"'{node.op}': input must be rank 4 (NHWC), got "
                      f"{fmt_shape(x.shape)}")
        return [AVal(None, x.dtype)]
    return [AVal((x.shape[0], x.shape[3]), x.dtype)]
