"""SameDiff — the define-then-run graph engine of the port.

Counterpart of ``deeplearning4j_tpu/autodiff/samediff.py``: the user (or an
importer) builds a graph of named variables and recorded ops; execution
runs the requested outputs' subgraph — after the pre-run optimizer
(:mod:`.optimize`: DCE, folding, CSE, algebraic cleanup and the fusion
tier) when ``optimize=True`` — through the op catalog below and the
port's registry, where fused nodes reach the hand-written CUDA kernels
(``dot_product_attention`` → flash attention, ``fused_matmul_bias_act`` →
the fused matmul epilogue).

What differs from the JAX package:

* There is no trace. ``output`` runs the plan as one compiled unit
  (``optimize.CompiledGraph``): on the card its kernels are captured into
  a CUDA graph once per feed signature and replayed after
  (``ops/capture.py``); on the CPU, and under ``disable_capture()``, the
  plan runs eagerly, node by node. Every compile is reported to the
  recompile ledger (``observe.ledger()``, graph ``"samediff"``, key
  ``"exec"``) with the JAX package's causes. Values a node's consumers no
  longer need are dropped as soon as the last one has run, so peak memory
  is the live set, not every intermediate.
* Arrays are torch tensors on ``SameDiff(device=...)`` (the card unless
  the caller asks for the CPU). Feeds, constants, variables and folded
  constants are canonicalized as the JAX package does with 64-bit types
  off: float64 → float32, int64 → int32 (complex128 → complex64, uint64 →
  uint32), so avals, CSE keys and folds are the JAX package's.
* ``output`` returns numpy arrays, as the JAX package does; a bfloat16
  result comes back as float32 (numpy has no bfloat16).
* Gradients come from ``torch.autograd.grad`` over the same plan
  ``output`` runs (the JAX package takes ``jax.grad`` of the traced
  interpreter), with zeros for a VARIABLE the loss never reads, as
  ``jax.grad`` gives. ``calculate_gradients`` and ``fit``'s step are
  training units (``nn/compiled.py``, keys ``grad`` and ``train``, the JAX
  package's jitted functions): captured per feed signature on the card,
  eager on the CPU and under ``disable_capture()``. ``fit`` steps: loss
  and gradients through the plan, then one ``Updater.apply_fused_many``
  over every leaf (the fused updater kernel on the card, one launch)
  under ``no_grad``, at the device iteration; on the card the arrays and
  the updater state are written in place (the JAX step's donated
  buffers), so ``output``'s captured graph sees each step through the
  versions its static loads check. Step losses stay on the device and
  are read once per epoch.
* Ported: the construction API, the ``math``, ``nn`` and ``loss``
  namespaces, the graph-op catalog, ``output``/``exec``,
  ``calculate_gradients``, ``TrainingConfig``/``fit`` with the training
  state and listeners, ``get_arr``/``set_arr``, ``variables`` and
  ``summary``; ``fit`` polls the preemption fault point and flag once a
  batch, keeps the data cursor and logs the ``train_epoch`` event. Not
  yet: control flow (scan/while/cond), serde, the other namespaces and
  graph checking (``check``; ``validate=True`` raises) (ROADMAP.md,
  Queue 1 items 7 and 11).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.ops import losses as loss_lib
from deeplearning4j_tpu_torch.ops import nn_ops
from deeplearning4j_tpu_torch.ops.registry import registry as op_registry

VALIDATE_NOT_PORTED = (
    "graph checking (validate=True) needs the analyzers' check_samediff, "
    "which the port does not have yet (ROADMAP.md, Queue 1 item 10)")

# the JAX package runs with 64-bit types off: these become 32-bit
_CANON = {torch.float64: torch.float32, torch.int64: torch.int32,
          torch.complex128: torch.complex64}
if hasattr(torch, "uint64"):
    _CANON[torch.uint64] = torch.uint32


def canonical_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype an array of ``dt`` has in the JAX package (64-bit off)."""
    return _CANON.get(dt, dt)


def canonical(value, device: Optional[torch.device] = None) -> torch.Tensor:
    """``value`` (tensor, numpy array or Python scalar) as a tensor of its
    canonical dtype on ``device`` (its own device when None)."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        if not arr.flags.writeable or not arr.flags.c_contiguous:
            arr = np.array(arr)  # torch.from_numpy wants writable memory
        if arr.dtype.name == "bfloat16":  # ml_dtypes: torch has no reader
            t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
    t = t.to(canonical_dtype(t.dtype))
    return t if device is None else t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class SDVariable:
    """SDVariable.java analog: a named symbolic tensor in one SameDiff graph.

    variable_type: PLACEHOLDER | VARIABLE (trainable) | CONSTANT | ARRAY
    (op output) — mirrors org.nd4j.autodiff.samediff.VariableType.
    """

    def __init__(self, sd: "SameDiff", name: str, vtype: str,
                 shape: Optional[Tuple[int, ...]] = None,
                 dtype: torch.dtype = torch.float32):
        self.sd = sd
        self.name = name
        self.vtype = vtype
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype

    # ---- python operator sugar (SDVariable.add/mul/... in the reference) --
    def _bin(self, op: str, other) -> "SDVariable":
        other = self.sd._lift(other)
        return self.sd._record(op, [self, other])

    def __add__(self, o):
        return self._bin("add", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self.sd._lift(o)._bin("sub", self)

    def __mul__(self, o):
        return self._bin("mul", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self.sd._lift(o)._bin("div", self)

    def __pow__(self, o):
        return self._bin("pow", o)

    def __neg__(self):
        return self.sd._record("neg", [self])

    def __matmul__(self, o):
        return self._bin("mmul", o)

    # ---- common methods ---------------------------------------------------
    def add(self, o):
        return self.__add__(o)

    def sub(self, o):
        return self.__sub__(o)

    def mul(self, o):
        return self.__mul__(o)

    def div(self, o):
        return self.__truediv__(o)

    def mmul(self, o):
        return self.__matmul__(o)

    def reshape(self, *shape):
        return self.sd._record("reshape", [self],
                               {"shape": tuple(int(s) for s in shape)})

    def transpose(self, *axes):
        return self.sd._record("transpose", [self], {"axes": axes or None})

    def sum(self, *axes, keepdims=False):
        return self.sd._record("reduce_sum", [self],
                               {"axes": axes or None, "keepdims": keepdims})

    def mean(self, *axes, keepdims=False):
        return self.sd._record("reduce_mean", [self],
                               {"axes": axes or None, "keepdims": keepdims})

    def max(self, *axes, keepdims=False):
        return self.sd._record("reduce_max", [self],
                               {"axes": axes or None, "keepdims": keepdims})

    def min(self, *axes, keepdims=False):
        return self.sd._record("reduce_min", [self],
                               {"axes": axes or None, "keepdims": keepdims})

    def std(self, *axes, keepdims=False):
        return self.sd._record("reduce_std", [self],
                               {"axes": axes or None, "keepdims": keepdims})

    def argmax(self, axis=-1):
        return self.sd._record("argmax", [self], {"axis": axis})

    def rename(self, new_name: str) -> "SDVariable":
        self.sd._rename(self.name, new_name)
        return self

    def eval(self, feeds: Optional[Dict[str, Any]] = None):
        """Evaluate just this variable (SDVariable.eval)."""
        return self.sd.output(feeds or {}, [self.name])[self.name]

    def __repr__(self):
        return (f"SDVariable(name={self.name!r}, type={self.vtype}, "
                f"shape={self.shape})")


class _Node:
    """One recorded op application (the reference's SameDiffOp entry)."""

    __slots__ = ("op", "inputs", "kwargs", "outputs")

    def __init__(self, op: str, inputs: List[str], kwargs: Dict[str, Any],
                 outputs: List[str]):
        self.op = op
        self.inputs = inputs
        self.kwargs = kwargs
        self.outputs = outputs


# ---------------------------------------------------------------------------
# Op implementations available to graphs: name -> callable taking
# (*input_tensors, **kwargs), the torch counterparts of the JAX package's
# GRAPH_OPS (its jnp/lax entries), with its dtype results: comparisons give
# float32, argmax/argmin and integer sums int32, true division of integers
# float32.
# ---------------------------------------------------------------------------


def _all_axes(x, axes):
    return tuple(range(x.ndim)) if not axes else tuple(int(a) for a in axes)


def _int_sum_dtype(x):
    # integer and bool sums accumulate in the default int (int32, x32)
    return None if (x.is_floating_point() or x.is_complex()) else torch.int32


def _reduce_sum(x, *, axes=None, keepdims=False):
    return torch.sum(x, dim=_all_axes(x, axes), keepdim=keepdims,
                     dtype=_int_sum_dtype(x))


def _float(x):
    return x if (x.is_floating_point() or x.is_complex()) else x.float()


def _reduce_mean(x, *, axes=None, keepdims=False):
    return torch.mean(_float(x), dim=_all_axes(x, axes), keepdim=keepdims)


def _reduce_max(x, *, axes=None, keepdims=False):
    return torch.amax(x, dim=_all_axes(x, axes), keepdim=keepdims)


def _reduce_min(x, *, axes=None, keepdims=False):
    return torch.amin(x, dim=_all_axes(x, axes), keepdim=keepdims)


def _reduce_prod(x, *, axes=None, keepdims=False):
    out = x if x.is_floating_point() else x.to(torch.int32)
    for a in sorted((d % max(x.ndim, 1) for d in _all_axes(x, axes)),
                    reverse=True):
        out = torch.prod(out, dim=a, keepdim=keepdims)
    return out


def _reduce_std(x, *, axes=None, keepdims=False):
    return torch.std(_float(x), dim=_all_axes(x, axes), unbiased=False,
                     keepdim=keepdims)


def _reduce_var(x, *, axes=None, keepdims=False):
    return torch.var(_float(x), dim=_all_axes(x, axes), unbiased=False,
                     keepdim=keepdims)


def _cumsum_flags(a, axis, exclusive, reverse):
    if reverse:
        a = torch.flip(a, dims=(axis,))
    out = torch.cumsum(a, dim=axis, dtype=_int_sum_dtype(a))
    if exclusive:
        out = out - a
    if reverse:
        out = torch.flip(out, dims=(axis,))
    return out


def _mmul(a, b, *, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.matmul(a, b)


def _transpose(a, *, axes=None):
    perm = (tuple(reversed(range(a.ndim))) if axes is None
            else tuple(int(p) for p in axes))
    return a.permute(perm)


def _expand_dims(a, *, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    rank = a.ndim + len(axes)
    for ax in sorted(int(x) % rank for x in axes):
        a = a.unsqueeze(ax)
    return a


def _squeeze(a, *, axis=None):
    if axis is None:
        return a.squeeze()
    return torch.squeeze(a, dim=axis if isinstance(axis, int)
                         else tuple(axis))


def _dynamic_slice(a, *, begin, size):
    # lax.dynamic_slice clamps each start so the slice stays in bounds
    for d, (b, s) in enumerate(zip(begin, size)):
        b = min(max(int(b), 0), a.shape[d] - int(s))
        a = a.narrow(d, b, int(s))
    return a


def _strided_slice(a, *, begin, end, strides=None):
    strides = strides or [1] * len(begin)
    for d, (b, e, s) in enumerate(zip(begin, end, strides)):
        idx = range(*slice(b, e, s).indices(a.shape[d]))
        if idx.step > 0:
            a = a.narrow(d, idx.start, len(idx)) if idx.step == 1 else \
                a[(slice(None),) * d + (slice(idx.start, idx.stop,
                                              idx.step),)]
        else:  # torch slicing takes no negative step
            rows = idx.start + idx.step * torch.arange(len(idx),
                                                       device=a.device)
            a = torch.index_select(a, d, rows)
    return a


def _gather(params, indices, *, axis=0):
    """``jnp.take(params, indices.astype(int32), axis)``: negative indices
    count from the end, out-of-range ones give NaN (0 for integers), as
    ``jnp.take``'s default fill mode."""
    axis = int(axis) % params.ndim
    n = params.shape[axis]
    idx = indices.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    flat = torch.clamp(idx, 0, max(n - 1, 0)).reshape(-1)
    if axis == 0 and params.ndim == 2 and params.is_floating_point():
        # a table's rows (an embedding): nn_ops.table_rows, whose gradient
        # has the same bits every run on the card, where index_select's
        # (index_add_) sums with atomics and F.embedding's sums a small
        # table's duplicate indices in an order that varies
        out = nn_ops.table_rows(params, flat)
    else:
        out = torch.index_select(params, axis, flat)
    out = out.reshape(params.shape[:axis] + idx.shape
                      + params.shape[axis + 1:])
    fill = float("nan") if params.is_floating_point() else 0
    keep = valid.reshape((1,) * axis + idx.shape
                         + (1,) * (params.ndim - axis - 1))
    return torch.where(keep, out, torch.full((), fill, dtype=out.dtype,
                                             device=out.device))


def _pad(a, *, paddings, value=0.0):
    if isinstance(paddings, int):
        paddings = [(paddings, paddings)] * a.ndim
    flat = []
    for lo, hi in reversed([tuple(p) for p in paddings]):
        flat += [int(lo), int(hi)]
    return F.pad(a, flat, value=value)


def _one_hot(a, *, depth):
    cls = torch.arange(int(depth), device=a.device)
    return (a.to(torch.int64)[..., None] == cls).to(torch.float32)


def _cast(a, *, dtype):
    from deeplearning4j_tpu_torch.analysis.values import as_dtype

    return a.to(canonical_dtype(as_dtype(dtype)))


def _cmp(fn):
    return lambda a, b: fn(a, b).to(torch.float32)


def _huber(pred, labels, delta):
    err = torch.abs(pred - labels)
    quad = torch.clamp_max(err, delta)
    return torch.mean(0.5 * quad ** 2 + delta * (err - quad))


GRAPH_OPS: Dict[str, Callable[..., Any]] = {
    # elementwise binary
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "pow": lambda a, b: a ** b,
    "floormod": torch.remainder,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "squared_difference": lambda a, b: (a - b) ** 2,
    # comparisons
    "gt": _cmp(torch.gt),
    "lt": _cmp(torch.lt),
    "gte": _cmp(torch.ge),
    "lte": _cmp(torch.le),
    "eq": _cmp(torch.eq),
    "neq": _cmp(torch.ne),
    # elementwise unary
    "neg": torch.neg,
    "abs": torch.abs,
    "exp": torch.exp,
    "log": torch.log,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "square": torch.square,
    "reciprocal": lambda a: 1.0 / a,
    "sign": torch.sign,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "round": torch.round,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "erf": torch.erf,
    "clip_by_value_graph": lambda a, *, min_value, max_value: torch.clamp(
        a, min_value, max_value),
    "cast": _cast,
    # activations
    "relu": torch.relu,
    "relu6": F.relu6,
    "leakyrelu": lambda a, *, alpha=0.01: F.leaky_relu(a, alpha),
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda a: F.gelu(a, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "swish": F.silu,
    "mish": F.mish,
    "hardsigmoid": F.hardsigmoid,
    "hardtanh": F.hardtanh,
    "softmax": lambda a, *, axis=-1: torch.softmax(a, dim=axis),
    "log_softmax": lambda a, *, axis=-1: torch.log_softmax(a, dim=axis),
    # linalg / shape
    "mmul": _mmul,
    "tensordot": lambda a, b, *, axes: torch.tensordot(a, b, dims=axes),
    "reshape": lambda a, *, shape: torch.reshape(a, tuple(shape)),
    "transpose": _transpose,
    "permute": lambda a, *, axes: a.permute(tuple(axes)),
    "expand_dims": _expand_dims,
    "squeeze": _squeeze,
    "concat": lambda *xs, axis=0: torch.cat(xs, dim=axis),
    "unstack_first": lambda x: x[0],
    "slice": _dynamic_slice,
    "strided_slice": _strided_slice,
    "gather": _gather,
    "tile": lambda a, *, reps: torch.tile(a, tuple(reps)),
    "pad": _pad,
    "size": lambda a: torch.full((), a.numel(), dtype=torch.int32,
                                 device=a.device),
    "one_hot_graph": _one_hot,
    "where": lambda c, a, b: torch.where(c.bool(), a, b),
    "select": lambda c, a, b: torch.where(c.bool(), a, b),
    # reductions
    "reduce_sum": _reduce_sum,
    "reduce_mean": _reduce_mean,
    "reduce_max": _reduce_max,
    "reduce_min": _reduce_min,
    "reduce_prod": _reduce_prod,
    "reduce_std": _reduce_std,
    "reduce_var": _reduce_var,
    "argmax": lambda a, *, axis=-1: torch.argmax(a, dim=axis).to(torch.int32),
    "argmin": lambda a, *, axis=-1: torch.argmin(a, dim=axis).to(torch.int32),
    "cumsum": lambda a, *, axis=0, exclusive=False, reverse=False:
        _cumsum_flags(a, axis, exclusive, reverse),
    "zeros_like": torch.zeros_like,
    "ones_like": torch.ones_like,
    "norm2": lambda a, *, axes=None: torch.sqrt(_reduce_sum(a ** 2,
                                                            axes=axes)),
    # nn composites
    "linear": lambda x, w, b=None: (x @ w + b) if b is not None else x @ w,
    "layer_norm_graph": lambda x, gain, bias=None, *, axis=-1, eps=1e-5:
        nn_ops.layer_norm.fn(x, gain, bias, axis=axis, eps=eps),
    "batch_norm_graph": lambda x, mean, var, gamma, beta, *, eps=1e-5:
        (x - mean) * torch.rsqrt(var + eps) * gamma + beta,
    "dropout_graph": lambda x, *, rate, seed=0: x,  # inference identity
    # losses (feed probabilities/logits per name, as the reference does)
    "softmax_cross_entropy": lambda logits, labels:
        loss_lib.softmax_cross_entropy_with_logits(logits, labels),
    "sparse_softmax_cross_entropy": lambda logits, ids:
        loss_lib.sparse_mcxent(logits, ids),
    "sigmoid_cross_entropy": lambda logits, labels:
        loss_lib.sigmoid_cross_entropy_with_logits(logits, labels),
    "mean_squared_error": lambda pred, labels: loss_lib.mse(pred, labels),
    "absolute_difference": lambda pred, labels: loss_lib.mae(pred, labels),
    "log_loss": lambda probs, labels: loss_lib.binary_xent(probs, labels),
    "huber_loss": lambda pred, labels, *, delta=1.0:
        _huber(pred, labels, delta),
    "cosine_distance": lambda a, b: loss_lib.cosine_proximity(a, b),
    # the JAX package resolves `identity` from its registry (the port's
    # registry has none) and its ONNX importer adds it here
    "identity": lambda a: a,
}


# Registry-shadowing whitelist, as the JAX package keeps it: resolution
# order is local -> GRAPH_OPS -> registry, so a GRAPH_OPS key that also
# names a registry op silently wins over the registry impl. Every
# intentional shadow is listed here.
REGISTRY_SHADOW_WHITELIST = frozenset(
    ["add", "abs", "acos", "asin", "atan", "ceil",
     "cos", "cosh", "erf", "exp", "floor", "floormod", "log", "log1p",
     "maximum", "minimum", "neg", "pow", "reciprocal", "round", "rsqrt",
     "sign", "sin", "sinh", "sqrt", "square", "tan", "tanh",
     "elu", "gelu", "mish", "relu6", "selu", "sigmoid", "softplus",
     "softsign", "swish"]
    + ["reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
       "reduce_prod", "argmax", "argmin", "cumsum"]
    + ["concat", "expand_dims", "gather", "pad", "permute", "reshape",
       "size", "slice", "squeeze", "strided_slice", "tile", "transpose",
       "zeros_like", "ones_like"]
    + ["where", "select"]
    + ["identity"]
)


def resolve_graph_op(name: str,
                     local_ops: Optional[Dict[str, Callable]] = None
                     ) -> Callable[..., Any]:
    """Resolve an op name: instance-local impls first, then the graph-op
    catalog, then the op registry.

    Registry ops WITH platform helpers resolve to the descriptor itself,
    so graph execution dispatches through ``OpDescriptor.resolve`` per
    call — this is how a fused ``dot_product_attention`` node lands on the
    flash kernel and a ``fused_matmul_bias_act`` node on the fused matmul
    kernel on the card. Helper-less ops return the raw impl."""
    if local_ops and name in local_ops:
        return local_ops[name]
    if name in GRAPH_OPS:
        return GRAPH_OPS[name]
    reg = op_registry()
    if name in reg:
        desc = reg.get(name)
        return desc if desc.platform_impls else desc.fn
    raise KeyError(f"unknown graph op '{name}'")


# ---------------------------------------------------------------------------
# Namespaced op factories (SDMath/SDNN analogs)
# ---------------------------------------------------------------------------


class _Namespace:
    def __init__(self, sd: "SameDiff"):
        self._sd = sd


class SDMath(_Namespace):
    def _u(self, op, x, **kw):
        return self._sd._record(op, [self._sd._lift(x)], kw)

    def abs(self, x):
        return self._u("abs", x)

    def exp(self, x):
        return self._u("exp", x)

    def log(self, x):
        return self._u("log", x)

    def sqrt(self, x):
        return self._u("sqrt", x)

    def square(self, x):
        return self._u("square", x)

    def sin(self, x):
        return self._u("sin", x)

    def cos(self, x):
        return self._u("cos", x)

    def tanh(self, x):
        return self._u("tanh", x)

    def erf(self, x):
        return self._u("erf", x)

    def sign(self, x):
        return self._u("sign", x)

    def floor(self, x):
        return self._u("floor", x)

    def neg(self, x):
        return self._u("neg", x)

    def max(self, a, b):
        return self._sd._record("maximum",
                                [self._sd._lift(a), self._sd._lift(b)])

    def min(self, a, b):
        return self._sd._record("minimum",
                                [self._sd._lift(a), self._sd._lift(b)])

    def clip_by_value(self, x, lo, hi):
        return self._sd._record("clip_by_value_graph", [self._sd._lift(x)],
                                {"min_value": lo, "max_value": hi})

    def cast(self, x, dtype):
        from deeplearning4j_tpu_torch.analysis.values import as_dtype

        return self._sd._record(
            "cast", [self._sd._lift(x)],
            {"dtype": str(as_dtype(dtype)).replace("torch.", "")})


class SDNN(_Namespace):
    def relu(self, x):
        return self._sd._record("relu", [x])

    def relu6(self, x):
        return self._sd._record("relu6", [x])

    def gelu(self, x):
        return self._sd._record("gelu", [x])

    def elu(self, x):
        return self._sd._record("elu", [x])

    def selu(self, x):
        return self._sd._record("selu", [x])

    def swish(self, x):
        return self._sd._record("swish", [x])

    def sigmoid(self, x):
        return self._sd._record("sigmoid", [x])

    def softplus(self, x):
        return self._sd._record("softplus", [x])

    def leaky_relu(self, x, alpha=0.01):
        return self._sd._record("leakyrelu", [x], {"alpha": alpha})

    def softmax(self, x, axis=-1):
        return self._sd._record("softmax", [x], {"axis": axis})

    def log_softmax(self, x, axis=-1):
        return self._sd._record("log_softmax", [x], {"axis": axis})

    def linear(self, x, w, b=None):
        ins = [x, w] + ([b] if b is not None else [])
        return self._sd._record("linear", ins)

    def layer_norm(self, x, gain, bias=None, axis=-1, eps=1e-5):
        ins = [x, gain] + ([bias] if bias is not None else [])
        return self._sd._record("layer_norm_graph", ins,
                                {"axis": axis, "eps": eps})

    def batch_norm(self, x, mean, var, gamma, beta, eps=1e-5):
        return self._sd._record("batch_norm_graph",
                                [x, mean, var, gamma, beta], {"eps": eps})

    def dropout(self, x, rate):
        return self._sd._record("dropout_graph", [x], {"rate": rate})

    def dot_product_attention(self, q, k, v):
        return self._sd._record("dot_product_attention", [q, k, v])


class SDLoss(_Namespace):
    """sd.loss — each method records the catalog loss op of its name: a
    scalar, the mean over examples."""

    def softmax_cross_entropy(self, logits, labels):
        return self._sd._record("softmax_cross_entropy", [logits, labels])

    def sparse_softmax_cross_entropy(self, logits, ids):
        return self._sd._record("sparse_softmax_cross_entropy", [logits, ids])

    def sigmoid_cross_entropy(self, logits, labels):
        return self._sd._record("sigmoid_cross_entropy", [logits, labels])

    def mean_squared_error(self, pred, labels):
        return self._sd._record("mean_squared_error", [pred, labels])

    def absolute_difference(self, pred, labels):
        return self._sd._record("absolute_difference", [pred, labels])

    def log_loss(self, probs, labels):
        return self._sd._record("log_loss", [probs, labels])

    def huber_loss(self, pred, labels, delta=1.0):
        return self._sd._record("huber_loss", [pred, labels],
                                {"delta": delta})

    def cosine_distance(self, a, b):
        return self._sd._record("cosine_distance", [a, b])


class TrainingConfig:
    """TrainingConfig.java analog: the updater (Adam by default, resolved
    through :func:`~deeplearning4j_tpu_torch.nn.updater.get_updater`), l1,
    l2 and weight decay, which placeholders a batch's features and labels
    feed, and the loss variables' names."""

    def __init__(self, updater=None, l1: float = 0.0, l2: float = 0.0,
                 weight_decay: float = 0.0,
                 data_set_feature_mapping: Optional[Sequence[str]] = None,
                 data_set_label_mapping: Optional[Sequence[str]] = None,
                 loss_variables: Optional[Sequence[str]] = None):
        from deeplearning4j_tpu_torch.nn.updater import Adam, get_updater

        self.updater = get_updater(updater) if updater is not None else Adam()
        self.l1 = l1
        self.l2 = l2
        self.weight_decay = weight_decay
        self.feature_mapping = list(data_set_feature_mapping or [])
        self.label_mapping = list(data_set_label_mapping or [])
        self.loss_variables = list(loss_variables or [])


class SameDiff:
    """The graph container + execution facade.

    ``optimize``: run the pre-run graph optimizer (:mod:`.optimize` — DCE,
    constant folding, CSE, algebraic cleanup, the fusion tier) before the
    first execution of an output set. ``optimize_passes``: subset of
    ``optimize.PASS_ORDER`` to enable (None = all of them).
    ``last_compile_stats``: :class:`~.optimize.OptimizeStats` of the plan
    most recently built or used (per-pass node deltas, fusion counts).
    ``device``: where arrays live (the card unless the caller passes
    ``"cpu"``). ``validate=True`` raises: graph checking is not ported.
    """

    def __init__(self, optimize: bool = True,
                 optimize_passes: Optional[Sequence[str]] = None,
                 validate: bool = False,
                 device: Union[str, torch.device, None] = None) -> None:
        if validate:
            raise NotImplementedError(VALIDATE_NOT_PORTED)
        self.device = resolve_device(device)
        self._vars: Dict[str, SDVariable] = {}
        self._arrays: Dict[str, torch.Tensor] = {}  # VARIABLE + CONSTANT
        self._nodes: List[_Node] = []
        # instance-local op impls; none are recorded yet (control flow is
        # not ported) but resolution keeps the JAX package's order
        self._local_ops: Dict[str, Callable[..., Any]] = {}
        self._name_counter = 0
        self.math = SDMath(self)
        self.nn = SDNN(self)
        self.loss = SDLoss(self)
        self.training_config: Optional[TrainingConfig] = None
        self._updater_state: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._step = 0
        # exact-resume bookkeeping: epochs completed across fit() calls and
        # completed batches of the current epoch
        self.epoch_count = 0
        self.batch_in_epoch = 0
        self._listeners: List[Any] = []
        self._jit_cache: Dict[Any, Any] = {}
        # graph IO signature, populated by the import layer (imports/ir.py)
        self.graph_inputs: List[str] = []
        self.graph_outputs: List[str] = []
        self.optimize = optimize
        self.optimize_passes = (tuple(optimize_passes)
                                if optimize_passes is not None else None)
        self.last_compile_stats = None
        # recompile-ledger wiring: the cause of the most recent cache
        # invalidation, applied by _note_compile to EVERY previously
        # compiled key rebuilt after it (keys never compiled before stay
        # "first_compile")
        self._pending_invalidate: Optional[str] = None
        self._ever_compiled: set = set()

    # ------------------------------------------------------------- factories
    @staticmethod
    def create(optimize: bool = True,
               optimize_passes: Optional[Sequence[str]] = None,
               validate: bool = False,
               device: Union[str, torch.device, None] = None) -> "SameDiff":
        return SameDiff(optimize=optimize, optimize_passes=optimize_passes,
                        validate=validate, device=device)

    def _fresh(self, prefix: str) -> str:
        self._name_counter += 1
        return f"{prefix}_{self._name_counter}"

    def placeholder(self, name: str, shape: Sequence[Optional[int]] = None,
                    dtype=torch.float32) -> SDVariable:
        from deeplearning4j_tpu_torch.analysis.values import as_dtype

        v = SDVariable(self, name, "PLACEHOLDER",
                       None if shape is None else
                       tuple(-1 if s is None else s for s in shape),
                       canonical_dtype(as_dtype(dtype)))
        self._vars[name] = v
        return v

    # reference alias
    place_holder = placeholder

    def var(self, name: str, array=None, shape: Sequence[int] = None,
            dtype=torch.float32, initializer: str = "xavier",
            generator: Optional[torch.Generator] = None) -> SDVariable:
        """Trainable variable — from an array, or from (shape, weight-init
        scheme) drawn from ``generator`` (seeded by the variable count
        when None; torch's stream, not the JAX package's)."""
        if array is None:
            from deeplearning4j_tpu_torch.analysis.values import as_dtype
            from deeplearning4j_tpu_torch.ops.weight_init import init_weights

            if shape is None:
                raise ValueError("var() needs an array or a shape")
            if generator is None:
                generator = torch.Generator().manual_seed(len(self._vars))
            array = init_weights(generator, tuple(shape), initializer,
                                 dtype=as_dtype(dtype))
        arr = canonical(array, self.device)
        v = SDVariable(self, name, "VARIABLE", tuple(arr.shape), arr.dtype)
        self._vars[name] = v
        self._arrays[name] = arr
        return v

    def constant(self, name_or_value, value=None) -> SDVariable:
        if value is None:
            name, value = self._fresh("const"), name_or_value
        else:
            name = name_or_value
        arr = canonical(value, self.device)
        v = SDVariable(self, name, "CONSTANT", tuple(arr.shape), arr.dtype)
        self._vars[name] = v
        self._arrays[name] = arr
        return v

    def op(self, name: str, *inputs, **kwargs) -> SDVariable:
        """Record any catalog or registry op by name (the
        Nd4j.exec(DynamicCustomOp) parity surface). Multi-output ops take
        ``n_out`` and return a tuple. Unknown names raise at graph build,
        not at execution."""
        n_out = int(kwargs.pop("n_out", 1))
        resolve_graph_op(name, self._local_ops)  # existence check
        ins = [self._lift(x) for x in inputs]
        return self._record(name, ins, kwargs or None, n_out=n_out)

    def _lift(self, x) -> SDVariable:
        if isinstance(x, SDVariable):
            return x
        return self.constant(x)

    def _rename(self, old: str, new: str) -> None:
        if new in self._vars:
            raise ValueError(f"variable '{new}' already exists")
        v = self._vars.pop(old)
        v.name = new
        self._vars[new] = v
        if old in self._arrays:
            self._arrays[new] = self._arrays.pop(old)
        for n in self._nodes:
            n.inputs = [new if i == old else i for i in n.inputs]
            n.outputs = [new if o == old else o for o in n.outputs]
        # renaming is a graph mutation: cached plans hold node-name snapshots
        self._invalidate("graph_mutation")

    def _invalidate(self, cause: str) -> None:
        """Drop every cached plan, runner and captured graph (with its
        memory pool), remembering WHY — the recompile ledger tags rebuilt
        keys with this cause (graph_mutation / constant_rebind /
        variable_rebind). A clear while the cache is empty AND no cause is
        pending (graph still being built, nothing ever compiled) is not an
        invalidation; an empty cache WITH a pending cause means we are
        between invalidation and recompile, where a second invalidation
        updates the cause to the latest one."""
        from deeplearning4j_tpu_torch.autodiff.optimize import CompiledGraph

        if self._jit_cache or self._pending_invalidate is not None:
            self._pending_invalidate = cause
        from deeplearning4j_tpu_torch.nn.compiled import TrainUnits

        for fn in self._jit_cache.values():
            if isinstance(fn, (CompiledGraph, TrainUnits)):
                fn.reset()
        self._jit_cache.clear()

    def _note_compile(self, fn, kind: str, signature: str,
                      stable_key: Any = None) -> None:
        """Report a compile to the recompile ledger iff this (unit, input
        signature) pair has not run before (``observe.note_jit_signature``:
        the seen-signature set lives ON the cached unit, so every
        ``_jit_cache`` invalidation drops the history with it).
        ``stable_key`` mirrors the ``_jit_cache`` key and survives
        invalidation in ``_ever_compiled``: a key compiled before that
        shows up as a fresh unit was REBUILT and reports the pending
        invalidation cause; a key never compiled before reports
        first_compile; a cached unit seeing a new signature reports
        new_shape (a new capture)."""
        from deeplearning4j_tpu_torch import observe

        ident = (kind, stable_key)
        rebuilt = ident in self._ever_compiled
        pend = (self._pending_invalidate if rebuilt else None) \
            or "first_compile"
        cause = observe.note_jit_signature(
            fn, graph="samediff", key=kind, signature=signature,
            stats=self.last_compile_stats, cause_if_new_fn=pend)
        if cause is not None:
            self._ever_compiled.add(ident)

    # -------------------------------------------------------------- recording
    def _record(self, op: str, inputs: List[SDVariable],
                kwargs: Optional[Dict[str, Any]] = None, n_out: int = 1):
        resolve_graph_op(op, self._local_ops)  # fail fast on unknown op
        out_names = [self._fresh(op) for _ in range(n_out)]
        self._nodes.append(_Node(op, [v.name for v in inputs],
                                 dict(kwargs or {}), out_names))
        outs = []
        for n in out_names:
            v = SDVariable(self, n, "ARRAY")
            self._vars[n] = v
            outs.append(v)
        self._invalidate("graph_mutation")
        return outs[0] if n_out == 1 else tuple(outs)

    # -------------------------------------------------------------- execution
    def _needed_nodes(self, wanted: Sequence[str]) -> List[_Node]:
        """Ancestor subgraph of the wanted outputs."""
        needed: set = set(wanted)
        keep: List[_Node] = []
        for node in reversed(self._nodes):
            if any(o in needed for o in node.outputs):
                keep.append(node)
                needed.update(node.inputs)
        keep.reverse()
        return keep

    def _precision_policy(self) -> str:
        """Dtype policy the graph's float arrays imply — float32 graphs run
        full float32 products (no TF32, ``nn.dtype.precision_scope``)."""
        for a in self._arrays.values():
            if a.dtype in (torch.bfloat16, torch.float16):
                return "bfloat16"
        return "float32"

    def _input_avals(self):
        """Declared placeholder metadata as symbolic avals — the optimizer's
        pass-invariance checker unifies named batch dims through them."""
        from deeplearning4j_tpu_torch.analysis import AVal

        return {n: AVal.of_placeholder(n, v.shape, v.dtype)
                for n, v in self._vars.items() if v.vtype == "PLACEHOLDER"}

    def _effective_passes(self) -> Optional[Tuple[str, ...]]:
        """The pass tuple a plan runs: the explicit ``optimize_passes`` or
        the whole pipeline; None when the optimizer is off."""
        if not self.optimize:
            return None
        if self.optimize_passes is not None:
            return self.optimize_passes
        from deeplearning4j_tpu_torch.autodiff import optimize as _opt

        return _opt.PASS_ORDER

    def _graph_plan(self, out_names: Tuple[str, ...]):
        """Optimized execution plan for the given outputs, or None when the
        optimizer is off; cached until the graph or a constant changes."""
        if not self.optimize:
            return None
        from deeplearning4j_tpu_torch.autodiff import optimize as _opt

        cache_key = ("plan", out_names, self._effective_passes())
        plan = self._jit_cache.get(cache_key)
        if plan is None:
            # shape/dtype evidence for algebraic strips comes ONLY from
            # bound arrays (VARIABLE + CONSTANT): declared PLACEHOLDER
            # metadata is not enforced at feed time
            seed_dtypes = {n: a.dtype for n, a in self._arrays.items()}
            var_shapes = {n: tuple(a.shape) for n, a in self._arrays.items()}
            plan = _opt.optimize_graph(
                self._needed_nodes(out_names), list(out_names),
                const_env=self._const_env(),
                seed_dtypes=seed_dtypes,
                var_shapes=var_shapes,
                local_ops=self._local_ops,
                resolve_op=lambda name: resolve_graph_op(name,
                                                         self._local_ops),
                passes=self._effective_passes(),
                precision_policy=self._precision_policy(),
                input_avals=self._input_avals())
            self._jit_cache[cache_key] = plan
        self.last_compile_stats = plan.stats
        return plan

    def _interpret(self, env: Dict[str, Any], wanted: Sequence[str],
                   plan=None, last_use: Optional[Dict[str, int]] = None
                   ) -> Dict[str, Any]:
        """Run the needed subgraph in order. With a ``plan`` the optimized
        node list runs instead and wanted names resolve through its alias
        map; the caller has merged ``plan.extra_consts`` into ``env``.
        ``last_use`` (name -> index of the last node reading it) lets a
        node output go as soon as its last consumer has run."""
        from deeplearning4j_tpu_torch.nn import dtype as DT

        nodes = plan.nodes if plan is not None else self._needed_nodes(wanted)
        with DT.precision_scope(self._precision_policy()):
            for idx, node in enumerate(nodes):
                if not all(i in env for i in node.inputs):
                    missing = [i for i in node.inputs if i not in env]
                    raise KeyError(
                        f"op '{node.op}' needs {missing}; placeholders not "
                        f"fed or graph out of order")
                fn = resolve_graph_op(node.op, self._local_ops)
                res = fn(*[env[i] for i in node.inputs], **node.kwargs)
                if len(node.outputs) == 1:
                    env[node.outputs[0]] = res
                else:
                    for o, r in zip(node.outputs, res):
                        env[o] = r
                if last_use is not None:
                    for name in set(node.inputs):
                        if last_use.get(name) == idx:
                            del env[name]
        if plan is not None:
            return {w: env[plan.resolve(w)] for w in wanted}
        return {w: env[w] for w in wanted}

    def _exec_fn(self, out_names: Tuple[str, ...]):
        """Build + cache the eager runner for the given outputs: a plain
        callable ``(var_arrays, feeds) -> outputs`` over the plan (or the
        reachable recording when the optimizer is off), with the constants
        — the graph's and the plan's folded ones — bound in. Gradients and
        ``fit`` run it eagerly; ``output`` runs it through
        :meth:`_compiled_fn`."""
        cache_key = ("exec", out_names, bool(self.optimize),
                     self._effective_passes())
        cached = self._jit_cache.get(cache_key)
        if cached is None:
            plan = self._graph_plan(out_names)
            const_env = self._const_env()
            if plan is not None:
                const_env = {**const_env, **plan.extra_consts}
                nodes = plan.nodes
                keep = {plan.resolve(w) for w in out_names}
            else:
                nodes = self._needed_nodes(out_names)
                keep = set(out_names)
            produced = {o for n in nodes for o in n.outputs}
            last_use = {name: idx for idx, n in enumerate(nodes)
                        for name in n.inputs
                        if name in produced and name not in keep}

            def run(var_arrays, feeds):
                env = dict(const_env)
                env.update(var_arrays)
                env.update(feeds)
                return self._interpret(env, out_names, plan, last_use)

            from deeplearning4j_tpu_torch.autodiff.optimize import (
                OptimizeStats)

            cached = (run, frozenset(const_env),
                      plan.stats if plan is not None else OptimizeStats())
            self._jit_cache[cache_key] = cached
        run, const_names, self.last_compile_stats = cached
        return run, const_names

    def _compiled_fn(self, out_names: Tuple[str, ...]):
        """The :class:`~.optimize.CompiledGraph` of the eager runner for the
        given outputs — the reference's ``CompiledGraph(jax.jit(run))``:
        captured once per feed signature on the card. Cached beside the
        runner, so every invalidation drops it with its graphs."""
        from deeplearning4j_tpu_torch.autodiff.optimize import CompiledGraph

        cache_key = ("compiled", out_names, bool(self.optimize),
                     self._effective_passes())
        fn = self._jit_cache.get(cache_key)
        run, const_names = self._exec_fn(out_names)
        if fn is None:
            fn = CompiledGraph(run, self.last_compile_stats,
                               device=self.device)
            fn._const_names = const_names
            self._jit_cache[cache_key] = fn
        self.last_compile_stats = fn.stats
        return fn

    def _var_arrays(self, const_names):
        return {k: v for k, v in self._arrays.items()
                if k not in const_names}

    def _const_env(self) -> Dict[str, Any]:
        """CONSTANT-vtype arrays (fold inputs, bound into every run)."""
        return {n: a for n, a in self._arrays.items()
                if self._vars[n].vtype == "CONSTANT"}

    def output(self, feeds: Dict[str, Any],
               outputs: Union[str, Sequence[str]]) -> Dict[str, np.ndarray]:
        """Execute the graph (InferenceSession.output analog): ONE compiled
        unit — on the card a CUDA-graph capture per feed signature,
        replayed after (``ops/capture.py``); the feeds are canonicalized
        onto the graph's device and the requested outputs come back as
        numpy arrays. Each compile is reported to the recompile ledger
        (graph ``"samediff"``, key ``"exec"``)."""
        if isinstance(outputs, str):
            outputs = [outputs]
        fn = self._compiled_fn(tuple(outputs))
        from deeplearning4j_tpu_torch.observe import signature_of

        self._note_compile(fn, "exec", signature_of(**feeds),
                           stable_key=(tuple(outputs), bool(self.optimize),
                                       self.optimize_passes))
        res = fn(self._var_arrays(fn._const_names),
                 {k: canonical(v, self.device) for k, v in feeds.items()})
        return {k: _to_numpy(v) for k, v in res.items()}

    exec = output  # reference SameDiff.exec alias

    # --------------------------------------------------------------- autodiff
    def create_grad_function(self) -> None:
        """API-parity no-op: the reference builds the grad subgraph
        eagerly; here autograd derives gradients at execution time."""

    def _trainable(self) -> List[str]:
        return [n for n, v in self._vars.items() if v.vtype == "VARIABLE"]

    def _loss_and_grads(self, loss_name: str, wrt: Sequence[str],
                        feeds: Dict[str, torch.Tensor]):
        """(loss, {name: gradient}) of the scalar ``loss_name`` through the
        plan ``output`` runs for it, the leaves ``wrt`` requiring grad. A
        leaf the loss never reads gets zeros, as ``jax.grad`` gives."""
        from deeplearning4j_tpu_torch.nn import dtype as DT

        run, const_names = self._exec_fn((loss_name,))
        arrays = self._var_arrays(const_names)
        leaves = [arrays[n].detach().requires_grad_(True) for n in wrt]
        arrays.update(zip(wrt, leaves))
        with torch.enable_grad(), DT.precision_scope(self._precision_policy()):
            loss = run(arrays, feeds)[loss_name]
            grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
                     if loss.requires_grad else [None] * len(leaves))
        return loss.detach(), {
            n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(wrt, leaves, grads)}

    def _train_units(self, kind: str, loss_name: str, extra=()):
        """The compiled-step holder (``nn/compiled.py``) of a ``kind``
        (``train`` / ``grad``) unit for ``loss_name``, cached in
        ``_jit_cache`` under the JAX package's key (the loss, the
        optimizer switch and its passes): every invalidation drops it with
        its graphs. Returns (units, key)."""
        from deeplearning4j_tpu_torch.nn.compiled import TrainUnits

        key = (kind, loss_name, *extra, bool(self.optimize),
               self._effective_passes())
        units = self._jit_cache.get(key)
        if units is None:
            units = TrainUnits(self.device, "samediff")
            self._jit_cache[key] = units
        return units, key

    def calculate_gradients(self, feeds: Dict[str, Any], loss_name: str,
                            wrt: Optional[Sequence[str]] = None
                            ) -> Dict[str, np.ndarray]:
        """Gradients of a scalar loss variable w.r.t. VARIABLEs (all of
        them unless ``wrt`` names some), as numpy arrays
        (sd.calculateGradients analog): the training unit ``grad`` —
        captured per feed signature on the card, eager on the CPU."""
        from deeplearning4j_tpu_torch.observe import signature_of

        wrt = list(wrt) if wrt is not None else self._trainable()
        feeds = {k: canonical(v, self.device) for k, v in feeds.items()}
        units, key = self._train_units("grad", loss_name, (tuple(wrt),))
        names = tuple(sorted(feeds))
        _, const_names = self._exec_fn((loss_name,))

        def body(*tensors):
            return self._loss_and_grads(loss_name, wrt,
                                        dict(zip(names, tensors)))[1]

        grads = units.run(
            "grad", body, [feeds[k] for k in names], layout=names,
            reads=list(self._var_arrays(const_names).values()),
            copy_out=False, note=lambda unit: self._note_compile(
                unit, "grad", signature_of(**feeds), stable_key=key))
        return {k: _to_numpy(g) for k, g in grads.items()}

    # --------------------------------------------------------------- training
    def set_training_config(self, tc: TrainingConfig) -> None:
        self.training_config = tc

    def _init_updater_state(self) -> None:
        if self._updater_state is None and self.training_config is not None:
            upd = self.training_config.updater
            self._updater_state = {n: upd.init_state(self._arrays[n])
                                   for n in self._trainable()}

    def training_state(self) -> Dict[str, Any]:
        """Full training state for exact resume: trainable VARIABLE
        arrays, updater slots, step/epoch position and the data cursor.
        Initializes the updater state if fit has not run yet, so a restore
        before the first fit still finds a matching tree."""
        self._init_updater_state()
        return {
            "params": {n: self._arrays[n] for n in self._trainable()},
            "opt_state": self._updater_state
            if self._updater_state is not None else {},
            "iteration": np.asarray(self._step),
            "epoch": np.asarray(self.epoch_count),
            "data_cursor": np.asarray(self.batch_in_epoch),
        }

    def apply_training_state(self, state: Dict[str, Any]) -> None:
        """Inverse of :meth:`training_state`. Arrays may be tensors or
        numpy arrays — the JAX package's ``training_state()`` converted
        with ``np.asarray`` carries a run across. Each array is copied into
        the tensor already in its place (same shape and dtype), so a
        captured training step keeps its buffers (no ``new_shape``)."""
        from deeplearning4j_tpu_torch.nn.compiled import commit

        for n, a in state["params"].items():
            self._arrays[n] = commit(self._arrays.get(n),
                                     canonical(a, self.device))
        opt = state.get("opt_state") or {}
        if opt:
            self._updater_state = commit(self._updater_state, {
                n: {k: canonical(a, self.device) for k, a in s.items()}
                for n, s in opt.items()})
        self._step = int(state["iteration"])
        self.epoch_count = int(state["epoch"])
        self.batch_in_epoch = int(state.get("data_cursor", 0))

    def _train_body(self, loss_name: str, trainable: Sequence[str],
                    feeds: Dict[str, torch.Tensor], step: torch.Tensor
                    ) -> torch.Tensor:
        """The step's body: loss and gradients through the plan, then per
        leaf the l2 and l1 terms, the updater's fused step and weight decay
        (of the weight before the step), in the JAX package's order, at
        the device iteration ``step``, which it then advances. On the card
        the arrays and the updater state are written in place. Returns the
        loss (a device scalar)."""
        from deeplearning4j_tpu_torch.nn.compiled import donates

        tc = self.training_config
        upd = tc.updater
        donate = donates(self.device)
        loss, grads = self._loss_and_grads(loss_name, trainable, feeds)
        lr = upd.lr(step)
        with torch.no_grad():
            names = list(grads)
            ws = [self._arrays[n] for n in names]
            gs = []
            for w, g in zip(ws, grads.values()):
                if tc.l2:
                    g = g + tc.l2 * w
                if tc.l1:
                    g = g + tc.l1 * torch.sign(w)
                gs.append(g)
            # weight decay reads the weight before the step: taken now,
            # before an in-place step overwrites it
            decay = ([lr * tc.weight_decay * w for w in ws]
                     if tc.weight_decay else None)
            # fused updater step (ops/cuda_updater.py): one multi-tensor
            # launch over every leaf on the card, the identical apply()
            # math elsewhere
            new_ws, new_ss = upd.apply_fused_many(
                ws, gs, [self._updater_state[n] for n in names], lr, step,
                inplace=donate)
            for i, (n, w, nw, ns) in enumerate(zip(names, ws, new_ws,
                                                   new_ss)):
                if donate:
                    if decay is not None:
                        w.sub_(decay[i])
                    continue
                if decay is not None:
                    nw = nw - decay[i]
                self._arrays[n] = nw.to(w.dtype)
                self._updater_state[n] = ns
            step.add_(1)
        return loss

    def _train_step(self, loss_name: str, trainable: Sequence[str],
                    feeds: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One step as the training unit ``train`` (cached per loss, the
        optimizer's passes and, through the capture, the feed signature,
        as the JAX ``step_key``): captured on the card, eager on the CPU.
        Returns the loss (a device scalar)."""
        from deeplearning4j_tpu_torch.nn.compiled import tensors_of
        from deeplearning4j_tpu_torch.observe import signature_of

        units, key = self._train_units("train", loss_name)
        step = units.iteration.at(self._step)
        names = tuple(sorted(feeds))
        _, const_names = self._exec_fn((loss_name,))
        trained = set(trainable)
        loss = units.run(
            "train", lambda *t: self._train_body(loss_name, trainable,
                                                 dict(zip(names, t)), step),
            [feeds[k] for k in names], layout=(names, tuple(trainable)),
            state=tensors_of([self._arrays[n] for n in trainable],
                             self._updater_state) + [step],
            reads=[a for n, a in self._var_arrays(const_names).items()
                   if n not in trained],
            note=lambda unit: self._note_compile(
                unit, "train", signature_of(**feeds), stable_key=key))
        units.iteration.advanced()
        return loss

    def fit(self, iterator, epochs: int = 1,
            loss_name: Optional[str] = None) -> List[float]:
        """sd.fit(DataSetIterator, nEpochs) — TrainingSession analog.

        Each batch's features and labels bind to placeholders through the
        TrainingConfig mappings (a list or tuple of arrays feeds one
        placeholder each). Returns per-epoch mean losses (History
        analog)."""
        tc = self.training_config
        if tc is None:
            raise ValueError("call set_training_config first")
        loss_name = loss_name or (tc.loss_variables[0]
                                  if tc.loss_variables else None)
        if loss_name is None:
            raise ValueError("no loss variable configured")
        trainable = self._trainable()
        self._init_updater_state()

        from deeplearning4j_tpu_torch import faults, observe
        from deeplearning4j_tpu_torch.datasets.dataset import (
            DataSet, ListDataSetIterator)
        from deeplearning4j_tpu_torch.nn.listeners import (
            notify_fit_done, notify_preemption)

        if isinstance(iterator, DataSet):
            iterator = ListDataSetIterator(iterator, batch_size=32)
        m = observe.metrics()
        steps_c = m.counter("dl4j_tpu_train_steps_total", model="samediff")
        ex_c = m.counter("dl4j_tpu_train_examples_total", model="samediff")
        xfer_c = m.counter("dl4j_tpu_host_to_device_transfers_total",
                           model="samediff")
        step_h = m.histogram("dl4j_tpu_train_step_seconds", model="samediff")
        history = []
        for ep in range(epochs):
            losses = []
            t_prev = time.perf_counter()
            # nonzero only when resuming mid-epoch: the first `skip`
            # batches were already consumed by the interrupted run
            skip = self.batch_in_epoch
            for bi, ds in enumerate(iterator):
                if bi < skip:
                    continue
                # the hard kill (raises, for a supervisor to resume) and
                # the graceful SIGTERM path (final snapshot, return)
                faults.maybe_fail("preemption")
                if faults.preemption_requested():
                    notify_preemption(self, self._listeners)
                    return history
                feats = (ds.features if isinstance(ds.features, (list, tuple))
                         else [ds.features])
                labs = (ds.labels if isinstance(ds.labels, (list, tuple))
                        else [ds.labels])
                feeds = {name: canonical(arr, self.device) for name, arr in
                         zip(tc.feature_mapping, feats)}
                feeds.update((name, canonical(arr, self.device)) for name, arr
                             in zip(tc.label_mapping, labs))
                loss = self._train_step(loss_name, trainable, feeds)
                self._step += 1
                self.batch_in_epoch = bi + 1  # cursor before listeners run
                losses.append(loss)
                # inter-step host time: steps are not synchronized, so this
                # is the enqueue rate until the device's queue fills
                now = time.perf_counter()
                step_h.observe(now - t_prev)
                t_prev = now
                steps_c.inc()
                ex_c.inc(ds.num_examples())
                xfer_c.inc(len(feeds))
                for lst in self._listeners:
                    lst.iteration_done(self, self._step, ep, loss)
            self.batch_in_epoch = 0
            self.epoch_count += 1
            # the global epoch count: a resumed fit's `ep` restarts at 0
            if losses:  # one device read per epoch
                ep_loss = float(torch.stack(losses).float().mean())
                history.append(ep_loss)
                observe.log_event("train_epoch", model="samediff",
                                  epoch=self.epoch_count, steps=len(losses),
                                  mean_loss=ep_loss)
            else:
                observe.log_event("train_epoch", model="samediff",
                                  epoch=self.epoch_count, steps=0)
        notify_fit_done(self, self._listeners)
        return history

    # --------------------------------------------------------------- listeners
    def set_listeners(self, *listeners) -> None:
        """SameDiff listener family (``autodiff/listeners.py``): listeners
        receive ``iteration_done(self, iteration, epoch, loss)`` during
        fit(), the loss a device scalar, and ``fit_done(self)`` after
        it."""
        self._listeners = list(listeners)

    # ------------------------------------------------------------------ misc
    def variables(self) -> List[str]:
        return list(self._vars)

    def get_variable(self, name: str) -> SDVariable:
        return self._vars[name]

    def get_arr(self, name: str) -> np.ndarray:
        return _to_numpy(self._arrays[name])

    def set_arr(self, name: str, value) -> None:
        if name not in self._vars:
            raise KeyError(name)
        old = self._arrays.get(name)
        arr = canonical(value, self.device)
        self._arrays[name] = arr
        # keep the variable's declared metadata in sync — optimizer plans
        # read it, and a stale declared shape would survive the clear below
        self._vars[name].shape = tuple(arr.shape)
        self._vars[name].dtype = arr.dtype
        if self._vars[name].vtype == "CONSTANT":
            # constants are bound into cached runners AND folded into
            # plans: changing one invalidates every cached plan
            self._invalidate("constant_rebind")
        elif old is None or old.dtype != arr.dtype or old.shape != arr.shape:
            # a VARIABLE changing dtype/shape invalidates plans (their
            # dtype-guarded identity strips read it)
            self._invalidate("variable_rebind")

    def summary(self) -> str:
        lines = [f"SameDiff: {len(self._vars)} variables, "
                 f"{len(self._nodes)} ops"]
        for n in self._nodes:
            lines.append(f"  {','.join(n.outputs)} = {n.op}"
                         f"({','.join(n.inputs)})")
        return "\n".join(lines)
