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
* Ported: the construction API, the ``math``, ``nn``, ``cnn``, ``rnn``,
  ``loss``, ``image``, ``linalg``, ``bitwise`` and ``random`` namespaces
  (the JAX package's method names and arguments; a ``random`` draw seeds
  a generator on the graph's device at every run), the graph-op catalog,
  ``output``/``exec``, ``calculate_gradients``, ``TrainingConfig``/``fit``
  with the training state and listeners, ``get_arr``/``set_arr``,
  ``variables`` and ``summary``; ``fit`` polls the preemption fault point
  and flag once a batch, keeps the data cursor and logs the
  ``train_epoch`` event. Not yet: serde and graph checking (``check``;
  ``validate=True`` raises) (ROADMAP.md, Queue 1 item 11).
* Control flow (``scan``, ``while_loop``, ``while_loop_multi``,
  ``scan_multi``, ``cond_multi``, ``cond``: the JAX package's signatures,
  the user's functions built from torch ops). A scan runs its fixed trip
  count with no host read, so its graph is captured like any other. A
  while loop or a conditional reads its predicate on the host and runs
  only what it picks (``lax.cond`` traces both branches); a graph holding
  one runs eagerly by rule — ``output``, ``calculate_gradients`` and
  ``fit`` record the routing once per signature in the ledger and count
  each call in ``dl4j_tpu_capture_skipped_total{unit,reason}``
  (``nn.compiled.CONTROL_FLOW``), as the masked LSTM step is routed.
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
from deeplearning4j_tpu_torch.ops import reductions as R
from deeplearning4j_tpu_torch.ops import shape_ops
from deeplearning4j_tpu_torch.ops import transforms as T
from deeplearning4j_tpu_torch.ops.transforms import inexact
from deeplearning4j_tpu_torch.ops.validation import takes_device
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


def _over_axes(fn):
    """A registry reduction (``fn(x, axis, keepdims)``) under the graph
    ops' keywords: ``axes`` (None or empty: every axis), ``keepdims``."""
    return lambda x, *, axes=None, keepdims=False: fn(
        x, tuple(axes) if axes else None, keepdims)


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


# ``jnp.take(params, indices.astype(int32), axis)`` in its fill mode
_gather = nn_ops.take


def _pad(a, *, paddings, value=0.0):
    if isinstance(paddings, int):
        paddings = [(paddings, paddings)] * a.ndim
    flat = []
    for lo, hi in reversed([tuple(p) for p in paddings]):
        flat += [int(lo), int(hi)]
    return F.pad(a, flat, value=value)


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
    # (jax.nn's: integer and bool inputs promote to float32)
    "relu6": T.registry_fn("relu6"),
    "leakyrelu": lambda a, *, alpha=0.01: F.leaky_relu(inexact(a), alpha),
    "elu": T.registry_fn("elu"),
    "selu": T.registry_fn("selu"),
    "gelu": lambda a: F.gelu(inexact(a), approximate="tanh"),
    "sigmoid": T.registry_fn("sigmoid"),
    "softplus": T.registry_fn("softplus"),
    "softsign": T.registry_fn("softsign"),
    "swish": T.registry_fn("swish"),
    "mish": T.registry_fn("mish"),
    "hardsigmoid": T.registry_fn("hard_sigmoid"),
    "hardtanh": T.registry_fn("hard_tanh"),
    "softmax": lambda a, *, axis=-1: torch.softmax(inexact(a), dim=axis),
    "log_softmax": lambda a, *, axis=-1: torch.log_softmax(inexact(a),
                                                           dim=axis),
    # linalg / shape
    "mmul": nn_ops.matmul.fn,
    "tensordot": lambda a, b, *, axes: torch.tensordot(a, b, dims=axes),
    "reshape": lambda a, *, shape: torch.reshape(a, tuple(shape)),
    "transpose": _transpose,
    "permute": lambda a, *, axes: a.permute(tuple(axes)),
    "expand_dims": _expand_dims,
    "squeeze": _squeeze,
    "concat": lambda *xs, axis=0: torch.cat(xs, dim=axis),
    "unstack_first": lambda x: x[0],
    "slice": shape_ops.slice_op.fn,
    "strided_slice": shape_ops.strided_slice.fn,
    "gather": _gather,
    "tile": lambda a, *, reps: torch.tile(a, tuple(reps)),
    "pad": _pad,
    "size": lambda a: torch.full((), a.numel(), dtype=torch.int32,
                                 device=a.device),
    "one_hot_graph": lambda a, *, depth: nn_ops.one_hot.fn(a, depth=depth),
    "where": lambda c, a, b: torch.where(c.bool(), a, b),
    "select": lambda c, a, b: torch.where(c.bool(), a, b),
    # reductions
    "reduce_sum": _over_axes(R.sum_),
    "reduce_mean": _over_axes(R.mean_),
    "reduce_max": _over_axes(R.amax_),
    "reduce_min": _over_axes(R.amin_),
    "reduce_prod": _over_axes(R.prod_),
    "reduce_std": _over_axes(R.std_),
    "reduce_var": _over_axes(R.var_),
    "argmax": lambda a, *, axis=-1: torch.argmax(a, dim=axis).to(torch.int32),
    "argmin": lambda a, *, axis=-1: torch.argmin(a, dim=axis).to(torch.int32),
    "cumsum": R.cumsum.fn,
    "zeros_like": torch.zeros_like,
    "ones_like": torch.ones_like,
    "norm2": lambda a, *, axes=None: torch.sqrt(_over_axes(R.sum_)(
        a ** 2, axes=axes)),
    # nn composites
    "linear": lambda x, w, b=None: (x @ w + b) if b is not None else x @ w,
    "layer_norm_graph": lambda x, gain, bias=None, *, axis=-1, eps=1e-5:
        nn_ops.layer_norm.fn(inexact(x), gain, bias, axis=axis, eps=eps),
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
    "mean_squared_error": lambda pred, labels: loss_lib.mse(
        inexact(pred), inexact(labels)),
    "absolute_difference": lambda pred, labels: loss_lib.mae(
        inexact(pred), inexact(labels)),
    "log_loss": lambda probs, labels: loss_lib.binary_xent(probs, labels),
    "huber_loss": lambda pred, labels, *, delta=1.0:
        _huber(pred, labels, delta),
    "cosine_distance": lambda a, b: loss_lib.cosine_proximity(
        inexact(a), inexact(b)),
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
# Control flow: the bodies of the recorded scan / while / cond ops
# ---------------------------------------------------------------------------


def _reads_host(fn):
    """Mark a control-flow op that reads a predicate on the host: a graph
    that runs it is routed to eager (``SameDiff._routing``)."""
    fn.reads_host = True
    return fn


def _predicate(p) -> bool:
    """A scalar predicate read on the host (nonzero is true, as
    ``astype(bool).reshape(())`` reads it)."""
    t = p if isinstance(p, torch.Tensor) else torch.as_tensor(p)
    return bool(t.reshape(()).bool())


def _tree_on(v, device):
    """A carry's initial value (a tree of tensors, arrays or scalars) as
    canonical tensors on ``device``."""
    if isinstance(v, (tuple, list)):
        return type(v)(_tree_on(x, device) for x in v)
    return canonical(v, device)


def _stack(ys):
    """Stack the per-trip outputs (tensors, tuples of them, or None)."""
    if ys[0] is None:
        return None
    if isinstance(ys[0], (tuple, list)):
        return tuple(torch.stack([torch.as_tensor(y[k]) for y in ys])
                     for k in range(len(ys[0])))
    return torch.stack([torch.as_tensor(y) for y in ys])


def _empty_stack(y):
    """The stack of no trip, shaped by one trip's outputs ``y``."""
    if y is None:
        return None
    if isinstance(y, (tuple, list)):
        return tuple(t.new_zeros((0,) + tuple(t.shape)) for t in y)
    return y.new_zeros((0,) + tuple(y.shape))


def _scan_loop(fn, init, xs: Sequence[torch.Tensor], trips: int,
               single_x: bool = False):
    """``lax.scan(fn, init, xs, length=trips)``: ``trips`` calls of
    ``fn(carry, x_slice)`` (the bare slice with ``single_x``, else a tuple
    of slices, None without xs), the per-trip outputs stacked on a new
    axis 0. A fixed trip count: no host read."""
    def slices(i):
        if single_x:
            return xs[0][i]
        return tuple(t[i] for t in xs) if xs else None

    carry, ys = init, []
    for i in range(trips):
        carry, y = fn(carry, slices(i))
        ys.append(y)
    if ys:
        return carry, _stack(ys)
    # no trip: one call on zero slices shapes the empty stacks
    zero = [t.new_zeros(tuple(t.shape[1:])) for t in xs]
    _, y0 = fn(init, zero[0] if single_x else (tuple(zero) if xs else None))
    return carry, _empty_stack(y0)


def _while(cond_fn, body_fn, carry: Tuple[torch.Tensor, ...]):
    """``lax.while_loop`` over a tuple carry: the predicate read on the
    host before every trip; the body must keep every carry's shape and
    dtype, as lax requires."""
    carry = tuple(carry)
    sig = [(tuple(t.shape), t.dtype) for t in carry]
    while _predicate(cond_fn(carry)):
        out = body_fn(carry)
        out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        got = [(tuple(t.shape), t.dtype) for t in out]
        if got != sig:
            raise TypeError(
                f"while_loop: body_fn output and input must have identical "
                f"types: carry {sig}, body returned {got}")
        carry = out
    return carry


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

    def multi_head_dot_product_attention(self, q, k, v, wq, wk, wv, wo,
                                         num_heads):
        """Projected multi-head attention: the registry op, whose attention
        goes through the ``dot_product_attention`` descriptor (the flash
        kernels on the card)."""
        return self._sd._record(
            "multi_head_dot_product_attention", [q, k, v, wq, wk, wv, wo],
            {"num_heads": num_heads})

    def dot_product_attention(self, q, k, v):
        return self._sd._record("dot_product_attention", [q, k, v])


class SDCNN(_Namespace):
    """sd.cnn — SDCNN.java op factory (NHWC, HWIO kernels)."""

    def conv2d(self, x, w, b=None, *, stride=1, padding="same", dilation=1):
        ins = [x, w] + ([b] if b is not None else [])
        return self._sd._record("conv2d", ins, {"stride": stride,
                                                "padding": padding,
                                                "dilation": dilation})

    def max_pooling2d(self, x, *, kernel, stride=None, padding="valid"):
        return self._sd._record("maxpool2d", [x], {"kernel": kernel,
                                                   "stride": stride,
                                                   "padding": padding})

    def avg_pooling2d(self, x, *, kernel, stride=None, padding="valid"):
        return self._sd._record("avgpool2d", [x], {"kernel": kernel,
                                                   "stride": stride,
                                                   "padding": padding})

    def upsampling2d(self, x, *, size=2):
        return self._sd._record("upsampling2d", [x], {"size": size})


class SDRNN(_Namespace):
    """sd.rnn — SDRNN.java op factory (one step of a cell)."""

    def lstm_cell(self, x, h, c, w_ih, w_hh, b):
        return self._sd._record("lstm_cell", [x, h, c, w_ih, w_hh, b],
                                n_out=2)

    def gru_cell(self, x, h, w_ih, w_hh, b_ih, b_hh):
        return self._sd._record("gru_cell", [x, h, w_ih, w_hh, b_ih, b_hh])


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


class SDImage(_Namespace):
    """sd.image — SDImage.java op factory over the catalog's image family."""

    def resize_bilinear(self, x, height, width):
        return self._sd.op("resize_bilinear", x, size=(height, width))

    def resize_nearest_neighbor(self, x, height, width):
        return self._sd.op("resize_nearest_neighbor", x, size=(height, width))

    def resize_bicubic(self, x, height, width):
        return self._sd.op("resize_bicubic", x, size=(height, width))

    def crop_and_resize(self, image, boxes, box_indices, crop_size):
        return self._sd.op("crop_and_resize", image, boxes, box_indices,
                           crop_size=tuple(crop_size))

    def non_max_suppression(self, boxes, scores, max_out_size,
                            iou_threshold=0.5, score_threshold=float("-inf")):
        """Returns (indices, valid_mask) — the op is two-output."""
        return self._sd.op("non_max_suppression", boxes, scores,
                           max_output_size=max_out_size,
                           iou_threshold=iou_threshold,
                           score_threshold=score_threshold, n_out=2)

    def adjust_contrast(self, x, factor):
        return self._sd.op("adjust_contrast", x, factor=factor)

    def adjust_hue(self, x, delta):
        return self._sd.op("adjust_hue", x, delta=delta)

    def adjust_saturation(self, x, factor):
        return self._sd.op("adjust_saturation", x, factor=factor)

    def rgb_to_hsv(self, x):
        return self._sd.op("rgb_to_hsv", x)

    def hsv_to_rgb(self, x):
        return self._sd.op("hsv_to_rgb", x)


class SDLinalg(_Namespace):
    """sd.linalg — SDLinalg.java op factory."""

    def cholesky(self, x):
        return self._sd.op("cholesky", x)

    def qr(self, x, full_matrices=False):
        return self._sd.op("qr", x, full_matrices=full_matrices, n_out=2)

    def svd(self, x, full_uv=False, compute_uv=True):
        return self._sd.op("svd", x, full_matrices=full_uv,
                           compute_uv=compute_uv, n_out=3 if compute_uv else 1)

    def solve(self, a, b):
        return self._sd.op("solve", a, b)

    def triangular_solve(self, a, b, lower=True, adjoint=False):
        return self._sd.op("triangular_solve", a, b, lower=lower,
                           adjoint=adjoint)

    def lu(self, x):
        return self._sd.op("lu", x, n_out=2)

    def matrix_determinant(self, x):
        return self._sd.op("matrix_determinant", x)

    def matrix_inverse(self, x):
        return self._sd.op("matrix_inverse", x)

    def matrix_band_part(self, x, lower, upper):
        return self._sd.op("matrix_band_part", x, num_lower=lower,
                           num_upper=upper)

    def diag(self, x):
        return self._sd.op("matrix_diag", x)


class SDBitwise(_Namespace):
    """sd.bitwise — SDBitwise.java op factory."""

    def and_(self, a, b):
        return self._sd.op("bitwise_and", a, b)

    def or_(self, a, b):
        return self._sd.op("bitwise_or", a, b)

    def xor(self, a, b):
        return self._sd.op("bitwise_xor", a, b)

    def left_shift(self, x, n):
        return self._sd.op("shift_bits", x, shift=int(n))

    def right_shift(self, x, n):
        return self._sd.op("rshift_bits", x, shift=int(n))

    def left_shift_cyclic(self, x, n):
        return self._sd.op("cyclic_shift_bits", x, shift=int(n))

    def right_shift_cyclic(self, x, n):
        return self._sd.op("cyclic_rshift_bits", x, shift=int(n))

    def toggle_bits(self, x):
        return self._sd.op("toggle_bits", x)

    def bits_hamming_distance(self, a, b):
        return self._sd.op("bits_hamming_distance", a, b)


class SDRandom(_Namespace):
    """sd.random — SDRandom.java op factory. Every draw takes an explicit
    ``seed``: its node seeds a fresh generator with it on the graph's
    device at every run, so the same seed gives the same draw there (the
    JAX package's key constant; the stream is torch's)."""

    def _draw(self, name, seed, **kw):
        return self._sd.op(name, key=int(seed), device=str(self._sd.device),
                           **kw)

    def uniform(self, lo, hi, shape, seed=0):
        return self._draw("random_uniform", seed, shape=tuple(shape),
                          minval=lo, maxval=hi)

    def normal(self, mean, stddev, shape, seed=0):
        return self._draw("random_normal", seed, shape=tuple(shape),
                          mean=mean, stddev=stddev)

    def truncated_normal(self, mean, stddev, shape, seed=0):
        return self._draw("random_truncated_normal", seed,
                          shape=tuple(shape), mean=mean, stddev=stddev)

    def bernoulli(self, p, shape, seed=0):
        return self._draw("random_bernoulli", seed, shape=tuple(shape),
                          prob=p)

    def exponential(self, rate, shape, seed=0):
        return self._draw("random_exponential", seed, shape=tuple(shape),
                          rate=rate)

    def gamma(self, alpha, shape, seed=0, beta=1.0):
        return self._draw("random_gamma", seed, shape=tuple(shape),
                          alpha=alpha, beta=beta)


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
        self.cnn = SDCNN(self)
        self.rnn = SDRNN(self)
        self.image = SDImage(self)
        self.linalg = SDLinalg(self)
        self.bitwise = SDBitwise(self)
        self.random = SDRandom(self)
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
        fn = resolve_graph_op(name, self._local_ops)  # existence check
        if "device" not in kwargs and takes_device(
                getattr(fn, "fn", fn)):
            # an op with no tensor input (a fill, a range, a draw) makes
            # its result on the graph's device
            kwargs["device"] = str(self.device)
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
            fn.eager_reason = self._routing(out_names)
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

        signature = signature_of(**feeds)
        self._note_compile(fn, "exec", signature,
                           stable_key=(tuple(outputs), bool(self.optimize),
                                       self.optimize_passes))
        res = fn(self._var_arrays(fn._const_names),
                 {k: canonical(v, self.device) for k, v in feeds.items()},
                 signature=signature)
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
            signature=signature_of(**feeds),
            eager_reason=self._routing((loss_name,)),
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
            signature=signature_of(**feeds),
            eager_reason=self._routing((loss_name,)),
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

    # ---------------------------------------------------------- control flow
    def scan(self, fn, init, xs_var: "SDVariable") -> "SDVariable":
        """Recorded scan over axis 0 of xs (the TF-frames / Enter-Exit
        control-flow analog; ``lax.scan`` in the JAX package).

        fn: (carry, x_slice) -> (new_carry, y_slice), built from torch ops
        (run at execution time, NOT recorded node by node). The trip count
        is xs's length: no host read, so the graph may be captured."""
        name = self._fresh("scan")

        def scan_op(xs, init_val=init):
            _, ys = _scan_loop(fn, _tree_on(init_val, xs.device), (xs,),
                               xs.shape[0], single_x=True)
            return ys

        self._local_ops[name + "_impl"] = scan_op
        return self._record(name + "_impl", [xs_var])

    def while_loop(self, cond_fn, body_fn,
                   init_var: "SDVariable") -> "SDVariable":
        """Recorded while loop (TF While-frame analog): ``cond_fn(x)`` is
        read on the host before every trip, so a graph holding one runs
        eagerly (:data:`~deeplearning4j_tpu_torch.nn.compiled.CONTROL_FLOW`
        routing)."""
        name = self._fresh("while")

        def while_op(x):
            return _while(lambda c: cond_fn(c[0]),
                          lambda c: (body_fn(c[0]),), (x,))[0]

        self._local_ops[name + "_impl"] = _reads_host(while_op)
        return self._record(name + "_impl", [init_var])

    def while_loop_multi(self, cond_fn, body_fn,
                         init_vars: Sequence["SDVariable"]):
        """Recorded multi-carry while loop — the TF2 While/StatelessWhile
        function-graph analog (AbstractSession loop frames).

        cond_fn: tuple(carry) -> scalar bool; body_fn: tuple(carry) ->
        tuple(carry). Returns one SDVariable per loop variable (the final
        carry), mirroring the TF While node's N outputs. The predicate is
        read on the host, as in :meth:`while_loop`."""
        name = self._fresh("while")
        n = len(init_vars)

        def while_op(*vals):
            out = _while(cond_fn, body_fn, tuple(vals))
            # n_out=1 slots store a bare value, not the 1-tuple carry
            return out[0] if n == 1 else out

        self._local_ops[name + "_impl"] = _reads_host(while_op)
        return self._record(name + "_impl", list(init_vars), n_out=n)

    def scan_multi(self, fn, init_vars: Sequence["SDVariable"],
                   xs_vars: Sequence["SDVariable"], n_ys: int,
                   length: Optional[int] = None):
        """Recorded multi-carry multi-output scan — the ONNX Scan /
        Loop-with-scan-outputs analog.

        fn: (tuple(carry), tuple(x_slices)) -> (tuple(carry),
        tuple(y_slices)) (x_slices is None without xs; then ``length`` is
        the trip count); returns [final carries…] + [stacked ys…] as
        SDVariables. No host read."""
        name = self._fresh("scan")
        n_state = len(init_vars)
        n_out = n_state + n_ys

        def scan_op(*vals):
            inits = tuple(vals[:n_state])
            xs = tuple(vals[n_state:])
            if not xs and length is None:
                raise ValueError("scan_multi: no xs and no length")
            trips = xs[0].shape[0] if xs else int(length)
            carry, ys = _scan_loop(fn, inits, xs, trips)
            outs = tuple(carry) + (tuple(ys) if isinstance(ys, tuple)
                                   else (ys,) if n_ys else ())
            return outs[0] if n_out == 1 else outs

        self._local_ops[name + "_impl"] = scan_op
        return self._record(name + "_impl",
                            list(init_vars) + list(xs_vars), n_out=n_out)

    def cond_multi(self, pred_var: "SDVariable", true_fn, false_fn,
                   operands: Sequence["SDVariable"], n_out: int):
        """Recorded conditional over N operands with M outputs — the TF2
        If/StatelessIf function-graph analog. true_fn/false_fn:
        (*operands) -> tuple of n_out values. The predicate (a scalar) is
        read on the host and only the branch it picks runs."""
        name = self._fresh("cond")

        def cond_op(pred, *vals):
            return true_fn(*vals) if _predicate(pred) else false_fn(*vals)

        self._local_ops[name + "_impl"] = _reads_host(cond_op)
        return self._record(name + "_impl", [pred_var] + list(operands),
                            n_out=n_out)

    def cond(self, pred_var: "SDVariable", true_fn, false_fn,
             operand: "SDVariable") -> "SDVariable":
        """Recorded conditional (TF Switch/Merge analog), the predicate read
        on the host as in :meth:`cond_multi`."""
        name = self._fresh("cond")

        def cond_op(pred, x):
            return true_fn(x) if _predicate(pred) else false_fn(x)

        self._local_ops[name + "_impl"] = _reads_host(cond_op)
        return self._record(name + "_impl", [pred_var, operand])

    def _routing(self, out_names: Tuple[str, ...]) -> Optional[str]:
        """The routing rule of the units that run ``out_names``:
        :data:`~deeplearning4j_tpu_torch.nn.compiled.CONTROL_FLOW` when a
        node they run reads the host (a while loop's or a conditional's
        predicate), else None. Decided from the plan before any capture;
        cached with it."""
        key = ("route", out_names, bool(self.optimize),
               self._effective_passes())
        if key not in self._jit_cache:
            plan = self._graph_plan(out_names)
            nodes = (plan.nodes if plan is not None
                     else self._needed_nodes(out_names))
            reads = any(getattr(self._local_ops.get(n.op), "reads_host",
                                False) for n in nodes)
            from deeplearning4j_tpu_torch.nn.compiled import CONTROL_FLOW

            self._jit_cache[key] = CONTROL_FLOW if reads else None
        return self._jit_cache[key]

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
