"""The port's op catalog against the JAX package's, on the CPU.

* The ratchet: every name in the port's registry owns at least one
  validation spec (``ops/validation.py``; no exemption list), and the
  port's registry holds every name of the JAX registry (285) plus its own
  two (``fused_bn_matmul_stats``, ``lstm_layer``).
* Parity, one case per (spec, dtype): the spec's seeded numpy inputs
  through the JAX op's ``.fn`` and through the port's registry op
  (``tests/torch_parity.assert_parity``), in float32 and in each 16-bit
  dtype the spec takes, at the spec's stated tolerance, with the same
  output structure, shapes and dtypes; gradients (``jax.vjp`` against
  ``torch.autograd``) where the spec asks, float32. The port's own two
  ops are held to the JAX functions they stand for
  (``pallas_convbn.reference_bn_matmul_stats``, ``layers._lstm_scan``).
  Random draws and the sign-free factorizations (qr, svd) are held by
  their spec's semantic check in both packages.
* The shadow check (the port's graftlint GL006): every SameDiff graph-op
  name that also names a registry op is on ``REGISTRY_SHADOW_WHITELIST``,
  and ``resolve_graph_op`` gives the same result in both packages on the
  same inputs for each of them.
* The graph-op faults a probe of both packages' graph ops found (one case
  each): an integer ``reduce_prod`` gave int64, an integer ``relu6``
  int32; integer inputs to the floating activations, the three losses and
  ``layer_norm_graph`` raised; ``gather`` filled an out-of-range integer
  row with 0 (``jnp.take`` gives the dtype's minimum).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import deeplearning4j_tpu.ops as jops
from deeplearning4j_tpu.autodiff import samediff as JS
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.ops import pallas_convbn as JC
from deeplearning4j_tpu.ops.activations import get_activation
from deeplearning4j_tpu.ops.compression import ThresholdEncoded as JEncoded
import deeplearning4j_tpu_torch.ops as tops
from deeplearning4j_tpu_torch.autodiff import samediff as TS
from deeplearning4j_tpu_torch.ops import validation as V

from torch_parity import assert_parity, spec_parity

PORT_ONLY = ("fused_bn_matmul_stats", "lstm_layer")


def _jax_lstm_layer(x, W, RW, b, h0=None, c0=None, mask=None, *,
                    gate_activation="sigmoid", activation="tanh",
                    reverse=False):
    n, h = x.shape[0], RW.shape[0]
    h0 = jnp.zeros((n, h), x.dtype) if h0 is None else h0
    c0 = jnp.zeros((n, h), x.dtype) if c0 is None else c0
    return jlayers._lstm_scan({"W": W, "RW": RW, "b": b}, x, h0, c0, mask,
                              gate_act=get_activation(gate_activation),
                              cell_act=get_activation(activation),
                              reverse=reverse)


def _reference(op):
    if op == "lstm_layer":
        return _jax_lstm_layer
    if op == "fused_bn_matmul_stats":
        return JC.reference_bn_matmul_stats
    fn = jops.registry().get(op).fn
    if op == "decode_threshold":  # the spec carries the four fields
        return lambda fields, **kw: fn(JEncoded(*fields), **kw)
    return fn


def test_every_op_has_a_spec_and_the_catalog_is_whole():
    jnames = set(jops.registry().names())
    tnames = set(tops.registry().names())
    assert len(jnames) == 285
    assert V.uncovered_ops() == []
    assert not jnames - tnames, sorted(jnames - tnames)
    assert tnames - jnames == set(PORT_ONLY)
    assert all(V.cases()[n] for n in tnames)
    # the same intentional shadows in both packages (the JAX package's
    # ONNX importer adds `identity` to its GRAPH_OPS when it loads, so the
    # lists are compared, not the tables)
    assert TS.REGISTRY_SHADOW_WHITELIST == JS.REGISTRY_SHADOW_WHITELIST


_PARITY = [pytest.param(op, i, dtype, id=f"{spec.name}-{dtype}")
           for op, specs in sorted(V.cases().items())
           for i, spec in enumerate(specs) for dtype in spec.dtypes]


@pytest.mark.parametrize("op,index,dtype", _PARITY)
def test_op_matches_the_jax_op(op, index, dtype):
    spec = V.cases()[op][index]
    desc = tops.registry().get(op)
    port_kwargs = {"device": "cpu"} if V.takes_device(desc.fn) else {}
    spec_parity(spec, _reference(op), desc, dtype, port_kwargs)


# ---------------------------------------------------------------------------
# the shadow check
# ---------------------------------------------------------------------------

_POS = ("log", "log1p", "sqrt", "rsqrt", "reciprocal", "pow")
_UNIT = ("asin", "acos", "tan")
_X = np.random.RandomState(11).randn(3, 4).astype(np.float32)
_Y = np.random.RandomState(12).randn(3, 4).astype(np.float32)
_SHADOW_ARGS = {
    "reduce_sum": ((_X,), {"axes": (1,)}),
    "reduce_mean": ((_X,), {"axes": (0,), "keepdims": True}),
    "reduce_max": ((_X,), {"axes": None}),
    "reduce_min": ((_X,), {"axes": (1,)}),
    "reduce_prod": ((_X,), {"axes": (1,)}),
    "argmax": ((_X,), {"axis": 1}),
    "argmin": ((_X,), {"axis": 0}),
    "cumsum": ((_X,), {"axis": 1, "exclusive": True}),
    "concat": ((_X, _Y), {"axis": 1}),
    "expand_dims": ((_X,), {"axis": 1}),
    "gather": ((_X, np.asarray([2, 0, 5], np.int32)), {"axis": 0}),
    "pad": ((_X,), {"paddings": ((1, 0), (0, 2))}),
    "permute": ((_X,), {"axes": (1, 0)}),
    "reshape": ((_X,), {"shape": (2, 6)}),
    "size": ((_X,), {}),
    "slice": ((_X,), {"begin": (1, 1), "size": (2, 2)}),
    "squeeze": ((_X[:1],), {}),
    "strided_slice": ((_X,), {"begin": (0, 3), "end": (3, 0),
                              "strides": (2, -1)}),
    "tile": ((_X,), {"reps": (2, 1)}),
    "transpose": ((_X,), {}),
    "where": ((_X > 0, _X, _Y), {}),
    "select": ((_X > 0, _X, _Y), {}),
}


def _shadow_args(name):
    if name in _SHADOW_ARGS:
        return _SHADOW_ARGS[name]
    x = np.abs(_X) + 0.5 if name in _POS else (
        np.clip(_X, -0.9, 0.9) if name in _UNIT else _X)
    if name in ("add", "floormod", "maximum", "minimum", "pow"):
        y = np.abs(_Y) + 0.5 if name in ("floormod", "pow") else _Y
        return (x, y), {}
    return (x,), {}


def _shadowing(graph_ops, reg):
    return sorted(n for n in graph_ops if n in reg)


@pytest.mark.parametrize("name", _shadowing(TS.GRAPH_OPS, tops.registry()))
def test_graph_op_shadows_only_when_listed_and_agrees(name):
    assert name in TS.REGISTRY_SHADOW_WHITELIST, (
        f"graph op {name!r} shadows the registry op without being listed")
    assert name in JS.REGISTRY_SHADOW_WHITELIST
    args, kwargs = _shadow_args(name)
    assert_parity(JS.resolve_graph_op(name), TS.resolve_graph_op(name),
                  *args, kwargs=kwargs, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the graph-op faults: integer inputs as jnp takes them, gather's fill
# ---------------------------------------------------------------------------

_I = np.asarray([[1, -2, 9], [3, 0, -4]], np.int32)
_J = np.asarray([[2, 1, 7], [3, 5, -1]], np.int32)
_FAULTS = [
    ("reduce_prod-int32", "reduce_prod", (_I,), {"axes": (1,)}),
    ("relu6-int32", "relu6", (_I,), {}),
    *[(f"{n}-int32", n, (_I,), {}) for n in (
        "gelu", "elu", "selu", "softplus", "mish", "hardsigmoid")],
    ("leakyrelu-int32", "leakyrelu", (_I,), {"alpha": 0.2}),
    ("softmax-int32", "softmax", (_I,), {"axis": -1}),
    ("log_softmax-int32", "log_softmax", (_I,), {"axis": 0}),
    ("mean_squared_error-int32", "mean_squared_error", (_I, _J), {}),
    ("absolute_difference-int32", "absolute_difference", (_I, _J), {}),
    ("cosine_distance-int32", "cosine_distance", (_I, _J), {}),
    ("layer_norm_graph-int32", "layer_norm_graph",
     (_I, np.asarray([1, 2, 1], np.int32), np.asarray([0, 1, 0], np.int32)),
     {}),
    ("gather-int32-out-of-range", "gather",
     (_I, np.asarray([1, 2, -1, -3], np.int32)), {}),
    ("gather-float32-out-of-range", "gather",
     (_X, np.asarray([[0, 3], [-4, 1]], np.int32)), {"axis": 0}),
]


@pytest.mark.parametrize("op,args,kwargs",
                         [pytest.param(*f[1:], id=f[0]) for f in _FAULTS])
def test_graph_op_fault_is_repaired(op, args, kwargs):
    """The graph op's dtype and values equal the JAX package's on integer
    inputs (and gather's fill past the end): each case failed before the
    repair (int64 / int32 dtypes, NotImplementedError, a 0 fill)."""
    assert_parity(JS.resolve_graph_op(op), TS.resolve_graph_op(op), *args,
                  kwargs=kwargs, rtol=1e-5, atol=1e-6)

