"""Every ONNX rule of the port against the JAX importer (CPU).

The port maps all 152 of the JAX package's ``ONNX_OP_MAPPERS``. Each rule
the first slice did not map has a case here, by family: the same ONNX
bytes (written by the port's ``testing/onnx_builder``) through JAX
``import_onnx`` and port ``import_onnx(..., device="cpu")`` with the
optimizer on, the outputs held to each other in dtype, shape and value
(float32 within 1e-5 relative and absolute, unless the case states its
own; integers and booleans exactly). The random rules are held by
semantics (their draws cannot equal ``jax.random``'s): shape, dtype,
range and moments, the same draws on re-import, distinct streams for
unseeded nodes. The documented rejections are held by their messages.
The control-flow rules have a file of their own
(``test_torch_onnx_control_flow.py``).
"""

import dataclasses
import zlib
from typing import Dict, List, Optional

import numpy as np
import pytest

from deeplearning4j_tpu.imports import onnx_import as jimp
from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.imports import onnx_import as timp
from deeplearning4j_tpu_torch.nn.compiled import SEEDED_RANDOM
from deeplearning4j_tpu_torch.testing import onnx_builder as tb

TOL = dict(rtol=1e-5, atol=1e-5)


@dataclasses.dataclass
class Case:
    """One rule's graph: ``nodes`` over placeholders fed from ``feeds``
    and initializers ``init``; ``outs`` compared (the JAX import with its
    default graph check)."""

    rule: str
    nodes: List[bytes]
    outs: List[str]
    feeds: Dict[str, np.ndarray]
    init: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    tol: Optional[dict] = None

    def model(self) -> bytes:
        return tb.build_model(self.nodes,
                              [(n, a.shape) for n, a in self.feeds.items()],
                              [(o, (1,)) for o in self.outs], self.init)


def _r(seed=0):
    return np.random.RandomState(seed)


def _x(*shape, seed=0, lo=None, hi=None):
    r = _r(seed)
    if lo is not None:
        return r.uniform(lo, hi, shape).astype(np.float32)
    return r.randn(*shape).astype(np.float32)


def one(rule, op=None, ins=("x",), feeds=None, init=None, n_out=1, tol=None,
        **attrs):
    """A one-node case of ``op`` (``rule`` when None)."""
    outs = [f"y{i}" for i in range(n_out)]
    return Case(rule, [tb.node_proto(op or rule, list(ins), outs, **attrs)],
                outs, feeds if feeds is not None else {"x": _x(3, 4)},
                init or {}, tol)


def _run_both(case: Case):
    model = case.model()
    jsd = jimp.import_onnx(model)
    tsd = timp.import_onnx(model, device="cpu")
    want = jsd.output(case.feeds, case.outs)
    got = tsd.output(case.feeds, case.outs)
    return {o: np.asarray(want[o]) for o in case.outs}, got, jsd, tsd


def check(case: Case):
    want, got, jsd, tsd = _run_both(case)
    for o in case.outs:
        w, g = want[o], got[o]
        assert g.dtype == w.dtype, (o, g.dtype, w.dtype)
        assert g.shape == w.shape, (o, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=o, equal_nan=True,
                                       **(case.tol or TOL))
        else:
            np.testing.assert_array_equal(g, w, err_msg=o)
    assert tsd.last_compile_stats.fusions == jsd.last_compile_stats.fusions


# ---------------------------------------------------------------------------
# 1. Elementwise, activation, comparison and logic
# ---------------------------------------------------------------------------

_UNIT = {"lo": 0.1, "hi": 0.9}
_UNARY = ["Abs", "Neg", "Exp", "Log", "Floor", "Ceil", "Round", "Sign",
          "Reciprocal", "Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh",
          "Cosh", "Softplus", "Softsign", "Mish", "HardSigmoid"]
_POSITIVE = {"Log", "Reciprocal", "Asin", "Acos"}


def _special():
    """Finite values, NaNs and both infinities."""
    x = _x(3, 4, seed=1)
    x[0, 0], x[1, 2], x[2, 3] = np.nan, np.inf, -np.inf
    return {"x": x}


def _ints(*shape, seed=2, lo=-9, hi=10):
    return _r(seed).randint(lo, hi, shape).astype(np.int32)


def _bools(*shape, seed=3):
    return _r(seed).rand(*shape) < 0.5


def _elementwise_cases():
    cases = [one(op, feeds={"x": _x(3, 4, **(_UNIT if op in _POSITIVE
                                                else {}))})
             for op in _UNARY]
    # Round: halves round to even, as ONNX (and jnp) round
    cases[_UNARY.index("Round")].feeds["x"][0] = [0.5, 1.5, 2.5, -0.5]
    cases += [
        one("Not", feeds={"x": _bools(3, 4)}),
        one("IsNaN", feeds=_special()),
        one("IsInf", feeds=_special()),
        one("LeakyRelu", alpha=0.2),
        one("Elu"),
        one("Selu"),
        one("LogSoftmax", axis=1),
        one("PRelu", ins=("x", "slope"),
            init={"slope": _x(4, seed=4, lo=0.1, hi=0.5)}),
        Case("Clip", [tb.node_proto("Clip", ["x"], ["y0"], min=-0.5,
                                    max=0.7),
                      tb.node_proto("Clip", ["x", "lo", "hi"], ["y1"])],
             ["y0", "y1"], {"x": _x(3, 4)},
             {"lo": np.float32(-0.3), "hi": np.float32(0.4)}),
        one("Celu", alpha=0.7),
        one("HardSwish", feeds={"x": 4 * _x(3, 4)}),
        one("Shrink", bias=0.1, lambd=0.4),
        one("Hardmax", feeds={"x": np.array([[1, 3, 3, 0], [2, 1, 0, 2],
                                             [5, 4, 4, 5]], np.float32)}),
    ]
    bin_f = {"a": _x(3, 4, seed=5), "b": _x(4, seed=6)}
    for op in ("Max", "Min"):
        cases.append(one(op, ins=("a", "b"), feeds=dict(bin_f)))
    # Mod: fmod=0 is the floor mod of integers (the divisor's sign),
    # fmod=1 the truncated mod of floats (the dividend's sign)
    cases.append(Case("Mod", [
        tb.node_proto("Mod", ["ia", "ib"], ["y0"]),
        tb.node_proto("Mod", ["a", "c"], ["y1"], fmod=1)], ["y0", "y1"],
        {"ia": _ints(3, 4), "ib": _ints(3, 4, seed=7, lo=1, hi=5)
         * np.where(_bools(3, 4, seed=8), 1, -1).astype(np.int32),
         "a": 5 * _x(3, 4, seed=5),
         "c": np.where(_bools(3, 4, seed=9), 1.5, -1.25).astype(
             np.float32)}))
    cmp = {"a": np.round(2 * _x(3, 4, seed=5)), "b": np.round(
        2 * _x(3, 4, seed=6))}
    for op in ("Equal", "Greater", "Less", "GreaterOrEqual", "LessOrEqual"):
        cases.append(one(op, ins=("a", "b"), feeds=dict(cmp)))
    for op in ("And", "Or", "Xor"):
        cases.append(one(op, ins=("a", "b"),
                         feeds={"a": _bools(3, 4), "b": _bools(3, 4, seed=4)}))
    cases += [
        one("Where", ins=("c", "a", "b"),
            feeds={"c": _bools(3, 4), "a": _x(3, 4), "b": _x(4, seed=1)}),
        one("BitShift", ins=("a", "s"), direction="RIGHT",
            feeds={"a": _ints(3, 4, lo=0, hi=1000)},
            init={"s": np.int32([1, 2, 3, 0])}),
        one("Sum", ins=("a", "b", "c"), feeds={
            "a": _x(3, 4), "b": _x(4, seed=1), "c": _x(3, 1, seed=2)}),
        one("Mean", ins=("a", "b", "c"), feeds={
            "a": _x(3, 4), "b": _x(4, seed=1), "c": _x(3, 1, seed=2)}),
    ]
    return cases


ELEMENTWISE = _elementwise_cases()


@pytest.mark.parametrize("case", ELEMENTWISE, ids=lambda c: c.rule)
def test_elementwise_rule_matches_jax(case):
    check(case)


def test_thresholded_relu_fails_as_in_jax():
    """The JAX rule records the activation ``thresholdedrelu``, which
    neither package's graph-op table resolves: both importers raise the
    same error at import (a reference fault, ROADMAP.md)."""
    model = one("ThresholdedRelu", alpha=0.5).model()
    with pytest.raises(KeyError) as j:
        jimp.import_onnx(model)
    with pytest.raises(KeyError) as t:
        timp.import_onnx(model, device="cpu")
    assert str(t.value) == str(j.value) == \
        "\"unknown graph op 'thresholdedrelu'\""


# ---------------------------------------------------------------------------
# 2. Reductions
# ---------------------------------------------------------------------------


def _reduction_cases():
    x = {"x": _x(2, 3, 4, lo=0.2, hi=1.2)}
    cases = []
    for op in ("ReduceSum", "ReduceMax", "ReduceMin"):
        cases.append(Case(op, [
            tb.node_proto(op, ["x"], ["y0"], axes=[1], keepdims=0),
            tb.node_proto(op, ["x"], ["y1"]),  # every axis, kept
            tb.node_proto(op, ["x", "ax"], ["y2"], keepdims=1)],
            ["y0", "y1", "y2"], dict(x), {"ax": np.int64([0, 2])}))
    # ReduceProd is not among the rules given constant operands (in both
    # packages), so it takes its axes as an attribute only
    cases.append(Case("ReduceProd", [
        tb.node_proto("ReduceProd", ["x"], ["y0"], axes=[1], keepdims=0),
        tb.node_proto("ReduceProd", ["x"], ["y1"])], ["y0", "y1"], dict(x)))
    cases.append(Case("ReduceLogSum", [
        tb.node_proto("ReduceLogSum", ["x"], ["y0"], axes=[-1], keepdims=0),
        tb.node_proto("ReduceLogSum", ["x", "ax"], ["y1"])], ["y0", "y1"],
        dict(x), {"ax": np.int64([1])}))
    ties = np.array([[[1, 5, 5, 0], [2, 2, 1, 0], [0, 3, 3, 3]]] * 2,
                    np.float32)
    for op in ("ArgMax", "ArgMin"):
        cases.append(Case(op, [
            tb.node_proto(op, ["x"], ["y0"], axis=2),
            tb.node_proto(op, ["x"], ["y1"], axis=1, keepdims=0),
            tb.node_proto(op, ["x"], ["y2"], axis=2, select_last_index=1)],
            ["y0", "y1", "y2"], {"x": ties}))
    return cases


REDUCTIONS = _reduction_cases()


@pytest.mark.parametrize("case", REDUCTIONS, ids=lambda c: c.rule)
def test_reduction_rule_matches_jax(case):
    check(case)


# rules that record their graph as the JAX rules do and fail where those
# fail (reference faults, ROADMAP.md "Not port faults"): the norm
# reductions pass ``axes=`` to catalog ops that take ``axis=``, and
# ReduceProd reads a constant axes input it is never given
FAULTED = [
    ("ReduceL1", tb.node_proto("ReduceL1", ["x"], ["y0"], axes=[1])),
    ("ReduceL2", tb.node_proto("ReduceL2", ["x"], ["y0"], axes=[1])),
    ("ReduceLogSumExp", tb.node_proto("ReduceLogSumExp", ["x"], ["y0"],
                                      axes=[1])),
    ("ReduceSumSquare", tb.node_proto("ReduceSumSquare", ["x"], ["y0"],
                                      axes=[1])),
    ("GlobalLpPool", tb.node_proto("GlobalLpPool", ["x"], ["y0"], p=2)),
    ("ReduceProd", tb.node_proto("ReduceProd", ["x", "ax"], ["y0"])),
]


@pytest.mark.parametrize("rule, node", FAULTED, ids=[r for r, _ in FAULTED])
def test_rule_fails_where_the_jax_rule_fails(rule, node):
    """The same graph recorded, the same error class raised, at import
    (ReduceProd's axes input) or at the first ``output``."""
    model = tb.build_model([node], [("x", (2, 3, 4, 5))], [("y0", (1,))],
                           {"ax": np.int64([1])})
    feeds = {"x": _x(2, 3, 4, 5)}
    errors = []
    for imp, kw in ((jimp, {}), (timp, {"device": "cpu"})):
        with pytest.raises((TypeError, AttributeError)) as e:
            imp.import_onnx(model, **kw).output(feeds, ["y0"])
        errors.append(e)
    assert errors[0].type is errors[1].type
    if rule != "ReduceProd":
        assert "'axes'" in str(errors[0].value) and \
            "'axes'" in str(errors[1].value)


# ---------------------------------------------------------------------------
# 3. Convolution, pooling, normalization and resampling
# ---------------------------------------------------------------------------


def _conv_cases():
    img = {"x": _x(2, 3, 8, 8)}
    c4 = {"x": _x(2, 4, 6, 6, seed=1)}
    conv_tol = dict(rtol=1e-4, atol=1e-5)
    return [
        Case("Conv", [
            tb.node_proto("Conv", ["x", "w", "b"], ["y0"],
                          kernel_shape=[3, 3], strides=[2, 2],
                          pads=[1, 1, 1, 1]),
            tb.node_proto("Conv", ["x", "wd"], ["y1"], kernel_shape=[3, 3],
                          group=3, pads=[0, 1, 0, 1])],
            ["y0", "y1"], img,
            {"w": _x(4, 3, 3, 3, seed=2), "b": _x(4, seed=3),
             "wd": _x(3, 1, 3, 3, seed=4)}, conv_tol),
        one("ConvTranspose", ins=("x", "w", "b"), feeds=c4,
            init={"w": _x(4, 2, 3, 3, seed=2), "b": _x(2, seed=3)},
            strides=[2, 2], tol=conv_tol),
        one("MaxPool", feeds=img, kernel_shape=[3, 3], strides=[2, 2],
            pads=[1, 1, 1, 1]),
        Case("AveragePool", [
            tb.node_proto("AveragePool", ["x"], ["y0"], kernel_shape=[3, 3],
                          strides=[1, 1], pads=[1, 1, 1, 1]),
            tb.node_proto("AveragePool", ["x"], ["y1"], kernel_shape=[3, 3],
                          strides=[2, 2], pads=[1, 1, 1, 1],
                          count_include_pad=1),
            tb.node_proto("AveragePool", ["x"], ["y2"],
                          kernel_shape=[2, 2])], ["y0", "y1", "y2"], img),
        one("GlobalAveragePool", feeds=img),
        one("GlobalMaxPool", feeds=img),
        one("BatchNormalization", ins=("x", "g", "b", "m", "v"), feeds=img,
            init={"g": _x(3, seed=5), "b": _x(3, seed=6), "m": _x(3, seed=7),
                  "v": _x(3, seed=8, lo=0.5, hi=1.5)}, epsilon=1e-3),
        one("InstanceNormalization", ins=("x", "s", "b"), feeds=img,
            init={"s": _x(3, seed=5), "b": _x(3, seed=6)}, epsilon=1e-4,
            tol=dict(rtol=1e-4, atol=1e-5)),
        one("LRN", feeds=c4, size=3, alpha=1e-3, beta=0.75, bias=1.5),
        one("LpNormalization", p=2, axis=-1),
        one("MeanVarianceNormalization", feeds=img,
            tol=dict(rtol=1e-4, atol=1e-5)),
        Case("Pad", [
            tb.node_proto("Pad", ["x", "pads"], ["y0"], value=0.5),
            tb.node_proto("Pad", ["x"], ["y1"], pads=[0, 1, 0, 2])],
            ["y0", "y1"], {"x": _x(3, 4)}, {"pads": np.int64([1, 0, 2, 1])}),
        Case("Resize", [
            tb.node_proto("Resize", ["x", "", "", "sizes"], ["y0"],
                          mode="linear",
                          coordinate_transformation_mode="half_pixel"),
            tb.node_proto("Resize", ["x", "", "scales"], ["y1"],
                          mode="nearest")],
            ["y0", "y1"], {"x": _x(1, 2, 4, 5)},
            {"sizes": np.int64([1, 2, 7, 9]),
             "scales": np.float32([1, 1, 2, 2])}, dict(rtol=1e-5, atol=1e-5)),
        one("Upsample", ins=("x", "scales"), feeds={"x": _x(1, 2, 3, 3)},
            init={"scales": np.float32([1, 1, 2, 2])}, mode="nearest"),
        one("DepthToSpace", feeds=c4, blocksize=2),
        one("SpaceToDepth", feeds=img, blocksize=2),
    ]


CONV = _conv_cases()


@pytest.mark.parametrize("case", CONV, ids=lambda c: c.rule)
def test_conv_family_rule_matches_jax(case):
    check(case)


@pytest.mark.parametrize("node, match", [
    (tb.node_proto("Conv", ["x", "w"], ["y0"], kernel_shape=[3, 3],
                   dilations=[2, 2]), "dilated Conv"),
    (tb.node_proto("Conv", ["x", "wg"], ["y0"], kernel_shape=[3, 3],
                   group=2), "group=2"),
    (tb.node_proto("Resize", ["x", "", "", "sizes"], ["y0"], mode="linear",
                   coordinate_transformation_mode="align_corners"),
     "align_corners"),
    (tb.node_proto("DepthToSpace", ["x"], ["y0"], blocksize=2, mode="CRD"),
     "CRD"),
    (tb.node_proto("ConvTranspose", ["x", "w"], ["y0"], pads=[0, 1, 0, 1]),
     "asymmetric"),
], ids=["dilation", "grouped", "resize_transform", "crd", "asym_pads"])
def test_conv_family_rejections_match_jax(node, match):
    model = tb.build_model([node], [("x", (1, 4, 6, 6))], [("y0", (1,))],
                           {"w": _x(4, 4, 3, 3), "wg": _x(4, 2, 3, 3),
                            "sizes": np.int64([1, 4, 3, 3])})
    with pytest.raises(NotImplementedError, match=match):
        jimp.import_onnx(model)
    with pytest.raises(NotImplementedError, match=match):
        timp.import_onnx(model, device="cpu")


# ---------------------------------------------------------------------------
# 4. Shape and indexing
# ---------------------------------------------------------------------------


def _shape_cases():
    x3 = {"x": _x(2, 3, 4)}
    return [
        one("Shape", feeds=x3),
        one("Size", feeds=x3),
        one("Det", feeds={"x": _x(2, 3, 3)}, tol=dict(rtol=1e-4, atol=1e-5)),
        one("GatherND", ins=("x", "i"), feeds=x3,
            init={"i": np.int64([[0, 1], [1, 2], [1, 0]])}),
        one("Expand", ins=("x", "s"), feeds={"x": _x(3, 1)},
            init={"s": np.int64([2, 1, 4])}),
        one("Tile", ins=("x", "r"), init={"r": np.int64([2, 3])}),
        Case("Split", [
            tb.node_proto("Split", ["x", "sp"], ["y0", "y1"], axis=1),
            tb.node_proto("Split", ["x"], ["y2", "y3"], axis=0)],
            ["y0", "y1", "y2", "y3"], {"x": _x(4, 6)},
            {"sp": np.int64([2, 4])}),
        Case("Slice", [
            tb.node_proto("Slice", ["x", "st", "en", "ax"], ["y0"]),
            tb.node_proto("Slice", ["x", "st2", "en2"], ["y1"])],
            ["y0", "y1"], x3,
            {"st": np.int64([1, -3]), "en": np.int64([1000, -1]),
             "ax": np.int64([2, 1]), "st2": np.int64([0, 1, 0]),
             "en2": np.int64([1, 3, 2])}),
        one("TopK", ins=("x", "k"), n_out=2,
            feeds={"x": _x(3, 6)}, init={"k": np.int64([3])}),
        one("ConstantOfShape", ins=("s",), feeds={},
            init={"s": np.int64([2, 3])}, value=np.float32([1.5])),
        one("Range", ins=("a", "b", "d"), feeds={},
            init={"a": np.float32(1.0), "b": np.float32(4.0),
                  "d": np.float32(0.5)}),
        Case("OneHot", [
            tb.node_proto("OneHot", ["i", "depth", "vals"], ["y0"]),
            tb.node_proto("OneHot", ["i", "depth", "vals"], ["y1"], axis=0)],
            ["y0", "y1"], {"i": _ints(2, 3, lo=0, hi=5)},
            {"depth": np.int64(5), "vals": np.float32([-1, 2])}),
        one("EyeLike", feeds={"x": _x(3, 5)}, k=1),
        one("GatherElements", ins=("x", "i"), axis=1,
            init={"i": np.int64([[0, 3, -1], [2, 2, 0], [1, 0, 3]])}),
        Case("ScatterElements", [
            tb.node_proto("ScatterElements", ["x", "i", "u"], ["y0"],
                          axis=1),
            tb.node_proto("ScatterElements", ["x", "i", "u"], ["y1"],
                          axis=1, reduction="add")],
            ["y0", "y1"], {"x": _x(3, 4), "u": _x(3, 2, seed=1)},
            {"i": np.int64([[0, 3], [2, 1], [1, -1]])}),
        one("Scatter", ins=("x", "i", "u"), axis=0,
            feeds={"x": _x(3, 4), "u": _x(1, 4, seed=1)},
            init={"i": np.int64([[2, 0, 1, 2]])}),
        one("ScatterND", ins=("x", "i", "u"),
            feeds={"x": _x(4, 3), "u": _x(2, 3, seed=1)},
            init={"i": np.int64([[3], [1]])}),
        Case("CumSum", [
            tb.node_proto("CumSum", ["x", "ax"], ["y0"]),
            tb.node_proto("CumSum", ["x", "ax"], ["y1"], exclusive=1,
                          reverse=1)],
            ["y0", "y1"], x3, {"ax": np.int64(2)}),
        Case("Trilu", [
            tb.node_proto("Trilu", ["x"], ["y0"]),
            tb.node_proto("Trilu", ["x", "k"], ["y1"], upper=0)],
            ["y0", "y1"], {"x": _x(4, 5)}, {"k": np.int64(1)}),
        one("Einsum", ins=("a", "b"), equation="bij,bjk->bik",
            feeds={"a": _x(2, 3, 4), "b": _x(2, 4, 5, seed=1)}),
    ]


SHAPE = _shape_cases()


@pytest.mark.parametrize("case", SHAPE, ids=lambda c: c.rule)
def test_shape_rule_matches_jax(case):
    check(case)


# ---------------------------------------------------------------------------
# 5. Recurrent
# ---------------------------------------------------------------------------

T, N, I, H = 4, 2, 3, 5


def _recurrent_cases():
    x = {"x": _x(T, N, I)}
    rnn_tol = dict(rtol=1e-4, atol=1e-5)
    return [
        one("LSTM", ins=("x", "W", "R", "B"), n_out=3, feeds=x,
            init={"W": _x(1, 4 * H, I, seed=1), "R": _x(1, 4 * H, H, seed=2),
                  "B": _x(1, 8 * H, seed=3)}, hidden_size=H, tol=rnn_tol),
        Case("GRU", [
            tb.node_proto("GRU", ["x", "W", "R", "B"], ["y0", "y1"],
                          hidden_size=H, linear_before_reset=1),
            tb.node_proto("GRU", ["x", "W", "R"], ["y2", "y3"],
                          hidden_size=H)],
            ["y0", "y1", "y2", "y3"], x,
            {"W": _x(1, 3 * H, I, seed=1), "R": _x(1, 3 * H, H, seed=2),
             "B": _x(1, 6 * H, seed=3)}, rnn_tol),
        Case("RNN", [
            tb.node_proto("RNN", ["x", "W", "R", "B"], ["y0", "y1"],
                          hidden_size=H),
            tb.node_proto("RNN", ["x", "W", "R", "", "", "h0"],
                          ["y2", "y3"], hidden_size=H,
                          activations=["Relu"])],
            ["y0", "y1", "y2", "y3"], x,
            {"W": _x(1, H, I, seed=1), "R": 0.5 * _x(1, H, H, seed=2),
             "B": _x(1, 2 * H, seed=3), "h0": _x(1, N, H, seed=4)}, rnn_tol),
    ]


RECURRENT = _recurrent_cases()


@pytest.mark.parametrize("case", RECURRENT, ids=lambda c: c.rule)
def test_recurrent_rule_matches_jax(case):
    check(case)


@pytest.mark.parametrize("ins, attrs, match", [
    (["x", "W", "R", "", "", "h0"], {}, "initial_h"),
    (["x", "W", "R", "", "sl"], {}, "sequence_lens"),
    (["x", "W", "R"], {"direction": "reverse"}, "direction=reverse"),
    (["x", "W", "R"], {"layout": 1}, "layout=1"),
    (["x", "W", "R"], {"clip": 2.0}, "clipping"),
], ids=["initial_h", "seq_lens", "reverse", "layout", "clip"])
def test_lstm_rejections_match_jax(ins, attrs, match):
    model = tb.build_model(
        [tb.node_proto("LSTM", ins, ["Y"], hidden_size=H, **attrs)],
        [("x", (T, N, I))], [("Y", (1,))],
        {"W": _x(1, 4 * H, I), "R": _x(1, 4 * H, H),
         "h0": _x(1, N, H), "sl": np.int32([T, T])})
    for imp, kw in ((jimp, {}), (timp, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match=match):
            imp.import_onnx(model, **kw)


# ---------------------------------------------------------------------------
# 7. Detection and quantization
# ---------------------------------------------------------------------------


def _detection_cases():
    boxes = np.array([[[0, 0, 1, 1], [0, 0, 1.05, 1.05], [2, 2, 3, 3],
                       [0.1, 0.1, 1.1, 1.1], [5, 5, 6, 7]]], np.float32)
    boxes = np.concatenate([boxes, boxes[:, ::-1]], 0)  # batch 2
    scores = _x(2, 2, 5, seed=3, lo=0.0, hi=1.0)
    cbox = np.concatenate([(boxes[..., :2] + boxes[..., 2:]) / 2,
                           boxes[..., 2:] - boxes[..., :2]], -1)
    ramp = np.arange(2 * 2 * 6 * 7, dtype=np.float32).reshape(2, 2, 6, 7)
    return [
        Case("NonMaxSuppression", [
            tb.node_proto("NonMaxSuppression",
                          ["b", "s", "mo", "iou", "st"], ["y0"]),
            tb.node_proto("NonMaxSuppression", ["cb", "s", "mo", "iou"],
                          ["y1"], center_point_box=1)],
            ["y0", "y1"], {"b": boxes, "s": scores, "cb": cbox},
            {"mo": np.int64(3), "iou": np.float32(0.5),
             "st": np.float32(0.2)}),
        Case("RoiAlign", [
            tb.node_proto("RoiAlign", ["x", "rois", "bi"], ["y0"],
                          output_height=2, output_width=3, sampling_ratio=2,
                          spatial_scale=0.5),
            tb.node_proto("RoiAlign", ["x", "rois", "bi"], ["y1"],
                          output_height=3, output_width=2, mode="max",
                          coordinate_transformation_mode="output_half_pixel")],
            ["y0", "y1"], {"x": ramp,
                           "rois": np.float32([[0, 0, 6, 8], [2, 1, 9, 11],
                                               [1, 1, 4, 3]])},
            {"bi": np.int64([0, 1, 1])}, dict(rtol=1e-5, atol=1e-4)),
        Case("GridSample", [
            tb.node_proto("GridSample", ["x", "g"], ["y0"], mode="bilinear",
                          padding_mode="zeros", align_corners=0),
            tb.node_proto("GridSample", ["x", "g"], ["y1"], mode="nearest",
                          padding_mode="border", align_corners=1)],
            ["y0", "y1"], {"x": _x(2, 3, 5, 6),
                           "g": _x(2, 4, 4, 2, seed=1, lo=-1.1, hi=1.1)}),
        one("DequantizeLinear", ins=("q", "sc", "zp"),
            feeds={"q": _r(4).randint(0, 256, (3, 4)).astype(np.uint8)},
            init={"sc": np.float32(0.05), "zp": np.uint8(128)}),
        Case("QuantizeLinear", [
            tb.node_proto("QuantizeLinear", ["x", "sc", "zp"], ["y0"]),
            tb.node_proto("QuantizeLinear", ["x", "sc", "zs"], ["y1"]),
            tb.node_proto("QuantizeLinear", ["x", "sc"], ["y2"])],
            ["y0", "y1", "y2"], {"x": 4 * _x(3, 4)},
            {"sc": np.float32(0.02), "zp": np.uint8(128),
             "zs": np.int8(-3)}),
        one("DynamicQuantizeLinear", n_out=3, feeds={"x": 3 * _x(3, 4)}),
    ]


DETECTION = _detection_cases()


@pytest.mark.parametrize("case", DETECTION, ids=lambda c: c.rule)
def test_detection_and_quantization_rule_matches_jax(case):
    check(case)


# ---------------------------------------------------------------------------
# 7. Random draws, held by semantics
# ---------------------------------------------------------------------------


def _random_model():
    nodes = [
        tb.node_proto("RandomNormal", [], ["rn"], shape=[4000], mean=2.0,
                      scale=0.5, seed=7.0),
        tb.node_proto("RandomUniform", [], ["ru"], shape=[50, 80], low=-1.0,
                      high=3.0),
        tb.node_proto("RandomNormalLike", ["x"], ["rnl"], scale=2.0),
        tb.node_proto("RandomUniformLike", ["x"], ["rul"], low=1.0, high=2.0),
        tb.node_proto("Bernoulli", ["p"], ["be"]),
        tb.node_proto("RandomNormal", [], ["rn2"], shape=[4000], mean=2.0,
                      scale=0.5),
    ]
    return tb.build_model(nodes, [("x", (40, 100)), ("p", (40, 100))],
                          [(o, (1,)) for o in RANDOM_OUTS], {})


RANDOM_OUTS = ["rn", "ru", "rnl", "rul", "be", "rn2"]
RANDOM_FEEDS = {"x": np.zeros((40, 100), np.float32),
                "p": np.full((40, 100), 0.3, np.float32)}


@pytest.fixture(scope="module")
def random_draws():
    model = _random_model()
    jout = jimp.import_onnx(model).output(RANDOM_FEEDS, RANDOM_OUTS)
    tsd = timp.import_onnx(model, device="cpu")
    return ({k: np.asarray(v) for k, v in jout.items()},
            tsd.output(RANDOM_FEEDS, RANDOM_OUTS), model)


@pytest.mark.parametrize("out, rule", [
    ("rn", "RandomNormal"), ("ru", "RandomUniform"),
    ("rnl", "RandomNormalLike"), ("rul", "RandomUniformLike"),
    ("be", "Bernoulli")])
def test_random_rule_matches_jax_by_semantics(random_draws, out, rule):
    """Shape and dtype as the JAX draws, the range, and the moments each
    distribution gives: within 5 standard errors of the mean (and of the
    variance for the normal draws) at these sizes."""
    want, got, _ = random_draws
    g, w = got[out], want[out]
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    n = g.size
    if rule in ("RandomNormal", "RandomNormalLike"):
        mean, sd = (2.0, 0.5) if rule == "RandomNormal" else (0.0, 2.0)
        assert abs(g.mean() - mean) < 5 * sd / np.sqrt(n)
        assert abs(g.var() - sd ** 2) < 5 * sd ** 2 * np.sqrt(2.0 / n)
    elif rule in ("RandomUniform", "RandomUniformLike"):
        lo, hi = (-1.0, 3.0) if rule == "RandomUniform" else (1.0, 2.0)
        assert g.min() >= lo and g.max() < hi
        assert abs(g.mean() - (lo + hi) / 2) < 5 * (hi - lo) / np.sqrt(12 * n)
    else:  # Bernoulli
        assert set(np.unique(g)) <= {0.0, 1.0}
        assert abs(g.mean() - 0.3) < 5 * np.sqrt(0.21 / n)


def _multinomial(batch):
    model = tb.build_model(
        [tb.node_proto("Multinomial", ["lp"], ["mu"], sample_size=3000,
                       seed=3.0)], [("lp", (batch, 3))], [("mu", (1,))], {})
    p = np.float32([[0.2, 0.3, 0.5], [0.7, 0.1, 0.2]])[:batch]
    return model, {"lp": np.log(p)}, p


@pytest.mark.parametrize("batch", [1, 2])
def test_multinomial_rule_matches_jax_by_semantics(batch):
    """(batch, sample_size) int32 classes, each row's class shares within
    5 standard errors of its probabilities, the same draws twice. The JAX
    rule draws a batch of one only: it asks ``jax.random.categorical`` for
    shape (batch, sample_size), which does not broadcast against the
    (batch,) rows past one (a reference fault, ROADMAP.md), so its shape
    and dtype are compared at batch 1 and its error at batch 2."""
    model, feeds, p = _multinomial(batch)
    tsd = timp.import_onnx(model, device="cpu")
    g = tsd.output(feeds, ["mu"])["mu"]
    np.testing.assert_array_equal(tsd.output(feeds, ["mu"])["mu"], g)
    if batch == 1:
        w = np.asarray(jimp.import_onnx(model).output(feeds, ["mu"])["mu"])
        assert g.shape == w.shape and g.dtype == w.dtype
    else:
        with pytest.raises(ValueError, match="broadcasting"):
            jimp.import_onnx(model).output(feeds, ["mu"])
    assert g.shape == (batch, 3000) and g.dtype == np.int32
    assert g.min() >= 0 and g.max() <= 2
    for row in range(batch):
        share = np.bincount(g[row], minlength=3) / g.shape[1]
        se = np.sqrt(p[row] * (1 - p[row]) / g.shape[1])
        assert np.all(np.abs(share - p[row]) < 5 * se), (row, share)


def test_random_rules_draw_alike_on_reimport_and_apart_unseeded(
        random_draws):
    """The same bytes drawn again (a second import, and a second run)
    give the same draws; unseeded nodes draw streams of their own (keyed
    by the crc32 of the node name) and a seeded one the stream of its
    seed, as the JAX rules key them."""
    _, got, model = random_draws
    tsd = timp.import_onnx(model, device="cpu")
    again = tsd.output(RANDOM_FEEDS, RANDOM_OUTS)
    for o in RANDOM_OUTS:
        np.testing.assert_array_equal(again[o], got[o], err_msg=o)
        np.testing.assert_array_equal(
            tsd.output(RANDOM_FEEDS, [o])[o], got[o], err_msg=o)
    assert np.abs(got["rn"] - got["rn2"]).max() > 0.1
    ir = timp.parse_model(model)
    by_name = {n.outputs[0]: n for n in ir.nodes}
    assert timp._onnx_seed(by_name["rn"].attrs, by_name["rn"]) == 7
    for o in ("ru", "rn2"):
        assert timp._onnx_seed(by_name[o].attrs, by_name[o]) == \
            jimp._onnx_seed(by_name[o].attrs, by_name[o]) == \
            zlib.crc32(by_name[o].name.encode()) & 0x7FFFFFFF


def test_random_graphs_route_to_eager():
    """A graph holding a random node runs eagerly by rule
    (``SEEDED_RANDOM``): each node seeds a fresh generator on every run,
    which a CUDA-graph capture refuses. The routing is recorded once."""
    observe.reset()
    tsd = timp.import_onnx(_random_model(), device="cpu")
    tsd.output(RANDOM_FEEDS, RANDOM_OUTS)
    tsd.output(RANDOM_FEEDS, RANDOM_OUTS)
    assert tsd._routing(tuple(RANDOM_OUTS)) == SEEDED_RANDOM
    assert [(e.graph, e.key, e.reason)
            for e in observe.ledger().routed_events()] == [
        ("samediff", "exec", SEEDED_RANDOM)]
    model, feeds, _ = _multinomial(1)
    tsd = timp.import_onnx(model, device="cpu")
    assert tsd._routing(("mu",)) == SEEDED_RANDOM


# ---------------------------------------------------------------------------
# 7. The documented rejections, held by their messages
# ---------------------------------------------------------------------------

REJECTIONS = {
    "NonZero": "dynamic-length output (count of nonzeros)",
    "Unique": "dynamic-length output (count of distinct values)",
    "Compress": "dynamic-length output (count of selected rows)",
    "StringNormalizer": "string tensors are unsupported",
    "TfIdfVectorizer": "string/sequence processing is unsupported",
    "MatMulInteger": "integer matmul with zero points is not imported",
    "ConvInteger": "integer conv with zero points is not imported",
    "QLinearConv": "fused int8 conv: use DequantizeLinear + Conv",
    "QLinearMatMul": "fused int8 matmul: use DequantizeLinear + MatMul",
}


@pytest.mark.parametrize("op", sorted(REJECTIONS))
def test_documented_rejection_messages(op):
    """Both importers refuse the op at import, naming it and its node;
    the port states its reason (the JAX reason, reworded where it was the
    TPU's) and how to restructure the model."""
    model = tb.build_model([tb.node_proto(op, ["x"], ["y0"], name="n1")],
                           [("x", (3,))], [("y0", (1,))], {})
    with pytest.raises(NotImplementedError, match=rf"^{op} \(n1\): ") as j:
        jimp.import_onnx(model)
    with pytest.raises(NotImplementedError, match=rf"^{op} \(n1\): ") as t:
        timp.import_onnx(model, device="cpu")
    msg = str(t.value)
    assert REJECTIONS[op] in msg and "restructure the model" in msg
    assert "XLA" not in msg and "TPU" not in msg
    if op not in ("MatMulInteger", "ConvInteger"):
        assert REJECTIONS[op] in str(j.value)


# ---------------------------------------------------------------------------
# The table as a whole
# ---------------------------------------------------------------------------

FIRST_SLICE = {"Relu", "Sigmoid", "Tanh", "Sqrt", "Erf", "Gelu", "Add",
               "Sub", "Mul", "Div", "Pow", "Softmax", "MatMul", "Gemm",
               "Identity", "Dropout", "Flatten", "Reshape", "Transpose",
               "Squeeze", "Unsqueeze", "Concat", "Gather", "ReduceMean",
               "Cast", "Constant", "LayerNormalization"}
CONTROL_FLOW = {"If", "Loop", "Scan"}


def test_the_port_maps_every_jax_onnx_rule():
    assert set(timp.ONNX_OP_MAPPERS) == set(jimp.ONNX_OP_MAPPERS)
    assert len(timp.ONNX_OP_MAPPERS) == 152
    assert timp._NEEDS_CONSTS == jimp._NEEDS_CONSTS
    assert timp._NEEDS_SCOPE == jimp._NEEDS_SCOPE == CONTROL_FLOW
    assert timp.OnnxImporter().needs_scope == CONTROL_FLOW


def test_every_rule_of_this_slice_has_a_case():
    """The 125 rules past the first slice: each has a parity case here,
    the control-flow ones in ``test_torch_onnx_control_flow.py``."""
    covered = {c.rule for c in ELEMENTWISE + REDUCTIONS + CONV + SHAPE
               + RECURRENT + DETECTION} | {r for r, _ in FAULTED}
    covered |= {"ThresholdedRelu", "RandomNormal", "RandomUniform",
                "RandomNormalLike", "RandomUniformLike", "Bernoulli",
                "Multinomial"} | set(REJECTIONS) | CONTROL_FLOW
    rest = set(jimp.ONNX_OP_MAPPERS) - FIRST_SLICE
    assert len(rest) == 125
    assert covered == rest, sorted(covered ^ rest)


# ---------------------------------------------------------------------------
# Whole vision models: a tiny ViT and a two-bottleneck ResNet
# ---------------------------------------------------------------------------

VIT_TINY = dict(layers=2, batch=2, image=32, patch=8, d=64, heads=4, ff=128,
                classes=10)
RESNET_TINY = dict(batch=2, image=32, blocks=(1, 1), width=8, classes=10)
VISION = {
    # each layer's attention onto the flash forward, its six MatMul + Add
    # onto the fused matmul (one with gelu_exact), and the Gemm head's
    # transB=1 product + bias fused too (the kernels' gates refuse the
    # transpose flag, so it runs generic on the card)
    "vit": (lambda: tb.vit_onnx_model(**VIT_TINY), "pixel_values",
            {"attention": 2, "epilogue": 13}),
    "resnet": (lambda: tb.resnet50_onnx_model(**RESNET_TINY), "x",
               {"epilogue": 1}),
}


@pytest.mark.parametrize("name", sorted(VISION))
def test_vision_builder_bytes_are_the_same_on_every_call(name):
    build = VISION[name][0]
    assert build() == build()


def _plan_ops(sd):
    plan = sd._jit_cache[("plan", ("logits",), sd._effective_passes())]
    return [(n.op, n.inputs, sorted(n.kwargs.items()), n.outputs)
            for n in plan.nodes]


@pytest.mark.parametrize("optimize", [True, False], ids=["opt", "noopt"])
@pytest.mark.parametrize("name", sorted(VISION))
def test_vision_model_matches_jax(name, optimize):
    """The logits within 1e-5 of the JAX import's; with the optimizer on,
    the optimized plan equal op for op and the fusions equal, as stated
    in ``VISION``. The ViT's class-token index is a 0-d constant, which
    the port reads as a scalar (ONNX's meaning) and the JAX package as
    shape (1,): its JAX logits keep the token axis, (batch, 1, classes),
    a departure ROADMAP.md records."""
    build, feed, fusions = VISION[name]
    model = build()
    cfg = VIT_TINY if name == "vit" else RESNET_TINY
    feeds = tb.image_feeds(feed, cfg["batch"], cfg["image"])
    jsd = jimp.import_onnx(model, optimize=optimize)
    tsd = timp.import_onnx(model, optimize=optimize, device="cpu")
    want = np.asarray(jsd.output(feeds, ["logits"])["logits"])
    got = tsd.output(feeds, ["logits"])["logits"]
    assert got.shape == (cfg["batch"], cfg["classes"])
    if name == "vit":
        assert want.shape == (cfg["batch"], 1, cfg["classes"])
        want = want[:, 0]
    assert want.shape == got.shape
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    if optimize:
        assert _plan_ops(tsd) == _plan_ops(jsd)
        assert tsd.last_compile_stats.fusions == \
            jsd.last_compile_stats.fusions == fusions
        assert tsd.last_compile_stats.passes == jsd.last_compile_stats.passes
