"""The imported-graph path of the PyTorch port against the JAX package
(CPU): ONNX bytes → ``import_onnx`` → SameDiff → optimizer → output.

* The port's ONNX builder (a copy, on the port's wire codec) writes the
  JAX builder's bytes, byte for byte, and the port's decoder reads them as
  the JAX decoder does.
* A tiny BERT (2 layers, d 128, 2 heads, ff 256, batch 2 × 16, ragged
  mask) through both packages: ``y`` within 1e-5 relative and absolute,
  optimizer on and off (float32: the same ops on the same numbers in
  another summation order); the optimized plan equal op for op (79 nodes,
  12 epilogue and 2 attention fusions).
* Every other mapped rule (Gemm with flags and scales, Relu, Tanh,
  Sigmoid, Gelu, LayerNormalization, Constant, Flatten, Concat, Squeeze)
  in one small graph, against the JAX import.
* An op without a rule raises at import; ``validate=True`` raises.
* No module of the port, nor ``chip_smoke.py``, names JAX or the JAX
  package in an import or a dotted module path.
"""

import pathlib
import re

import numpy as np
import pytest

from deeplearning4j_tpu.imports import onnx_import as jimp
from deeplearning4j_tpu.testing import onnx_builder as jb
from deeplearning4j_tpu_torch.imports import onnx_import as timp
from deeplearning4j_tpu_torch.testing import onnx_builder as tb

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(layers=2, batch=2, seq=16, d=128, heads=2, ff=256, vocab=64)
TOL = dict(rtol=1e-5, atol=1e-5)


def _tiny_feeds(seed=1):
    r = np.random.RandomState(seed)
    lens = np.array([16, 5])  # ragged, end-padded; no row fully masked
    return {"ids": r.randint(0, TINY["vocab"], (2, 16)).astype(np.float32),
            "mask": (np.arange(16)[None] < lens[:, None]).astype(
                np.float32)}


def _plan(sd, outputs=("y",)):
    return sd._jit_cache[("plan", tuple(outputs), sd._effective_passes())]


@pytest.fixture(scope="module")
def tiny_bytes():
    return tb.bert_onnx_model(**TINY)


def test_builder_bytes_equal_the_jax_builders():
    for cfg in (TINY, dict(layers=1, batch=1, seq=8, d=64, heads=4, ff=96,
                           vocab=30, seed=3)):
        assert tb.bert_onnx_model(**cfg) == jb.bert_onnx_model(**cfg)
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.int64([2, 3]), np.int32(7), np.uint8([1, 2])]
    for a in arrays:
        assert tb.tensor_proto("t", a) == jb.tensor_proto("t", a)
    for v in (1.5, 3, "s", np.ones(2, np.float32), [1.0, 2.0], [1, 2]):
        assert tb.attr_proto("a", v) == jb.attr_proto("a", v)
    assert tb.node_proto("Add", ["a", "b"], ["c"], axis=1) == \
        jb.node_proto("Add", ["a", "b"], ["c"], axis=1)
    assert tb.value_info("x", (2, 3)) == jb.value_info("x", (2, 3))


def test_decoder_reads_what_the_jax_decoder_reads(tiny_bytes):
    t, j = timp.parse_model(tiny_bytes), jimp.parse_model(tiny_bytes)
    assert [(n.name, n.op_type, n.inputs, n.outputs) for n in t.nodes] == \
        [(n.name, n.op_type, n.inputs, n.outputs) for n in j.nodes]
    assert [n.attrs.keys() for n in t.nodes] == [n.attrs.keys()
                                                 for n in j.nodes]
    assert t.inputs == j.inputs and t.outputs == j.outputs
    assert sorted(t.initializers) == sorted(j.initializers)
    for k, v in t.initializers.items():
        assert v.dtype == j.initializers[k].dtype
        np.testing.assert_array_equal(v, j.initializers[k])


@pytest.mark.parametrize("optimize", [True, False])
def test_tiny_bert_output_matches_jax(tiny_bytes, optimize):
    feeds = _tiny_feeds()
    want = jimp.import_onnx(tiny_bytes, optimize=optimize).output(
        feeds, ["y"])["y"]
    sd = timp.import_onnx(tiny_bytes, optimize=optimize, device="cpu")
    got = sd.output(feeds, ["y"])["y"]
    assert got.shape == want.shape == (2, 16, 2)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **TOL)


def test_tiny_bert_plan_equals_the_jax_plan(tiny_bytes):
    feeds = _tiny_feeds()
    jsd = jimp.import_onnx(tiny_bytes)
    jsd.output(feeds, ["y"])
    tsd = timp.import_onnx(tiny_bytes, device="cpu")
    tsd.output(feeds, ["y"])
    assert len(tsd._nodes) == len(jsd._nodes) == 128

    def ops(sd):
        return [(n.op, n.inputs, sorted(n.kwargs.items()), n.outputs)
                for n in _plan(sd).nodes]

    assert ops(tsd) == ops(jsd)
    st = tsd.last_compile_stats
    assert (st.nodes_before, st.nodes_after) == (128, 79)
    assert st.fusions == {"attention": 2, "epilogue": 12}
    assert st.passes == jsd.last_compile_stats.passes
    acts = [n.kwargs["activation"] for n in _plan(tsd).nodes
            if n.op == "fused_matmul_bias_act"]
    assert acts.count("gelu_exact") == 2 and acts.count("none") == 10
    assert sorted(_plan(tsd).extra_consts) == sorted(_plan(jsd).extra_consts)


def _rules_model():
    """Every mapped rule outside the BERT graph, in one small graph."""
    r = np.random.RandomState(4)
    init = {"w": (r.randn(6, 8) * 0.3).astype(np.float32),
            "wt": (r.randn(8, 6) * 0.3).astype(np.float32),
            "c": (r.randn(8) * 0.1).astype(np.float32),
            "g": (1 + 0.1 * r.randn(8)).astype(np.float32),
            "beta": (0.1 * r.randn(8)).astype(np.float32),
            "sq_axes": np.int64([1])}
    nodes = [
        tb.node_proto("Gemm", ["x", "w", "c"], ["g1"], alpha=0.5, beta=2.0),
        tb.node_proto("Gemm", ["x", "wt", "c"], ["g2"], transB=1),
        tb.node_proto("Relu", ["g1"], ["r"]),
        tb.node_proto("Tanh", ["g2"], ["t"]),
        tb.node_proto("Sigmoid", ["r"], ["s"]),
        tb.node_proto("Gelu", ["t"], ["ge"], approximate="none"),
        tb.node_proto("Concat", ["s", "ge"], ["cat"], axis=1),
        tb.node_proto("Constant", [], ["k"],
                      value=np.full((1, 16), 0.25, np.float32)),
        tb.node_proto("Mul", ["cat", "k"], ["catk"]),
        tb.node_proto("Flatten", ["catk"], ["fl"], axis=1),
        tb.node_proto("LayerNormalization", ["g1", "g", "beta"], ["ln"],
                      epsilon=1e-5),
        tb.node_proto("Unsqueeze", ["ln"], ["lnu"], axes=[1]),
        tb.node_proto("Squeeze", ["lnu", "sq_axes"], ["lns"]),
        tb.node_proto("Add", ["lns", "t"], ["y2"]),
    ]
    return tb.build_model(nodes, [("x", (4, 6))],
                          [("fl", (4, 16)), ("y2", (4, 8))], init)


@pytest.mark.parametrize("optimize", [True, False])
def test_every_mapped_rule_matches_jax(optimize):
    model = _rules_model()
    x = np.random.RandomState(5).randn(4, 6).astype(np.float32)
    jsd = jimp.import_onnx(model, optimize=optimize)
    tsd = timp.import_onnx(model, optimize=optimize, device="cpu")
    for out in ("fl", "y2"):
        want = jsd.output({"x": x}, [out])[out]
        got = tsd.output({"x": x}, [out])[out]
        np.testing.assert_allclose(got, want, err_msg=out, **TOL)
    if optimize:
        assert tsd.last_compile_stats.fusions == \
            jsd.last_compile_stats.fusions


def test_an_unmapped_op_raises_at_import():
    model = tb.build_model(
        [tb.node_proto("Conv", ["x", "w"], ["y"])], [("x", (1, 1, 4, 4))],
        [("y", (1, 1, 4, 4))], {"w": np.ones((1, 1, 1, 1), np.float32)})
    with pytest.raises(NotImplementedError, match="Conv"):
        timp.import_onnx(model, device="cpu")


def test_validate_raises(tiny_bytes):
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        timp.import_onnx(tiny_bytes, validate=True, device="cpu")


def test_the_port_names_no_jax_module():
    files = sorted((REPO / "deeplearning4j_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = re.compile(r"^\s*(import jax|from jax)|deeplearning4j_tpu\.[a-z_]",
                     re.M)
    hits = [(f.relative_to(REPO).as_posix(), m.group(0))
            for f in files for m in bad.finditer(f.read_text())]
    assert len(files) > 40 and hits == []
