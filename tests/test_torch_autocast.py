"""The optimizer's opt-in ``autocast`` pass of the port against the JAX
package's (CPU).

The same graph goes through both packages' optimizer with ``passes``
including ``"autocast"``: an MLP with bias + GELU (two fused epilogues),
a ``conv2d`` with a bias, and the tiny imported BERT
(``testing/onnx_builder.bert_onnx_model``). Checked:

* the plans, node for node (ops, inputs, kwargs, outputs: where every
  ``cast`` sits) and the ``autocast_casts`` count, equal to the JAX
  package's;
* the outputs: against the JAX package's autocast outputs to float32
  rounding (1e-5) where XLA rounds every bfloat16 result (a subprocess
  with ``--xla_allow_excess_precision=false``): both generics compute the
  same bfloat16 products in float32 and round each once, then add the
  float32 bias. XLA by default keeps a fused bfloat16 result in float32
  (excess precision), so in this process the JAX outputs differ by the
  rounding the port does: within one bfloat16 unit (2^-7) of the
  output's scale. Against the float32 plan (no autocast) within
  bfloat16 error: 2e-2 relative and 1e-2 absolute (the JAX package's
  own autocast test's bound) — and not bit for bit;
* a node whose result is not float32 (a float64 seed, a float16 matmul)
  is left alone, in both packages;
* the pass is idempotent, and ``check_invariants=True`` accepts its
  plans (the cast-back keeps every interface dtype).
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import optimize as jopt
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.imports import onnx_import as jimp
from deeplearning4j_tpu_torch.autodiff import optimize as topt
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff as TSameDiff
from deeplearning4j_tpu_torch.imports import onnx_import as timp
from deeplearning4j_tpu_torch.testing import onnx_builder as tb

TESTS = pathlib.Path(__file__).resolve().parent
PASSES = topt.PASS_ORDER + ("autocast",)
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=1e-2)
TINY = dict(layers=2, batch=2, seq=16, d=128, heads=2, ff=256, vocab=64)


def _new(pkg, passes=PASSES):
    if pkg == "jax":
        return JSameDiff(optimize_passes=passes)
    return TSameDiff(optimize_passes=passes, device="cpu")


def g_mlp(pkg, passes=PASSES):
    r = np.random.RandomState(3)
    sd = _new(pkg, passes)
    x = sd.placeholder("x", (8, 32))
    w1 = sd.var("w1", (r.randn(32, 64) * 0.2).astype(np.float32))
    b1 = sd.var("b1", (r.randn(64) * 0.1).astype(np.float32))
    w2 = sd.var("w2", (r.randn(64, 16) * 0.2).astype(np.float32))
    b2 = sd.var("b2", (r.randn(16) * 0.1).astype(np.float32))
    h = sd.nn.gelu(x @ w1 + b1)
    sd.nn.softmax(h @ w2 + b2, axis=-1).rename("out")
    return sd, {"x": r.randn(8, 32).astype(np.float32)}, "out"


def g_conv(pkg, passes=PASSES):
    r = np.random.RandomState(5)
    sd = _new(pkg, passes)
    x = sd.placeholder("x", (2, 8, 8, 3))
    w = sd.var("w", (r.randn(3, 3, 3, 4) * 0.3).astype(np.float32))
    b = sd.var("b", (r.randn(4) * 0.1).astype(np.float32))
    sd.nn.relu(sd.cnn.conv2d(x, w, b)).rename("out")
    return sd, {"x": r.randn(2, 8, 8, 3).astype(np.float32)}, "out"


def g_bert(pkg, passes=PASSES):
    model = tb.bert_onnx_model(**TINY)
    sd = jimp.import_onnx(model) if pkg == "jax" else \
        timp.import_onnx(model, device="cpu")
    sd.optimize_passes = passes
    r = np.random.RandomState(1)
    lens = np.array([16, 5])
    feeds = {"ids": r.randint(0, TINY["vocab"], (2, 16)).astype(np.float32),
             "mask": (np.arange(16)[None] < lens[:, None]).astype(
                 np.float32)}
    return sd, feeds, "y"


GRAPHS = {"mlp": (g_mlp, 4), "conv2d": (g_conv, 2), "bert": (g_bert, 26)}


@pytest.fixture(scope="module")
def jax_rounded(tmp_path_factory):
    """The JAX package's autocast outputs of every graph, computed in a
    subprocess where XLA rounds each bfloat16 result as written."""
    path = tmp_path_factory.mktemp("jax") / "out.npz"
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(TESTS)!r}, {str(TESTS.parent)!r}]
        import numpy as np
        import test_torch_autocast as T
        res = {{}}
        for name, (build, _) in T.GRAPHS.items():
            sd, feeds, out = build("jax")
            res[name] = np.asarray(sd.output(feeds, [out])[out])
        np.savez({str(path)!r}, **res)
        """)
    flags = (os.environ.get("XLA_FLAGS", "") +
             " --xla_allow_excess_precision=false").strip()
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   env=dict(os.environ, XLA_FLAGS=flags,
                            JAX_PLATFORMS="cpu"))
    return dict(np.load(path))


def _plan(sd, out):
    return sd._jit_cache[("plan", (out,), sd._effective_passes())]


def _ops(plan):
    return [(n.op, list(n.inputs), sorted(n.kwargs.items()),
             list(n.outputs)) for n in plan.nodes]


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plans_and_outputs_match_jax(graph, jax_rounded):
    build, casts = GRAPHS[graph]
    (jsd, feeds, out), (tsd, _, _) = build("jax"), build("torch")
    want = np.asarray(jsd.output(feeds, [out])[out])
    got = tsd.output(feeds, [out])[out]
    assert _ops(_plan(tsd, out)) == _ops(_plan(jsd, out))
    st, jst = tsd.last_compile_stats, jsd.last_compile_stats
    assert st.fusions == jst.fusions
    assert st.fusions["autocast_casts"] == casts
    assert st.passes == jst.passes and "autocast" in st.passes
    assert st.invariant_checks > 0
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, jax_rounded[graph], **JAX_TOL)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                               atol=2.0 ** -7 * scale)
    # bfloat16 math, float32 interface: within bfloat16 error of the
    # float32 plan, and not equal to it
    f32, _, _ = build("torch", topt.PASS_ORDER)
    ref = f32.output(feeds, [out])[out]
    np.testing.assert_allclose(got, ref, **BF16_TOL)
    assert not np.array_equal(got, ref)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_casts_wrap_every_matmul_and_conv(graph):
    """Every matmul/conv-class node reads bfloat16 casts of its first two
    operands and feeds a float32 cast; no softmax or layer norm reads a
    bfloat16 result."""
    build, _ = GRAPHS[graph]
    tsd, feeds, out = build("torch")
    tsd.output(feeds, [out])
    plan = _plan(tsd, out)
    producer = {o: n for n in plan.nodes for o in n.outputs}
    consumers = {}
    for n in plan.nodes:
        for i in n.inputs:
            consumers.setdefault(i, []).append(n)
    casted = [n for n in plan.nodes if n.op in topt._AUTOCAST_OPS]
    assert casted
    for n in casted:
        for i in n.inputs[:2]:
            p = producer.get(i)
            assert p is not None and p.op == "cast" and \
                p.kwargs["dtype"] == "bfloat16"
        (c,) = consumers[n.outputs[0]]
        assert c.op == "cast" and c.kwargs["dtype"] == "float32"
    for n in plan.nodes:
        if n.op in ("softmax", "layer_norm", "fused_layer_norm"):
            p = producer.get(n.inputs[0])
            assert p is None or p.kwargs.get("dtype") != "bfloat16"


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_matmul_that_is_not_float32_is_left_alone(pkg):
    """With a float64 weight seed (the optimizer's evidence; neither
    package's arrays hold float64 with 64-bit types off) the matmul's
    result is float64 and keeps full precision; a float16 matmul keeps
    its dtype too. Only the float32 node is cast."""
    opt = jopt if pkg == "jax" else topt
    sd = _new(pkg)
    x = sd.placeholder("x", (4, 8))
    w64 = sd.var("w64", np.ones((8, 8), np.float32))
    h16 = sd.placeholder("h16", (4, 8), dtype=np.float16)
    w16 = sd.var("w16", np.ones((8, 8), np.float16))
    w32 = sd.var("w32", np.ones((8, 8), np.float32))
    (x @ w64).rename("y64")
    (h16 @ w16).rename("y16")
    (x @ w32).rename("y32")
    seed = {n: a.dtype for n, a in sd._arrays.items()}
    seed["w64"] = np.float64 if pkg == "jax" else torch.float64
    plan = opt.optimize_graph(sd._nodes, ["y64", "y16", "y32"],
                              const_env={}, seed_dtypes=seed,
                              var_shapes={n: tuple(a.shape) for n, a in
                                          sd._arrays.items()},
                              passes=("autocast",), check_invariants=True,
                              input_avals=sd._input_avals())
    casts = [n for n in plan.nodes if n.op == "cast"]
    assert plan.stats.fusions == {"autocast_casts": 2}
    assert sorted(c.inputs[0] for c in casts if
                  c.kwargs["dtype"] == "bfloat16") == ["w32", "x"]
    mm = {n.outputs[0]: n for n in plan.nodes if n.op == "mmul"}
    assert mm["y64"].inputs == ["x", "w64"]
    assert mm["y16"].inputs == ["h16", "w16"]


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_the_pass_is_idempotent(graph):
    build, _ = GRAPHS[graph]
    tsd, feeds, out = build("torch")
    tsd.output(feeds, [out])
    plan = _plan(tsd, out)
    consts = dict(tsd._arrays)
    consts.update(plan.extra_consts)
    again = topt.optimize_graph(
        plan.nodes, [out], const_env=consts,
        seed_dtypes={n: a.dtype for n, a in consts.items()},
        var_shapes={n: tuple(a.shape) for n, a in consts.items()},
        passes=("autocast",), check_invariants=True)
    assert _ops(again) == _ops(plan)
    assert "autocast_casts" not in again.stats.fusions


def test_the_environment_switch_is_not_read(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_AUTOCAST", "bf16")
    tsd, feeds, out = g_mlp("torch", None)
    tsd.output(feeds, [out])
    assert "autocast_casts" not in tsd.last_compile_stats.fusions
    assert "autocast" not in tsd.last_compile_stats.passes
