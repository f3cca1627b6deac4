"""The port's SameDiff and graph optimizer against the JAX package (CPU).

The same graph is built through both packages' SameDiff API (one builder,
two classes) from the same numpy arrays, and run with the optimizer on
and off. Checked:

* outputs: float32 within 1e-5 relative and absolute — the same ops on
  the same numbers, summed in another order by another library;
* the optimized plans: the same op list, node for node, the same per-pass
  node deltas and the same fusion counts — the port's matchers must decide
  exactly as the JAX matchers do. This covers the redundant graph of
  ``bench.py``'s ``_bench_graph_compile``, the attention and epilogue
  fusion fixtures of ``tests/test_optimizer_fusion.py`` with their
  negative variants, a ``(None, 128)`` placeholder (symbolic batch dims)
  and ``layer_norm`` → ``gelu``, where ``_try_layernorm`` fires;
* the evidence the matchers read (``_abstract_avals``: every tensor's
  symbolic shape and dtype) equal to the JAX package's;
* the optimizer's dtype promotion table against ``jnp.promote_types``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.environment import environment as jenvironment
from deeplearning4j_tpu_torch.analysis import broadcast as tbroadcast
from deeplearning4j_tpu_torch.analysis.values import as_dtype
from deeplearning4j_tpu_torch.autodiff import optimize as topt
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff as TSameDiff
from deeplearning4j_tpu_torch.environment import environment

B, H, T, HD = 2, 2, 8, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _new(pkg, optimize=True):
    if pkg == "jax":
        return JSameDiff(optimize=optimize)
    return TSameDiff(optimize=optimize, device="cpu")


def _plan(sd, outputs):
    return sd._jit_cache[("plan", tuple(outputs), sd._effective_passes())]


def _plan_ops(sd, outputs):
    return [(n.op, sorted(n.kwargs)) for n in _plan(sd, outputs).nodes]


# ----------------------------------------------------------------- graphs


def g_mlp(pkg, optimize):
    r = np.random.RandomState(0)
    sd = _new(pkg, optimize)
    x = sd.placeholder("x", (4, 32))
    w1 = sd.var("w1", (r.randn(32, 64) * 0.2).astype(np.float32))
    b1 = sd.var("b1", (r.randn(64) * 0.1).astype(np.float32))
    w2 = sd.var("w2", (r.randn(64, 16) * 0.2).astype(np.float32))
    h = sd.nn.relu(x @ w1 + b1)
    h = sd.math.tanh(h @ w2)
    p = sd.nn.softmax(h, axis=-1)
    (p.mean(1, keepdims=True) - p.max(1, keepdims=True)).rename("stat")
    p.rename("out")
    feeds = {"x": r.randn(4, 32)}  # float64: canonicalized to float32
    return sd, feeds, ("out", "stat")


def g_shapes(pkg, optimize):
    """Shape, indexing and reduction ops of the catalog."""
    r = np.random.RandomState(1)
    sd = _new(pkg, optimize)
    x = sd.placeholder("x", (2, 3, 4))
    ids = sd.placeholder("ids", (5,), dtype=np.int32)
    table = sd.var("table", r.randn(7, 4).astype(np.float32))
    e = sd.op("gather", table, ids, axis=0)                     # (5, 4)
    t = x.transpose(2, 0, 1).reshape(4, 6)                       # (4, 6)
    c = sd.op("concat", t, sd.op("tile", t, reps=(1, 1)), axis=1)
    d = sd.op("expand_dims", c, axis=0)
    s = sd.op("squeeze", d, axis=0)
    sq = sd.op("strided_slice", s, begin=[0, 1], end=[4, 12],
               strides=[2, 3])
    z = sd.op("slice", s, begin=[1, 2], size=[2, 5])
    red = z.sum(1) + sd.op("reduce_prod", z, axes=[0]).sum()
    sd.op("cast", red, dtype="int32").rename("as_int")
    (e.sum(0) * 2.0 - 1.0).rename("emb")
    sd.op("pad", sq, paddings=((1, 0), (0, 2)), value=-1.0).rename("pad")
    (sd.op("argmax", s, axis=-1) + 0).rename("arg")
    sd.op("cumsum", s, axis=1, exclusive=True, reverse=True).rename("cum")
    feeds = {"x": r.randn(2, 3, 4).astype(np.float32),
             "ids": np.array([0, 6, 3, -1, 2], np.int32)}
    return sd, feeds, ("as_int", "emb", "pad", "arg", "cum")


def g_attention(pkg, optimize, scale_variant="div_scores", mask="float",
                share_probs=False, transpose_b=False):
    """The importer-shaped attention chain of tests/test_optimizer_fusion.py."""
    r = np.random.RandomState(0)
    sd = _new(pkg, optimize)
    q = sd.placeholder("q", (B, H, T, HD))
    k = sd.placeholder("k", (B, H, T, HD))
    v = sd.placeholder("v", (B, H, T, HD))
    m = sd.placeholder("m", (B, 1, 1, T),
                       dtype=np.int32 if mask == "int" else np.float32)
    one = sd.constant("one", np.float32(1.0))
    neg = sd.constant("neg", np.float32(-10000.0))
    scale = sd.constant("scale", np.float32(np.sqrt(HD)))
    inv_scale = sd.constant("inv_scale", np.float32(1.0 / np.sqrt(HD)))
    if transpose_b:
        scores = sd._record("mmul", [q, k], {"transpose_b": True})
    else:
        kt = sd._record("transpose", [k], {"axes": (0, 1, 3, 2)})
        scores = sd._record("mmul", [q, kt])
    scaled = {"div_scores": lambda: scores / scale,
              "mul_scores": lambda: scores * inv_scale,
              "wrong_side": lambda: scores * scale,
              "none": lambda: scores}[scale_variant]()
    if mask != "off":
        scaled = scaled + (one - m) * neg
    probs = sd.nn.softmax(scaled, axis=-1)
    outs = ("out",)
    if share_probs:
        sd._record("reduce_sum", [probs]).rename("probs_sum")
        outs = ("out", "probs_sum")
    sd._record("mmul", [probs, v]).rename("out")
    feeds = {"q": r.randn(B, H, T, HD).astype(np.float32),
             "k": r.randn(B, H, T, HD).astype(np.float32),
             "v": r.randn(B, H, T, HD).astype(np.float32),
             "m": (r.rand(B, 1, 1, T) > 0.2).astype(
                 np.int32 if mask == "int" else np.float32)}
    return sd, feeds, outs


def g_epilogue(pkg, optimize, act="none", share_mm=False):
    r = np.random.RandomState(1)
    sd = _new(pkg, optimize)
    x = sd.placeholder("x", (4, 16))
    w = sd.var("w", (r.randn(16, 8) * 0.2).astype(np.float32))
    b = sd.var("b", (r.randn(8) * 0.1).astype(np.float32))
    mm = x @ w
    h = mm + b
    if act == "erf_gelu":
        inv = sd.constant("sqrt2", np.float32(np.sqrt(2.0)))
        one = sd.constant("one1", np.float32(1.0))
        half = sd.constant("half", np.float32(0.5))
        e = sd.math.erf(h / inv) + one
        h = (h * e) * half
    elif act != "none":
        h = {"relu": sd.nn.relu, "tanh": sd.math.tanh,
             "gelu": sd.nn.gelu}[act](h)
    h.rename("out")
    outs = ("out",)
    if share_mm:
        (mm * 2.0).rename("mm2")
        outs = ("out", "mm2")
    return sd, {"x": r.randn(4, 16).astype(np.float32)}, outs


def g_symbolic_batch(pkg, optimize):
    """A (None, 128) placeholder: the epilogue still fuses."""
    r = np.random.RandomState(2)
    sd = _new(pkg, optimize)
    x = sd.placeholder("x", (None, 128))
    w = sd.var("w", (r.randn(128, 128) * 0.05).astype(np.float32))
    b = sd.var("b", np.zeros(128, np.float32))
    sd.nn.gelu(x @ w + b).rename("out")
    return sd, {"x": r.randn(6, 128).astype(np.float32)}, ("out",)


def g_layernorm_gelu(pkg, optimize):
    """layer_norm → gelu: _try_layernorm emits fused_layer_norm."""
    r = np.random.RandomState(3)
    sd = _new(pkg, optimize)
    x = sd.placeholder("x", (2, 5, 64))
    g = sd.var("g", (1.0 + 0.1 * r.randn(64)).astype(np.float32))
    b = sd.var("b", (0.1 * r.randn(64)).astype(np.float32))
    sd.nn.gelu(sd.op("layer_norm", x, g, b, eps=1e-5)).rename("out")
    return sd, {"x": r.randn(2, 5, 64).astype(np.float32)}, ("out",)


def g_redundant(pkg, optimize, layers=3, width=128, batch=4):
    """bench.py's _bench_graph_compile graph: per-layer duplicated
    subexpressions, foldable constant chains, identity/transpose no-ops
    and dead branches."""
    r = np.random.RandomState(0)
    sd = _new(pkg, optimize)
    h = sd.placeholder("x", (batch, width))
    for i in range(layers):
        w = sd.var(f"w{i}", r.randn(width, width).astype(np.float32) * 0.05)
        b = sd.var(f"b{i}", np.zeros(width, np.float32))
        c = sd.constant(f"c{i}", np.float32(width))
        scale = sd.math.sqrt(c)
        pre = (h @ w + b) / scale
        t1 = sd.math.tanh(pre)
        t2 = sd.math.tanh(pre)
        g = sd.nn.sigmoid(t1 + t2)
        g = sd.op("identity", g) * 1.0 + 0.0
        g = g.transpose(1, 0).transpose(1, 0)
        _dead = sd.math.exp(pre) @ w
        h = g
    h.sum().rename("out")
    feeds = {"x": np.random.RandomState(1).randn(batch, width)
             .astype(np.float32)}
    return sd, feeds, ("out",)


GRAPHS = {
    "mlp": g_mlp,
    "shapes": g_shapes,
    "attention_div": g_attention,
    "attention_mul": lambda p, o: g_attention(p, o, "mul_scores"),
    "attention_noscale": lambda p, o: g_attention(p, o, "none"),
    "attention_transpose_b": lambda p, o: g_attention(p, o,
                                                      transpose_b=True),
    "attention_nomask": lambda p, o: g_attention(p, o, mask="off"),
    "attention_wrong_side": lambda p, o: g_attention(p, o, "wrong_side"),
    "attention_int_mask": lambda p, o: g_attention(p, o, mask="int"),
    "attention_shared_probs": lambda p, o: g_attention(p, o,
                                                       share_probs=True),
    "epilogue_none": g_epilogue,
    "epilogue_relu": lambda p, o: g_epilogue(p, o, "relu"),
    "epilogue_tanh": lambda p, o: g_epilogue(p, o, "tanh"),
    "epilogue_gelu": lambda p, o: g_epilogue(p, o, "gelu"),
    "epilogue_erf_gelu": lambda p, o: g_epilogue(p, o, "erf_gelu"),
    "epilogue_shared_mm": lambda p, o: g_epilogue(p, o, share_mm=True),
    "symbolic_batch": g_symbolic_batch,
    "layernorm_gelu": g_layernorm_gelu,
    "redundant": g_redundant,
}


@pytest.fixture
def generic_jax():
    """Pin the JAX side to its generic ops (the Pallas helpers register
    under "tpu" only, so this changes nothing on the CPU but states it)."""
    env = jenvironment()
    prev = env.helper_mode
    env.helper_mode = "xla"
    yield
    env.helper_mode = prev


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_outputs_and_plans_match_jax(name, generic_jax):
    build = GRAPHS[name]
    got, want = {}, {}
    for optimize in (False, True):
        jsd, feeds, outs = build("jax", optimize)
        tsd, _, _ = build("torch", optimize)
        want[optimize] = jsd.output(feeds, list(outs))
        got[optimize] = tsd.output(feeds, list(outs))
        for o in outs:
            assert got[optimize][o].dtype == want[optimize][o].dtype, o
            assert got[optimize][o].shape == want[optimize][o].shape, o
            np.testing.assert_allclose(got[optimize][o], want[optimize][o],
                                       err_msg=f"{name}/{o}", **TOL)
    assert _plan_ops(tsd, outs) == _plan_ops(jsd, outs)
    ts, js = tsd.last_compile_stats, jsd.last_compile_stats
    assert ts.fusions == js.fusions
    assert ts.passes == js.passes
    assert (ts.nodes_before, ts.nodes_after, ts.invariant_checks) == \
        (js.nodes_before, js.nodes_after, js.invariant_checks)


def test_fusion_counts_of_the_fixtures():
    """What the matchers decide, spelled out (both packages agree on it by
    the test above)."""
    want = {"attention_div": {"attention": 1},
            "attention_wrong_side": {},
            "attention_int_mask": {},
            "attention_shared_probs": {},
            "epilogue_erf_gelu": {"epilogue": 1},
            "epilogue_shared_mm": {},
            "symbolic_batch": {"epilogue": 1},
            "layernorm_gelu": {"layernorm": 1},
            "redundant": {"epilogue": 3}}
    for name, fusions in want.items():
        sd, feeds, outs = GRAPHS[name]("torch", True)
        sd.output(feeds, list(outs))
        assert sd.last_compile_stats.fusions == fusions, name
    sd, feeds, outs = g_layernorm_gelu("torch", True)
    sd.output(feeds, list(outs))
    ops = [op for op, _ in _plan_ops(sd, outs)]
    assert ops == ["fused_layer_norm"]
    assert _plan(sd, outs).nodes[0].kwargs["activation"] == "gelu"


def test_symbolic_batch_plan_runs_at_any_batch():
    sd, _, _ = g_symbolic_batch("torch", True)
    r = np.random.RandomState(5)
    for batch in (1, 3, 8):
        x = r.randn(batch, 128).astype(np.float32)
        out = sd.output({"x": x}, ["out"])["out"]
        ref = torch.nn.functional.gelu(
            torch.from_numpy(x) @ torch.from_numpy(sd.get_arr("w"))
            + torch.from_numpy(sd.get_arr("b")), approximate="tanh")
        np.testing.assert_allclose(out, ref.numpy(), **TOL)
    assert sd.last_compile_stats.fusions == {"epilogue": 1}


def test_env_fusion_opt_out_and_plan_rebuild(monkeypatch):
    """The port reads no environment switch: DL4J_TPU_FUSION=0 leaves the
    plan fused, and the opt-out is the explicit ``optimize_passes``."""
    sd, feeds, outs = g_attention("torch", True)
    on = sd.output(feeds, list(outs))["out"]
    assert "dot_product_attention" in [o for o, _ in _plan_ops(sd, outs)]
    monkeypatch.setenv("DL4J_TPU_FUSION", "0")
    monkeypatch.setenv("DL4J_TPU_CHECK_PASSES", "0")
    sd.output(feeds, list(outs))
    assert "dot_product_attention" in [o for o, _ in _plan_ops(sd, outs)]
    assert sd.last_compile_stats.invariant_checks > 0
    sd.optimize_passes = tuple(p for p in topt.PASS_ORDER if p != "fusion")
    off = sd.output(feeds, list(outs))["out"]
    assert "dot_product_attention" not in [o for o, _ in _plan_ops(sd, outs)]
    np.testing.assert_allclose(on, off, **TOL)


def test_autocast_is_refused_not_ignored(monkeypatch):
    """``autocast`` is asked for by name in ``passes=`` (it is ported:
    tests/test_torch_autocast.py); the JAX package's environment switch
    is not read, and an unknown pass name raises."""
    sd, feeds, outs = g_epilogue("torch", True)
    with pytest.raises(ValueError, match="unknown optimizer pass"):
        topt.optimize_graph(sd._nodes, ["out"], const_env={},
                            passes=("dce", "autocast_bf16"))
    monkeypatch.setenv("DL4J_TPU_AUTOCAST", "bf16")
    sd.output(feeds, list(outs))  # the environment is not read
    assert "autocast_casts" not in sd.last_compile_stats.fusions
    sd.optimize_passes = topt.PASS_ORDER + ("autocast",)
    sd.output(feeds, list(outs))
    assert sd.last_compile_stats.fusions["autocast_casts"] == 2


def test_validate_is_refused_not_ignored():
    """``SameDiff(validate=True)`` checks the subgraph an output set runs
    before running it, in both packages: a clean graph runs and keeps its
    report; a matmul whose contraction cannot agree raises GraphCheckError
    with the JAX package's GC002 at the same node, and ``check()`` gives
    the same findings without raising."""
    from deeplearning4j_tpu.analysis import GraphCheckError as JErr
    from deeplearning4j_tpu_torch.analysis import GraphCheckError as TErr

    reports = []
    for SD, kw, err in ((JSameDiff, {}, JErr),
                        (TSameDiff, {"device": "cpu"}, TErr)):
        sd = SD(validate=True, **kw)
        x = sd.placeholder("x", (None, 4))
        w = sd.var("w", np.ones((4, 3), np.float32))
        x.mmul(w).rename("y")
        sd.output({"x": np.ones((2, 4), np.float32)}, ["y"])
        assert sd.last_check_report.ok
        v = sd.var("v", np.ones((5, 2), np.float32))
        sd._vars["y"].mmul(v).rename("z")
        with pytest.raises(err) as exc:
            sd.output({"x": np.ones((2, 4), np.float32)}, ["z"])
        reports.append(([(f.rule, f.line) for f in exc.value.findings],
                        [(f.rule, f.line) for f in sd.check().findings]))
    assert reports[1] == reports[0]
    assert reports[0][0][0][0] == "GC002"


def test_constant_rebind_and_graph_mutation_invalidate_the_plan():
    sd = TSameDiff(device="cpu")
    x = sd.placeholder("x", (3,))
    c = sd.constant("c", np.float32([1.0, 2.0, 3.0]))
    (x * sd.math.sqrt(c)).rename("out")
    feeds = {"x": np.ones(3, np.float32)}
    np.testing.assert_allclose(sd.output(feeds, ["out"])["out"],
                               np.sqrt([1.0, 2.0, 3.0]), **TOL)
    sd.set_arr("c", np.float32([4.0, 9.0, 16.0]))
    np.testing.assert_allclose(sd.output(feeds, ["out"])["out"],
                               [2.0, 3.0, 4.0], **TOL)
    (sd.get_variable("out") + 1.0).rename("out2")
    np.testing.assert_allclose(sd.output(feeds, ["out2"])["out2"],
                               [3.0, 4.0, 5.0], **TOL)
    assert sd.summary().startswith("SameDiff:")
    assert {"x", "c", "out", "out2"} <= set(sd.variables())


def test_feeds_and_constants_are_canonicalized_to_32_bits():
    sd = TSameDiff(device="cpu")
    x = sd.placeholder("x", (2,))
    k = sd.constant("k", np.arange(2))                 # int64 → int32
    f = sd.constant("f", np.float64(0.5))              # float64 → float32
    (x * f + sd.op("cast", k, dtype="int64")).rename("out")
    assert sd._arrays["k"].dtype == torch.int32
    assert sd._arrays["f"].dtype == torch.float32
    out = sd.output({"x": np.array([1.0, 2.0])}, ["out"])["out"]
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, [0.5, 2.0])


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default resolves to it")
    with pytest.raises(RuntimeError, match="cuda"):
        TSameDiff()
    assert environment().helper_mode == "auto"


def test_promotion_table_is_jax_promote_types():
    names = ["bool", "uint8", "uint16", "uint32", "uint64", "int8", "int16",
             "int32", "int64", "bfloat16", "float16", "float32", "float64",
             "complex64", "complex128"]
    for a in names:
        for b in names:
            want = np.dtype(jnp.promote_types(jnp.dtype(a), jnp.dtype(b)))
            got = tbroadcast.promote_types(as_dtype(a), as_dtype(b))
            assert got == as_dtype(want.name), (a, b, got, want)


def _avals_of(sd, outs, opt_mod):
    """The fusion matchers' evidence for the reachable recording: every
    name's (shape with symbolic dims by name, dtype name)."""
    nodes = sd._needed_nodes(list(outs))
    const_env = sd._const_env()
    avals = opt_mod._abstract_avals(
        nodes, dict(const_env),
        {n: tuple(a.shape) for n, a in sd._arrays.items()},
        {n: a.dtype for n, a in sd._arrays.items()},
        sd._input_avals(), sd._local_ops)

    def dt(d):
        return None if d is None else str(d).replace("torch.", "")

    return {k: (None if a.shape is None else tuple(
        str(d) if not isinstance(d, int) else d for d in a.shape),
        dt(a.dtype)) for k, a in avals.items()}


@pytest.mark.parametrize("name", ["mlp", "shapes", "attention_div",
                                  "attention_int_mask", "epilogue_erf_gelu",
                                  "symbolic_batch", "layernorm_gelu",
                                  "redundant"])
def test_matcher_evidence_matches_jax(name):
    """The shape/dtype evidence the matchers read (``_abstract_avals``) is
    the JAX package's for every tensor of the graph, symbolic batch dims
    included."""
    from deeplearning4j_tpu.autodiff import optimize as jopt

    jsd, _, outs = GRAPHS[name]("jax", True)
    tsd, _, _ = GRAPHS[name]("torch", True)
    want = _avals_of(jsd, outs, jopt)
    got = _avals_of(tsd, outs, topt)
    assert got == want


def _bf16_matmul(sd_cls, **kw):
    """A bfloat16 placeholder ``mmul`` a bfloat16 variable, 4×8 · 8×3."""
    import ml_dtypes

    r = np.random.RandomState(12)
    sd = sd_cls(**kw)
    x = sd.placeholder("x", (4, 8), ml_dtypes.bfloat16)
    w = sd.var("w", r.randn(8, 3).astype(ml_dtypes.bfloat16))
    x.mmul(w).rename("y")
    return sd, {"x": r.randn(4, 8).astype(ml_dtypes.bfloat16)}


def test_bfloat16_output_comes_back_bfloat16():
    """A bfloat16 result of ``output`` is an ``ml_dtypes.bfloat16`` numpy
    array, as the JAX package returns it, within one bfloat16 unit
    (relative to the largest value) of the JAX result."""
    jsd, feeds = _bf16_matmul(JSameDiff)
    tsd, _ = _bf16_matmul(TSameDiff, device="cpu")
    want = np.asarray(jsd.output(feeds, ["y"])["y"])
    got = tsd.output(feeds, ["y"])["y"]
    assert str(want.dtype) == str(got.dtype) == "bfloat16"
    want32 = want.astype(np.float32)
    np.testing.assert_allclose(got.astype(np.float32), want32, rtol=0,
                               atol=2.0 ** -7 * np.abs(want32).max())
    assert str(tsd.get_arr("w").dtype) == "bfloat16"


def test_bfloat16_output_is_float32_without_ml_dtypes(monkeypatch):
    """Where ``ml_dtypes`` cannot be imported, a bfloat16 result comes
    back upcast to float32, exactly; float16 never needs it."""
    import sys

    from deeplearning4j_tpu_torch.nn.dtype import host_array

    tsd, feeds = _bf16_matmul(TSameDiff, device="cpu")
    with_ml = tsd.output(feeds, ["y"])["y"]
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # import fails
    got = tsd.output(feeds, ["y"])["y"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, with_ml.astype(np.float32))
    half = torch.tensor([1.5, -2.25], dtype=torch.float16)
    assert host_array(half).dtype == np.float16
