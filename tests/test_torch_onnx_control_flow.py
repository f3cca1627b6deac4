"""ONNX control flow and the JAX package's ONNX golden graphs, through
both importers (CPU).

* ``If``, ``Loop`` and ``Scan`` lower onto SameDiff's ``cond_multi``,
  ``while_loop_multi`` and ``scan_multi``, outer-scope tensors captured by
  name. Every golden test of the JAX package's
  ``tests/test_onnx_import.py`` and ``tests/test_onnx_control_flow.py``
  that imports a graph runs here again with its ``import_onnx`` swapped
  for one that imports the same bytes into both packages, with the
  optimizer on and off: each ``output`` the golden test reads is held to
  the port's (dtype and shape equal, float32 within 1e-4 relative +
  1e-5 absolute: the goldens' convolutions and recurrences sum in
  another order), the golden's own oracle then checks the JAX values,
  and a graph the JAX importer refuses must be refused by the port with
  the same error class.
* The port's ``graph_proto`` / ``graph_attr`` / ``node_with_graph_attrs``
  write the JAX control-flow tests' bytes.
* The imported LSTM's weight gradients against the JAX package's
  ``calculate_gradients`` (``jax.grad``) through the recorded gate
  re-packing.
* A graph whose while loop or conditional reads its predicate on the host
  runs eagerly by rule (``nn.compiled.CONTROL_FLOW``); a Scan-only graph
  is captured like any other.
"""

import inspect

import numpy as np
import pytest

import deeplearning4j_tpu.imports as jimports
from deeplearning4j_tpu.imports import onnx_import as jimp
from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.imports import onnx_import as timp
from deeplearning4j_tpu_torch.nn.compiled import CONTROL_FLOW, SEEDED_RANDOM
from deeplearning4j_tpu_torch.testing import onnx_builder as tb
from tests import test_onnx_control_flow as jcf
from tests import test_onnx_import as jgold

TOL = dict(rtol=1e-4, atol=1e-5)


class _Both:
    """The JAX SameDiff of an import, with the port's import of the same
    bytes beside it: ``output`` runs both and holds the port's results to
    the JAX ones before returning the JAX ones; anything else is the JAX
    SameDiff's."""

    compared = 0

    def __init__(self, jsd, tsd):
        self._j, self._t = jsd, tsd

    def output(self, feeds, outputs):
        want = self._j.output(feeds, outputs)
        got = self._t.output(feeds, outputs)
        # random draws cannot equal jax.random's: shape and dtype only
        drawn = any(n.op.startswith("onnx_random") for n in self._j._nodes)
        for k, w in want.items():
            w, g = np.asarray(w), got[k]
            assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype,
                                                               w.dtype)
            if drawn:
                continue
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, err_msg=k, **TOL)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
        _Both.compared += 1
        return want

    def __getattr__(self, name):
        return getattr(self._j, name)


def _both_importer(optimize):
    def import_onnx(model, *args, **kwargs):
        try:
            jsd = jimp.import_onnx(model, optimize=optimize)
        except Exception as e:
            with pytest.raises(type(e)):
                timp.import_onnx(model, optimize=optimize, device="cpu")
            raise
        return _Both(jsd, timp.import_onnx(model, optimize=optimize,
                                           device="cpu"))
    return import_onnx


def _goldens():
    """(id, bound method factory, kwargs) of every JAX golden test that
    imports a graph."""
    out = []
    for mod in (jgold, jcf):
        for cname, cls in sorted(vars(mod).items()):
            if not (inspect.isclass(cls) and cname.startswith("Test")):
                continue
            for mname, fn in sorted(vars(cls).items()):
                if not mname.startswith("test_") or \
                        "import_onnx" not in inspect.getsource(fn):
                    continue
                marks = [m for m in getattr(fn, "pytestmark", [])
                         if m.name == "parametrize"]
                if marks:
                    names = [n.strip() for n in marks[0].args[0].split(",")]
                    for vals in marks[0].args[1]:
                        out.append((f"{cname}.{mname}[{vals}]", cls, mname,
                                    dict(zip(names, vals))))
                else:
                    out.append((f"{cname}.{mname}", cls, mname, {}))
    return out


GOLDENS = _goldens()


@pytest.mark.parametrize("optimize", [True, False], ids=["opt", "noopt"])
@pytest.mark.parametrize("gid, cls, method, kw", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_jax_golden_graph_through_both_importers(gid, cls, method, kw,
                                                 optimize, monkeypatch):
    imp = _both_importer(optimize)
    for mod in (jgold, jcf, jimports):
        if hasattr(mod, "import_onnx"):
            monkeypatch.setattr(mod, "import_onnx", imp)
    before = _Both.compared
    getattr(cls(), method)(**kw)
    src = inspect.getsource(getattr(cls, method))
    if "raises" not in src and ".output(" in src:
        assert _Both.compared > before  # the port's outputs were held


def test_goldens_cover_the_control_flow_and_import_tests():
    ids = {g[0].split("[")[0] for g in GOLDENS}
    assert {"TestOnnxLoop.test_for_loop_with_capture",
            "TestOnnxLoop.test_while_loop_runtime_cond",
            "TestOnnxLoop.test_loop_scan_outputs_static_m",
            "TestOnnxIf.test_then_branch", "TestOnnxIf.test_else_branch",
            "TestOnnxScan.test_reverse_direction",
            "TestOnnxIfDifferingCaptures."
            "test_branches_capture_different_outer_tensors",
            "TestOnnxImport.test_cnn_golden_vs_torch",
            "TestOnnxRecurrentAndResize.test_lstm_forward"} <= ids
    assert len(GOLDENS) >= 35


# ---------------------------------------------------------------------------
# builder helpers
# ---------------------------------------------------------------------------


def test_builder_control_flow_helpers_equal_the_jax_test_helpers():
    body = [tb.node_proto("Add", ["x_in", "step"], ["x_out"]),
            tb.node_proto("Identity", ["cond_in"], ["cond_out"])]
    args = (body, [("iter", ()), ("cond_in", ()), ("x_in", (2,))],
            [("cond_out", ()), ("x_out", (2,))],
            {"one": np.float32([1.0, 2.0])})
    g = tb.graph_proto(*args, name="b")
    assert g == jcf.graph_proto(*args, name="b")
    assert tb.graph_attr("body", g) == jcf.graph_attr("body", g)
    assert tb.node_with_graph_attrs(
        "Loop", ["M", "", "x0"], ["x_final"], {"body": g}, name="L",
        num_scan_inputs=1) == jcf.node_with_graph_attrs(
            "Loop", ["M", "", "x0"], ["x_final"], {"body": g}, name="L",
            num_scan_inputs=1)


# ---------------------------------------------------------------------------
# more control flow: a runtime trip count, a nested loop's capture, the
# scan-output Loop with a runtime M refused
# ---------------------------------------------------------------------------


def _loop_model(m_init, with_scan):
    body_nodes = [tb.node_proto("Identity", ["cond_in"], ["cond_out"]),
                  tb.node_proto("Mul", ["x_in", "k"], ["x_out"])]
    body_outs = [("cond_out", ()), ("x_out", (2,))]
    if with_scan:
        body_nodes.append(tb.node_proto("Cast", ["it"], ["emit"], to=1))
        body_outs.append(("emit", ()))
    body = tb.graph_proto(body_nodes, [("it", ()), ("cond_in", ()),
                                       ("x_in", (2,))], body_outs)
    outs = ["x_final"] + (["trace"] if with_scan else [])
    nodes = [tb.node_proto("Add", ["k0", "k0"], ["k"]),
             tb.node_with_graph_attrs("Loop", ["M", "", "x0"], outs,
                                      {"body": body})]
    feeds = {"x0": np.float32([1.0, -2.0])}
    init = {"k0": np.float32([0.75, 0.5])}
    inputs = [("x0", (2,))]
    if m_init:
        init["M"] = np.int64(3)
    else:
        inputs.append(("M", ()))
        feeds["M"] = np.int64(3)
    return tb.build_model(nodes, inputs, [(o, (1,)) for o in outs],
                          init), feeds, outs


def test_loop_with_a_runtime_trip_count():
    model, feeds, outs = _loop_model(m_init=False, with_scan=False)
    want = np.asarray(jimp.import_onnx(model).output(feeds, outs)["x_final"])
    got = timp.import_onnx(model, device="cpu").output(feeds, outs)[
        "x_final"]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, feeds["x0"] * np.float32([1.5, 1.0]) ** 3,
                               rtol=1e-6)


def test_loop_scan_outputs_need_a_constant_trip_count():
    model, feeds, outs = _loop_model(m_init=True, with_scan=True)
    got = timp.import_onnx(model, device="cpu").output(feeds, outs)
    want = jimp.import_onnx(model).output(feeds, outs)
    for o in outs:
        np.testing.assert_allclose(got[o], np.asarray(want[o]), **TOL)
    np.testing.assert_array_equal(got["trace"], [0.0, 1.0, 2.0])
    model, _, _ = _loop_model(m_init=False, with_scan=True)
    for imp, kw in ((jimp, {}), (timp, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="constant trip count"):
            imp.import_onnx(model, **kw)


def test_nested_loop_captures_through_both_levels():
    """An inner Loop's body reads a tensor of the outermost graph: the
    outer body captures it for the inner one."""
    inner = tb.graph_proto(
        [tb.node_proto("Identity", ["c2"], ["c2o"]),
         tb.node_proto("Add", ["y_in", "step"], ["y_out"])],
        [("j", ()), ("c2", ()), ("y_in", (2,))],
        [("c2o", ()), ("y_out", (2,))], name="inner")
    outer = tb.graph_proto(
        [tb.node_proto("Identity", ["c1"], ["c1o"]),
         tb.node_with_graph_attrs("Loop", ["M2", "", "x_in"], ["x_out"],
                                  {"body": inner})],
        [("i", ()), ("c1", ()), ("x_in", (2,))],
        [("c1o", ()), ("x_out", (2,))], name="outer")
    model = tb.build_model(
        [tb.node_proto("Mul", ["s", "s"], ["step"]),
         tb.node_with_graph_attrs("Loop", ["M", "", "x0"], ["x_final"],
                                  {"body": outer})],
        [("x0", (2,))], [("x_final", (2,))],
        {"M": np.int64(2), "M2": np.int64(3), "s": np.float32([0.5, 2.0])})
    feeds = {"x0": np.float32([1.0, 1.0])}
    got = timp.import_onnx(model, device="cpu").output(feeds, ["x_final"])
    want = jimp.import_onnx(model).output(feeds, ["x_final"])
    np.testing.assert_allclose(got["x_final"], np.asarray(want["x_final"]),
                               **TOL)
    np.testing.assert_allclose(got["x_final"], [2.5, 25.0], rtol=1e-6)


# ---------------------------------------------------------------------------
# gradients through an imported LSTM
# ---------------------------------------------------------------------------


def test_lstm_weight_gradients_match_jax():
    """The gate re-packing is recorded over the imported W, R, B, so their
    gradients reach the originals: the port's ``calculate_gradients``
    against the JAX package's (``jax.grad``), 1e-5 relative + 1e-6
    absolute."""
    r = np.random.RandomState(3)
    t, n, i, h = 3, 2, 3, 4
    init = {"W": r.randn(1, 4 * h, i).astype(np.float32),
            "R": r.randn(1, 4 * h, h).astype(np.float32),
            "B": r.randn(1, 8 * h).astype(np.float32)}
    model = tb.build_model(
        [tb.node_proto("LSTM", ["x", "W", "R", "B"], ["Y", "Y_h", "Y_c"],
                       hidden_size=h)], [("x", (t, n, i))],
        [("Y", (t, 1, n, h))], init)
    x = r.randn(t, n, i).astype(np.float32)
    grads = []
    for sd in (jimp.import_onnx(model),
               timp.import_onnx(model, device="cpu")):
        assert sd._vars["W"].vtype == "VARIABLE"
        sq = sd._record("mul", [sd._vars["Y"], sd._vars["Y_c"]])
        sd._record("reduce_mean", [sq], {"axes": None, "keepdims": False}
                   ).rename("loss")
        grads.append(sd.calculate_gradients({"x": x}, "loss",
                                            wrt=["W", "R", "B"]))
    for k in ("W", "R", "B"):
        want = np.asarray(grads[0][k])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(grads[1][k], want, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# routing: host-read predicates run eagerly, a Scan graph is captured
# ---------------------------------------------------------------------------


def _scan_over(body_nodes):
    """Scan(s0, xs) over a body (s_in, x_el) → (s_out, y_el) of
    ``body_nodes``, which write ``s_out``; ``y_el`` is ``s_out``."""
    body = tb.graph_proto(
        list(body_nodes) + [tb.node_proto("Identity", ["s_out"], ["y_el"])],
        [("s_in", (2,)), ("x_el", (2,))], [("s_out", (2,)), ("y_el", (2,))])
    return tb.build_model(
        [tb.node_with_graph_attrs("Scan", ["s0", "xs"], ["s_final", "ys"],
                                  {"body": body}, num_scan_inputs=1)],
        [("s0", (2,)), ("xs", (4, 2))], [("ys", (4, 2))], {})


def test_a_scan_inherits_its_bodys_routing():
    """A Scan whose body holds an If (a host read) routes to eager by the
    control-flow rule, and one whose body draws a seeded random node by
    ``SEEDED_RANDOM``: a capture of the scan would hold the read or the
    seeding inside it. The If body's outputs equal the JAX import's, and
    the random body's draws repeat run to run."""
    then_g = tb.graph_proto([tb.node_proto("Add", ["s_in", "x_el"],
                                           ["z_then"])],
                            [], [("z_then", (2,))], name="then")
    else_g = tb.graph_proto([tb.node_proto("Sub", ["s_in", "x_el"],
                                           ["z_else"])],
                            [], [("z_else", (2,))], name="else")
    if_body = [
        tb.node_proto("ReduceSum", ["x_el"], ["rs"], keepdims=0),
        tb.node_proto("Cast", ["rs"], ["pred"], to=9),
        tb.node_with_graph_attrs("If", ["pred"], ["s_out"],
                                 {"then_branch": then_g,
                                  "else_branch": else_g})]
    random_body = [
        tb.node_proto("RandomNormalLike", ["x_el"], ["n"], seed=4.0),
        tb.node_proto("Add", ["s_in", "n"], ["s_out"])]
    feeds = {"s0": np.zeros(2, np.float32),
             "xs": np.float32([[1, 1], [0, 0], [-1, 3], [2, -2]])}
    for body, reason in ((if_body, CONTROL_FLOW),
                         (random_body, SEEDED_RANDOM)):
        model = _scan_over(body)
        observe.reset()
        sd = timp.import_onnx(model, device="cpu")
        got = sd.output(feeds, ["ys"])["ys"]
        assert sd._routing(("ys",)) == reason
        assert [(e.graph, e.key, e.reason)
                for e in observe.ledger().routed_events()] == [
            ("samediff", "exec", reason)]
        if reason == CONTROL_FLOW:
            want = np.asarray(jimp.import_onnx(model).output(
                feeds, ["ys"])["ys"])
            np.testing.assert_allclose(got, want, rtol=0, atol=0)
        else:
            np.testing.assert_array_equal(
                sd.output(feeds, ["ys"])["ys"], got)


def test_if_and_loop_graphs_route_to_eager_scan_graphs_do_not():
    cases = {
        "if": (jcf.TestOnnxIf()._model(), {"x": np.float32([1.0, 2.0])},
               "y"),
        "loop": (_loop_model(m_init=True, with_scan=False)[:2] + ("x_final",)),
        "scan": None,
    }
    body = tb.graph_proto(
        [tb.node_proto("Add", ["s_in", "x_el"], ["s_out"]),
         tb.node_proto("Identity", ["s_out"], ["y_el"])],
        [("s_in", (2,)), ("x_el", (2,))], [("s_out", (2,)), ("y_el", (2,))])
    cases["scan"] = (tb.build_model(
        [tb.node_with_graph_attrs("Scan", ["s0", "xs"], ["s_final", "ys"],
                                  {"body": body}, num_scan_inputs=1)],
        [("s0", (2,)), ("xs", (5, 2))], [("ys", (5, 2))], {}),
        {"s0": np.zeros(2, np.float32),
         "xs": np.ones((5, 2), np.float32)}, "ys")
    for label, (model, feeds, out) in cases.items():
        observe.reset()
        sd = timp.import_onnx(model, device="cpu")
        sd.output(feeds, [out])
        routed = observe.ledger().routed_events()
        if label == "scan":
            assert sd._routing((out,)) is None and routed == ()
        else:
            assert sd._routing((out,)) == CONTROL_FLOW
            assert [(e.graph, e.key, e.reason) for e in routed] == [
                ("samediff", "exec", CONTROL_FLOW)], label
