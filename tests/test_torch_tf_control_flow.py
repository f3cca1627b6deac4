"""Control flow: SameDiff's six methods and the TF importers' loops and
conditionals, the port against the JAX package (CPU).

* ``scan``, ``while_loop``, ``while_loop_multi``, ``scan_multi``,
  ``cond_multi`` and ``cond`` recorded through both packages' SameDiff
  with the same user functions (one definition over ``jnp`` or ``torch``):
  outputs within 1e-5 × max(1, max |JAX|), dtypes equal, both branches of
  each conditional, a zero-trip loop; ``scan``'s and ``scan_multi``'s
  gradients against ``jax.grad``'s; a body that changes a carry's dtype
  raises in both.
* The JAX package's ``TestTfControlFlow`` (functional While/If, nested,
  two-slot outputs) and ``TestTf1FrameControlFlow`` (lowered frames,
  frameless conds, a nested cond) graphs through both importers, against
  each other and TF.
* Routing: a graph holding a while loop or a conditional runs eagerly by
  rule — ``sd.output`` records one routed ledger event a signature and
  counts ``dl4j_tpu_capture_skipped_total{unit="exec",reason}`` a call and
  captures nothing; ``calculate_gradients`` and ``fit`` route their
  training units the same way; a graph holding only a scan is not routed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.imports import TensorflowImporter as JImporter
from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.autodiff import TrainingConfig
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.imports import TensorflowImporter
from deeplearning4j_tpu_torch.nn.compiled import CONTROL_FLOW
from deeplearning4j_tpu_torch.nn.updater import Sgd

torch.backends.cuda.matmul.allow_tf32 = False
REL = 1e-5


def assert_port(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (
        port.shape, port.dtype, ref.shape, ref.dtype)
    if ref.dtype.kind == "f":
        scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
        np.testing.assert_allclose(port, ref, rtol=0, atol=REL * scale)
    else:
        np.testing.assert_array_equal(port, ref)


def both_sd():
    """(port SameDiff on the CPU, its namespace), (JAX SameDiff, jnp)."""
    return ((SameDiff.create(device="cpu"), torch),
            (JSameDiff.create(), jnp))


# ---------------------------------------------------------------------------
# SameDiff's control-flow methods
# ---------------------------------------------------------------------------

XS = np.random.RandomState(0).randn(5, 3).astype(np.float32)


def _scan(sd, ops):
    xs = sd.var("xs", XS)
    ys = sd.scan(lambda c, x: (c * 0.9 + ops.tanh(x), c * x + ops.sin(x)),
                 np.zeros(3, np.float32), xs).rename("ys")
    ys.sum().rename("loss")
    return ["ys"], {}


def _while_loop(sd, ops):
    x = sd.placeholder("x", (3,))
    sd.while_loop(lambda v: v.sum() < 50.0, lambda v: v * 1.5 + 1.0,
                  x).rename("y")
    return ["y"], {"x": np.float32([1.0, 2.0, 0.5])}


def _while_loop_zero_trips(sd, ops):
    x = sd.placeholder("x", (3,))
    sd.while_loop(lambda v: v.sum() < 0.0, lambda v: v * 2.0, x).rename("y")
    return ["y"], {"x": np.float32([1.0, 2.0, 0.5])}


def _while_loop_multi(sd, ops):
    i = sd.constant("i0", np.int32(0))
    x = sd.placeholder("x", (3,))
    i_out, v_out = sd.while_loop_multi(
        lambda c: c[0] < 4, lambda c: (c[0] + 1, c[1] * 1.1 + c[0]), [i, x])
    i_out.rename("i")
    v_out.rename("v")
    return ["i", "v"], {"x": np.float32([1.0, -2.0, 3.0])}


def _scan_multi(sd, ops):
    c0 = sd.placeholder("c0", (3,))
    a = sd.var("a", XS)
    b = sd.var("b", XS[::-1].copy())

    def fn(carry, xs):
        (c,), (x, y) = carry, xs
        nc = c * 0.5 + x * y
        return (nc,), (nc + 1.0, ops.tanh(nc) * y)

    out = sd.scan_multi(fn, [c0], [a, b], n_ys=2)
    for v, n in zip(out, ("c", "y1", "y2")):
        v.rename(n)
    (out[0].sum() + out[1].sum() + out[2].sum()).rename("loss")
    cnt = sd.scan_multi(lambda carry, _: ((carry[0] * 2.0,), (carry[0],)),
                        [c0], [], n_ys=1, length=3)
    cnt[0].rename("c_len")
    cnt[1].rename("y_len")
    return ["c", "y1", "y2", "c_len", "y_len"], {
        "c0": np.float32([0.5, -1.0, 2.0])}


def _cond_multi(sd, ops):
    p = sd.placeholder("p", ())
    a = sd.placeholder("a", (3,))
    b = sd.placeholder("b", (3,))
    o1, o2 = sd.cond_multi(p, lambda x, y: (x + y, x * y),
                           lambda x, y: (x - y, x / y), [a, b], n_out=2)
    o1.rename("o1")
    o2.rename("o2")
    return ["o1", "o2"], {"a": np.float32([1.0, 2.0, 3.0]),
                          "b": np.float32([0.5, -4.0, 2.0])}


def _cond(sd, ops):
    p = sd.placeholder("p", ())
    x = sd.placeholder("x", (3,))
    sd.cond(p, lambda v: v * 2.0 + 1.0, lambda v: -v, x).rename("y")
    return ["y"], {"x": np.float32([1.0, -2.0, 3.0])}


CASES = {"scan": _scan, "while_loop": _while_loop,
         "while_loop_zero_trips": _while_loop_zero_trips,
         "while_loop_multi": _while_loop_multi, "scan_multi": _scan_multi,
         "cond_multi": _cond_multi, "cond": _cond}


@pytest.mark.parametrize("case", sorted(CASES))
def test_samediff_control_flow_against_jax(case):
    outs = []
    for sd, ops in both_sd():
        fetch, feeds = CASES[case](sd, ops)
        preds = ([{"p": np.float32(1.0)}, {"p": np.float32(0.0)}]
                 if "p" in sd._vars else [{}])
        outs.append([sd.output({**feeds, **p}, fetch) for p in preds])
    for port, ref in zip(*outs):
        assert sorted(port) == sorted(ref)
        for k in ref:
            assert_port(port[k], ref[k])


@pytest.mark.parametrize("case", ["scan", "scan_multi"])
def test_scan_gradients_against_jax(case):
    grads = []
    for sd, ops in both_sd():
        _, feeds = CASES[case](sd, ops)
        wrt = [n for n, v in sd._vars.items() if v.vtype == "VARIABLE"]
        grads.append(sd.calculate_gradients(feeds, "loss", wrt=wrt))
    assert sorted(grads[0]) == sorted(grads[1])
    for k in grads[1]:
        assert np.abs(grads[1][k]).max() > 0
        assert_port(grads[0][k], grads[1][k])


def test_while_body_changing_a_carry_dtype_raises():
    for sd, ops, err in ((SameDiff.create(device="cpu"), torch, TypeError),
                         (JSameDiff.create(), jnp, TypeError)):
        x = sd.placeholder("x", (2,))
        sd.while_loop(lambda v: v.sum() < 10.0,
                      lambda v: (v * 2.0).astype(jnp.int32) if ops is jnp
                      else (v * 2.0).to(torch.int32), x).rename("y")
        with pytest.raises(err):
            sd.output({"x": np.float32([1.0, 2.0])}, "y")


# ---------------------------------------------------------------------------
# the JAX package's TF control-flow graphs, through both importers
# ---------------------------------------------------------------------------


def freeze(fn, *specs, lower_control_flow=True):
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    cf = tf.function(fn).get_concrete_function(*specs)
    frozen = convert_variables_to_constants_v2(
        cf, lower_control_flow=lower_control_flow)
    return (frozen.graph.as_graph_def(),
            [t.name.split(":")[0] for t in frozen.inputs],
            [t.name.split(":")[0] for t in frozen.outputs])


def _w_counter(x):
    def cond(i, x):
        return i < 5

    def body(i, x):
        return i + 1, x * 1.5 + 1.0

    return tf.while_loop(cond, body, [tf.constant(0), x])[1]


def _w_data(x):
    return tf.while_loop(lambda v: tf.reduce_sum(v) < 100.0,
                         lambda v: (v * 2.0,), [x])[0]


def _c_sum(x):
    return tf.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0 + 1.0, lambda: -x)


def _nested_while_in_cond(x):
    def loop():
        return tf.while_loop(lambda i, v: i < 3, lambda i, v: (i + 1, v + v),
                             [tf.constant(0), x])[1]

    return tf.cond(tf.reduce_sum(x) > 0.0, loop, lambda: x)


def _two_slots(x):
    i, y = tf.while_loop(lambda i, v: i < 4, lambda i, v: (i + 1, v * 1.1),
                         [tf.constant(0), x])
    return tf.cast(i, tf.float32) + tf.reduce_sum(y)


def _c_multi_capture(x, y):
    return tf.cond(tf.reduce_mean(x) > tf.reduce_mean(y),
                   lambda: x - y, lambda: x * y + 3.0)


def _matmul_body(x):
    m = tf.constant(np.array([[0.9, 0.1], [0.2, 0.7]], np.float32))
    return tf.while_loop(lambda i, v: i < 4,
                         lambda i, v: (i + 1, tf.linalg.matvec(m, v)),
                         [tf.constant(0), x])[1]


def _nested_cond(x):
    return tf.cond(tf.reduce_sum(x) > 0.0,
                   lambda: tf.cond(tf.reduce_max(x) > 5.0,
                                   lambda: x + 100.0, lambda: x + 1.0),
                   lambda: -x)


def _single_var(x):
    return tf.while_loop(lambda v: tf.reduce_sum(v) < 10.0,
                         lambda v: (v * 2.0,), [x])[0]


_V = tf.TensorSpec
R = np.random.RandomState(0)
TF_CASES = {
    # (model, specs, feed sets)
    "while_loop_golden": (_w_counter, [_V([4], tf.float32)],
                          [[np.float32([1.0, -2.0, 0.5, 3.0])]]),
    "while_data_dependent_trip_count": (
        _w_data, [_V([3], tf.float32)],
        [[s * np.float32([1.0, 2.0, 3.0])] for s in (1.0, 7.0)]),
    "cond_both_branches": (
        _c_sum, [_V([4], tf.float32)],
        [[s * np.arange(1.0, 5.0, dtype=np.float32)] for s in (1.0, -1.0)]),
    "nested_while_in_cond": (
        _nested_while_in_cond, [_V([2], tf.float32)],
        [[s * np.float32([1.0, 2.0])] for s in (1.0, -1.0)]),
    "while_multi_output_slots": (_two_slots, [_V([3], tf.float32)],
                                 [[np.float32([1.0, 2.0, 3.0])]]),
    "cond_multi_capture": (
        _c_multi_capture, [_V([3], tf.float32), _V([3], tf.float32)],
        [[R.randn(3).astype(np.float32), R.randn(3).astype(np.float32)]
         for _ in range(3)]),
    "while_matmul_body": (_matmul_body, [_V([2], tf.float32)],
                          [[np.float32([1.0, 2.0])]]),
    "nested_cond": (_nested_cond, [_V([2], tf.float32)],
                    [[np.float32(v)] for v in ([1.0, 2.0], [1.0, 9.0],
                                               [-1.0, -2.0])]),
    "single_var_while_keeps_shape": (_single_var, [_V([3], tf.float32)],
                                     [[np.float32([1.0, 0.5, 0.25])]]),
}
# TestTfControlFlow freezes these functionally; TestTf1FrameControlFlow
# lowered into TF1 frames (TF's default)
FUNCTIONAL = ("while_loop_golden", "while_data_dependent_trip_count",
              "cond_both_branches", "nested_while_in_cond",
              "while_multi_output_slots", "single_var_while_keeps_shape")
LOWERED = ("while_loop_golden", "while_data_dependent_trip_count",
           "cond_both_branches", "cond_multi_capture", "while_matmul_body",
           "nested_cond", "single_var_while_keeps_shape")


@pytest.mark.parametrize("case,lowered",
                         [(c, False) for c in FUNCTIONAL]
                         + [(c, True) for c in LOWERED])
def test_tf_control_flow_graph_both_importers(case, lowered):
    model, specs, feed_sets = TF_CASES[case]
    gd, ins, outs = freeze(model, *specs, lower_control_flow=lowered)
    ops = {n.op for n in gd.node}
    if lowered:
        assert ops & {"Enter", "Switch"}
        assert not ops & {"While", "StatelessWhile", "If", "StatelessIf"}
    else:
        assert ops & {"While", "StatelessWhile", "If", "StatelessIf"}
    data = gd.SerializeToString()
    psd = TensorflowImporter(device="cpu").run_import(data)
    jsd = JImporter().run_import(data)
    for feeds in feed_sets:
        golden = model(*[tf.constant(f) for f in feeds]).numpy()
        fd = dict(zip(ins, feeds))
        port = psd.output(fd, outs[0])[outs[0]]
        assert_port(port, jsd.output(fd, outs[0])[outs[0]])
        assert port.shape == golden.shape
        np.testing.assert_allclose(port, golden, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _skipped(unit):
    return observe.metrics().counter("dl4j_tpu_capture_skipped_total",
                                     unit=unit, reason=CONTROL_FLOW).value


def test_while_graph_output_routed_to_eager_once():
    observe.reset()
    sd = SameDiff.create(device="cpu")
    x = sd.placeholder("x", (3,))
    sd.while_loop(lambda v: v.sum() < 100.0, lambda v: v * 2.0,
                  x).rename("y")
    for scale in (1.0, 7.0, 1.0):
        y = sd.output({"x": scale * np.float32([1, 2, 3])}, "y")["y"]
        assert y.sum() >= 100.0
    routed = observe.ledger().routed_events()
    assert [(e.graph, e.key, e.signature, e.reason) for e in routed] == [
        ("samediff", "exec", "x:float32[3]", CONTROL_FLOW)]
    assert _skipped("exec") == 3.0
    (fn,) = [f for k, f in sd._jit_cache.items() if k[0] == "compiled"]
    assert fn.eager_reason == CONTROL_FLOW and fn.unit.captures == 0
    causes = [(e.key, e.cause) for e in observe.ledger().events()
              if e.graph == "samediff"]
    assert causes == [("exec", "first_compile")]


def test_cond_graph_training_units_routed():
    observe.reset()
    sd = SameDiff.create(device="cpu")
    x = sd.placeholder("x", (4, 3))
    p = sd.placeholder("p", ())
    w = sd.var("w", np.full((3, 2), 0.1, np.float32))
    h = sd.cond(p, lambda v: v * 2.0, lambda v: v - 1.0, x @ w)
    lab = sd.placeholder("labels", (4, 2))
    sd.loss.mean_squared_error(h, lab).rename("loss")
    feeds = {"x": np.ones((4, 3), np.float32), "p": np.float32(1.0),
             "labels": np.zeros((4, 2), np.float32)}
    g = sd.calculate_gradients(feeds, "loss")
    # h = 2·x@w = 0.6 everywhere; d mean(h²)/dw = 4 rows · 2 · 2h / 8
    np.testing.assert_allclose(g["w"], np.full((3, 2), 1.2, np.float32),
                               rtol=1e-6)
    sd.set_training_config(TrainingConfig(
        updater=Sgd(learning_rate=0.1), loss_variables=["loss"]))
    sd._init_updater_state()
    sd._train_step("loss", ["w"], {k: torch.as_tensor(v)
                                   for k, v in feeds.items()})
    reasons = {(e.key, e.reason) for e in observe.ledger().routed_events()}
    assert reasons == {("grad", CONTROL_FLOW), ("train", CONTROL_FLOW)}
    assert _skipped("grad") == 1.0 and _skipped("train") == 1.0


def test_scan_graph_is_not_routed():
    observe.reset()
    sd = SameDiff.create(device="cpu")
    _scan(sd, torch)
    sd.output({}, "ys")
    assert sd._routing(("ys",)) is None
    assert observe.ledger().routed_events() == ()


@pytest.mark.parametrize("method", ["scan", "while_loop", "while_loop_multi",
                                    "scan_multi", "cond_multi", "cond"])
def test_control_flow_signature_equals_jax(method):
    import inspect

    def params(cls):
        sig = inspect.signature(getattr(cls, method))
        return [(p.name, p.kind, p.default) for p in sig.parameters.values()]

    assert params(SameDiff) == params(JSameDiff)
