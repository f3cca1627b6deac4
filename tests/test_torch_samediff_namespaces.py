"""SameDiff's op namespaces in the port against the JAX package's (CPU).

* Every public method of the JAX package's ``SDMath``, ``SDNN``,
  ``SDCNN``, ``SDRNN``, ``SDLoss``, ``SDImage``, ``SDLinalg``,
  ``SDBitwise`` and ``SDRandom`` exists in the port with the same
  parameters (names, kinds and defaults).
* Each method in a one-node graph in both packages on the same inputs:
  the outputs' dtypes and shapes equal, values within 1e-5 relative and
  1e-6 absolute (gelu's tanh form and the special functions 2e-5); the
  factorizations free up to signs (``qr``, ``svd``) by reconstruction and
  orthogonality; the random draws by shape, bounds and the same seed
  giving the same draw (the two packages' streams differ).
* The ``sd_namespaces`` encoder of chip_smoke at 2 layers and width 64
  (``testing/namespace_encoder.py``, one builder for both packages'
  SameDiff, the same weights): ``output`` (logits 1e-5 relative to their
  largest magnitude) and one ``fit`` step with Adam: the loss within 1e-5
  relative, every parameter within 1e-5 of its leaf's largest magnitude.
"""

import inspect

import numpy as np
import pytest

from deeplearning4j_tpu.autodiff import samediff as JS
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu_torch.autodiff import samediff as TS
from deeplearning4j_tpu_torch.nn.updater import Adam as TAdam
from deeplearning4j_tpu_torch.testing import namespace_encoder as ne

NAMESPACES = ("SDMath", "SDNN", "SDCNN", "SDRNN", "SDLoss", "SDImage",
              "SDLinalg", "SDBitwise", "SDRandom")
ATTR = {"SDMath": "math", "SDNN": "nn", "SDCNN": "cnn", "SDRNN": "rnn",
        "SDLoss": "loss", "SDImage": "image", "SDLinalg": "linalg",
        "SDBitwise": "bitwise", "SDRandom": "random"}


def _methods(cls):
    return sorted(n for n, f in vars(cls).items()
                  if callable(f) and not n.startswith("_"))


_ALL = [(ns, m) for ns in NAMESPACES for m in _methods(getattr(JS, ns))]


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("ns,method", _ALL,
                         ids=[f"{a}.{b}" for a, b in _ALL])
def test_method_exists_with_the_same_parameters(ns, method):
    jfn = getattr(getattr(JS, ns), method)
    tfn = getattr(getattr(TS, ns), method, None)
    assert tfn is not None, f"port {ns} has no {method}"
    assert _params(tfn) == _params(jfn)


# ---------------------------------------------------------------------------
# each method in a one-node graph
# ---------------------------------------------------------------------------

_R = np.random.RandomState(5)


def _f(*shape, lo=None, hi=None):
    a = _R.randn(*shape).astype(np.float32)
    if lo is not None:
        a = (lo + (hi - lo) * _R.rand(*shape)).astype(np.float32)
    return a


def _spd(n):
    a = _f(n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


_X = _f(3, 5)
_POS = _f(3, 5, lo=0.2, hi=3.0)
_IMG = _f(2, 6, 6, 3, lo=0.0, hi=1.0)
_INTS = _R.randint(-(1 << 31), (1 << 31) - 1, (3, 4)).astype(np.int32)
_INTS2 = _R.randint(-(1 << 31), (1 << 31) - 1, (3, 4)).astype(np.int32)
_ONEHOT = np.eye(5, dtype=np.float32)[[0, 3, 1]]
_BOXES = np.concatenate([_f(8, 2, lo=0.0, hi=0.6),
                         _f(8, 2, lo=0.0, hi=0.6) + 0.35], 1)

# (namespace, method) -> (array inputs, extra positional args, kwargs)
CASES = {
    ("SDMath", "max"): ([_X, _f(3, 5)], (), {}),
    ("SDMath", "min"): ([_X, _f(3, 5)], (), {}),
    ("SDMath", "clip_by_value"): ([_X], (-0.5, 0.7), {}),
    ("SDMath", "cast"): ([_X * 4], ("int32",), {}),
    ("SDNN", "leaky_relu"): ([_X], (0.2,), {}),
    ("SDNN", "softmax"): ([_X], (0,), {}),
    ("SDNN", "log_softmax"): ([_X], (), {}),
    ("SDNN", "linear"): ([_X, _f(5, 4), _f(4)], (), {}),
    ("SDNN", "layer_norm"): ([_X, _f(5), _f(5)], (), {}),
    ("SDNN", "batch_norm"): ([_X, _f(5), _POS[0], _f(5), _f(5)], (), {}),
    ("SDNN", "dropout"): ([_X], (0.3,), {}),
    ("SDNN", "dot_product_attention"): ([_f(2, 4, 8), _f(2, 6, 8),
                                         _f(2, 6, 8)], (), {}),
    ("SDNN", "multi_head_dot_product_attention"): (
        [_f(2, 4, 8), _f(2, 6, 8), _f(2, 6, 8)] + [_f(8, 8) for _ in range(4)],
        (2,), {}),
    ("SDCNN", "conv2d"): ([_IMG, _f(3, 3, 3, 4), _f(4)], (),
                          {"stride": 2, "padding": "same"}),
    ("SDCNN", "max_pooling2d"): ([_IMG], (), {"kernel": 2}),
    ("SDCNN", "avg_pooling2d"): ([_IMG], (), {"kernel": 3, "stride": 2,
                                             "padding": "same"}),
    ("SDCNN", "upsampling2d"): ([_IMG], (), {"size": 2}),
    ("SDRNN", "lstm_cell"): ([_f(3, 4), _f(3, 5), _f(3, 5), _f(4, 20),
                              _f(5, 20), _f(20)], (), {}),
    ("SDRNN", "gru_cell"): ([_f(3, 4), _f(3, 5), _f(4, 15), _f(5, 15),
                             _f(15), _f(15)], (), {}),
    ("SDLoss", "softmax_cross_entropy"): ([_X, _ONEHOT], (), {}),
    ("SDLoss", "sparse_softmax_cross_entropy"): (
        [_X, np.asarray([0, 4, 2], np.int32)], (), {}),
    ("SDLoss", "sigmoid_cross_entropy"): ([_X, (_X > 0).astype(np.float32)],
                                          (), {}),
    ("SDLoss", "mean_squared_error"): ([_X, _f(3, 5)], (), {}),
    ("SDLoss", "absolute_difference"): ([_X, _f(3, 5)], (), {}),
    ("SDLoss", "log_loss"): ([_f(3, 5, lo=0.05, hi=0.95),
                              (_X > 0).astype(np.float32)], (), {}),
    ("SDLoss", "huber_loss"): ([_X, _f(3, 5)], (0.5,), {}),
    ("SDImage", "resize_bilinear"): ([_IMG], (4, 9), {}),
    ("SDImage", "resize_nearest_neighbor"): ([_IMG], (9, 4), {}),
    ("SDImage", "resize_bicubic"): ([_IMG], (5, 7), {}),
    ("SDImage", "crop_and_resize"): (
        [_IMG, np.asarray([[0.1, 0.2, 0.8, 0.7], [0.0, 0.0, 1.0, 0.5]],
                          np.float32), np.asarray([1, 0], np.int32)],
        ((3, 4),), {}),
    ("SDImage", "non_max_suppression"): ([_BOXES, _f(8, lo=0.0, hi=1.0)],
                                         (4, 0.4), {}),
    ("SDImage", "adjust_contrast"): ([_IMG], (1.5,), {}),
    ("SDImage", "adjust_hue"): ([_IMG], (0.2,), {}),
    ("SDImage", "adjust_saturation"): ([_IMG], (0.5,), {}),
    ("SDImage", "rgb_to_hsv"): ([_IMG], (), {}),
    ("SDImage", "hsv_to_rgb"): ([_IMG], (), {}),
    ("SDLinalg", "cholesky"): ([_spd(4)], (), {}),
    ("SDLinalg", "qr"): ([_f(5, 3)], (), {}),
    ("SDLinalg", "svd"): ([_f(4, 3)], (), {}),
    ("SDLinalg", "solve"): ([_spd(4), _f(4, 2)], (), {}),
    ("SDLinalg", "triangular_solve"): (
        [(np.tril(_f(4, 4)) + 4 * np.eye(4)).astype(np.float32), _f(4, 2)],
        (), {"adjoint": True}),
    ("SDLinalg", "lu"): ([_f(4, 4)], (), {}),
    ("SDLinalg", "matrix_determinant"): ([_f(3, 3)], (), {}),
    ("SDLinalg", "matrix_inverse"): ([_spd(3)], (), {}),
    ("SDLinalg", "matrix_band_part"): ([_f(4, 5)], (1, 0), {}),
    ("SDLinalg", "diag"): ([_f(2, 3)], (), {}),
    ("SDBitwise", "left_shift"): ([_INTS], (3,), {}),
    ("SDBitwise", "right_shift"): ([_INTS], (5,), {}),
    ("SDBitwise", "left_shift_cyclic"): ([_INTS], (7,), {}),
    ("SDBitwise", "right_shift_cyclic"): ([_INTS], (9,), {}),
    ("SDBitwise", "toggle_bits"): ([_INTS], (), {}),
    ("SDRandom", "uniform"): ([], (-1.0, 2.0, (40, 50)), {"seed": 3}),
    ("SDRandom", "normal"): ([], (0.5, 2.0, (40, 50)), {"seed": 4}),
    ("SDRandom", "truncated_normal"): ([], (0.0, 1.0, (40, 50)),
                                       {"seed": 5}),
    ("SDRandom", "bernoulli"): ([], (0.3, (40, 50)), {"seed": 6}),
    ("SDRandom", "exponential"): ([], (2.0, (40, 50)), {"seed": 7}),
    ("SDRandom", "gamma"): ([], (2.0, (40, 50)), {"seed": 8, "beta": 0.5}),
}
for _m in ("and_", "or_", "xor", "bits_hamming_distance"):
    CASES[("SDBitwise", _m)] = ([_INTS, _INTS2], (), {})
for _m in ("abs", "exp", "sin", "cos", "tanh", "erf", "sign", "floor", "neg",
           "square"):
    CASES[("SDMath", _m)] = ([_X], (), {})
for _m in ("log", "sqrt"):
    CASES[("SDMath", _m)] = ([_POS], (), {})
for _m in ("relu", "relu6", "gelu", "elu", "selu", "swish", "sigmoid",
           "softplus"):
    CASES[("SDNN", _m)] = ([_X * 3], (), {})

# (lo, hi) bounds of each draw, for the semantic check
_DRAW_BOUNDS = {"uniform": (-1.0, 2.0), "normal": (-np.inf, np.inf),
                "truncated_normal": (-2.0, 2.0), "bernoulli": (0.0, 1.0),
                "exponential": (0.0, np.inf), "gamma": (0.0, np.inf)}


def _one_node(mod, ns, method, arrays, args, kwargs):
    sd = mod.SameDiff(device="cpu") if mod is TS else mod.SameDiff()
    ins = [sd.constant(f"in{i}", a) for i, a in enumerate(arrays)]
    out = getattr(getattr(sd, ATTR[ns]), method)(*ins, *args, **kwargs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    res = sd.output({}, [o.name for o in outs])
    return [np.asarray(res[o.name]) for o in outs]


def test_every_method_has_a_one_node_case():
    assert sorted(CASES) == sorted(_ALL)


@pytest.mark.parametrize("ns,method", _ALL,
                         ids=[f"{a}.{b}" for a, b in _ALL])
def test_method_in_a_one_node_graph(ns, method):
    arrays, args, kwargs = CASES[(ns, method)]
    want = _one_node(JS, ns, method, arrays, args, kwargs)
    got = _one_node(TS, ns, method, arrays, args, kwargs)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    if ns == "SDRandom":
        lo, hi = _DRAW_BOUNDS[method]
        for g in got + want:
            assert np.isfinite(g).all() and (g >= lo).all() and (g <= hi).all()
        again = _one_node(TS, ns, method, arrays, args, kwargs)
        np.testing.assert_array_equal(again[0], got[0])  # the same seed
        assert np.isclose(got[0].mean(), want[0].mean(),
                          atol=0.15 * max(1.0, abs(want[0].std())))
        return
    if (ns, method) in (("SDLinalg", "qr"), ("SDLinalg", "svd")):
        a = arrays[0].astype(np.float64)
        if method == "qr":
            q, r = got
            np.testing.assert_allclose(q @ r, a, rtol=1e-4, atol=1e-5)
        else:
            u, s, vh = got
            np.testing.assert_allclose(s, want[1], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose((u * s) @ vh, a, rtol=1e-4,
                                       atol=1e-5)
        np.testing.assert_allclose(got[0].T @ got[0], np.eye(3), atol=1e-5)
        return
    rtol = 2e-5 if method in ("gelu", "erf", "adjust_hue") else 1e-5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6)


# ---------------------------------------------------------------------------
# the sd_namespaces encoder, 2 layers at width 64
# ---------------------------------------------------------------------------

SMALL = dict(batch=4, seq=16, d=64, heads=4, ff=256, layers=2, classes=2)
LR = 5e-5


def test_namespace_encoder_output_and_one_fit_step():
    weights = ne.encoder_weights(SMALL)
    x, labels = ne.encoder_batch(SMALL)
    js, ts = JS.SameDiff(), TS.SameDiff(device="cpu")
    jl, jloss = ne.build_encoder(js, SMALL, weights)
    tl, tloss = ne.build_encoder(ts, SMALL, weights)
    feeds = {"x": x, "labels": labels}
    jo, to = js.output(feeds, [jl, jloss]), ts.output(feeds, [tl, tloss])
    scale = np.abs(jo[jl]).max()
    np.testing.assert_allclose(to[tl], jo[jl], rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(to[tloss], jo[jloss], rtol=1e-5)
    for sd, cfg_cls, adam, loss in ((js, JS.TrainingConfig, JAdam, jloss),
                                    (ts, TS.TrainingConfig, TAdam, tloss)):
        sd.set_training_config(cfg_cls(
            updater=adam(learning_rate=LR), data_set_feature_mapping=["x"],
            data_set_label_mapping=["labels"], loss_variables=[loss]))
    jh = js.fit([ne.Batch(x, labels)])
    th = ts.fit([ne.Batch(x, labels)])
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    for name in weights:
        want = np.asarray(js.get_arr(name))
        got = ts.get_arr(name)
        assert not np.array_equal(want, weights[name]), name  # it moved
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
