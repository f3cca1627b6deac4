"""Validation specs of the ops the port registered before its catalog.

The nn family of ``ops/nn_ops.py`` (convolutions, pools, normalizations,
attention, the cells and sequences, the dense primitives), the quantized
ops, the fused updater step, the fused conv-BN statistics GEMM, the paged
decode attention and the LSTM layer: every one of them owns a spec here,
as the ratchet (:func:`.validation.uncovered_ops`) requires. The shapes
are small; the attention, matmul, layer-norm and conv-BN specs also meet
the gates of their CUDA kernels, so chip_smoke's ``op_catalog`` phase
reaches the kernels through the registry on the card.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.ops import validation as V
from deeplearning4j_tpu_torch.ops.validation import Key


def _r(*shape, scale=1.0):
    return lambda r: r.randn(*shape).astype(np.float32) * np.float32(scale)


def _args(*makers):
    return lambda r: [m(r) if callable(m) else m for m in makers]


def _img(n=2, h=6, w=6, c=3):
    return _r(n, h, w, c)


# ---- convolutions and pools -------------------------------------------------

for _pad in ("same", "valid", (1, 0)):
    V.case("conv2d", _args(_img(), _r(3, 3, 3, 4, scale=0.3), _r(4)),
           kwargs={"stride": 2 if _pad == "valid" else 1, "padding": _pad},
           dtypes=V.HALF, grad=True, rtol=1e-5, atol=1e-5,
           tol={"bfloat16": (2.0 ** -6, 2.0 ** -5)}, label=str(_pad))
V.case("conv2d", _args(_img(), _r(3, 3, 3, 4, scale=0.3)),
       kwargs={"dilation": 2}, grad=True, rtol=1e-5, atol=1e-5,
       label="dilated")
V.case("depthwise_conv2d", _args(_img(), _r(3, 3, 3, 2, scale=0.3), _r(6)),
       grad=True, rtol=1e-5, atol=1e-5)
V.case("sconv2d", _args(_img(), _r(3, 3, 3, 1, scale=0.3),
                        _r(1, 1, 3, 4, scale=0.5), _r(4)),
       kwargs={"stride": 2}, grad=True, rtol=1e-5, atol=1e-5)
for _s, _pad in ((2, "same"), (2, "valid"), (1, "same")):
    V.case("deconv2d", _args(_img(h=4, w=5), _r(3, 3, 3, 4, scale=0.3),
                             _r(4)),
           kwargs={"stride": _s, "padding": _pad}, grad=True, rtol=1e-5,
           atol=1e-5, label=f"{_s},{_pad}")
V.case("conv1d", _args(_r(2, 9, 3), _r(3, 3, 4, scale=0.3), _r(4)),
       dtypes=V.HALF, grad=True, rtol=1e-5, atol=1e-5,
       tol={"bfloat16": (2.0 ** -6, 2.0 ** -5)})
V.case("conv1d", _args(_r(2, 9, 3), _r(3, 3, 4, scale=0.3)),
       kwargs={"stride": 2, "padding": "valid", "dilation": 2}, grad=True,
       rtol=1e-5, atol=1e-5, label="valid,dilated")
V.case("conv1d", _args(_r(2, 9, 3), _r(3, 3, 4, scale=0.3)),
       kwargs={"padding": 2}, rtol=1e-5, atol=1e-5, label="explicit")
V.case("conv3d", _args(_r(1, 4, 5, 4, 2), _r(3, 2, 3, 2, 3, scale=0.3),
                       _r(3)),
       grad=True, rtol=1e-5, atol=1e-5)
V.case("conv3d", _args(_r(1, 5, 5, 4, 2), _r(2, 2, 2, 2, 3, scale=0.3)),
       kwargs={"stride": 2, "padding": "valid"}, rtol=1e-5, atol=1e-5,
       label="valid")
V.case("conv3d", _args(_r(1, 4, 4, 4, 2), _r(3, 3, 3, 2, 2, scale=0.3)),
       kwargs={"padding": 1, "dilation": (1, 2, 1)}, rtol=1e-5, atol=1e-5,
       label="explicit")
for _pad in ("valid", "same"):
    V.case("im2col", _args(_img(h=5, w=6)),
           kwargs={"kernel": (2, 3), "stride": (1, 2), "padding": _pad},
           dtypes=V.HALF, grad=True, label=_pad)
V.case("upsampling2d", _args(_img(h=3, w=2)), kwargs={"size": (2, 3)},
       dtypes=V.HALF, grad=True)
V.case("lrn", _args(_img(c=7)), kwargs={"depth": 5, "alpha": 0.1},
       grad=True)
for _name in ("maxpool2d", "avgpool2d", "pnormpool2d"):
    V.case(_name, _args(_img(h=5, w=6)), kwargs={"kernel": 2},
           dtypes=V.HALF, grad=True)
    V.case(_name, _args(_img(h=5, w=6)),
           kwargs={"kernel": 3, "stride": 2, "padding": "same"},
           grad=True, label="same")
V.case("avgpool2d", _args(_img(h=5, w=6)),
       kwargs={"kernel": 3, "stride": 2, "padding": "same",
               "count_include_pad": False}, grad=True, label="exclude-pad")
V.case("global_avg_pool", _args(_img()), dtypes=V.HALF, grad=True)
V.case("global_max_pool", _args(_img()), dtypes=V.HALF, grad=True)

# ---- normalizations ----------------------------------------------------------

V.case("batchnorm", _args(_img(), _r(3), lambda r: np.abs(
    r.randn(3)).astype(np.float32) + 0.5, _r(3), _r(3)),
    dtypes=V.HALF, grad=True)
V.case("layer_norm", _args(_r(4, 16), _r(16), _r(16)), dtypes=V.HALF,
       grad=True, rtol=1e-5, atol=1e-5)
V.case("fused_layer_norm", _args(_r(8, 128), _r(128), _r(128)),
       kwargs={"activation": "gelu"}, dtypes=V.HALF, grad=True,
       rtol=1e-5, atol=1e-5)
V.case("standardize", _args(_r(4, 9)), dtypes=V.HALF, grad=True,
       rtol=1e-5, atol=1e-5)
V.case("standardize", _args(_r(4, 3, 5)), kwargs={"axis": (1, 2)},
       grad=True, rtol=1e-5, atol=1e-5, label="axes")

# ---- dense primitives, gather, one-hot ---------------------------------------

V.case("matmul", _args(_r(3, 4), _r(4, 5)), dtypes=V.HALF, grad=True,
       rtol=1e-5, atol=1e-5)
V.case("matmul", _args(_r(2, 4, 3), _r(2, 5, 4)),
       kwargs={"transpose_a": True, "transpose_b": True}, grad=True,
       rtol=1e-5, atol=1e-5, label="transposed")
V.case("xw_plus_b", _args(_r(3, 4), _r(4, 5), _r(5)), dtypes=V.HALF,
       grad=True, rtol=1e-5, atol=1e-5)
for _act in ("none", "relu", "tanh", "gelu", "gelu_exact"):
    V.case("fused_matmul_bias_act", _args(_r(16, 32), _r(32, 24, scale=0.2),
                                          _r(24)),
           kwargs={"activation": _act}, dtypes=V.HALF, grad=True,
           rtol=1e-5, atol=1e-5, label=_act)
V.case("gather", _args(_r(5, 3), np.asarray([[0, 4], [-1, 2]], np.int32)),
       dtypes=V.HALF, grad=True)
V.case("gather", _args(_r(2, 5, 3), np.asarray([1, 7, -6, 0], np.int32)),
       kwargs={"axis": 1}, label="out-of-range")
V.case("gather", _args(np.arange(12, dtype=np.int32).reshape(4, 3),
                       np.asarray([3, 4, -5], np.int32)),
       label="int32-out-of-range")
V.case("embedding_lookup", _args(_r(6, 4), np.asarray([[0, 5], [2, 2]],
                                                      np.int32)),
       dtypes=V.HALF, grad=True)
V.case("one_hot", _args(np.asarray([0, 3, -1, 4, 2], np.int32)),
       kwargs={"depth": 4})
V.case("one_hot", _args(np.asarray([[1, 0], [2, 2]], np.int32)),
       kwargs={"depth": 3, "on_value": 0.9, "off_value": 0.05},
       label="values")

# ---- softmax, clips -----------------------------------------------------------

V.case("softmax_op", _args(_r(3, 7)), dtypes=V.HALF, grad=True)
V.case("softmax_op", _args(_r(3, 4, 5)), kwargs={"axis": 1}, grad=True,
       label="axis=1")
V.case("log_softmax_op", _args(_r(3, 7)), dtypes=V.HALF, grad=True)
V.case("clip_by_norm", _args(_r(4, 5)), kwargs={"clip_norm": 1.0},
       dtypes=V.HALF, grad=True)
V.case("clip_by_norm", _args(_r(4, 5)), kwargs={"clip_norm": 1.0,
                                                "axis": 1},
       grad=True, label="axis=1")
V.case("clip_by_value", _args(_r(4, 5)), kwargs={"min_value": -0.5,
                                                 "max_value": 0.7},
       dtypes=V.HALF, grad=True)

# ---- attention ----------------------------------------------------------------

_QKV = _args(_r(2, 2, 16, 32), _r(2, 2, 16, 32), _r(2, 2, 16, 32))
V.case("dot_product_attention", _QKV, dtypes=V.HALF, grad=True,
       rtol=1e-5, atol=1e-5)
V.case("dot_product_attention", _QKV, kwargs={"causal": True}, grad=True,
       rtol=1e-5, atol=1e-5, label="causal")
V.case("dot_product_attention",
       _args(_r(2, 2, 16, 32), _r(2, 2, 16, 32), _r(2, 2, 16, 32),
             lambda r: r.rand(2, 1, 1, 16) > 0.3),
       grad=True, rtol=1e-5, atol=1e-5, label="mask")
V.case("multi_head_dot_product_attention",
       _args(_r(2, 16, 64), _r(2, 16, 64), _r(2, 16, 64),
             _r(64, 64, scale=0.1), _r(64, 64, scale=0.1),
             _r(64, 64, scale=0.1), _r(64, 64, scale=0.1)),
       kwargs={"num_heads": 4}, dtypes=V.HALF, grad=True, rtol=1e-5,
       atol=1e-5)
V.case("multi_head_dot_product_attention",
       _args(_r(2, 8, 32), _r(2, 12, 32), _r(2, 12, 32),
             _r(32, 32, scale=0.1), _r(32, 32, scale=0.1),
             _r(32, 32, scale=0.1), _r(32, 32, scale=0.1),
             lambda r: (r.rand(2, 12) > 0.3).astype(np.int32)),
       kwargs={"num_heads": 2, "bq": np.full(32, 0.1, np.float32),
               "bo": np.full(32, -0.2, np.float32)},
       grad=True, rtol=1e-5, atol=1e-5, label="mask,bias")


def _paged(r):
    q = r.randn(2, 2, 16).astype(np.float32)
    k = r.randn(6, 4, 2, 16).astype(np.float32)
    v = r.randn(6, 4, 2, 16).astype(np.float32)
    table = np.asarray([[3, 0, 5], [1, 4, 2]], np.int32)
    lens = np.asarray([9, 5], np.int32)
    return [q, k, v, table, lens]


V.case("paged_decode_attention", _paged, dtypes=V.HALF, rtol=1e-5,
       atol=1e-5)


def _check_dropout(outs, spec, dtype):
    x = np.asarray(spec.draw()[0], np.float32)
    keep = 1.0 - spec.kwargs["rate"]
    y = outs[0].astype(np.float32)
    kept = y != 0
    rel = 2.0 ** -7 if dtype != "float32" else 1e-6
    np.testing.assert_allclose(y[kept], (x / keep)[kept], rtol=rel * 2)
    frac = kept.mean()
    assert abs(frac - keep) < 0.05, f"kept {frac:.3f} of the entries"


V.case("dropout", _args(lambda r: r.rand(64, 64).astype(np.float32) + 0.5,
                        Key(3)),
       kwargs={"rate": 0.25}, dtypes=V.HALF, check=_check_dropout)
V.case("dropout", _args(_r(4, 5), Key(1)),
       kwargs={"rate": 0.5, "deterministic": True}, label="deterministic")

# ---- recurrent cells and sequences ------------------------------------------

V.case("lstm_cell", _args(_r(3, 4), _r(3, 5), _r(3, 5), _r(4, 20, scale=.5),
                          _r(5, 20, scale=.5), _r(20)),
       kwargs={"forget_bias": 1.0}, grad=True, rtol=1e-5, atol=1e-5)
V.case("gru_cell", _args(_r(3, 4), _r(3, 5), _r(4, 15, scale=.5),
                         _r(5, 15, scale=.5), _r(15), _r(15)),
       grad=True, rtol=1e-5, atol=1e-5)
V.case("simple_rnn_cell", _args(_r(3, 4), _r(3, 5), _r(4, 5, scale=.5),
                                _r(5, 5, scale=.5), _r(5)),
       grad=True, rtol=1e-5, atol=1e-5)
V.case("lstm_sequence", _args(_r(2, 5, 3), _r(3, 16, scale=.5),
                              _r(4, 16, scale=.5), _r(16)),
       grad=True, rtol=1e-5, atol=1e-5)
for _lbr in (True, False):
    V.case("gru_sequence", _args(_r(2, 4, 3), _r(3, 15, scale=.5),
                                 _r(5, 15, scale=.5), _r(15), _r(15),
                                 _r(2, 5)),
           kwargs={"linear_before_reset": _lbr}, grad=True, rtol=1e-5,
           atol=1e-5, label=f"lbr={_lbr}")
V.case("lstm_layer", _args(_r(2, 6, 3), _r(3, 16, scale=.5),
                           _r(4, 16, scale=.5), _r(16), _r(2, 4), _r(2, 4)),
       grad=True, rtol=1e-5, atol=1e-5)
V.case("lstm_layer", _args(_r(3, 6, 3), _r(3, 16, scale=.5),
                           _r(4, 16, scale=.5), _r(16), None, None,
                           np.asarray([[1] * 6, [1] * 4 + [0] * 2,
                                       [1] * 2 + [0] * 4], np.float32)),
       kwargs={"gate_activation": "hardsigmoid", "reverse": True},
       cast=(0, 1, 2, 3), rtol=1e-5, atol=1e-5, label="mask,reverse")

# ---- the kernels' other ops -----------------------------------------------------

V.case("fused_bn_matmul_stats",
       _args(_r(128, 64), lambda r: r.rand(64).astype(np.float32) + 0.5,
             _r(64, scale=0.1), _r(64, 64, scale=0.2),
             lambda r: np.zeros(64, np.float32)),
       dtypes=("float32", "bfloat16"), cast=(0, 3), rtol=1e-5, atol=1e-5,
       tol={"bfloat16": (2.0 ** -7, 1e-3)})
V.case("fused_bn_matmul_stats",
       _args(_r(128, 64), lambda r: np.ones(64, np.float32),
             lambda r: np.zeros(64, np.float32), _r(64, 64, scale=0.2),
             _r(64, scale=0.1)),
       kwargs={"relu": False, "fuse_prologue": False}, cast=(0, 3),
       rtol=1e-5, atol=1e-5, label="no-prologue")
for _axis in (None, 0, 1):
    V.case("quantize_int8", _args(_r(6, 5)), kwargs={"axis": _axis},
           dtypes=V.HALF, label=f"axis={_axis}")
V.case("dequantize_int8",
       _args(lambda r: r.randint(-127, 128, (4, 3)).astype(np.int8),
             lambda r: r.rand(1, 3).astype(np.float32)))
V.case("matmul_int8",
       _args(_r(4, 16), lambda r: r.randint(-127, 128, (16, 8))
             .astype(np.int8), lambda r: (r.rand(8) * 0.01)
             .astype(np.float32)),
       dtypes=V.HALF, cast=(0,), rtol=1e-5, atol=1e-5)


def _updater_args(r):
    return [r.randn(10).astype(np.float32), r.randn(10).astype(np.float32),
            np.asarray(0.01, np.float32), np.asarray(3, np.int32),
            (r.randn(10) * 0.1).astype(np.float32),
            (r.rand(10) * 0.1).astype(np.float32)]


V.case("fused_updater_step", _updater_args, kwargs={"kind": "Adam"},
       rtol=1e-5, atol=1e-6)
V.case("fused_updater_step", lambda r: _updater_args(r)[:4],
       kwargs={"kind": "Sgd"}, label="sgd")
V.case("fused_updater_step", lambda r: _updater_args(r)[:5],
       kwargs={"kind": "Nesterovs", "momentum": 0.9}, label="nesterovs")
