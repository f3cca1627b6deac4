"""The int8 serving slice at small size: a dynamically quantized BERT
encoder recorded through both packages' SameDiff API (CPU).

One builder, two classes: ``testing/int8_bert.bert_int8_encoder`` records
the same graph on the JAX package's ``SameDiff`` and on the port's, from
the float32 weights of ``bert_onnx_model`` (``bert_onnx_weights``: 2
layers, d 64, 4 heads, FF 128, vocab 100; batch 2 × seq 16 with ragged
key masks). Checked:

* the weights are the ONNX builder's, byte for byte (the port's import
  of ``bert_onnx_model``'s bytes reads the same arrays), and their int8
  quantization (``quantize_int8(w, axis=0)``) equals the JAX package's
  bit for bit, as recorded in both graphs;
* the optimized plans op for op, with 13 ``matmul_int8`` nodes (6 a layer
  and the classifier) and no fusion — the epilogue matcher takes ``mmul``,
  not ``matmul_int8`` — and the optimizer's shape evidence for every
  ``matmul_int8`` node comes from its rule, not the meta-tensor probe;
* ``y`` and the last hidden state against the JAX graph, optimizer on and
  off: 1e-5 absolute. Both quantize the same float32 activations to the
  same integers here; the float32 parts (LayerNorm, attention, GELU)
  differ in summation order only;
* the int8 graph against the float32 imported encoder (``onnx_bert``'s
  function) on the same weights and feeds: the relative error of the
  last hidden state, ``||h_int8 - h_f32|| / ||h_f32||``, and of ``y``.
  The hidden state is dominated by the residual stream, so its cosine
  sits near 1 even with a wrong scale axis or transposed projections;
  those two faults, injected here, move the relative error 20-40× above
  the true graph's. At BERT-base width both grow (``chip_smoke.py``'s
  ``int8_bert`` phase measures the true graph and a wrong-scale-axis
  graph against the float32 forward); its gross-fault bound
  ``GROSS_REL_ERR`` sits between them, more than ten times what the
  true graph reads here.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.ops import quantized as jq
from deeplearning4j_tpu_torch.analysis import interpreter
from deeplearning4j_tpu_torch.autodiff import SameDiff as TSameDiff
from deeplearning4j_tpu_torch.imports import onnx_import as timp
from deeplearning4j_tpu_torch.testing import int8_bert as IB
from deeplearning4j_tpu_torch.testing import onnx_builder as tb

TINY = dict(layers=2, batch=2, seq=16, d=64, heads=4, ff=128, vocab=100)
# chip_smoke.py's bound on the int8 graph's last hidden state against the
# float32 graph's (relative error); see the module docstring
GROSS_REL_ERR = 0.1
TOL = dict(rtol=0, atol=1e-5)
OUTS = ["y", "hidden"]


def _weights():
    return tb.bert_onnx_weights(**{k: TINY[k] for k in
                                   ("layers", "seq", "d", "ff", "vocab")})


@pytest.fixture(scope="module")
def tiny():
    feeds = tb.bert_onnx_feeds(TINY["batch"], TINY["seq"], TINY["vocab"],
                               min_len=4)
    return _weights(), feeds


def _build(pkg, arrays, optimize=True):
    sd = (JSameDiff(optimize=optimize) if pkg == "jax"
          else TSameDiff(optimize=optimize, device="cpu"))
    names = IB.bert_int8_encoder(sd, arrays, batch=TINY["batch"],
                                 seq=TINY["seq"], heads=TINY["heads"])
    assert names == {"y": "y", "hidden": "hidden"}
    return sd


def _plan_ops(sd):
    plan = sd._jit_cache[("plan", tuple(OUTS), sd._effective_passes())]
    return [(n.op, sorted(n.kwargs)) for n in plan.nodes]


def _dense_names():
    return ([f"l{i}_w{t}" for i in range(TINY["layers"])
             for t in ("q", "k", "v", "o", "1", "2")] + ["cls_w"])


def test_weights_are_the_onnx_builders_and_quantize_as_jax(tiny):
    arrays, _ = tiny
    imported = timp.import_onnx(tb.bert_onnx_model(**TINY), device="cpu")
    for name, a in arrays.items():
        np.testing.assert_array_equal(imported.get_arr(name), a,
                                      err_msg=name)
    jsd, tsd = _build("jax", arrays), _build("torch", arrays)
    assert len(_dense_names()) == 13
    for name in _dense_names():
        q, s = IB.quantize_weight(arrays[name])
        wq, ws = jq.quantize_int8.fn(jnp.asarray(arrays[name]), axis=0)
        assert q.dtype == np.int8 and s.shape == (1, q.shape[1])
        np.testing.assert_array_equal(q, np.asarray(wq), err_msg=name)
        np.testing.assert_array_equal(s, np.asarray(ws), err_msg=name)
        for sd in (jsd, tsd):
            np.testing.assert_array_equal(np.asarray(sd.get_arr(f"{name}_q")),
                                          q, err_msg=name)
            np.testing.assert_array_equal(
                np.asarray(sd.get_arr(f"{name}_scale")), s, err_msg=name)


def test_plan_matches_jax_with_13_int8_matmuls(tiny, monkeypatch):
    arrays, feeds = tiny
    probed = []
    real = interpreter._meta_probe

    def record(op, fn, ins, kwargs):
        probed.append(op)
        return real(op, fn, ins, kwargs)

    monkeypatch.setattr(interpreter, "_meta_probe", record)
    jsd, tsd = _build("jax", arrays), _build("torch", arrays)
    jsd.output(feeds, OUTS)
    tsd.output(feeds, OUTS)
    ops = _plan_ops(tsd)
    assert ops == _plan_ops(jsd)
    assert sum(op == "matmul_int8" for op, _ in ops) == 13
    assert sum(op == "dot_product_attention" for op, _ in ops) == 2
    for st in (jsd.last_compile_stats, tsd.last_compile_stats):
        assert st.fusions == {}
        assert (st.nodes_before, st.nodes_after) == (
            jsd.last_compile_stats.nodes_before,
            jsd.last_compile_stats.nodes_after)
    assert probed and "matmul_int8" not in probed  # its rule decided


@pytest.mark.parametrize("optimize", [True, False], ids=["opt", "noopt"])
def test_output_and_hidden_state_match_jax(tiny, optimize):
    arrays, feeds = tiny
    want = _build("jax", arrays, optimize).output(feeds, OUTS)
    got = _build("torch", arrays, optimize).output(feeds, OUTS)
    assert got["y"].shape == (TINY["batch"], TINY["seq"], 2)
    assert got["hidden"].shape == (TINY["batch"], TINY["seq"], TINY["d"])
    for name in OUTS:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   err_msg=name, **TOL)


def _rel_err(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cosine(got, want):
    return float(got.ravel() @ want.ravel()
                 / (np.linalg.norm(got) * np.linalg.norm(want)))


def _int8_vs_float32(arrays, feeds, fault=None, monkeypatch=None):
    """(relative error of the last hidden state, max abs error of y,
    cosine of the last hidden state) of the int8 graph against the
    float32 imported encoder."""
    if fault == "transpose":  # every attention projection transposed
        arrays = {k: (a.T.copy() if k.endswith(("_wq", "_wk", "_wv", "_wo"))
                      else a) for k, a in arrays.items()}
    if fault == "scale_axis":  # each column de-scaled by another's scale
        real = IB.quantize_weight

        def shifted(w):
            q, s = real(w)
            return q, np.roll(s, 1, axis=1)

        monkeypatch.setattr(IB, "quantize_weight", shifted)
    got = _build("torch", arrays).output(feeds, OUTS)
    last = f"l{TINY['layers'] - 1}_out"
    want = timp.import_onnx(tb.bert_onnx_model(**TINY), device="cpu").output(
        feeds, ["y", last])
    return (_rel_err(got["hidden"], want[last]),
            float(np.abs(got["y"] - want["y"]).max()),
            _cosine(got["hidden"], want[last]))


def test_int8_against_the_float32_encoder_and_the_gross_bound(tiny,
                                                              monkeypatch):
    arrays, feeds = tiny
    rel, y_err, cos = _int8_vs_float32(arrays, feeds)
    assert rel < GROSS_REL_ERR / 10 and y_err < 5e-3 and cos > 0.9999
    for fault in ("transpose", "scale_axis"):
        with monkeypatch.context() as m:
            bad, _, bad_cos = _int8_vs_float32(arrays, feeds, fault, m)
        assert bad > 10 * rel, fault
        # the residual stream keeps even a faulted graph's cosine near 1:
        # the relative error, not the cosine, tells the fault apart
        assert bad_cos > 0.999, fault
