"""SameDiff training of the PyTorch port against the JAX package (CPU).

One builder, two classes: the same graph is built through both packages'
SameDiff API from the same numpy arrays — every ``sd.loss`` op on a small
graph, and an imported tiny BERT (the ONNX bytes of
``bert_onnx_model``: 2 layers, d 128, 2 heads, ff 256, vocab 64, batch
2 × seq 8, ragged masks) with the token-classification head a fine-tune
adds in SameDiff (dense → LayerNorm → GELU → classifier over 9 tags,
softmax cross entropy; 41 trainable leaves, one of them — ``cls_w`` —
never read by the loss). Checked, in float32:

* every loss op's value and its gradient against the JAX op: 1e-5
  relative and 1e-6 absolute;
* the optimized loss plan op for op against the JAX plan, with fusions
  ``{"attention": 2, "epilogue": 14, "layernorm": 1}``;
* ``calculate_gradients`` over all leaves: each gradient within 1e-4
  relative plus 1e-5 of the largest gradient of any leaf absolute (the
  same float32 math summed in another order; the key-bias gradients are
  zero up to rounding, ~1e-13);
* ``fit`` for two steps (Adam lr 5e-5; and once more with l2 and weight
  decay; l1 as well on a small graph): the epoch history to 1e-5
  relative, the parameters
  within 5% of one step's size (Adam moves an element whose gradient is
  rounding noise by up to lr either way), the Adam moments ``m`` within
  1e-5 of the largest gradient and ``v`` within 1e-4 relative plus
  1e-10 absolute;
* the training state carried across: ``apply_training_state`` from the
  JAX ``training_state()`` after one step, then one more step in each,
  held as ``fit`` is;
* the listener, counters and resume cursor of ``fit`` (the float64
  finite-difference check of the tiny BERT's gradients through its plan
  is in ``test_torch_samediff_gradcheck.py``);
* bfloat16 numpy arrays (``ml_dtypes.bfloat16``) as variables and feeds of
  a small graph: ``output`` and one ``fit`` step against the JAX package,
  and a JAX bfloat16 training state applied to the port. Tolerance one
  bfloat16 unit (2^-7 relative) plus 1e-6: both compute the same bfloat16
  graph; the JAX generic step promotes the bfloat16 parameters to float32
  and the port keeps their dtype (rounds the new value once), which moves a
  parameter by at most half a unit;
* the parameter dtype of a bfloat16 ``fit`` against the JAX Pallas updater
  kernel (``fused_updater_helper`` in interpret mode, installed as the JAX
  registry's CPU helper for the test): the kernel stores each new parameter
  in the leaf's dtype, as the port's kernel and plain version do, so after
  three steps both runs hold bfloat16 parameters. Their values agree to one
  bfloat16 unit of the parameter per step taken: each step rounds once in
  each run, and the two frameworks' bfloat16 gradients differ (Adam's first
  moment by up to 15 units after one step), so a rounding can fall the
  other way once a step.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTC
from deeplearning4j_tpu.imports import onnx_import as jimp
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.autodiff import SameDiff as TSameDiff
from deeplearning4j_tpu_torch.autodiff import TrainingConfig as TTC
from deeplearning4j_tpu_torch.autodiff.listeners import HistoryListener
from deeplearning4j_tpu_torch.imports import onnx_import as timp
from deeplearning4j_tpu_torch.nn.updater import Adam as TAdam
from deeplearning4j_tpu_torch.testing import onnx_builder as tb

TINY = dict(layers=2, batch=2, seq=8, d=128, heads=2, ff=256, vocab=64)
LR = 5e-5
FUSIONS = {"attention": 2, "epilogue": 14, "layernorm": 1}


def _plan_ops(sd, outputs):
    plan = sd._jit_cache[("plan", tuple(outputs), sd._effective_passes())]
    return [(n.op, sorted(n.kwargs)) for n in plan.nodes]


class Batch:
    """A batch of the loss-op graphs: no features, the labels."""

    def __init__(self, labels):
        self.features, self.labels = [], labels

    def num_examples(self):
        return int(self.labels.shape[0])


# ------------------------------------------------------------- loss ops


def _loss_graph(pkg, op):
    r = np.random.RandomState(7)
    sd = JSameDiff() if pkg == "jax" else TSameDiff(device="cpu")
    pred = sd.var("pred", r.randn(4, 6).astype(np.float32))
    feeds = {"labels": np.eye(6, dtype=np.float32)[r.randint(0, 6, 4)]}
    labels = sd.placeholder("labels", (4, 6))
    if op == "sparse_softmax_cross_entropy":
        feeds = {"labels": r.randint(0, 6, 4).astype(np.int32)}
        labels = sd.placeholder("labels", (4,), np.int32)
    elif op in ("mean_squared_error", "absolute_difference", "huber_loss",
                "cosine_distance"):
        feeds = {"labels": r.randn(4, 6).astype(np.float32)}
    if op == "log_loss":
        pred = sd.nn.sigmoid(pred)
    if op == "huber_loss":
        out = sd.loss.huber_loss(pred, labels, delta=0.7)
    elif op == "cosine_distance" and pkg == "jax":
        out = sd.op("cosine_distance", pred, labels)  # no SDLoss method
    else:
        out = getattr(sd.loss, op)(pred, labels)
    out.rename("loss")
    return sd, feeds


@pytest.mark.parametrize("op", [
    "softmax_cross_entropy", "sparse_softmax_cross_entropy",
    "sigmoid_cross_entropy", "mean_squared_error", "absolute_difference",
    "log_loss", "huber_loss", "cosine_distance"])
def test_loss_ops_match_jax(op):
    (jsd, feeds), (tsd, _) = _loss_graph("jax", op), _loss_graph("torch", op)
    want = jsd.output(feeds, ["loss"])["loss"]
    got = tsd.output(feeds, ["loss"])["loss"]
    assert got.shape == want.shape == ()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    gw = jsd.calculate_gradients(feeds, "loss")["pred"]
    gg = tsd.calculate_gradients(feeds, "loss")["pred"]
    np.testing.assert_allclose(gg, np.asarray(gw), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- imported BERT


@pytest.fixture(scope="module")
def tiny():
    model = tb.bert_onnx_model(**TINY)
    feeds = tb.bert_onnx_feeds(TINY["batch"], TINY["seq"], TINY["vocab"],
                               min_len=4)
    feeds["labels"] = tb.token_labels(TINY["batch"], TINY["seq"])
    return model, feeds


def _finetune(pkg, model, **tc_kw):
    """The imported tiny BERT with the token head, its training config
    set (Adam lr 5e-5 unless ``updater`` says otherwise)."""
    if pkg == "jax":
        sd = jimp.import_onnx(model)
        TC, Adam = JTC, JAdam
    else:
        sd = timp.import_onnx(model, device="cpu")
        TC, Adam = TTC, TAdam
    logits, loss = tb.add_token_head(
        sd, f"l{TINY['layers'] - 1}_out", tb.token_head_arrays(TINY["d"]),
        TINY["batch"], TINY["seq"])
    sd.set_training_config(TC(
        updater=tc_kw.pop("updater", Adam(learning_rate=LR)),
        data_set_feature_mapping=["ids", "mask"],
        data_set_label_mapping=["labels"], loss_variables=[loss], **tc_kw))
    return sd, logits, loss


def _batch(feeds):
    return tb.TokenBatch(feeds, feeds["labels"])


def _grad_tol(want):
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want.values())
    return dict(rtol=1e-4, atol=1e-5 * scale)


def test_plan_matches_jax_with_one_layernorm_fusion(tiny):
    model, feeds = tiny
    jsd, _, loss = _finetune("jax", model)
    tsd, _, _ = _finetune("torch", model)
    jsd.calculate_gradients(feeds, loss)
    tsd.calculate_gradients(feeds, loss)
    assert tsd.last_compile_stats.fusions == FUSIONS
    assert jsd.last_compile_stats.fusions == FUSIONS
    assert _plan_ops(tsd, [loss]) == _plan_ops(jsd, [loss])
    assert sum(op == "fused_layer_norm" for op, _ in _plan_ops(tsd, [loss])) \
        == 1


def test_calculate_gradients_match_jax_over_every_leaf(tiny):
    model, feeds = tiny
    jsd, _, loss = _finetune("jax", model)
    tsd, _, _ = _finetune("torch", model)
    want = jsd.calculate_gradients(feeds, loss)
    got = tsd.calculate_gradients(feeds, loss)
    assert len(got) == 41 and sorted(got) == sorted(want)
    assert not np.any(got["cls_w"])  # the loss never reads it: zeros
    tol = _grad_tol(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   err_msg=name, **tol)
    # a subset names its leaves only
    sub = tsd.calculate_gradients(feeds, loss, wrt=["head_ln_g", "emb"])
    assert sorted(sub) == ["emb", "head_ln_g"]
    np.testing.assert_array_equal(sub["emb"], got["emb"])


def _check_state(tsd, jsd, lr, grad_scale):
    state = jsd.training_state()
    for name, w in state["params"].items():
        np.testing.assert_allclose(tsd.get_arr(name), np.asarray(w),
                                   rtol=0, atol=0.05 * lr, err_msg=name)
        m, v = (np.asarray(state["opt_state"][name][k]) for k in "mv")
        ts = tsd._updater_state[name]
        np.testing.assert_allclose(ts["m"].numpy(), m, rtol=1e-4,
                                   atol=1e-5 * grad_scale, err_msg=name)
        np.testing.assert_allclose(ts["v"].numpy(), v, rtol=1e-4,
                                   atol=1e-10, err_msg=name)
    assert tsd._step == int(state["iteration"])


@pytest.mark.parametrize("reg", [{}, {"l2": 1e-2, "weight_decay": 1e-2}])
def test_fit_matches_jax(tiny, reg):
    model, feeds = tiny
    jsd, _, loss = _finetune("jax", model, **reg)
    tsd, logits, _ = _finetune("torch", model, **reg)
    scale = _grad_tol(jsd.calculate_gradients(feeds, loss))["atol"] / 1e-5
    unread = tsd.get_arr("cls_w")
    b = _batch(feeds)
    want = jsd.fit([b, b])
    got = tsd.fit([b, b])
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _check_state(tsd, jsd, LR, scale)
    # the loss never reads cls_w: decay still moves it, as in the JAX step
    assert np.array_equal(tsd.get_arr("cls_w"), unread) == (not reg)
    out = tsd.output(feeds, [logits])[logits]
    assert out.shape == (TINY["batch"], TINY["seq"], tb.NER_TAGS)


def test_fit_with_l1_l2_and_decay_matches_jax():
    """l1 on a graph whose every gradient is well above rounding (in the
    imported BERT the key biases' exact gradient is zero, and l1's
    sign(w) of a bias moved only by rounding noise has no defined
    sign)."""
    (jsd, feeds), (tsd, _) = (_loss_graph("jax", "mean_squared_error"),
                              _loss_graph("torch", "mean_squared_error"))
    for sd, TC, Adam in ((jsd, JTC, JAdam), (tsd, TTC, TAdam)):
        sd.set_training_config(TC(
            updater=Adam(learning_rate=1e-2), l1=1e-2, l2=1e-1,
            weight_decay=1e-2, data_set_label_mapping=["labels"],
            loss_variables=["loss"]))
    b = Batch(feeds["labels"])
    want = jsd.fit([b, b, b], epochs=2)
    got = tsd.fit([b, b, b], epochs=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _check_state(tsd, jsd, 1e-2, 1.0)


def test_training_state_carried_from_jax(tiny):
    model, feeds = tiny
    jsd, _, loss = _finetune("jax", model)
    tsd, _, _ = _finetune("torch", model)
    scale = _grad_tol(jsd.calculate_gradients(feeds, loss))["atol"] / 1e-5
    b = _batch(feeds)
    jsd.fit([b])
    state = jsd.training_state()
    tsd.apply_training_state({
        "params": {n: np.asarray(a) for n, a in state["params"].items()},
        "opt_state": {n: {k: np.asarray(a) for k, a in s.items()}
                      for n, s in state["opt_state"].items()},
        "iteration": state["iteration"], "epoch": state["epoch"],
        "data_cursor": state["data_cursor"]})
    assert tsd._step == 1 and tsd.epoch_count == 1
    want = jsd.fit([b])
    got = tsd.fit([b])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _check_state(tsd, jsd, LR, scale)


def test_fit_listeners_counters_and_resume(tiny):
    model, feeds = tiny
    observe.reset()
    tsd, _, _ = _finetune("torch", model)
    hl = HistoryListener()
    done = []

    class Done:
        def iteration_done(self, *a):
            pass

        def fit_done(self, model):
            done.append(model)

    tsd.set_listeners(hl, Done())
    b = _batch(feeds)
    hist = tsd.fit([b, b, b])
    assert len(hl.history.loss_curve) == 3 and done == [tsd]
    np.testing.assert_allclose(np.mean(hl.history.loss_curve), hist[0],
                               rtol=1e-6)
    assert hl.finalize().epoch_losses == pytest.approx(hist)
    m = observe.metrics()
    assert m.counter("dl4j_tpu_train_steps_total", model="samediff").value \
        == 3
    assert m.counter("dl4j_tpu_train_examples_total",
                     model="samediff").value == 3 * TINY["batch"]
    assert m.counter("dl4j_tpu_host_to_device_transfers_total",
                     model="samediff").value == 9
    assert m.histogram("dl4j_tpu_train_step_seconds",
                       model="samediff").count == 3
    assert tsd._step == 3 and tsd.epoch_count == 1 \
        and tsd.batch_in_epoch == 0
    # resume mid-epoch: the first batch_in_epoch batches are skipped
    tsd.batch_in_epoch = 2
    tsd.fit([b, b, b])
    assert tsd._step == 4 and len(hl.history.loss_curve) == 4
    with pytest.raises(ValueError):
        TSameDiff(device="cpu").fit([b])


# ------------------------------------------------------- bfloat16 arrays

BF16 = ml_dtypes.bfloat16
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)


def _bf16_graph(pkg):
    """tanh(x @ w + b) and its mean squared error, with bfloat16 numpy
    variables, placeholders and feeds; Adam lr 1e-2."""
    r = np.random.RandomState(3)
    sd = JSameDiff() if pkg == "jax" else TSameDiff(device="cpu")
    x = sd.placeholder("x", (4, 6), BF16)
    labels = sd.placeholder("labels", (4, 3), BF16)
    w = sd.var("w", (r.randn(6, 3) * 0.5).astype(BF16))
    b = sd.var("b", (r.randn(3) * 0.1).astype(BF16))
    y = sd.math.tanh(x.mmul(w) + b)
    y.rename("y")
    sd.loss.mean_squared_error(y, labels).rename("loss")
    TC, Adam = (JTC, JAdam) if pkg == "jax" else (TTC, TAdam)
    sd.set_training_config(TC(
        updater=Adam(learning_rate=1e-2), data_set_feature_mapping=["x"],
        data_set_label_mapping=["labels"], loss_variables=["loss"]))
    r = np.random.RandomState(4)
    return sd, {"x": r.randn(4, 6).astype(BF16),
                "labels": r.randn(4, 3).astype(BF16)}


class _Bf16Batch(Batch):
    def __init__(self, feeds):
        super().__init__(feeds["labels"])
        self.features = [feeds["x"]]


def test_bfloat16_numpy_graph_output_and_fit_match_jax():
    (jsd, feeds), (tsd, _) = _bf16_graph("jax"), _bf16_graph("torch")
    assert tsd.get_arr("w").shape == (6, 3)
    want = jsd.output(feeds, ["y"])["y"]
    got = tsd.output(feeds, ["y"])["y"]
    # a bfloat16 result comes back as bfloat16, as the JAX package's does
    assert str(want.dtype) == str(got.dtype) == "bfloat16"
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **BF16_TOL)
    b = _Bf16Batch(feeds)
    np.testing.assert_allclose(tsd.fit([b]), jsd.fit([b]), **BF16_TOL)
    for name in ("w", "b"):
        np.testing.assert_allclose(
            tsd.get_arr(name), np.asarray(jsd.get_arr(name), np.float32),
            err_msg=name, **BF16_TOL)


def test_bfloat16_training_state_carried_from_jax():
    (jsd, feeds), (tsd, _) = _bf16_graph("jax"), _bf16_graph("torch")
    b = _Bf16Batch(feeds)
    jsd.fit([b])
    state = jsd.training_state()
    opt = {n: {k: np.asarray(a) for k, a in s.items()}
           for n, s in state["opt_state"].items()}
    assert str(opt["w"]["m"].dtype) == "bfloat16"  # Adam's moments
    tsd.apply_training_state({
        "params": {n: np.asarray(a) for n, a in state["params"].items()},
        "opt_state": opt, "iteration": state["iteration"],
        "epoch": state["epoch"], "data_cursor": state["data_cursor"]})
    assert tsd._updater_state["w"]["m"].dtype == torch.bfloat16
    np.testing.assert_allclose(tsd.fit([b]), jsd.fit([b]), **BF16_TOL)
    for name in ("w", "b"):
        np.testing.assert_allclose(
            tsd.get_arr(name), np.asarray(jsd.get_arr(name), np.float32),
            err_msg=name, **BF16_TOL)


def _units(want, got):
    """|got - want| in bfloat16 units of ``want`` (the spacing of the
    bfloat16 grid at each element's magnitude)."""
    unit = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
    return np.abs(got - want) / unit


def test_bfloat16_parameters_keep_their_dtype_as_the_jax_kernel_does(
        monkeypatch):
    """The port's bfloat16 leaves stay bfloat16 through ``fit``, as the JAX
    Pallas updater (``pallas_updater.py`` ``_kernel``: ``(p - u).astype(
    out dtype)``) keeps them; only the JAX generic ``param - u`` promotes.
    The JAX run here takes the Pallas kernel in interpret mode."""
    from deeplearning4j_tpu.ops.pallas_updater import fused_updater_helper
    from deeplearning4j_tpu.ops.registry import registry as jregistry

    kernel_dtypes = []

    def interpret_kernel(*args, **kw):
        out = fused_updater_helper(*args, interpret=True, **kw)
        kernel_dtypes.append((args[0].dtype, out[0].dtype))
        return out

    desc = jregistry().get("fused_updater_step")
    monkeypatch.setitem(desc.platform_impls, "cpu", interpret_kernel)
    monkeypatch.setitem(desc.platform_usable, "cpu", lambda *a, **k: True)
    (jsd, feeds), (tsd, _) = _bf16_graph("jax"), _bf16_graph("torch")
    b = _Bf16Batch(feeds)
    for step in range(1, 4):
        np.testing.assert_allclose(tsd.fit([b]), jsd.fit([b]), **BF16_TOL)
        for name in ("w", "b"):
            want = np.asarray(jsd.get_arr(name), np.float32)
            assert _units(want, tsd.get_arr(name)).max() <= step, name
    # the JAX kernel ran on both bfloat16 leaves and returned bfloat16
    assert kernel_dtypes and all(
        str(i) == str(o) == "bfloat16" for i, o in kernel_dtypes)
    for name in ("w", "b"):
        assert str(jsd.get_arr(name).dtype) == "bfloat16"
        assert tsd._arrays[name].dtype == torch.bfloat16
