"""Evaluation, listeners, normalizers and graph zips of the PyTorch port
against the JAX package (CPU).

Covered: every evaluation class (``Evaluation``, ``EvaluationBinary``,
``ROC``, ``ROCBinary``, ``ROCMultiClass``, ``RegressionEvaluation``,
``EvaluationCalibration``) on the same numpy arrays, with and without
masks; ``evaluate`` / ``evaluate_regression`` / ``evaluate_roc`` of both
networks; the listener hooks ``fit`` calls, for both networks, in the
JAX package's order; the score handed to listeners staying a device
tensor (no host read a step unless a listener reads it);
``CheckpointListener`` zips and ``save_graph`` / ``restore_graph`` zips
restored across the two packages both ways; the three normalizers and
``restore_normalizer`` crossing both ways.

Tolerances: evaluation metrics are host numpy in both packages and
compare exactly (AUCs and regression statistics to 1e-12); network
outputs 1e-5 relative + 1e-5 absolute; scores 1e-5 relative; zip
entries byte for byte.
"""

import json
import logging
import os
import zipfile

import numpy as np
import pytest

import jax
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.eval import evaluation as jev
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu.nn import listeners as jls
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.datasets import dataset as tds
from deeplearning4j_tpu_torch.eval import evaluation as tev
from deeplearning4j_tpu_torch.nn import graph as tgraph
from deeplearning4j_tpu_torch.nn import listeners as tls

OUT = dict(rtol=1e-5, atol=1e-5)
SCORE = dict(rtol=1e-5)
EXACT = dict(rtol=1e-12, atol=0)


def _host(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


# ---------------------------------------------------------------------------
# evaluation classes
# ---------------------------------------------------------------------------


def _probs(rng, shape):
    p = np.exp(rng.standard_normal(shape))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _onehot(rng, shape, k):
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, shape)]


def _mask(rng, shape):
    m = (rng.random(shape) > 0.3).astype(np.float32)
    m.reshape(-1)[0] = 1.0
    return m


def _same(a, b):
    """Two evaluation objects' public state, compared field by field."""
    for k, v in vars(a).items():
        w = vars(b)[k]
        if isinstance(v, dict):
            assert sorted(v) == sorted(w), k
            for c in v:
                _same(v[c], w[c])
        elif isinstance(v, list):
            assert len(v) == len(w), k
            for x, y in zip(v, w):
                np.testing.assert_array_equal(x, y, err_msg=k)
        elif v is None or isinstance(v, (int, float, str)):
            assert v == w, k
        else:
            np.testing.assert_array_equal(v, w, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rank", [2, 3])
def test_evaluation_matches_jax(masked, rank):
    rng = np.random.default_rng(0)
    shape = (12,) if rank == 2 else (4, 5)
    labels, preds = _onehot(rng, shape, 4), _probs(rng, shape + (4,))
    mask = _mask(rng, shape) if masked else None
    j, t = jev.Evaluation(), tev.Evaluation()
    for _ in range(2):
        j.eval(labels, preds, mask)
        t.eval(labels, preds, mask)
    _same(j, t)
    assert t.accuracy() == j.accuracy()
    for fn in ("precision", "recall", "f1"):
        np.testing.assert_array_equal(getattr(t, fn)(), getattr(j, fn)())
        np.testing.assert_array_equal(getattr(t, fn)(1), getattr(j, fn)(1))
    assert t.stats() == j.stats()
    assert (t.merge(tev.Evaluation()).confusion == j.confusion).all()


def test_evaluation_refuses_per_output_masks_like_jax():
    rng = np.random.default_rng(1)
    labels, preds = _onehot(rng, (6,), 3), _probs(rng, (6, 3))
    for ev in (jev.Evaluation(), tev.Evaluation()):
        with pytest.raises(ValueError, match="per-output masks"):
            ev.eval(labels, preds, np.ones((6, 3)))


@pytest.mark.parametrize("masked", [False, True])
def test_evaluation_binary_and_calibration_match_jax(masked):
    rng = np.random.default_rng(2)
    labels = (rng.random((5, 4, 3)) > 0.5).astype(np.float32)
    preds = rng.random((5, 4, 3)).astype(np.float32)
    mask = _mask(rng, (5, 4)) if masked else None
    for jcls, tcls in ((jev.EvaluationBinary, tev.EvaluationBinary),
                       (jev.EvaluationCalibration,
                        tev.EvaluationCalibration)):
        j, t = jcls(), tcls()
        j.eval(labels, preds, mask)
        t.eval(labels, preds, mask)
        _same(j, t)
    jb, tb = jev.EvaluationBinary(), tev.EvaluationBinary()
    jb.eval(labels, preds, mask)
    tb.eval(labels, preds, mask)
    assert (tb.accuracy(), tb.f1()) == (jb.accuracy(), jb.f1())
    jc, tc = jev.EvaluationCalibration(5), tev.EvaluationCalibration(5)
    jc.eval(labels, preds, mask)
    tc.eval(labels, preds, mask)
    for a, b in zip(tc.reliability(), jc.reliability()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_roc_family_matches_jax(masked):
    rng = np.random.default_rng(3)
    two = _onehot(rng, (30,), 2)
    two_p = _probs(rng, (30, 2))
    multi, multi_p = _onehot(rng, (30,), 4), _probs(rng, (30, 4))
    multi_label = (rng.random((30, 3)) > 0.5).astype(np.float32)
    multi_label_p = rng.random((30, 3)).astype(np.float32)
    mask = _mask(rng, (30,)) if masked else None
    out_mask = _mask(rng, (30, 3)) if masked else None
    j, t = jev.ROC(), tev.ROC()
    j.eval(two, two_p, mask)
    t.eval(two, two_p, mask)
    _same(j, t)
    np.testing.assert_allclose(t.calculate_auc(), j.calculate_auc(), **EXACT)
    np.testing.assert_allclose(t.calculate_auprc(), j.calculate_auprc(),
                               **EXACT)
    j, t = jev.ROCMultiClass(), tev.ROCMultiClass()
    j.eval(multi, multi_p)
    t.eval(multi, multi_p)
    for c in range(4):
        np.testing.assert_allclose(t.calculate_auc(c), j.calculate_auc(c),
                                   **EXACT)
    np.testing.assert_allclose(t.calculate_average_auc(),
                               j.calculate_average_auc(), **EXACT)
    for m in (mask, out_mask):
        j, t = jev.ROCBinary(), tev.ROCBinary()
        j.eval(multi_label, multi_label_p, m)
        t.eval(multi_label, multi_label_p, m)
        for c in range(3):
            np.testing.assert_allclose(t.calculate_auc(c),
                                       j.calculate_auc(c), **EXACT)
            np.testing.assert_allclose(t.calculate_auprc(c),
                                       j.calculate_auprc(c), **EXACT)
        np.testing.assert_allclose(t.calculate_average_auc(),
                                   j.calculate_average_auc(), **EXACT)


@pytest.mark.parametrize("masked", [False, True])
def test_regression_evaluation_matches_jax(masked):
    rng = np.random.default_rng(4)
    labels = rng.standard_normal((6, 5, 2)).astype(np.float32)
    preds = (labels + 0.3 * rng.standard_normal((6, 5, 2))).astype(
        np.float32)
    mask = _mask(rng, (6, 5)) if masked else None
    j, t = jev.RegressionEvaluation(), tev.RegressionEvaluation()
    j.eval(labels, preds, mask)
    t.eval(labels, preds, mask)
    for col in (0, 1):
        for fn in ("mean_squared_error", "mean_absolute_error",
                   "root_mean_squared_error", "r_squared",
                   "pearson_correlation"):
            np.testing.assert_allclose(getattr(t, fn)(col),
                                       getattr(j, fn)(col), **EXACT)
    np.testing.assert_allclose(t.average_mean_squared_error(),
                               j.average_mean_squared_error(), **EXACT)
    assert t.stats() == j.stats()


# ---------------------------------------------------------------------------
# networks: evaluate, listeners
# ---------------------------------------------------------------------------


def _mln_conf(pkg):
    return (pkg.builder().seed(3).updater(pkg.Adam(learning_rate=1e-2))
            .list()
            .layer(pkg.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                        activation="relu"))
            .layer(pkg.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.convolutional(6, 6, 2))
            .build())


def _graph_conf(pkg, g):
    b = (g.graph_builder().seed(4).updater(pkg.Nesterovs(learning_rate=0.05))
         .add_inputs("in")
         .set_input_types(**{"in": pkg.InputType.convolutional(6, 6, 2)}))
    b.add_layer("c", pkg.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                          convolution_mode="same",
                                          activation="relu"), "in")
    b.add_layer("bn", pkg.BatchNormalization(), "c")
    b.add_vertex("cat", g.MergeVertex(), "bn", "in")
    b.add_layer("gap", pkg.GlobalPoolingLayer(pooling_type="avg"), "cat")
    b.add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"), "gap")
    b.set_outputs("out")
    return b.build()


def _nets(kind):
    """(JAX network, port network) with the JAX parameters."""
    if kind == "mln":
        jnet = jnn.MultiLayerNetwork(_mln_conf(jnn)).init()
        tnet = tnn.MultiLayerNetwork(
            tnn.MultiLayerConfiguration.from_json(jnet.conf.to_json()),
            device="cpu").init(_host(jnet.params))
    else:
        jnet = jgraph.ComputationGraph(_graph_conf(jnn, jgraph)).init()
        tnet = tgraph.ComputationGraph(
            tgraph.ComputationGraphConfiguration.from_json(
                jnet.conf.to_json()), device="cpu").init(_host(jnet.params))
    return jnet, tnet


def _batches(n=2, b=4, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.random((b, 6, 6, 2), dtype=np.float32),
             _onehot(rng, (b,), 3)) for _ in range(n)]


class _Recorder:
    """A listener written against the hooks (no base class)."""

    def __init__(self):
        self.calls = []
        self.score_types = []

    def on_epoch_start(self, model):
        self.calls.append(("start", model.iteration_count,
                           model.epoch_count))

    def iteration_done(self, model, iteration, epoch, score):
        self.score_types.append(type(score))
        self.calls.append(("iter", iteration, epoch, float(score)))

    def on_epoch_end(self, model):
        self.calls.append(("end", model.iteration_count, model.epoch_count))

    def fit_done(self, model):
        self.calls.append(("done", model.iteration_count,
                           model.epoch_count))


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_listener_calls_follow_jax(kind):
    """Two epochs of two batches: the same hooks in the same order with
    the same iteration and epoch numbers and scores; the port hands
    listeners the device tensor the step returned."""
    jnet, tnet = _nets(kind)
    jrec, trec = _Recorder(), _Recorder()
    jcol, tcol = (jls.CollectScoresIterationListener(),
                  tls.CollectScoresIterationListener())
    jnet.set_listeners(jrec, jcol)  # the JAX graph has set_listeners only
    tnet.set_listeners(trec)
    tnet.add_listeners(tcol)
    data = jds.ListDataSetIterator([jds.DataSet(x, y)
                                    for x, y in _batches()])
    tdata = tds.ListDataSetIterator([tds.DataSet(x, y)
                                     for x, y in _batches()])
    jnet.fit(data, epochs=2)
    tnet.fit(tdata, epochs=2)
    assert [c[:3] for c in trec.calls] == [c[:3] for c in jrec.calls]
    assert [c[0] for c in trec.calls] == (
        ["start"] + ["iter"] * 2 + ["end"]) * 2 + ["done"]
    for a, b in zip(trec.calls, jrec.calls):
        if a[0] == "iter":
            np.testing.assert_allclose(a[3], b[3], **SCORE)
    assert set(trec.score_types) == {torch.Tensor}
    assert [i for i, _ in tcol.scores] == [i for i, _ in jcol.scores]
    np.testing.assert_allclose([s for _, s in tcol.scores],
                               [s for _, s in jcol.scores], **SCORE)


def test_fit_reads_no_score_without_a_listener(monkeypatch):
    """With no listener the step's score stays a device tensor: ``fit``
    converts nothing (``Tensor.item`` / ``__float__`` are never called)."""
    _, tnet = _nets("mln")
    reads = []
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: reads.append("item") or 0.0)
    tnet.fit(*_batches(1)[0], batch_size=4)
    assert reads == [] and isinstance(tnet._score, torch.Tensor)


def test_score_performance_time_listeners(caplog):
    _, tnet = _nets("mln")
    perf = tls.PerformanceListener(frequency=1, report_score=True)
    tnet.set_listeners(tls.ScoreIterationListener(1), perf,
                       tls.TimeIterationListener(total_iterations=3,
                                                 frequency=1))
    with caplog.at_level(logging.INFO):
        for x, y in _batches(3):
            tnet.fit(x, y, batch_size=4)
    assert [r["iteration"] for r in perf.history] == [2, 3]
    assert all(r["samples_per_sec"] > 0 and r["iter_ms"] > 0
               for r in perf.history)
    text = caplog.text
    assert "Score at iteration 3 is" in text and "score" in text
    assert "iteration 3/3" in text


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_evaluate_matches_jax(kind):
    jnet, tnet = _nets(kind)
    x, y = _batches(1, b=8)[0]
    je = jnet.evaluate(jds.DataSet(x, y))
    te = tnet.evaluate(tds.DataSet(x, y))
    assert isinstance(te, tev.Evaluation)
    np.testing.assert_array_equal(te.confusion, je.confusion)
    out = tnet.output(x)
    out = out[0] if isinstance(out, list) else out
    assert te.accuracy() == float((out.argmax(-1) == y.argmax(-1)).mean())
    if kind == "mln":
        jr = jnet.evaluate_regression(jds.DataSet(x, y))
        tr = tnet.evaluate_regression(tds.DataSet(x, y))
        np.testing.assert_allclose(tr.average_mean_squared_error(),
                                   jr.average_mean_squared_error(), **OUT)
        troc = tnet.evaluate_roc(tds.DataSet(x, y))
        jroc = jnet.evaluate_roc(jds.DataSet(x, y))
        np.testing.assert_allclose(troc.calculate_auc(),
                                   jroc.calculate_auc(), **OUT)


def test_evaluative_listener_evaluates_like_jax():
    jnet, tnet = _nets("mln")
    x, y = _batches(1, b=8, seed=9)[0]
    jl = jls.EvaluativeListener(jds.DataSet(x, y), frequency=1,
                                unit="iteration")
    tl = tls.EvaluativeListener(tds.DataSet(x, y), frequency=1,
                                unit="iteration")
    jnet.set_listeners(jl)
    tnet.set_listeners(tl)
    for bx, by in _batches(2):
        jnet.fit(bx, by, batch_size=4)
        tnet.fit(bx, by, batch_size=4)
    assert len(tl.evaluations) == len(jl.evaluations) == 2
    for a, b in zip(tl.evaluations, jl.evaluations):
        np.testing.assert_array_equal(a.confusion, b.confusion)


# ---------------------------------------------------------------------------
# zips across the packages
# ---------------------------------------------------------------------------


def _entries_equal(path_a, path_b):
    with zipfile.ZipFile(path_a) as a, zipfile.ZipFile(path_b) as b:
        assert a.namelist() == b.namelist()
        for entry in a.namelist():
            if entry == "configuration.json":
                assert json.loads(a.read(entry)) == json.loads(b.read(entry))
            else:
                assert a.read(entry) == b.read(entry), entry


def test_checkpoint_listener_zips_cross_both_ways(tmp_path):
    """The port's CheckpointListener (every iteration, keep 2) on a
    MultiLayerNetwork and on a ComputationGraph: the kept zips restore in
    the JAX package (``restore_model`` / ``restore_graph``) with the
    port's parameters; the JAX listener's MultiLayerNetwork zips restore
    in the port."""
    jnet, tnet = _nets("mln")
    ck = tls.CheckpointListener(str(tmp_path / "t"),
                                save_every_n_iterations=1, keep_last=2)
    jck = jls.CheckpointListener(str(tmp_path / "j"),
                                 save_every_n_iterations=1, keep_last=2)
    tnet.set_listeners(ck)
    jnet.set_listeners(jck)
    for x, y in _batches(3):
        tnet.fit(x, y, batch_size=4)
        jnet.fit(x, y, batch_size=4)
    assert [os.path.basename(p) for p in ck.saved] == [
        "checkpoint_iter_2.zip", "checkpoint_iter_3.zip"]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    back = jnn.restore_model(ck.saved[-1])
    np.testing.assert_array_equal(back.params_flat(), tnet.params_flat())
    assert back.iteration_count == 3
    port = tnn.restore_model(jck.saved[-1], device="cpu")
    np.testing.assert_array_equal(port.params_flat(), jnet.params_flat())
    np.testing.assert_array_equal(port.updater_state_flat(),
                                  jnet.updater_state_flat())
    _, tg = _nets("graph")
    gck = tls.CheckpointListener(str(tmp_path / "g"),
                                 save_every_n_epochs=1)
    tg.set_listeners(gck)
    tg.fit(tds.ListDataSetIterator([tds.DataSet(x, y)
                                    for x, y in _batches()]))
    jg = jgraph.restore_graph(gck.saved[-1])
    np.testing.assert_array_equal(jg.params_flat(), tg.params_flat())
    assert jg.epoch_count == 1


def test_graph_zips_cross_both_ways(tmp_path):
    """``save_graph`` in JAX → ``restore_graph`` in the port (the same
    parameters, updater state and counters; saved again, the same entry
    bytes), and the port's zip after a step → the JAX package, whose
    next step matches the port's."""
    jnet, tnet = _nets("graph")
    x, y = _batches(1)[0]
    jnet.fit(x, y, batch_size=4)
    path = str(tmp_path / "jax.zip")
    jgraph.save_graph(jnet, path)
    port = tgraph.restore_graph(path, device="cpu")
    np.testing.assert_array_equal(port.params_flat(), jnet.params_flat())
    assert port.iteration_count == 1 and port.epoch_count == 1
    again = str(tmp_path / "port.zip")
    tgraph.save_graph(port, again)
    _entries_equal(path, again)
    tnet.fit(x, y, batch_size=4)
    mine = str(tmp_path / "mine.zip")
    tgraph.save_graph(tnet, mine)
    jback = jgraph.restore_graph(mine)
    np.testing.assert_array_equal(jback.params_flat(), tnet.params_flat())
    x2, y2 = _batches(1, seed=8)[0]
    jback.fit(x2, y2, batch_size=4)
    port.fit(x2, y2, batch_size=4)
    np.testing.assert_allclose(port.score(), jback.score(), **SCORE)
    np.testing.assert_allclose(port.output(x2)[0], jback.output(x2)[0],
                               **OUT)


def test_one_writer_and_reader_serve_both_networks(tmp_path):
    """``save_model`` writes a graph's zip entry for entry as the JAX
    package's ``save_graph`` (no netState.bin, ``model_type`` in
    meta.json); ``restore_model`` reads the network type from meta.json;
    ``restore_graph`` refuses a MultiLayerNetwork's zip."""
    jg, tg = _nets("graph")
    jpath, tpath = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    jgraph.save_graph(jg, jpath)
    tnn.save_model(tg, tpath)
    _entries_equal(jpath, tpath)
    back = tnn.restore_model(jpath, device="cpu")
    assert isinstance(back, tgraph.ComputationGraph)
    np.testing.assert_array_equal(back.params_flat(), jg.params_flat())
    _, tm = _nets("mln")
    mpath = str(tmp_path / "mln.zip")
    tnn.save_model(tm, mpath)
    assert isinstance(tnn.restore_model(mpath, device="cpu"),
                      tnn.MultiLayerNetwork)
    with pytest.raises(ValueError, match="not a ComputationGraph"):
        tgraph.restore_graph(mpath, device="cpu")


# ---------------------------------------------------------------------------
# normalizers
# ---------------------------------------------------------------------------

NORMALIZERS = ["NormalizerStandardize", "NormalizerMinMaxScaler",
               "ImagePreProcessingScaler"]


@pytest.mark.parametrize("name", NORMALIZERS)
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_normalizers_match_jax(name, dtype):
    rng = np.random.default_rng(11)
    feats = (rng.integers(0, 256, (6, 4, 4, 3)).astype(np.uint8)
             if dtype == "uint8"
             else rng.standard_normal((6, 4, 4, 3)).astype(np.float32))
    j, t = getattr(jds, name)(), getattr(tds, name)()
    parts = [(feats[:3], None), (feats[3:], None)]
    j.fit(jds.ListDataSetIterator([jds.DataSet(f) for f, _ in parts]))
    t.fit(tds.ListDataSetIterator([tds.DataSet(f) for f, _ in parts]))
    for k, v in j.state().items():
        np.testing.assert_array_equal(np.asarray(t.state()[k]),
                                      np.asarray(v), err_msg=k)
    jd, td = jds.DataSet(feats.copy()), tds.DataSet(feats.copy())
    j.transform(jd)
    t.transform(td)
    assert td.features.dtype == jd.features.dtype
    # float32 arithmetic of one formula: the native uint8 loop may fuse
    np.testing.assert_allclose(td.features, jd.features, rtol=1e-6,
                               atol=1e-6)
    if name == "NormalizerStandardize" and dtype == "float32":
        j.revert(jd)
        t.revert(td)
        np.testing.assert_allclose(td.features, jd.features, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name", NORMALIZERS)
def test_normalizer_zips_cross_both_ways(tmp_path, name):
    """``save_model(..., normalizer=)`` in either package, then
    ``restore_normalizer`` in the other: the same class and state; the
    entry's bytes equal."""
    jnet, tnet = _nets("mln")
    feats = np.random.default_rng(12).random((5, 6, 6, 2)).astype(
        np.float32) * 255
    j, t = getattr(jds, name)(), getattr(tds, name)()
    j.fit(jds.DataSet(feats))
    t.fit(tds.DataSet(feats))
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jnn.save_model(jnet, jpath, normalizer=j)
    tnn.save_model(tnet, tpath, normalizer=t)
    with zipfile.ZipFile(jpath) as a, zipfile.ZipFile(tpath) as b:
        assert a.read("normalizer.json") == b.read("normalizer.json")
    from_jax = tnn.restore_normalizer(jpath)
    from_port = jnn.restore_normalizer(tpath)
    assert type(from_jax).__name__ == type(from_port).__name__ == name
    for k, v in j.state().items():
        np.testing.assert_array_equal(np.asarray(from_jax.state()[k]),
                                      np.asarray(v))
        np.testing.assert_array_equal(np.asarray(from_port.state()[k]),
                                      np.asarray(t.state()[k]))
    plain = str(tmp_path / "plain.zip")
    tnn.save_model(tnet, plain)
    assert tnn.restore_normalizer(plain) is None
