"""Transfer learning and early stopping of the PyTorch port against the JAX
package (CPU).

* ``TransferLearning.builder`` on a small MultiLayerNetwork: kept layers
  carry the source's parameters bit for bit, frozen layers get the
  ``Frozen`` updater and stay bit-identical through two ``fit`` steps
  (also under a ``FineTuneConfiguration`` with l2 and weight decay),
  ``n_out_replace`` re-initializes its layer and fixes the next layer's
  n_in, an added layer infers its n_in; the re-initialized layers' draws
  are carried across from the JAX network (the two packages draw from
  different generators), then both networks take the same two steps.
* ``TransferLearningHelper``: the featurized dataset and the head's fit.
* ``graph_transfer_builder`` on a 2-layer Keras encoder
  (``testing/keras_builder``, dropout 0) imported by both packages, with
  the card's recipe (``testing/layer_nets.transfer_keras_encoder``): kept,
  frozen and re-initialized parameters and two multi-input steps.
* ``EarlyStoppingTrainer`` through both packages on the same data, for a
  MultiLayerNetwork and a ComputationGraph: termination reason, best
  epoch, score history; the best model restored in place.

Tolerances: SGD steps 1e-5 relative + 1e-6 absolute (float32, the two
frameworks sum in other orders); scores 1e-5 relative; frozen and kept
leaves bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import (
    ListDataSetIterator as JListIterator)
from deeplearning4j_tpu.imports import keras_import as JK
from deeplearning4j_tpu.nn import earlystopping as JES
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.imports import keras_import as TK
from deeplearning4j_tpu_torch.nn import graph as tgraph
from deeplearning4j_tpu_torch.testing import keras_builder as kb
from deeplearning4j_tpu_torch.testing import layer_nets as L

STEP = dict(rtol=1e-5, atol=1e-6)
EXACT = dict(rtol=0, atol=0)


def _host(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _np(tree):
    return jax.tree.map(lambda t: t.detach().cpu().numpy(), tree)


def _assert_trees(want, got, tol, what):
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree.leaves(got)
    assert len(wl) == len(gl), what
    for (path, w), g in zip(wl, gl):
        np.testing.assert_allclose(g, w, err_msg=f"{what} {path}", **tol)


def _mln(pkg):
    return (pkg.builder().seed(5).updater(pkg.Adam(learning_rate=0.01))
            .list()
            .layer(pkg.DenseLayer(n_in=6, n_out=5, activation="tanh"))
            .layer(pkg.DenseLayer(n_in=5, n_out=4, activation="relu"))
            .layer(pkg.OutputLayer(n_in=4, n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(6)).build())


def _data(n=8, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(n, 6).astype(np.float32),
            np.eye(3, dtype=np.float32)[r.randint(0, 3, n)])


RECIPES = {
    "freeze_and_replace": lambda pkg, b: (
        b.fine_tune_configuration(pkg.FineTuneConfiguration(
            updater=pkg.Sgd(learning_rate=0.1)))
        .set_feature_extractor(0).n_out_replace(1, 7)),
    "new_head_l2_decay": lambda pkg, b: (
        b.fine_tune_configuration(pkg.FineTuneConfiguration(
            updater=pkg.Sgd(learning_rate=0.1), l2=1e-2, weight_decay=1e-2))
        .set_feature_extractor(1).remove_output_layer()
        .add_layer(pkg.OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent"))),
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_transfer_builder_matches_jax(recipe):
    jsrc = jnn.MultiLayerNetwork(_mln(jnn)).init()
    tsrc = tnn.MultiLayerNetwork(_mln(tnn), device="cpu").init(
        params=_host(jsrc.params))
    jnet = RECIPES[recipe](jnn, jnn.TransferLearning.builder(jsrc)).build()
    tnet = RECIPES[recipe](tnn, tnn.TransferLearning.builder(tsrc)).build()
    assert jnet.conf.to_json() == tnet.conf.to_json()
    frozen = 1 if recipe == "freeze_and_replace" else 2
    kept = frozen if recipe == "freeze_and_replace" else 2
    for i, lc in enumerate(tnet.conf.layers):
        assert (type(lc.updater).__name__ == "Frozen") == (i < frozen)
    for i in range(kept):  # kept: the source's leaves
        _assert_trees(_host(jsrc.params[i]), _np(tnet.params[i]), EXACT,
                      f"kept {i}")
    if recipe == "freeze_and_replace":  # the fan-in follows
        assert tnet.params[1]["W"].shape == (5, 7)
        assert tnet.params[2]["W"].shape == (7, 3)
        assert tnet.conf.layers[2].n_in == 7
    else:
        assert tnet.params[2]["W"].shape == (4, 2)
    # the re-initialized layers take the JAX draw, then two steps each
    for i in range(kept, len(tnet.params)):
        tnet.params[i] = {k: torch.from_numpy(np.array(v))
                          for k, v in jnet.params[i].items()}
    x, y = _data()
    if recipe == "new_head_l2_decay":  # the new head has two classes
        y = np.eye(2, dtype=np.float32)[np.argmax(y, -1) % 2]
    before = _np(tnet.params)
    for _ in range(2):
        jnet.fit(JDataSet(x, y), batch_size=8)
        tnet.fit(DataSet(x, y), batch_size=8)
    _assert_trees(_host(jnet.params), _np(tnet.params), STEP, recipe)
    for i in range(frozen):  # frozen: bit-identical through the steps
        _assert_trees(before[i], _np(tnet.params[i]), EXACT, f"frozen {i}")
        _assert_trees(_host(jsrc.params[i]), _host(jnet.params[i]), EXACT,
                      f"jax frozen {i}")


def test_transfer_learning_helper_matches_jax():
    jsrc = jnn.MultiLayerNetwork(_mln(jnn)).init()
    tsrc = tnn.MultiLayerNetwork(_mln(tnn), device="cpu").init(
        params=_host(jsrc.params))
    jh = jnn.TransferLearningHelper(jsrc, frozen_until=0)
    th = tnn.TransferLearningHelper(tsrc, frozen_until=0)
    x, y = _data(seed=3)
    jf, tf_ = jh.featurize(JDataSet(x, y)), th.featurize(DataSet(x, y))
    np.testing.assert_allclose(tf_.features, np.asarray(jf.features), **STEP)
    jh.fit_featurized(jf, epochs=2, batch_size=4)
    th.fit_featurized(tf_, epochs=2, batch_size=4)
    _assert_trees(_host(jsrc.params), _np(tsrc.params), dict(rtol=1e-4,
                                                             atol=1e-5),
                  "helper")
    assert th.unfrozen_mln() is th.head
    _assert_trees(_host(jsrc.params[0]), _np(tsrc.params[0]), STEP,
                  "prefix untouched")


KERAS = dict(layers=2, hidden=32, heads=4, ff=64, vocab=100,
             max_positions=16, seq=8, dropout=0.0)


@pytest.fixture(scope="module")
def keras_pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kt") / "bert.h5")
    kb.bert_keras_h5(path, std=0.2, **KERAS)
    return (JK.import_keras_model_and_weights(path),
            TK.import_keras_model_and_weights(path, device="cpu"))


def test_graph_transfer_of_a_keras_encoder_matches_jax(keras_pair):
    jsrc, tsrc = keras_pair
    kw = dict(freeze_at="layer_0_output_norm", classes=3,
              hidden=KERAS["hidden"])
    jnet = L.transfer_keras_encoder(jnn, jsrc,
                                    updater=jnn.Sgd(learning_rate=0.1), **kw)
    tnet = L.transfer_keras_encoder(tnn, tsrc,
                                    updater=tnn.Sgd(learning_rate=0.1), **kw)
    assert jnet.conf.network_outputs == tnet.conf.network_outputs == ["head"]
    frozen = {n.name for n in tnet.conf.nodes if n.layer is not None
              and type(n.layer.updater).__name__ == "Frozen"}
    jfrozen = {n.name for n in jnet.conf.nodes if n.layer is not None
               and type(n.layer.updater).__name__ == "Frozen"}
    assert frozen == jfrozen
    assert {"token_embedding", "layer_0_attention",
            "layer_0_output_norm"} <= frozen
    assert not frozen & {"layer_1_attention", "pooler", "head"}
    assert "classifier" not in tnet.params
    for name, leaves in tsrc.params.items():  # kept: the source's leaves
        if name != "classifier":
            _assert_trees(_np(leaves), _np(tnet.params[name]), EXACT, name)
    # the re-initialized head takes the JAX draw; two multi-input steps
    tnet.params["head"] = {k: torch.from_numpy(np.array(v))
                           for k, v in jnet.params["head"].items()}
    ids, pos = kb.bert_inputs(4, KERAS["seq"], KERAS["vocab"], seed=2)
    feeds = [ids.astype(np.float32), pos.astype(np.float32)]
    y = np.eye(3, dtype=np.float32)[[0, 2, 1, 2]]
    before = _np(tnet.params)
    jl = [jnet.fit_multi(feeds, [y]) for _ in range(2)]
    tl = [tnet.fit_multi(feeds, [y]) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for name in tnet.params:
        want = _host(jnet.params[name])
        if name in frozen:
            _assert_trees(before[name], _np(tnet.params[name]), EXACT, name)
        _assert_trees(want, _np(tnet.params[name]), STEP, name)
    # the graph scores a multi-input dataset as the sequential network does
    ds = DataSet(ids, y)
    ds.features = feeds
    score = tnet.score(ds)
    out = tnet.output(*feeds)[0]
    np.testing.assert_allclose(
        score, -np.mean(np.sum(y * np.log(out), -1)), rtol=1e-5)


# --------------------------------------------------------- early stopping


def _es_data(seed):
    r = np.random.RandomState(seed)
    x = r.randn(24, 6).astype(np.float32)
    w = r.randn(6, 3)
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, -1)]
    return x, y


def _graph(pkg_graph, pkg):
    return (pkg_graph.graph_builder().seed(5)
            .updater(pkg.Sgd(learning_rate=0.5)).add_inputs("in")
            .add_layer("h", pkg.DenseLayer(n_in=6, n_out=5,
                                           activation="tanh"), "in")
            .add_layer("out", pkg.OutputLayer(n_in=5, n_out=3,
                                              activation="softmax",
                                              loss="mcxent"), "h")
            .set_outputs("out").build())


def _xent(probs, y):
    return float(-np.mean(np.sum(y * np.log(np.asarray(probs) + 1e-12), -1)))


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_early_stopping_matches_jax(kind):
    x, y = _es_data(0)
    hx, hy = _es_data(1)
    if kind == "mln":
        jconf = (jnn.builder().seed(5).updater(jnn.Sgd(learning_rate=0.5))
                 .list().layer(jnn.DenseLayer(n_in=6, n_out=5,
                                              activation="tanh"))
                 .layer(jnn.OutputLayer(n_in=5, n_out=3,
                                        activation="softmax",
                                        loss="mcxent")).build())
        tconf = tnn.MultiLayerConfiguration.from_json(jconf.to_json())
        jnet = jnn.MultiLayerNetwork(jconf).init()
        tnet = tnn.MultiLayerNetwork(tconf, device="cpu").init(
            params=_host(jnet.params))
        calc = (None, None)
        tests = (JListIterator(JDataSet(hx, hy), batch_size=12),
                 ListDataSetIterator(DataSet(hx, hy), batch_size=12))
    else:
        jnet = jgraph.ComputationGraph(_graph(jgraph, jnn)).init()
        tnet = tgraph.ComputationGraph(_graph(tgraph, tnn),
                                       device="cpu").init(
            params=_host(jnet.params))
        # the JAX graph scores no dataset: a held-out loss calculator
        calc = tuple(lambda net: _xent(net.output(hx)[0], hy)
                     for _ in range(2))
        tests = (None, None)
    results, nets = [], (jnet, tnet)
    for pkg, es, net, it_cls, ds_cls, c, test in (
            (jnn, JES, jnet, JListIterator, JDataSet, calc[0], tests[0]),
            (tnn, tnn, tnet, ListDataSetIterator, DataSet, calc[1],
             tests[1])):
        cfg = es.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(6),
                es.ScoreImprovementEpochTerminationCondition(1, 1e-3)],
            iteration_termination_conditions=[
                es.MaxScoreIterationTerminationCondition(1e6)],
            score_calculator=c, model_saver=es.InMemoryModelSaver())
        train = it_cls(ds_cls(x, y), batch_size=6)
        results.append(es.EarlyStoppingTrainer(cfg, net, train, test).fit())
    jr, tr = results
    assert tr.termination_reason == jr.termination_reason
    assert tr.termination_details == jr.termination_details
    assert tr.best_epoch == jr.best_epoch and tr.total_epochs == \
        jr.total_epochs
    assert sorted(tr.score_history) == sorted(jr.score_history)
    np.testing.assert_allclose([tr.score_history[k] for k in
                                sorted(tr.score_history)],
                               [jr.score_history[k] for k in
                                sorted(jr.score_history)], rtol=1e-5)
    np.testing.assert_allclose(tr.best_score, jr.best_score, rtol=1e-5)
    # the best model is back in the network, and scores best_score
    assert tr.best_model is tnet
    again = (tnet.score(DataSet(hx, hy)) if kind == "mln"
             else calc[1](tnet))
    np.testing.assert_allclose(again, tr.best_score, rtol=1e-6)
    _assert_trees(_host(jnet.params), _np(tnet.params), dict(rtol=1e-4,
                                                             atol=1e-5),
                  "best model")


def test_in_memory_saver_restores_into_the_live_tensors():
    net = tnn.MultiLayerNetwork(_mln(tnn), device="cpu").init()
    saver = tnn.InMemoryModelSaver()
    saver.save_best(net)
    x, y = _data()
    net.fit(DataSet(x, y), batch_size=8)
    live = [t for p in net.params for t in p.values()]
    moved = [t.clone() for t in live]
    saver.restore_best(net)
    after = [t for p in net.params for t in p.values()]
    assert all(a is b for a, b in zip(after, live))
    assert any(not torch.equal(a, m) for a, m in zip(after, moved))
    for a, p in zip(after, [t for p in saver.best["params"]
                            for t in p.values()]):
        assert torch.equal(a, p) and a is not p
