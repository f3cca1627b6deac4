"""The recurrent entry points of the port's ComputationGraph against the
JAX graph (CPU): ``rnn_time_step`` / ``rnn_clear_previous_state``,
``fit_tbptt`` and ``fit``'s truncated-BPTT dispatch, and ``fit_multi``,
from the same numpy parameters and inputs; and, within the port, the
graph against the ``MultiLayerNetwork`` of the same layers.

Tolerances (float32; the two frameworks sum in other orders): outputs
1e-5 relative + 1e-5 absolute, scores 1e-5 relative, parameters after
the steps each leaf's move within 1e-3 relative L2 of the JAX move and
every element within 1e-4 (``test_torch_multilayer.py`` gives the reason:
Adam's step is steep where |g| nears its epsilon). The port's graph and
network run the same ops in the same order: bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import faults as jfaults
from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu_torch import faults
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.nn import graph as tgraph

OUT = dict(rtol=1e-5, atol=1e-5)
SCORE = dict(rtol=1e-5)
MOVE_REL = 1e-3
ELEM_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """Both fit loops poll their package's faults: none armed here."""
    monkeypatch.delenv(faults.FAULTS_ENV, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _host(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _assert_moved_alike(jparams, tparams, start):
    for name in start:
        for k in start[name]:
            j = np.asarray(jparams[name][k])
            t = tparams[name][k].detach().cpu().numpy()
            move = j - start[name][k]
            rel = np.linalg.norm(t - j) / max(np.linalg.norm(move), 1e-30)
            assert rel <= MOVE_REL, (name, k, rel)
            np.testing.assert_allclose(t, j, rtol=0, atol=ELEM_ATOL,
                                       err_msg=f"{name}.{k}")


def _pair(build):
    """The JAX graph and the port's from one builder, the port holding
    the JAX parameters."""
    jg = jgraph.ComputationGraph(build(jnn, jgraph)).init()
    tg = tgraph.ComputationGraph(build(tnn, tgraph), device="cpu").init(
        params=_host(jg.params))
    return jg, tg


def _stream_graph(pkg, gmod):
    return (gmod.graph_builder().seed(4).updater(pkg.Adam(learning_rate=1e-2))
            .add_inputs("in")
            .set_input_types(**{"in": pkg.InputType.recurrent(4)})
            .add_layer("lstm", pkg.LSTM(n_out=6, activation="tanh"), "in")
            .add_layer("gru", pkg.GRU(n_out=5), "lstm")
            .add_layer("rnn", pkg.SimpleRnn(n_out=4, activation="tanh"),
                       "gru")
            .add_layer("out", pkg.RnnOutputLayer(
                n_out=3, activation="softmax", loss="mcxent"), "rnn")
            .set_outputs("out").build())


def test_rnn_time_step_streams_like_jax_and_like_output():
    """Single steps, then a chunk: equal to the JAX graph's
    ``rnn_time_step`` and to the port's own ``output`` over the whole
    sequence; clearing the state starts over."""
    jg, tg = _pair(_stream_graph)
    x = np.random.default_rng(2).standard_normal((2, 9, 4),
                                                 dtype=np.float32)
    whole = tg.output(x)[0]
    np.testing.assert_allclose(whole, np.asarray(jg.output(x)[0]), **OUT)
    streamed = [tg.rnn_time_step(x[:, t]) for t in range(6)]
    jstreamed = [np.asarray(jg.rnn_time_step(x[:, t])) for t in range(6)]
    assert streamed[0].shape == (2, 3)
    streamed.extend(np.moveaxis(tg.rnn_time_step(x[:, 6:]), 1, 0))
    jstreamed.extend(np.moveaxis(np.asarray(jg.rnn_time_step(x[:, 6:])), 1,
                                 0))
    np.testing.assert_allclose(np.stack(streamed, 1), whole, **OUT)
    np.testing.assert_allclose(np.stack(streamed, 1),
                               np.stack(jstreamed, 1), **OUT)
    h, c = tg._rnn_states["lstm"]
    jh, jc = jg._rnn_states["lstm"]
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **OUT)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **OUT)
    assert tg._rnn_states["out"] is None
    tg.rnn_clear_previous_state()
    np.testing.assert_allclose(tg.rnn_time_step(x[:, 0]), whole[:, 0],
                               **OUT)


def _tbptt_graph(pkg, gmod):
    conf = (gmod.graph_builder().seed(5)
            .updater(pkg.Adam(learning_rate=1e-2)).add_inputs("in")
            .set_input_types(**{"in": pkg.InputType.recurrent(3)})
            .add_layer("lstm", pkg.LSTM(n_out=8, activation="tanh"), "in")
            .add_layer("out", pkg.RnnOutputLayer(
                n_out=4, activation="softmax", loss="mcxent"), "lstm")
            .set_outputs("out").build())
    conf.backprop_type = "tbptt"
    conf.tbptt_fwd_length = 5
    conf.tbptt_back_length = 5
    return conf


class _Scores:
    """Every listener call's (iteration, score), in order."""

    def __init__(self):
        self.calls = []

    def iteration_done(self, model, iteration, epoch, score):
        self.calls.append((iteration, float(score)))

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


def test_fit_dispatches_tbptt_like_jax():
    """``fit`` on a tBPTT graph: T 20 in segments of 5 over two batches —
    the per-segment scores the listeners see (and their iteration
    numbers), the iteration count, the cursor and the parameters."""
    jg, tg = _pair(_tbptt_graph)
    start = _host(jg.params)
    js, ts = _Scores(), _Scores()
    jg.set_listeners(js)
    tg.set_listeners(ts)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 20, 3), dtype=np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (6, 20))]
    jg.fit(x, y, batch_size=3)
    tg.fit(x, y, batch_size=3)
    assert [i for i, _ in ts.calls] == [i for i, _ in js.calls]
    assert len(ts.calls) == 8
    np.testing.assert_allclose([s for _, s in ts.calls],
                               [s for _, s in js.calls], **SCORE)
    np.testing.assert_allclose(tg.tbptt_scores(),
                               [s for _, s in js.calls[4:]], **SCORE)
    assert tg.iteration_count == jg.iteration_count == 8
    assert tg.epoch_count == jg.epoch_count == 1
    assert tg.batch_in_epoch == jg.batch_in_epoch == 0
    _assert_moved_alike(jg.params, tg.params, start)


def test_fit_tbptt_with_dicts_and_masks_like_jax():
    """``fit_tbptt`` called directly, name-keyed inputs and right-padded
    masks: the returned score and the parameters."""
    jg, tg = _pair(_tbptt_graph)
    start = _host(jg.params)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 12, 3), dtype=np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 12))]
    m = (np.arange(12)[None] < np.array([12, 9, 4])[:, None]).astype(
        np.float32)
    for _ in range(2):
        got = tg.fit_tbptt({"in": x}, {"out": y}, masks={"in": m},
                           lmasks={"out": m})
        want = jg.fit_tbptt({"in": x}, {"out": y}, masks={"in": m},
                            lmasks={"out": m})
        np.testing.assert_allclose(got, want, **SCORE)
    assert tg.iteration_count == jg.iteration_count == 6
    _assert_moved_alike(jg.params, tg.params, start)


def test_tbptt_and_rnn_time_step_refusals():
    _, tg = _pair(_tbptt_graph)
    with pytest.raises(ValueError, match="3-D time-series labels"):
        tg.fit_tbptt(np.zeros((2, 10, 3), np.float32),
                     np.zeros((2, 4), np.float32))
    tg.conf.tbptt_fwd_length = -1
    with pytest.raises(ValueError, match="tbptt lengths"):
        tg.fit_tbptt(np.zeros((2, 10, 3), np.float32),
                     np.zeros((2, 10, 4), np.float32))
    bidir = tgraph.ComputationGraph(
        tgraph.graph_builder().seed(1).add_inputs("in")
        .set_input_types(**{"in": tnn.InputType.recurrent(3)})
        .add_layer("bi", tnn.Bidirectional.wrap(
            tnn.LSTM(n_out=4, activation="tanh"), "concat"), "in")
        .add_layer("out", tnn.RnnOutputLayer(n_out=2, activation="softmax",
                                             loss="mcxent"), "bi")
        .set_outputs("out").build(), device="cpu").init()
    with pytest.raises(ValueError, match="Bidirectional"):
        bidir.rnn_time_step(np.zeros((2, 3), np.float32))


def _multi_graph(pkg, gmod):
    return (gmod.graph_builder().seed(6)
            .updater(pkg.Adam(learning_rate=1e-2)).add_inputs("a", "b")
            .set_input_types(a=pkg.InputType.feed_forward(3),
                             b=pkg.InputType.feed_forward(2))
            .add_vertex("merge", gmod.MergeVertex(), "a", "b")
            .add_layer("h", pkg.DenseLayer(n_out=6, activation="tanh"),
                       "merge")
            .add_layer("cls", pkg.OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "h")
            .add_layer("reg", pkg.OutputLayer(n_out=2, activation="identity",
                                              loss="mse"), "h")
            .set_outputs("cls", "reg").build())


def test_fit_multi_like_jax():
    """Two inputs merged, two output layers (softmax + mse): three
    ``fit_multi`` steps from lists and from name-keyed dicts."""
    jg, tg = _pair(_multi_graph)
    start = _host(jg.params)
    rng = np.random.default_rng(7)
    calls = _Scores()
    tg.set_listeners(calls)
    for i in range(3):
        a = rng.standard_normal((5, 3), dtype=np.float32)
        b = rng.standard_normal((5, 2), dtype=np.float32)
        cls = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]
        reg = rng.standard_normal((5, 2), dtype=np.float32)
        if i == 1:
            got = tg.fit_multi({"a": a, "b": b}, {"cls": cls, "reg": reg})
        else:
            got = tg.fit_multi([a, b], [cls, reg])
        want = jg.fit_multi([a, b], [cls, reg])
        np.testing.assert_allclose(got, want, **SCORE)
    assert tg.iteration_count == jg.iteration_count == 3
    assert [i for i, _ in calls.calls] == [1, 2, 3]
    assert tg.last_batch_size == 5
    outs = tg.output(a, b)
    for t, j in zip(outs, jg.output(a, b)):
        np.testing.assert_allclose(t, np.asarray(j), **OUT)
    _assert_moved_alike(jg.params, tg.params, start)


def _seq_pair():
    """The same LSTM → RnnOutput layers as a tBPTT graph and a tBPTT
    MultiLayerNetwork, the network holding the graph's parameters."""
    tg = tgraph.ComputationGraph(_tbptt_graph(tnn, tgraph),
                                 device="cpu").init()
    conf = (tnn.builder().seed(5).updater(tnn.Adam(learning_rate=1e-2))
            .tbptt(5, 5).list()
            .layer(tnn.LSTM(n_out=8, activation="tanh"))
            .layer(tnn.RnnOutputLayer(n_out=4, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(tnn.InputType.recurrent(3)).build())
    mln = tnn.MultiLayerNetwork(conf, device="cpu").init(
        params=[tg.params["lstm"], tg.params["out"]])
    return tg, mln


def test_graph_and_network_tbptt_agree_bit_for_bit():
    tg, mln = _seq_pair()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 15, 3), dtype=np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (4, 15))]
    for _ in range(2):
        tg.fit(x, y, batch_size=4)
        mln.fit(x, y, batch_size=4)
        assert tg.tbptt_scores() == mln.tbptt_scores()
    for name, i in (("lstm", 0), ("out", 1)):
        for k, v in tg.params[name].items():
            assert torch.equal(v, mln.params[i][k]), (name, k)
    streamed_g = [tg.rnn_time_step(x[:, t]) for t in range(15)]
    streamed_m = [mln.rnn_time_step(x[:, t]) for t in range(15)]
    np.testing.assert_array_equal(np.stack(streamed_g), np.stack(streamed_m))
