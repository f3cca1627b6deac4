"""MultiLayerNetwork of the PyTorch port against the JAX package (CPU).

Configurations cross as JSON in both directions; parameters are drawn by
the JAX package and carried across as numpy (``init(params=...)``),
never re-seeded; inputs are drawn with numpy. Covered: the JSON of every
ported layer and preprocessor, LeNet at full width (3 ``fit`` steps), a
small BiLSTM tagger on ragged right-padded masks (3 steps), truncated
BPTT (per-segment losses and ``iteration_count``), ``rnn_time_step``
streaming, model zips both ways, and a ComputationGraph holding the new
recurrent layers.

Tolerances, with their reasons (float32 everywhere; the two frameworks
sum in other orders):

* scores: 1e-5 relative;
* outputs: 1e-5 relative + 1e-5 absolute;
* parameters after Adam steps: each parameter's move (final − initial)
  within 1e-3 relative L2 norm of the JAX move, and every element within
  1e-4 absolute. Adam's step lr·g/(|g| + 1e-8) is steep where |g| is near
  its epsilon: there a rounding of g moves an element by up to a share of
  lr (1e-3 … 1e-2). The few such elements dominate the difference (LeNet's
  dense weight: 3.2e-5 at most, 1.5e-4 of its move in L2 norm, when the
  bound was set); the rest agree to ~1e-7;
* updater state after the steps: 1e-4 relative + 1e-6 absolute: Adam's
  first moment sums gradients whose roundings are ~1e-7 of their largest
  terms (9 of LeNet's 862,160 entries differ by 1e-7 … 2.2e-7).
"""

import json
import zipfile

import numpy as np
import pytest

import jax
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.zoo import LeNet as JLeNet
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import LeNet, TextGenerationLSTM
from deeplearning4j_tpu_torch.nn import graph as tgraph

SCORE = dict(rtol=1e-5)
OUT = dict(rtol=1e-5, atol=1e-5)
MOVE_REL = 1e-3
ELEM_ATOL = 1e-4
STATE = dict(rtol=1e-4, atol=1e-6)


def _host(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _assert_params_moved_alike(jparams, tparams, start):
    """Each leaf's move agrees in relative L2 norm; every element within
    ELEM_ATOL (see the module docstring)."""
    jl = jax.tree_util.tree_leaves_with_path(_host(jparams))
    tl = jax.tree.leaves(jax.tree.map(lambda t: t.detach().cpu().numpy(),
                                      tparams))
    sl = jax.tree.leaves(start)
    assert len(jl) == len(tl) == len(sl)
    for (path, j), t, s in zip(jl, tl, sl):
        move = j - s
        rel = np.linalg.norm(t - j) / max(np.linalg.norm(move), 1e-30)
        assert rel <= MOVE_REL, (path, rel)
        np.testing.assert_allclose(t, j, rtol=0, atol=ELEM_ATOL,
                                   err_msg=str(path))


def _tagger_data(n=4, t=10, f=6, classes=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t, f), dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, (n, t))]
    lengths = np.array([t, 7, 3, 1][:n])
    m = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return x, y, m


def _tagger_conf(pkg, hidden=8, f=6, classes=5):
    return (pkg.builder().seed(12).updater(pkg.Adam(learning_rate=5e-3))
            .list()
            .layer(pkg.Bidirectional.wrap(
                pkg.LSTM(n_out=hidden, activation="tanh"), "concat"))
            .layer(pkg.RnnOutputLayer(n_out=classes, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(f))
            .build())


# ---------------------------------------------------------------------------
# configuration JSON
# ---------------------------------------------------------------------------


def _every_layer_conf(pkg):
    lstm = pkg.LSTM(n_out=4, activation="tanh")
    return (pkg.builder().seed(3).updater(pkg.RmsProp(learning_rate=1e-2))
            .l2(1e-4).gradient_normalization("clip_l2_per_layer", 2.0)
            .tbptt(5, 4).list()
            .layer(pkg.EmbeddingSequenceLayer(n_in=20, n_out=6))
            .layer(pkg.DropoutLayer(rate=0.2, mode="spatial"))
            .layer(pkg.GravesLSTM(n_out=5, activation="tanh", dropout=0.1))
            .layer(pkg.GRU(n_out=5))
            .layer(pkg.SimpleRnn(n_out=5, activation="relu"))
            .layer(pkg.Bidirectional.wrap(lstm, "average"))
            .layer(pkg.LastTimeStep.wrap(pkg.LSTM(n_out=3)))
            .layer(pkg.EmbeddingLayer(n_in=3, n_out=4, has_bias=True))
            .layer(pkg.LossLayer(activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(1))
            .build())


def _rnn_loss_conf(pkg):
    return (pkg.builder().list()
            .layer(pkg.LSTM(n_out=4, activation="tanh"))
            .layer(pkg.RnnLossLayer(activation="softmax"))
            .input_pre_processor(1, pkg.conf.RnnToFeedForwardPreProcessor())
            .set_input_type(pkg.InputType.recurrent(3))
            .build())


CONFS = {"lenet": lambda pkg: JLeNet().init().conf if pkg is jnn
         else LeNet(device="cpu").conf(),
         "tagger": _tagger_conf, "every_layer": _every_layer_conf,
         "rnn_loss": _rnn_loss_conf}


@pytest.mark.parametrize("name", sorted(CONFS))
def test_json_crosses_both_ways(name):
    """JAX to_json → port from_json → port to_json → JAX from_json, and
    the port's own builder writes the JAX package's JSON."""
    jconf = CONFS[name](jnn)
    jtext = jconf.to_json()
    tconf = tnn.MultiLayerConfiguration.from_json(jtext)
    ttext = tconf.to_json()
    assert json.loads(ttext) == json.loads(jtext)
    back = jnn.MultiLayerConfiguration.from_json(ttext)
    assert json.loads(back.to_json()) == json.loads(jtext)
    assert json.loads(CONFS[name](tnn).to_json()) == json.loads(jtext)


def test_shape_inference_inserts_the_jax_preprocessors():
    conf = LeNet(device="cpu").conf()
    assert conf.preprocessors == {
        0: tnn.FeedForwardToCnnPreProcessor(28, 28, 1),
        4: tnn.CnnToFeedForwardPreProcessor(4, 4, 50)}
    assert conf.layers[4].n_in == 800
    tagger = _tagger_conf(tnn)
    assert tagger.layers[0].inner().n_in == 6
    assert tagger.layers[1].n_in == 16


@pytest.mark.parametrize("name", ["SelfAttentionLayer",
                                  "CenterLossOutputLayer"])
def test_unported_types_are_refused_by_name_in_multilayer_json(name):
    text = _tagger_conf(jnn).to_json().replace(
        '"@type": "RnnOutputLayer"', f'"@type": "{name}"', 1)
    with pytest.raises(ValueError, match=f"'{name}' is not ported"):
        tnn.MultiLayerConfiguration.from_json(text)
    # every preprocessor of the JAX package is ported (the 3-D one with
    # the Keras importer); a name outside that set is still refused
    text = LeNet(device="cpu").conf().to_json()
    conf = tnn.MultiLayerConfiguration.from_json(text.replace(
        '"CnnToFeedForwardPreProcessor"', '"Cnn3DToFeedForwardPreProcessor"'))
    assert conf.preprocessors[4] == tnn.Cnn3DToFeedForwardPreProcessor(
        0, 4, 4, 50)
    text = text.replace('"CnnToFeedForwardPreProcessor"',
                        '"CnnToRnnPreProcessor"')
    with pytest.raises(ValueError, match="'CnnToRnnPreProcessor' "
                                         "is not ported"):
        tnn.MultiLayerConfiguration.from_json(text)


# ---------------------------------------------------------------------------
# training against the JAX package
# ---------------------------------------------------------------------------


def test_lenet_three_fit_steps_match_jax():
    """LeNet at its zoo defaults (431,080 parameters), batch 8, three
    ``fit`` steps from the JAX parameters."""
    jnet = JLeNet().init()
    start = _host(jnet.params)
    tnet = LeNet(device="cpu").init(params=start)
    assert tnet.num_params() == jnet.num_params() == 431080
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.random((8, 784), dtype=np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
        np.testing.assert_allclose(tnet.output(x), jnet.output(x), **OUT)
        jnet.fit(x, y, batch_size=8)
        tnet.fit(x, y, batch_size=8)
        np.testing.assert_allclose(tnet.score(), jnet.score(), **SCORE)
    assert tnet.iteration_count == jnet.iteration_count == 3
    _assert_params_moved_alike(jnet.params, tnet.params, start)
    np.testing.assert_allclose(tnet.updater_state_flat(),
                               jnet.updater_state_flat(), **STATE)


def test_bilstm_tagger_three_steps_match_jax():
    """Bidirectional(LSTM 8, concat) → RnnOutputLayer over T 10 with
    right-padded features and labels masks (lengths 10, 7, 3, 1): per-step
    scores, outputs at every position and the parameters."""
    jnet = jnn.MultiLayerNetwork(_tagger_conf(jnn)).init()
    start = _host(jnet.params)
    tnet = tnn.MultiLayerNetwork(_tagger_conf(tnn), device="cpu").init(
        params=start)
    x, y, m = _tagger_data()
    np.testing.assert_allclose(tnet.output(x, m), jnet.output(x, m), **OUT)
    for _ in range(3):
        jnet.fit(JDataSet(x, y, m, m))
        tnet.fit(DataSet(x, y, m, m))
        np.testing.assert_allclose(tnet.score(), jnet.score(), **SCORE)
    _assert_params_moved_alike(jnet.params, tnet.params, start)
    np.testing.assert_allclose(tnet.output(x, m), jnet.output(x, m), **OUT)
    np.testing.assert_allclose(tnet.predict(x), jnet.predict(x))


def _tbptt_conf(pkg, updater):
    return (pkg.builder().seed(5).updater(updater).tbptt(5, 5).list()
            .layer(pkg.LSTM(n_out=8, activation="tanh"))
            .layer(pkg.RnnOutputLayer(n_out=4, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(3))
            .build())


def test_tbptt_segments_match_jax():
    """LSTM 8 over T 20 in segments of 5: the score of every segment, the
    iteration count (one a segment) and the parameters, over two
    batches."""
    jnet = jnn.MultiLayerNetwork(
        _tbptt_conf(jnn, jnn.Adam(learning_rate=1e-2))).init()
    seg_scores = []
    step_fn = jnet._make_train_step_tbptt()

    def recording_step(*args):
        out = step_fn(*args)
        seg_scores.append(float(out[-1]))
        return out

    jnet._jit_cache["train_step_tbptt"] = recording_step
    start = _host(jnet.params)
    tnet = tnn.MultiLayerNetwork(
        _tbptt_conf(tnn, tnn.Adam(learning_rate=1e-2)), device="cpu").init(
        params=start)
    rng = np.random.default_rng(1)
    for _ in range(2):
        x = rng.standard_normal((3, 20, 3), dtype=np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 20))]
        del seg_scores[:]
        jnet.fit(x, y, batch_size=3)
        tnet.fit(x, y, batch_size=3)
        assert len(seg_scores) == 4
        np.testing.assert_allclose(tnet.tbptt_scores(), seg_scores, **SCORE)
        np.testing.assert_allclose(tnet.score(), jnet.score(), **SCORE)
        assert tnet.iteration_count == jnet.iteration_count
    assert tnet.iteration_count == 8
    _assert_params_moved_alike(jnet.params, tnet.params, start)


def test_tbptt_refuses_per_sequence_labels_and_bidirectional():
    tnet = tnn.MultiLayerNetwork(
        _tbptt_conf(tnn, tnn.Sgd(learning_rate=0.1)), device="cpu").init()
    with pytest.raises(ValueError, match="3-D time-series labels"):
        tnet.fit(np.zeros((2, 10, 3), np.float32),
                 np.zeros((2, 4), np.float32))
    bidir = tnn.MultiLayerNetwork(_tagger_conf(tnn), device="cpu").init()
    with pytest.raises(ValueError, match="Bidirectional"):
        bidir.rnn_time_step(np.zeros((2, 6), np.float32))


def _stream_conf(pkg):
    return (pkg.builder().seed(9).list()
            .layer(pkg.LSTM(n_out=6, activation="tanh"))
            .layer(pkg.GRU(n_out=5))
            .layer(pkg.SimpleRnn(n_out=4, activation="tanh"))
            .layer(pkg.RnnOutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(4))
            .build())


def test_rnn_time_step_streams_like_jax_and_like_output():
    """Fed one step at a time (then a chunk of steps), the streamed
    outputs equal the JAX package's ``rnn_time_step`` and the port's own
    ``output`` over the whole sequence; clearing the state restarts."""
    jnet = jnn.MultiLayerNetwork(_stream_conf(jnn)).init()
    tnet = tnn.MultiLayerNetwork(_stream_conf(tnn), device="cpu").init(
        params=_host(jnet.params))
    x = np.random.default_rng(2).standard_normal((2, 9, 4),
                                                 dtype=np.float32)
    whole = tnet.output(x)
    np.testing.assert_allclose(whole, jnet.output(x), **OUT)
    streamed = [tnet.rnn_time_step(x[:, t]) for t in range(6)]
    jstreamed = [jnet.rnn_time_step(x[:, t]) for t in range(6)]
    streamed.extend(np.moveaxis(tnet.rnn_time_step(x[:, 6:]), 1, 0))
    jstreamed.extend(np.moveaxis(jnet.rnn_time_step(x[:, 6:]), 1, 0))
    np.testing.assert_allclose(np.stack(streamed, 1), whole, **OUT)
    np.testing.assert_allclose(np.stack(streamed, 1), np.stack(jstreamed, 1),
                               **OUT)
    h, c = tnet.rnn_get_previous_state(0)
    jh, jc = jnet.rnn_get_previous_state(0)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **OUT)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **OUT)
    assert tnet.rnn_get_previous_state(3) is None
    tnet.rnn_clear_previous_state()
    np.testing.assert_allclose(tnet.rnn_time_step(x[:, 0]), whole[:, 0],
                               **OUT)


def test_feed_forward_score_and_counters():
    """Per-layer activations, ``score(ds)`` against the JAX package, and
    the ``mln`` training counters."""
    jnet = jnn.MultiLayerNetwork(_tagger_conf(jnn)).init()
    tnet = tnn.MultiLayerNetwork(_tagger_conf(tnn), device="cpu").init(
        params=_host(jnet.params))
    x, y, m = _tagger_data()
    for a, b in zip(tnet.feed_forward(x), jnet.feed_forward(x)):
        np.testing.assert_allclose(a, b, **OUT)
    np.testing.assert_allclose(tnet.score(DataSet(x, y, m, m)),
                               jnet.score(JDataSet(x, y, m, m)), **SCORE)
    observe.reset()
    tnet.fit(x, y, batch_size=2)
    met = observe.metrics()
    assert met.counter("dl4j_tpu_train_steps_total", model="mln").value == 2
    assert met.counter("dl4j_tpu_train_examples_total",
                       model="mln").value == 4
    assert met.counter("dl4j_tpu_host_to_device_transfers_total",
                       model="mln").value == 4
    assert tnet.epoch_count == 1


def test_unported_entry_points_raise():
    """``fit_scanned`` is ported (its parity with the JAX package:
    ``test_torch_capture_train.py``); what it does not take raises, as in
    the JAX package, whose ``fit_scanned`` has no mask arguments: masks."""
    tnet = LeNet(device="cpu").init()
    x = np.zeros((2, 784), np.float32)
    y = np.eye(10, dtype=np.float32)[[0, 1]]
    for kw in (dict(features_mask=np.ones((2, 1), np.float32)),
               dict(labels_mask=np.ones((2, 1), np.float32))):
        with pytest.raises(ValueError, match="no masks"):
            tnet.fit_scanned(x, y, steps=1, **kw)
    assert tnet.iteration_count == 0


def test_text_generation_lstm_zoo_config():
    conf = TextGenerationLSTM(vocab_size=77, device="cpu").conf()
    jconf = jnn.MultiLayerConfiguration.from_json(conf.to_json())
    from deeplearning4j_tpu.models.zoo import TextGenerationLSTM as JText
    assert json.loads(JText(vocab_size=77).init().conf.to_json()) == \
        json.loads(jconf.to_json())
    net = TextGenerationLSTM(vocab_size=77, device="cpu").init()
    assert [sorted(p) for p in net.params] == [["RW", "W", "b"]] * 2 + [
        ["W", "b"]]


# ---------------------------------------------------------------------------
# model zips
# ---------------------------------------------------------------------------


def _bn_conf(pkg):
    return (pkg.builder().seed(4).updater(pkg.Nesterovs(learning_rate=0.05))
            .list()
            .layer(pkg.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                        activation="relu"))
            .layer(pkg.BatchNormalization())
            .layer(pkg.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(pkg.InputType.convolutional_flat(6, 6, 1))
            .build())


def _zip_case(name):
    if name == "tagger":
        x, y, m = _tagger_data()
        return _tagger_conf, (x, y, m, m)
    rng = np.random.default_rng(3)
    x = rng.random((5, 36), dtype=np.float32)
    return _bn_conf, (x, np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1]],
                      None, None)


@pytest.mark.parametrize("name", ["tagger", "batchnorm"])
def test_zip_from_jax_restores_in_the_port(tmp_path, name):
    """A zip the JAX package saves after a step restores in the port:
    outputs, parameters, layer state, updater state and counters; and
    the port's ``save_model`` writes the same entries, byte for byte."""
    conf_fn, (x, y, fm, lm) = _zip_case(name)
    jnet = jnn.MultiLayerNetwork(conf_fn(jnn)).init()
    jnet.fit(JDataSet(x, y, fm, lm))
    path = str(tmp_path / "jax.zip")
    jnn.save_model(jnet, path)
    tnet = tnn.restore_model(path, device="cpu")
    assert tnet.iteration_count == 1 and tnet.epoch_count == 1
    np.testing.assert_array_equal(tnet.params_flat(), jnet.params_flat())
    np.testing.assert_array_equal(tnet.updater_state_flat(),
                                  jnet.updater_state_flat())
    np.testing.assert_allclose(tnet.output(x, fm), jnet.output(x, fm), **OUT)
    again = str(tmp_path / "port.zip")
    tnn.save_model(tnet, again)
    with zipfile.ZipFile(path) as a, zipfile.ZipFile(again) as b:
        assert a.namelist() == b.namelist()
        for entry in a.namelist():
            if entry == "configuration.json":
                assert json.loads(a.read(entry)) == json.loads(b.read(entry))
            else:
                assert a.read(entry) == b.read(entry), entry


@pytest.mark.parametrize("name", ["tagger", "batchnorm"])
def test_zip_from_the_port_restores_in_jax(tmp_path, name):
    """The reverse: the port trains a step from the JAX parameters, saves,
    and the JAX package restores the same network; a second step on both
    sides stays together."""
    conf_fn, (x, y, fm, lm) = _zip_case(name)
    start = _host(jnn.MultiLayerNetwork(conf_fn(jnn)).init().params)
    tnet = tnn.MultiLayerNetwork(conf_fn(tnn), device="cpu").init(
        params=start)
    tnet.fit(DataSet(x, y, fm, lm))
    path = str(tmp_path / "port.zip")
    tnn.save_model(tnet, path)
    jnet = jnn.restore_model(path)
    assert jnet.iteration_count == 1
    np.testing.assert_array_equal(jnet.params_flat(), tnet.params_flat())
    np.testing.assert_array_equal(jnet.updater_state_flat(),
                                  tnet.updater_state_flat())
    np.testing.assert_allclose(jnet.output(x, fm), tnet.output(x, fm), **OUT)
    jnet.fit(JDataSet(x, y, fm, lm))
    tnet.fit(DataSet(x, y, fm, lm))
    np.testing.assert_allclose(tnet.score(), jnet.score(), **SCORE)
    _assert_params_moved_alike(jnet.params, tnet.params, start)


# ---------------------------------------------------------------------------
# the recurrent layers inside a ComputationGraph
# ---------------------------------------------------------------------------


def _rnn_graph(pkg, gmod):
    return (gmod.graph_builder().seed(2).updater(
        pkg.Adam(learning_rate=1e-2)).add_inputs("in")
        .set_input_types(**{"in": pkg.InputType.recurrent(6)})
        .add_layer("bi", pkg.Bidirectional.wrap(
            pkg.LSTM(n_out=5, activation="tanh"), "concat"), "in")
        .add_layer("out", pkg.RnnOutputLayer(n_out=4, activation="softmax",
                                             loss="mcxent"), "bi")
        .set_outputs("out").build())


def test_computation_graph_takes_the_recurrent_layers():
    """Bidirectional(LSTM) → RnnOutputLayer as a graph: the JAX JSON
    loads, the output and two ``fit`` steps (nested parameter trees
    through the update tail) match the JAX graph's."""
    jg = jgraph.ComputationGraph(_rnn_graph(jnn, jgraph)).init()
    tconf = tgraph.ComputationGraphConfiguration.from_json(
        _rnn_graph(jnn, jgraph).to_json())
    start = _host(jg.params)
    tg = tgraph.ComputationGraph(tconf, device="cpu").init(
        params=jax.tree.map(torch.from_numpy, start))
    x, y, _ = _tagger_data(classes=4)
    np.testing.assert_allclose(tg.output(x)[0], np.asarray(jg.output(x)[0]),
                               **OUT)
    for _ in range(2):
        jg.fit(x, y, batch_size=4)
        tg.fit(x, y, batch_size=4)
        np.testing.assert_allclose(tg.score(), jg.score(), **SCORE)
    _assert_params_moved_alike(jg.params, tg.params, start)


# ---------------------------------------------------------------------------
# 16-bit storage policies (the promotion repair)
# ---------------------------------------------------------------------------

# one unit of the storage dtype, relative
POLICY_UNIT = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
POLICY_LR = 1e-2


def _policy_updater(pkg, policy):
    """Adam under bfloat16; Nesterovs under float16, where the JAX
    generic Adam overflows (``test_float16_adam_stays_finite``)."""
    if policy == "bfloat16":
        return pkg.Adam(learning_rate=POLICY_LR)
    return pkg.Nesterovs(learning_rate=POLICY_LR, momentum=0.9)


def _policy_layers(pkg, recurrent):
    if recurrent:
        return (pkg.LSTM(n_out=8, activation="tanh"),
                pkg.RnnOutputLayer(n_out=5, activation="softmax",
                                   loss="mcxent"),
                pkg.InputType.recurrent(6))
    return (pkg.DenseLayer(n_out=8, activation="relu"),
            pkg.OutputLayer(n_out=5, activation="softmax", loss="mcxent"),
            pkg.InputType.feed_forward(6))


def _policy_net(pkg, gmod, policy, recurrent, graph):
    """Dense(8, relu) → Output(5) over 6 features, or LSTM(8) →
    RnnOutput(5) over 6 features a step, under ``policy``; sequential or
    a graph."""
    hidden, out, itype = _policy_layers(pkg, recurrent)
    if graph:
        return (gmod.graph_builder().seed(3).dtype(policy)
                .updater(_policy_updater(pkg, policy)).add_inputs("in")
                .set_input_types(**{"in": itype})
                .add_layer("hidden", hidden, "in")
                .add_layer("out", out, "hidden").set_outputs("out").build())
    return (pkg.builder().seed(3).dtype(policy)
            .updater(_policy_updater(pkg, policy)).list()
            .layer(hidden).layer(out).set_input_type(itype).build())


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
@pytest.mark.parametrize("recurrent", [False, True], ids=["dense", "lstm"])
@pytest.mark.parametrize("policy", ["bfloat16", "float16"])
def test_16bit_policies_store_16bit_and_compute_like_jax(policy, recurrent,
                                                         graph):
    """Under "bfloat16" / "float16" both networks keep 16-bit parameters,
    and float32 input × 16-bit weights computes in float32 as jnp
    promotes it: the float32 (4, 5) output (per step for the LSTM) and
    one ``fit`` step's score within 1e-5 of the JAX package's from the
    same 16-bit parameters. After the step the port's parameters and
    updater state are still 16-bit, within one unit of the storage dtype
    (``POLICY_UNIT``) relative + 2 × lr × that unit absolute of the JAX
    step: the port's updater computes in float32 and rounds the results
    to the leaf's dtype (as the JAX kernel does), where the JAX generic
    updater on the CPU computes the moments in the storage dtype and
    returns float32 parameters; the update's share of a moment rounding
    is at most lr × one unit."""
    jconf = _policy_net(jnn, jgraph, policy, recurrent, graph)
    tconf = _policy_net(tnn, tgraph, policy, recurrent, graph)
    if graph:
        jnet = jgraph.ComputationGraph(jconf).init()
        tnet = tgraph.ComputationGraph(tconf, device="cpu").init(
            params=_host(jnet.params))
    else:
        jnet = jnn.MultiLayerNetwork(jconf).init()
        tnet = tnn.MultiLayerNetwork(tconf, device="cpu").init(
            params=_host(jnet.params))
    want = getattr(torch, policy)
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t.dtype, tnet.params))
    assert leaves and all(d == want for d in leaves)
    rng = np.random.default_rng(4)
    shape = (4, 3, 6) if recurrent else (4, 6)
    x = rng.standard_normal(shape, dtype=np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, shape[:-1])]
    tout = tnet.output(x)[0] if graph else tnet.output(x)
    jout = np.asarray(jnet.output(x)[0] if graph else jnet.output(x))
    assert tout.dtype == np.float32 and tout.shape == shape[:-1] + (5,)
    np.testing.assert_allclose(tout, jout, **OUT)
    jnet.fit(x, y, batch_size=4)
    tnet.fit(x, y, batch_size=4)
    np.testing.assert_allclose(tnet.score(), jnet.score(), **SCORE)
    unit = POLICY_UNIT[policy]
    for part in ("params", "opt_state"):
        tl = jax.tree_util.tree_leaves_with_path(jax.tree.map(
            lambda t: t.detach().float().numpy(), getattr(tnet, part)))
        jl = jax.tree.leaves(_host(getattr(jnet, part)))
        assert len(tl) == len(jl)
        for (path, t), j in zip(tl, jl):
            assert t.dtype == np.float32
            j = np.asarray(j, np.float32)
            np.testing.assert_allclose(t, j, rtol=unit,
                                       atol=2 * POLICY_LR * unit,
                                       err_msg=f"{part}{path}")
    assert all(d == want for d in jax.tree.leaves(
        jax.tree.map(lambda t: t.dtype, tnet.params)))


def test_float16_adam_stays_finite():
    """Adam under "float16": the port's updater computes in float32 (as
    the JAX kernel does) and its parameters stay finite. The JAX generic
    updater on the CPU computes ``sqrt(v) + 1e-8`` in float16, where
    1e-8 underflows to 0 and a small gradient's v to 0 as well, so its
    step writes infinities: a reference defect (ROADMAP Queue 3, not
    port faults), recorded here so the comparison above uses Nesterovs
    under float16."""
    conf = lambda pkg: (  # noqa: E731
        pkg.builder().seed(3).dtype("float16")
        .updater(pkg.Adam(learning_rate=POLICY_LR)).list()
        .layer(pkg.DenseLayer(n_out=8, activation="relu"))
        .layer(pkg.OutputLayer(n_out=5, activation="softmax",
                               loss="mcxent"))
        .set_input_type(pkg.InputType.feed_forward(6)).build())
    jnet = jnn.MultiLayerNetwork(conf(jnn)).init()
    tnet = tnn.MultiLayerNetwork(conf(tnn), device="cpu").init(
        params=_host(jnet.params))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 6), dtype=np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
    jnet.fit(x, y, batch_size=4)
    tnet.fit(x, y, batch_size=4)
    assert np.isfinite(tnet.params_flat()).all()
    assert tnet.params[0]["W"].dtype == torch.float16
    assert not np.isfinite(jnet.params_flat()).all()
