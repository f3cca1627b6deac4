"""The conv-family ops, layers and graph vertices of the PyTorch port
against the JAX package (CPU).

Covered: ``depthwise_conv2d``, ``sconv2d``, ``deconv2d``,
``upsampling2d`` and ``lrn`` and their gradients against the JAX ``.fn``
and ``jax.vjp`` on the same numpy inputs (deconv at stride 1 and 2 under
"same", "valid" and an explicit pad with odd and even kernels; LRN at
depth 4 and 5; depthwise at multiplier 1 and 2); each new layer type
inside a network built from the JAX package's JSON with its parameters
(output and one ``fit`` step); all twelve new vertices; and the JSON of
each new type written by the JAX package, read by the port and back.

Tolerances (float32; the two libraries sum in other orders): values
1e-5 relative + 1e-5 absolute, gradients 1e-4 relative + 1e-5 absolute;
a network's score 1e-5 relative.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu.ops import nn_ops as jops
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.nn import graph as tgraph
from deeplearning4j_tpu_torch.ops import nn_ops as tops
from deeplearning4j_tpu_torch.ops.registry import registry

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
SCORE = dict(rtol=1e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _vs_jax(jfn, tfn, inputs, seed=99):
    """Value and every input's gradient (one random cotangent) of ``tfn``
    on tensors and ``jfn`` on jax arrays, from the same numpy inputs."""
    yj, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in inputs])
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    yt = tfn(*ts)
    assert tuple(yt.shape) == tuple(yj.shape)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **VAL)
    dy = _rand(yj.shape, seed)
    gj = vjp(jnp.asarray(dy))
    gt = torch.autograd.grad(yt, ts, torch.from_numpy(dy))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


# ---------------------------------------------------------------------------
# the five ops
# ---------------------------------------------------------------------------


def test_registry_holds_the_five_ops_generic_only():
    reg = registry()
    for name in ("depthwise_conv2d", "sconv2d", "deconv2d", "upsampling2d",
                 "lrn"):
        assert name in reg
        assert reg.get(name).platform_impls == {}


@pytest.mark.parametrize("mult", [1, 2])
@pytest.mark.parametrize("stride,padding", [(1, "same"), (2, "same"),
                                            (2, "valid")])
def test_depthwise_conv2d_matches_jax(mult, stride, padding):
    x, w, b = _rand((2, 9, 8, 3), 0), _rand((3, 3, 3, mult), 1), _rand(
        (3 * mult,), 2)
    _vs_jax(lambda x, w, b: jops.depthwise_conv2d.fn(
                x, w, b, stride=stride, padding=padding),
            lambda x, w, b: tops.depthwise_conv2d.fn(
                x, w, b, stride=stride, padding=padding), (x, w, b))


def test_depthwise_output_channel_order_is_the_jax_reshape():
    """Output channel c·mult + m is input channel c under multiplier m."""
    x = _rand((1, 5, 5, 2), 3)
    w = np.zeros((1, 1, 2, 3), np.float32)
    w[0, 0, 1, 2] = 1.0
    y = tops.depthwise_conv2d.fn(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(y[..., 1 * 3 + 2].numpy(), x[..., 1])
    assert float(y[..., :5].abs().sum()) == 0.0


@pytest.mark.parametrize("stride,padding", [(1, "same"), (2, "same"),
                                            (1, "valid")])
def test_separable_conv2d_matches_jax(stride, padding):
    x, dw, pw, b = (_rand((2, 7, 7, 3), 4), _rand((3, 3, 3, 2), 5),
                    _rand((1, 1, 6, 4), 6), _rand((4,), 7))
    _vs_jax(lambda *a: jops.separable_conv2d.fn(*a, stride=stride,
                                                padding=padding),
            lambda *a: tops.separable_conv2d.fn(*a, stride=stride,
                                                padding=padding),
            (x, dw, pw, b))


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["same", "valid", (1, 0)])
def test_deconv2d_matches_jax(k, stride, padding):
    x, w, b = (_rand((2, 5, 4, 3), 8), _rand((k, k, 3, 2), 9),
               _rand((2,), 10))
    _vs_jax(lambda x, w, b: jops.deconv2d.fn(x, w, b, stride=stride,
                                              padding=padding),
            lambda x, w, b: tops.deconv2d.fn(x, w, b, stride=stride,
                                              padding=padding), (x, w, b))


def test_deconv2d_same_gives_tf_output_size():
    y = tops.deconv2d.fn(torch.zeros(1, 5, 7, 2), torch.zeros(3, 3, 2, 4),
                         stride=2, padding="same")
    assert tuple(y.shape) == (1, 10, 14, 4)


@pytest.mark.parametrize("size", [2, (2, 3)])
def test_upsampling2d_matches_jax(size):
    _vs_jax(lambda x: jops.upsampling2d.fn(x, size=size),
            lambda x: tops.upsampling2d.fn(x, size=size),
            (_rand((2, 3, 4, 5), 11),))


@pytest.mark.parametrize("depth", [4, 5])
def test_lrn_matches_jax(depth):
    """alpha is not divided by depth (F.local_response_norm would); the
    even window starts depth // 2 channels before each channel."""
    kw = dict(depth=depth, bias=2.0, alpha=1e-2, beta=0.75)
    _vs_jax(lambda x: jops.local_response_normalization.fn(x, **kw),
            lambda x: tops.local_response_normalization.fn(x, **kw),
            (3.0 * _rand((2, 3, 3, 7), 12),))


# ---------------------------------------------------------------------------
# the six layers, inside networks the JAX package builds
# ---------------------------------------------------------------------------


def _layer_net(pkg, lc, input_type, flat_out=True):
    b = (pkg.builder().seed(5).updater(pkg.Sgd(learning_rate=0.1)).list()
         .layer(lc))
    if flat_out:
        b = b.layer(pkg.OutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent"))
    return b.set_input_type(input_type).build()


LAYERS = {
    "Deconvolution2D_same": lambda pkg: pkg.Deconvolution2D(
        n_out=4, kernel=(3, 3), stride=(2, 2), convolution_mode="same",
        activation="tanh"),
    "Deconvolution2D_truncate": lambda pkg: pkg.Deconvolution2D(
        n_out=4, kernel=(3, 3), stride=(2, 2), padding=(1, 1),
        activation="tanh", dropout=0.0),
    "DepthwiseConvolution2D": lambda pkg: pkg.DepthwiseConvolution2D(
        kernel=(3, 3), depth_multiplier=2, convolution_mode="same",
        activation="relu"),
    "SeparableConvolution2D": lambda pkg: pkg.SeparableConvolution2D(
        n_out=5, kernel=(3, 3), stride=(2, 2), depth_multiplier=2,
        convolution_mode="same", activation="relu"),
    "Upsampling2D": lambda pkg: pkg.Upsampling2D(size=(2, 3)),
    "LocalResponseNormalization": lambda pkg:
        pkg.LocalResponseNormalization(n=4, k=1.5, alpha=1e-2),
    "SpaceToDepthLayer": lambda pkg: pkg.conf.SpaceToDepthLayer(
        block_size=2),
}


def _jax_conf(name):
    return _layer_net(jnn, LAYERS[name](jnn),
                      jnn.InputType.convolutional(6, 6, 3))


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_output_and_step_match_jax(name):
    """Built from the JAX JSON with the JAX parameters: the output and
    the score and parameters after one Sgd step."""
    jnet = jnn.MultiLayerNetwork(_jax_conf(name)).init()
    tconf = tnn.MultiLayerConfiguration.from_json(jnet.conf.to_json())
    start = jax.tree.map(np.asarray, jnet.params)
    tnet = tnn.MultiLayerNetwork(tconf, device="cpu").init(params=start)
    assert tnet.layers[0].otype.to_dict() == jnet.layers[0].otype.to_dict()
    assert [sorted(p) for p in tnet.params] == [sorted(p)
                                                for p in jnet.params]
    x = _rand((4, 6, 6, 3), 20)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    np.testing.assert_allclose(tnet.output(x), np.asarray(jnet.output(x)),
                               **VAL)
    jnet.fit(x, y, batch_size=4)
    tnet.fit(x, y, batch_size=4)
    np.testing.assert_allclose(tnet.score(), jnet.score(), **SCORE)
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(),
                               **GRAD)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_output_types_match_jax(name):
    lc = LAYERS[name](jnn)
    it = jnn.InputType.convolutional(6, 6, 3)
    conf = _layer_net(jnn, lc, it, flat_out=False)
    jt = conf.layers[0].output_type(it)
    tconf = tnn.MultiLayerConfiguration.from_json(conf.to_json())
    tt = tconf.layers[0].output_type(tnn.InputType.convolutional(6, 6, 3))
    assert tt.to_dict() == jt.to_dict()


def test_deconv_explicit_pad_output_differs_from_its_declared_type():
    """Mirrors the JAX package: with an explicit pad the op computes
    (h−1)·s + 2 + 2p − k, the configuration declares s·(h−1) + k − 2p
    (ROADMAP Queue 3, not a port fault)."""
    lc = tnn.Deconvolution2D(n_in=3, n_out=4, kernel=(4, 4), stride=(2, 2),
                             padding=(1, 1))
    declared = lc.output_type(tnn.InputType.convolutional(6, 6, 3))
    y = tops.deconv2d.fn(torch.zeros(1, 6, 6, 3), torch.zeros(4, 4, 3, 4),
                         stride=2, padding=(1, 1))
    jy = jops.deconv2d.fn(jnp.zeros((1, 6, 6, 3)), jnp.zeros((4, 4, 3, 4)),
                          stride=2, padding=(1, 1))
    assert tuple(y.shape) == tuple(jy.shape) == (1, 10, 10, 4)
    assert (declared.height, declared.width) == (12, 12)


def test_flat_input_gets_a_cnn_preprocessor_before_the_new_layers():
    for name in ("Upsampling2D", "LocalResponseNormalization"):
        conf = _layer_net(tnn, LAYERS[name](tnn),
                          tnn.InputType.convolutional_flat(6, 6, 3))
        jconf = _layer_net(jnn, LAYERS[name](jnn),
                           jnn.InputType.convolutional_flat(6, 6, 3))
        assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
        assert isinstance(conf.preprocessors[0],
                          tnn.FeedForwardToCnnPreProcessor)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_json_crosses_both_ways(name):
    jtext = _jax_conf(name).to_json()
    ttext = tnn.MultiLayerConfiguration.from_json(jtext).to_json()
    assert json.loads(ttext) == json.loads(jtext)
    back = jnn.MultiLayerConfiguration.from_json(ttext)
    assert json.loads(back.to_json()) == json.loads(jtext)
    own = _layer_net(tnn, LAYERS[name](tnn),
                     tnn.InputType.convolutional(6, 6, 3))
    assert json.loads(own.to_json()) == json.loads(jtext)


def test_unported_types_are_still_refused_by_name():
    text = _jax_conf("Upsampling2D").to_json()
    for name in ("VariationalAutoencoder", "SelfAttentionLayer", "MoELayer",
                 "Yolo2OutputLayer", "CapsuleLayer"):
        bad = text.replace('"@type": "Upsampling2D"', f'"@type": "{name}"')
        with pytest.raises(ValueError, match=f"'{name}' is not ported"):
            tnn.MultiLayerConfiguration.from_json(bad)


# ---------------------------------------------------------------------------
# vertices
# ---------------------------------------------------------------------------

VERTICES = {
    "MergeVertex": (lambda g: g.MergeVertex(), [(2, 3, 3, 2), (2, 3, 3, 4)]),
    "MergeVertex_ff": (lambda g: g.MergeVertex(), [(2, 5), (2, 3)]),
    "DotProductVertex": (lambda g: g.DotProductVertex(), [(2, 5), (2, 5)]),
    "DotProductVertex_seq": (lambda g: g.DotProductVertex(normalize=True),
                             [(2, 4, 6), (2, 3, 6)]),
    "DotProductVertex_axis1": (lambda g: g.DotProductVertex(axes=1),
                               [(2, 4, 6), (2, 4, 5)]),
    "SubsetVertex": (lambda g: g.SubsetVertex(from_idx=1, to_idx=3),
                     [(2, 6)]),
    "ScaleVertex": (lambda g: g.ScaleVertex(scale=0.17), [(2, 3, 3, 4)]),
    "ShiftVertex": (lambda g: g.ShiftVertex(shift=-1.5), [(2, 4)]),
    "L2NormalizeVertex": (lambda g: g.L2NormalizeVertex(), [(2, 3, 5)]),
    "StackVertex": (lambda g: g.StackVertex(), [(2, 4), (3, 4)]),
    "ReshapeVertex": (lambda g: g.ReshapeVertex(shape=(2, 3, 4)),
                      [(2, 12)]),
    "UnstackVertex": (lambda g: g.UnstackVertex(from_idx=1, stack_size=3),
                      [(6, 4)]),
    "DuplicateToTimeSeriesVertex": (
        lambda g: g.DuplicateToTimeSeriesVertex(), [(2, 4), (2, 5, 3)]),
    "LastTimeStepVertex": (lambda g: g.LastTimeStepVertex(), [(2, 5, 3)]),
    "FlattenVertex": (lambda g: g.FlattenVertex(), [(2, 3, 3, 2)]),
}


@pytest.mark.parametrize("name", sorted(VERTICES))
def test_vertex_matches_jax(name):
    make, shapes = VERTICES[name]
    inputs = [_rand(s, 30 + i) for i, s in enumerate(shapes)]
    jv, tv = make(jgraph), make(tgraph)
    diff = [i for i, s in enumerate(shapes) if name !=
            "DuplicateToTimeSeriesVertex" or i == 0]
    yj, vjp = jax.vjp(lambda *a: jv.apply(list(a)),
                      *[jnp.asarray(a) for a in inputs])
    ts = [torch.tensor(a, requires_grad=i in diff)
          for i, a in enumerate(inputs)]
    yt = tv.apply(ts)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **VAL)
    dy = _rand(yj.shape, 40)
    gj = vjp(jnp.asarray(dy))
    gt = torch.autograd.grad(yt, [ts[i] for i in diff], torch.from_numpy(dy))
    for g, i in zip(gt, diff):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[i]), **GRAD)
    assert tv.to_dict() == jv.to_dict()
    back = tgraph.GraphVertex.from_dict(jv.to_dict())
    assert back == tv


def test_vertex_output_types_match_jax():
    it = {"cnn": lambda p, c: p.InputType.convolutional(3, 3, c),
          "ff": lambda p, n: p.InputType.feed_forward(n),
          "rnn": lambda p, n: p.InputType.recurrent(n, 5)}
    cases = [("MergeVertex", [("cnn", 2), ("cnn", 4)]),
             ("MergeVertex_ff", [("ff", 5), ("ff", 3)]),
             ("DotProductVertex", [("ff", 5), ("ff", 5)]),
             ("SubsetVertex", [("ff", 6)]),
             ("ScaleVertex", [("cnn", 4)]),
             ("DuplicateToTimeSeriesVertex", [("ff", 4), ("rnn", 3)]),
             ("LastTimeStepVertex", [("rnn", 3)]),
             ("FlattenVertex", [("cnn", 2)])]
    for name, types in cases:
        make = VERTICES[name][0]
        jt = make(jgraph).output_type([it[k](jnn, n) for k, n in types])
        tt = make(tgraph).output_type([it[k](tnn, n) for k, n in types])
        assert tt.to_dict() == jt.to_dict(), name


def test_every_jax_vertex_type_is_ported():
    assert sorted(tgraph.VERTEX_TYPES) == sorted(jgraph.VERTEX_TYPES)


def _vertex_graph(pkg, g):
    """A small graph through Merge, Scale, Shift, Subset and L2Normalize,
    trained by its output layer."""
    b = (g.graph_builder().seed(7).updater(pkg.Adam(learning_rate=1e-2))
         .add_inputs("in")
         .set_input_types(**{"in": pkg.InputType.convolutional(5, 5, 2)}))
    b.add_layer("c1", pkg.ConvolutionLayer(n_out=3, kernel=(3, 3),
                                           convolution_mode="same",
                                           activation="relu"), "in")
    b.add_layer("c2", pkg.SeparableConvolution2D(
        n_out=4, kernel=(3, 3), convolution_mode="same",
        activation="tanh"), "in")
    b.add_vertex("cat", g.MergeVertex(), "c1", "c2")
    b.add_vertex("scale", g.ScaleVertex(scale=0.5), "cat")
    b.add_layer("up", pkg.Upsampling2D(size=(2, 2)), "scale")
    b.add_layer("gap", pkg.GlobalPoolingLayer(pooling_type="avg"), "up")
    b.add_vertex("shift", g.ShiftVertex(shift=0.25), "gap")
    b.add_vertex("sub", g.SubsetVertex(from_idx=1, to_idx=5), "shift")
    b.add_vertex("l2", g.L2NormalizeVertex(), "sub")
    b.add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"), "l2")
    b.set_outputs("out")
    return b.build()


def test_graph_of_vertices_trains_like_jax():
    jg = jgraph.ComputationGraph(_vertex_graph(jnn, jgraph)).init()
    text = jg.conf.to_json()
    tconf = tgraph.ComputationGraphConfiguration.from_json(text)
    assert json.loads(tconf.to_json()) == json.loads(text)
    tg = tgraph.ComputationGraph(tconf, device="cpu").init(
        params=jax.tree.map(np.asarray, jg.params))
    assert json.loads(tg.conf.to_json()) == json.loads(text)
    x = _rand((4, 5, 5, 2), 50)
    y = np.eye(3, dtype=np.float32)[[0, 2, 1, 0]]
    np.testing.assert_allclose(tg.output(x)[0], np.asarray(jg.output(x)[0]),
                               **VAL)
    for _ in range(2):
        jg.fit(x, y, batch_size=4)
        tg.fit(x, y, batch_size=4)
        np.testing.assert_allclose(tg.score(), jg.score(), **SCORE)
    np.testing.assert_allclose(tg.params_flat(), jg.params_flat(), **GRAD)
