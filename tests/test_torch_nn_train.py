"""ComputationGraph training parity of the PyTorch port against the JAX
package (CPU): layers, a small graph, and ResNet-50 as a whole.

Inputs and parameters are drawn with numpy (or carried from one package to
the other) and fed to both; configurations cross as JSON. Tolerances, with
their reasons:

* Layers, float32: 1e-5 relative + 1e-5 absolute on outputs, 1e-4 on
  gradients — the same float32 math summed in other orders (conv
  reductions of up to 7·7·8 terms). bfloat16 BatchNormalization: one bf16
  unit (2^-7 relative) + 1e-2 absolute on the output, whose bf16 values
  are O(1); the float32 statistics 1e-5.
* The small graph (stem, a projected and an identity bottleneck, global
  pooling, softmax output; composed layers and FusedBottleneck), float32:
  logits and loss 1e-5, parameters / updater state / running statistics
  after 1 and 3 steps 2e-4 relative + 2e-5 absolute — float32 rounding
  carried through three forward/backward/update rounds of a 20-layer
  network with batch statistics.
  Under "mixed" every activation is rounded to bfloat16 (8 significant
  bits) at op boundaries that differ between the two frameworks (XLA may
  keep float32 between fused ops), and training amplifies such roundings:
  logits 3e-2 relative, the score 5e-2 relative, and the parameters and
  running statistics after 1 and 3 steps within 3× the JAX package's own
  difference when its input moves by one bf16 unit (measured in the test;
  the port sat at 0.4–0.8× of it when the bound was set).
* ResNet-50: see ``test_resnet50_forward_and_one_step_match_jax``.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.models.zoo import ResNet50 as JaxResNet50
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.ops import nn_ops as jops
from deeplearning4j_tpu.ops.activations import softmax as jsoftmax
from deeplearning4j_tpu_torch.datasets import synthetic_image_batch
from deeplearning4j_tpu_torch.models import ResNet50, graph_state_from_numpy
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn import graph as tgraph
from deeplearning4j_tpu_torch.nn.layers import build_layer
from deeplearning4j_tpu_torch.ops import losses as tlosses
from deeplearning4j_tpu_torch.ops import nn_ops as tops
from deeplearning4j_tpu_torch.ops.activations import softmax as tsoftmax

LAYER = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return _np(a)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,s,h", [(7, 2, 16), (7, 2, 15), (3, 2, 8),
                                   (3, 2, 7), (1, 2, 8), (3, 1, 5)])
def test_same_conv_matches_jax(k, s, h):
    """XLA's SAME pads the odd cell on the high side: (2, 3) for 7×7/2 on
    an even size; the port pads with F.pad first."""
    r = np.random.RandomState(k * 10 + h)
    x = r.randn(2, h, h, 6).astype(np.float32)
    w = r.randn(k, k, 6, 4).astype(np.float32)
    dy = r.randn(2, -(-h // s), -(-h // s), 4).astype(np.float32)

    def jf(x, w):
        return jnp.sum(jops.conv2d.fn(x, w, None, stride=(s, s),
                                      padding="same") * dy)

    yj = jops.conv2d.fn(x, w, None, stride=(s, s), padding="same")
    gj = jax.grad(jf, argnums=(0, 1))(x, w)
    xt, wt = (torch.tensor(a, requires_grad=True) for a in (x, w))
    yt = tops.conv2d.fn(xt, wt, None, stride=(s, s), padding="same")
    (yt * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(_t(yt), _np(yj), **LAYER)
    np.testing.assert_allclose(_t(xt.grad), _np(gj[0]), **GRAD)
    np.testing.assert_allclose(_t(wt.grad), _np(gj[1]), **GRAD)


def _conv_layer(lc, itype):
    net = tconf.MultiLayerConfiguration(weight_init="relu")
    _, lc = tconf.infer_layer(itype, lc)
    return build_layer(net, lc, itype, torch.device("cpu"))


def test_s2d_stem_equals_the_plain_stride2_conv_and_jax():
    r = np.random.RandomState(3)
    x = r.randn(2, 16, 16, 3).astype(np.float32)
    w = r.randn(7, 7, 3, 8).astype(np.float32)
    itype = tconf.InputType.convolutional(16, 16, 3)
    kw = dict(n_out=8, kernel=(7, 7), stride=(2, 2), convolution_mode="same",
              has_bias=False)
    stem = _conv_layer(tconf.ConvolutionLayer(s2d_stem=True, **kw), itype)
    plain = _conv_layer(tconf.ConvolutionLayer(**kw), itype)
    wt = torch.tensor(w, requires_grad=True)
    y1, _, _ = stem.apply({"W": wt}, torch.from_numpy(x), {}, train=True,
                          rng=None)
    y1.square().sum().backward()
    g1 = wt.grad.clone()
    wt.grad = None
    y2, _, _ = plain.apply({"W": wt}, torch.from_numpy(x), {}, train=True,
                           rng=None)
    y2.square().sum().backward()
    np.testing.assert_allclose(_t(y1), _t(y2), **LAYER)
    np.testing.assert_allclose(_t(g1), _t(wt.grad), **GRAD)
    jl = jnn.layers.build_layer(
        jnn.conf.MultiLayerConfiguration(weight_init="relu"),
        jnn.conf.ConvolutionLayer(n_in=3, s2d_stem=True, **kw),
        jnn.conf.InputType.convolutional(16, 16, 3))
    yj, _, _ = jl.apply({"W": jnp.asarray(w)}, jnp.asarray(x), {},
                        train=True, rng=None)
    np.testing.assert_allclose(_t(y1), _np(yj), **LAYER)


@pytest.mark.parametrize("h", [16, 15])
def test_same_maxpool_matches_jax(h):
    r = np.random.RandomState(h)
    x = r.randn(2, h, h, 4).astype(np.float32)
    o = -(-h // 2)
    dy = r.randn(2, o, o, 4).astype(np.float32)
    kw = dict(kernel=(3, 3), stride=(2, 2), padding="same")
    yj = jops.maxpool2d.fn(x, **kw)
    gj = jax.grad(lambda x: jnp.sum(jops.maxpool2d.fn(x, **kw) * dy))(x)
    xt = torch.tensor(x, requires_grad=True)
    yt = tops.maxpool2d.fn(xt, **kw)
    (yt * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_array_equal(_t(yt), _np(yj))
    np.testing.assert_array_equal(_t(xt.grad), _np(gj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_jax(dtype):
    """Output, gradients (relu on top, so the backward is not trivial) and
    the running statistics with ``decay``; bfloat16 takes the one-pass
    moments shifted by the running mean."""
    r = np.random.RandomState(5)
    x = (r.randn(8, 3, 3, 16) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * r.randn(16)).astype(np.float32)
    b = (0.1 * r.randn(16)).astype(np.float32)
    rm = (0.1 * r.randn(16)).astype(np.float32)
    rv = (1 + 0.1 * r.rand(16)).astype(np.float32)
    dy = r.randn(*x.shape).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jf(x, g, b):
        out, nm, nv = jops.batch_norm_train(
            x, g, b, jnp.asarray(rm), jnp.asarray(rv), axis=(0, 1, 2),
            momentum=0.9)
        return jnp.sum(jax.nn.relu(out).astype(jnp.float32) * dy), (out, nm,
                                                                    nv)

    jx = [jnp.asarray(a).astype(jd) for a in (x, g, b)]
    (_, (oj, nmj, nvj)), gj = jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True)(*jx)
    tx = [torch.from_numpy(a).to(td).requires_grad_(True) for a in (x, g, b)]
    ot, nmt, nvt = tops.batch_norm_train(
        *tx, torch.from_numpy(rm), torch.from_numpy(rv), axis=(0, 1, 2),
        momentum=0.9)
    (torch.relu(ot).float() * torch.from_numpy(dy)).sum().backward()
    out_tol = (dict(rtol=2.0 ** -7, atol=1e-2) if dtype == "bfloat16"
               else LAYER)
    np.testing.assert_allclose(_t(ot), _np(oj), **out_tol)
    np.testing.assert_allclose(_t(nmt), _np(nmj), **LAYER)
    np.testing.assert_allclose(_t(nvt), _np(nvj), **LAYER)
    grad_tol = (dict(rtol=2.0 ** -6, atol=5e-2) if dtype == "bfloat16"
                else GRAD)
    for a, t in zip(gj, tx):
        np.testing.assert_allclose(_t(t.grad), _np(a), **grad_tol)


def test_global_avg_pool_and_softmax_mcxent_match_jax():
    r = np.random.RandomState(6)
    x = r.randn(4, 3, 3, 8).astype(np.float32)
    w = (0.5 * r.randn(8, 5)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[r.randint(0, 5, 4)]

    def jf(x, w):
        p = jsoftmax(jops.global_avg_pool.fn(x) @ w)
        return jlosses.mcxent(p, jnp.asarray(y))

    lj, gj = jax.value_and_grad(jf, argnums=(0, 1))(x, w)
    xt, wt = (torch.tensor(a, requires_grad=True) for a in (x, w))
    lt = tlosses.get_loss("mcxent")(
        tsoftmax(tops.global_avg_pool.fn(xt) @ wt), torch.from_numpy(y))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    np.testing.assert_allclose(_t(xt.grad), _np(gj[0]), **GRAD)
    np.testing.assert_allclose(_t(wt.grad), _np(gj[1]), **GRAD)


# ---------------------------------------------------------------------------
# a small graph, from one JSON, trained in both packages
# ---------------------------------------------------------------------------


def _small_graph_json(fused: bool, dtype: str) -> str:
    b = (jgraph.graph_builder().seed(7)
         .updater(jnn.Nesterovs(learning_rate=0.05, momentum=0.9))
         .weight_init("relu").dtype(dtype).add_inputs("input")
         .set_input_types(input=jnn.InputType.convolutional(32, 32, 3)))
    b.add_layer("conv1", jnn.ConvolutionLayer(
        n_out=16, kernel=(7, 7), stride=(2, 2), convolution_mode="same",
        has_bias=False, s2d_stem=True), "input")
    b.add_layer("bn1", jnn.BatchNormalization(activation="relu"), "conv1")
    b.add_layer("pool1", jnn.SubsamplingLayer(
        kernel=(3, 3), stride=(2, 2), convolution_mode="same"), "bn1")
    if fused:
        b.add_layer("blk0", jnn.FusedBottleneck(filters=8, stride=2,
                                                project=True), "pool1")
        b.add_layer("blk1", jnn.FusedBottleneck(filters=8), "blk0")
        last = "blk1"
    else:
        z = JaxResNet50()
        last = z._bottleneck(b, "blk0", "pool1", 8, 2, project=True)
        last = z._bottleneck(b, "blk1", last, 8, 1, project=False)
    b.add_layer("gap", jnn.GlobalPoolingLayer(pooling_type="avg"), last)
    b.add_layer("fc", jnn.OutputLayer(n_out=5, activation="softmax",
                                      loss="mcxent"), "gap")
    b.set_outputs("fc")
    return b.build().to_json()


def _pair_of_graphs(fused, dtype):
    text = _small_graph_json(fused, dtype)
    jnet = jgraph.ComputationGraph(
        jgraph.ComputationGraphConfiguration.from_json(text)).init()
    tnet = tgraph.ComputationGraph(
        tgraph.ComputationGraphConfiguration.from_json(text), device="cpu")
    tnet.params, tnet.net_state, tnet.opt_state = graph_state_from_numpy(
        _tree_np(jnet.params), _tree_np(jnet.net_state),
        _tree_np(jnet.opt_state), device="cpu")
    # the JSON crosses both ways, before and after shape inference
    assert tgraph.ComputationGraphConfiguration.from_json(
        text).to_json() == text
    assert tnet.conf.to_json() == jnet.conf.to_json()
    return jnet, tnet


def _diffs(jtree, ttree):
    """max |jax - port| and max |jax| over every leaf of two trees."""
    if isinstance(jtree, dict):
        pairs = [_diffs(jtree[k], ttree[k]) for k in jtree]
        return (max([p[0] for p in pairs], default=0.0),
                max([p[1] for p in pairs], default=0.0))
    a = _np(jtree)
    return float(np.abs(a - _t(ttree)).max()), float(np.abs(a).max())


def _assert_trees_close(jtree, ttree, rtol, atol):
    if isinstance(jtree, dict):
        assert sorted(jtree) == sorted(ttree)
        for k in jtree:
            _assert_trees_close(jtree[k], ttree[k], rtol, atol)
        return
    np.testing.assert_allclose(_t(ttree), _np(jtree), rtol=rtol, atol=atol)


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "mixed"])
def test_small_graph_trains_like_jax(fused, dtype):
    jnet, tnet = _pair_of_graphs(fused, dtype)
    x, lab = synthetic_image_batch(8, 32, 32, 3, 5, seed=11)
    y = np.eye(5, dtype=np.float32)[lab]
    lj, lt = jnet.output(x)[0], tnet.output(x)[0]
    if dtype == "float32":
        np.testing.assert_allclose(lt, lj, **LAYER)
    else:
        np.testing.assert_allclose(lt, lj, rtol=3e-2, atol=3e-3)
        # the yardstick: the JAX package against itself, its input moved
        # by one bf16 unit (2^-8 relative)
        jpert, _ = _pair_of_graphs(fused, dtype)
        sign = np.sign(np.random.RandomState(5).randn(*x.shape))
        xp = (x * (1 + 2.0 ** -8 * sign)).astype(np.float32)
    for steps in (1, 2):  # after 1 and after 3 steps
        for _ in range(steps):
            jnet.fit(x, y, batch_size=8)
            tnet.fit(x, y, batch_size=8)
            if dtype == "mixed":
                jpert.fit(xp, y, batch_size=8)
        if dtype == "float32":
            np.testing.assert_allclose(tnet.score(), jnet.score(), rtol=1e-5)
            for jt, tt in ((jnet.params, tnet.params),
                           (jnet.opt_state, tnet.opt_state),
                           (jnet.net_state, tnet.net_state)):
                _assert_trees_close(jt, tt, rtol=2e-4, atol=2e-5)
        else:
            np.testing.assert_allclose(tnet.score(), jnet.score(), rtol=5e-2)
            yardstick = _diffs(jnet.params, jpert.params)[0]
            assert 0 < yardstick < 0.1
            assert _diffs(jnet.params, tnet.params)[0] <= 3 * yardstick
            assert (_diffs(jnet.net_state, tnet.net_state)[0]
                    <= 3 * _diffs(jnet.net_state, jpert.net_state)[0])
    assert tnet.iteration_count == 3


def test_float64_numpy_input_computes_in_float32_as_jax():
    """numpy's default float (float64) features and one-hot labels
    (``np.eye(5)[labels]``): the JAX package, 64-bit types off, computes in
    float32, and so does the port — ``output`` returns float32 within
    ``LAYER`` of the JAX output, and a ``fit`` step gives the JAX score
    within 1e-5."""
    jnet, tnet = _pair_of_graphs(False, "float32")
    x, lab = synthetic_image_batch(8, 32, 32, 3, 5, seed=12)
    x = x.astype(np.float64)
    y = np.eye(5)[lab]
    assert x.dtype == y.dtype == np.float64
    lj, lt = jnet.output(x)[0], tnet.output(x)[0]
    assert np.asarray(lj).dtype == lt.dtype == np.float32
    np.testing.assert_allclose(lt, lj, **LAYER)
    jnet.fit(x, y, batch_size=8)
    tnet.fit(x, y, batch_size=8)
    np.testing.assert_allclose(tnet.score(), jnet.score(), rtol=1e-5)


def test_unported_layer_types_are_refused_by_name():
    """A layer type the port has not ported (DuelingQLayer, since MoELayer
    came with the parallel package) is refused by name, by the graph's
    JSON and by the sequential network's."""
    text = _small_graph_json(False, "float32").replace(
        '"@type": "ActivationLayer"', '"@type": "DuelingQLayer"', 1)
    with pytest.raises(ValueError, match="'DuelingQLayer' is not ported"):
        tgraph.ComputationGraphConfiguration.from_json(text)
    mlc = (jnn.builder().list()
           .layer(jnn.DenseLayer(n_in=4, n_out=3, activation="relu"))
           .layer(jnn.OutputLayer(n_in=3, n_out=2)).build())
    text = mlc.to_json().replace('"@type": "DenseLayer"',
                                 '"@type": "DuelingQLayer"', 1)
    with pytest.raises(ValueError, match="'DuelingQLayer' is not ported"):
        tconf.MultiLayerConfiguration.from_json(text)


# ---------------------------------------------------------------------------
# the whole slice: ResNet-50
# ---------------------------------------------------------------------------


def test_resnet50_forward_and_one_step_match_jax():
    """ResNet-50 (5 classes, 64×64 input, batch 4), parameters drawn by the
    port and carried to the JAX package, configuration crossing as JSON.

    Forward logits (inference) 1e-5. One Nesterovs step: the score 1e-4
    relative, the output layer's parameters 1e-4. The rest of the network
    is chaotic at this size: the JAX package's own parameters after one
    step move by ~0.16 when its input is perturbed by one float32 unit
    (2^-23 relative), so the port's difference from JAX is held to 3× that
    yardstick, measured here. (At 32×32 with batch 2, the stage-4 batch
    norms see 2 values each and the JAX package's own step moves weights
    by 1e9; that size is no test.)"""
    b, s = 4, 64
    tz = ResNet50(num_classes=5, input_shape=(s, s, 3), device="cpu")
    tnet = tz.init()
    np_params = {n: {k: v.numpy() for k, v in p.items()}
                 for n, p in tnet.params.items()}
    conf_json = tz.conf().to_json()

    def jax_net():
        return jgraph.ComputationGraph(
            jgraph.ComputationGraphConfiguration.from_json(conf_json)).init(
                params=jax.tree.map(jnp.asarray, np_params))

    jnet = jax_net()
    x, lab = synthetic_image_batch(b, s, s, 3, 5, seed=1)
    y = np.eye(5, dtype=np.float32)[lab]
    np.testing.assert_allclose(tnet.output(x)[0], jnet.output(x)[0],
                               **LAYER)
    jnet.fit(x, y, batch_size=b)
    tnet.fit(x, y, batch_size=b)
    np.testing.assert_allclose(tnet.score(), jnet.score(), rtol=1e-4)
    _assert_trees_close(jnet.params["fc"], tnet.params["fc"], rtol=1e-4,
                        atol=1e-4)
    jpert = jax_net()
    sign = np.sign(np.random.RandomState(5).randn(*x.shape))
    jpert.fit((x * (1 + 2.0 ** -23 * sign)).astype(np.float32), y,
              batch_size=b)
    yardstick = _diffs(jnet.params, jpert.params)[0]
    assert 0 < yardstick < 1.0
    assert _diffs(jnet.params, tnet.params)[0] <= 3 * yardstick


def test_resnet50_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ResNet50(num_classes=5, input_shape=(32, 32, 3)).init()
    net = ResNet50(num_classes=5, input_shape=(32, 32, 3),
                   device="cpu").init()
    assert all(v.device.type == "cpu" for p in net.params.values()
               for v in p.values())
    assert sum(len(p) for p in net.params.values()) == 161
    assert math.isclose(net.num_params(), 23518277)
