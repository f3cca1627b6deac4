"""The zoo's vision models of the PyTorch port against the JAX package
(CPU).

Each of the eleven models is built through both packages at the small
shapes the JAX zoo tests use (``tests/test_graph_zoo.py``,
``tests/test_layers_round3.py``), the port's from its own zoo class.
Held: the configuration JSON (a graph's after shape inference) and the
parameter count; ``output`` and, for the nine trainable models, two
``fit`` steps (scores, parameters, updater state) with one parameter
tree in both networks; for TinyYOLO and YOLO2 ``yolo_loss`` and its
gradient w.r.t. the prediction; a JAX graph's trees after a step (its
parameters, batch-norm statistics and updater state) carried into the
port by ``graph_state_from_numpy``; the GPT entry's logits from the JAX
model's weights.

The parameters are drawn once by the port's zoo class and handed to both
packages as numpy (the JAX package's own zoo init runs ~10 s a model on
this CPU; the JAX trees' structure is the one both ``init(params=...)``
take). Each ``fit`` step starts both networks from the same state (the
port's carried over from the JAX network's parameters, layer state and
updater state before the second step), so each step is held on its own
and no chaos of a random network builds up across steps; each step
runs in float64 through both packages (the float32 steps of a random
relu network cross relu and max-pool boundaries a rounding apart). AlexNet, VGG
and SqueezeNet train with dropout 0: two frameworks' random streams
cannot draw the same masks. The models whose zoo updater is Adam or
RmsProp take the steps under Nesterovs (the constructor's ``updater``
argument): both turn a gradient that is zero in exact arithmetic (a
convolution's bias feeding batch norm through an all-active relu) into
a step of about the learning rate with the sign of its rounding noise,
in either framework; a Nesterovs step is linear in the gradient. Adam
and RmsProp themselves are held in ``test_torch_updater.py``.

Tolerances: float32 outputs 1e-5 relative + 1e-5 absolute; a ``fit``
step in float64 through both packages 1e-9 (score, parameters, updater
state), the float32 steps against it as the fit test says; the
YOLO loss 1e-5 relative and its gradient 1e-5 relative + 1e-7 absolute.
Batch 4: batch norm over N·1·1 values at the deepest layers is ill
conditioned at N = 2 (``test_torch_nn_train.py``'s ResNet-50 note).
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.models._tree import map_tree
from deeplearning4j_tpu_torch.nn import graph as tgraph
from deeplearning4j_tpu_torch.nn.updater import Updater
from deeplearning4j_tpu_torch.testing import zoo_cnn

OUT = dict(rtol=1e-5, atol=1e-5)
SCORE = dict(rtol=1e-5)
F64 = 1e-9
F32_JAX = ("Xception",)  # its JAX step in float32 (see the fit test)
F32_SCORE = 1e-4
F32_STEP = 0.05
BATCH = 4

# the JAX zoo tests' shapes (Xception's cut)
MODELS = {
    "SimpleCNN": dict(num_classes=5, input_shape=(32, 32, 3)),
    "AlexNet": dict(num_classes=10, input_shape=(67, 67, 3)),
    "VGG16": dict(num_classes=10, input_shape=(32, 32, 3)),
    "VGG19": dict(num_classes=5, input_shape=(32, 32, 3)),
    "Darknet19": dict(num_classes=10, input_shape=(32, 32, 3)),
    "SqueezeNet": dict(num_classes=4, input_shape=(67, 67, 3)),
    "UNet": dict(input_shape=(32, 32, 1), base=4),
    # 39×39 for the JAX tests' 71×71: every flow still halves down to 2×2,
    # at half the CPU time of the float64 depthwise steps
    "Xception": dict(num_classes=3, input_shape=(39, 39, 3),
                     middle_repeats=1),
    "InceptionResNetV1": dict(num_classes=4, input_shape=(96, 96, 3),
                              blocks=(1, 1, 1)),
    "TinyYOLO": dict(num_classes=4, num_boxes=2, input_shape=(64, 64, 3)),
    "YOLO2": dict(num_classes=3, num_boxes=2, input_shape=(64, 64, 3)),
}
TRAINABLE = [m for m in MODELS if m not in ("TinyYOLO", "YOLO2")]
NO_DROPOUT = ("AlexNet", "VGG16", "VGG19", "SqueezeNet")
LINEAR_UPDATER = ("SimpleCNN", "SqueezeNet", "UNet", "Xception",
                  "InceptionResNetV1")


def _host(tree):
    return jax.tree.map(
        lambda a: (a.detach().numpy() if isinstance(a, torch.Tensor)
                   else np.array(a)), tree)


@functools.lru_cache(maxsize=None)
def _params(name):
    """One parameter tree a model, drawn by the port's zoo class."""
    return _host(getattr(tzoo, name)(device="cpu", **MODELS[name])
                 .init().params)


def _kwargs(pkg, name):
    kw = dict(MODELS[name])
    if name in LINEAR_UPDATER:
        kw["updater"] = pkg.Nesterovs(learning_rate=1e-2, momentum=0.9)
    return kw


def _train_conf(conf, name):
    """Dropout 0: AlexNet's and VGG's dense layers, SqueezeNet's
    DropoutLayer."""
    if name in NO_DROPOUT and hasattr(conf, "layers"):
        conf.layers = [dataclasses.replace(lc, dropout=None)
                       if getattr(lc, "dropout", None) else lc
                       for lc in conf.layers]
    if name in NO_DROPOUT:
        for node in getattr(conf, "nodes", ()):
            if type(node.layer).__name__ == "DropoutLayer":
                node.layer = dataclasses.replace(node.layer, rate=0.0)
    return conf


@pytest.fixture
def undrawn_jax_init(monkeypatch):
    """The JAX zoo's ``init()`` builds the network (and a graph's shape
    inference) without drawing parameters."""
    monkeypatch.setattr(jnn.MultiLayerNetwork, "init",
                        lambda self, params=None: self)
    monkeypatch.setattr(jgraph.ComputationGraph, "init",
                        lambda self, params=None: self)


def _nets(name, monkeypatch):
    """(JAX network, port network) with the same parameters."""
    with monkeypatch.context() as m:
        m.setattr(jnn.MultiLayerNetwork, "init",
                  lambda self, params=None: self)
        m.setattr(jgraph.ComputationGraph, "init",
                  lambda self, params=None: self)
        jconf = _train_conf(getattr(jzoo, name)(
            **_kwargs(jnn, name)).init().conf, name)
    make = (jgraph.ComputationGraph
            if isinstance(jconf, jgraph.ComputationGraphConfiguration)
            else jnn.MultiLayerNetwork)
    jnet = make(jconf).init(jax.tree.map(jnp.asarray, _params(name)))
    tconf = _train_conf(getattr(tzoo, name)(
        device="cpu", **_kwargs(tnn, name)).conf(), name)
    tmake = (tgraph.ComputationGraph
             if isinstance(tconf, tgraph.ComputationGraphConfiguration)
             else tnn.MultiLayerNetwork)
    return jnet, tmake(tconf, device="cpu").init(_params(name))


def _first(out):
    return out[0] if isinstance(out, list) else out


def _data(name, n=2, seed=0):
    rng = np.random.default_rng(seed)
    h, w, c = MODELS[name]["input_shape"]
    x = rng.random((n, h, w, c), dtype=np.float32)
    if name == "UNet":
        y = (rng.random((n, h, w, 1)) > 0.5).astype(np.float32)
    else:
        k = MODELS[name]["num_classes"]
        y = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]
    return x, y


def _flat(tree):
    """Every leaf in ``jax.tree.leaves`` order (sorted keys), as one
    float64 vector; the port's tensors and the JAX arrays alike."""
    return np.concatenate([np.asarray(leaf, np.float64).reshape(-1)
                           for leaf in jax.tree.leaves(_host(tree))])


def _rel(a, b, ref):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_configuration_matches_jax(name, undrawn_jax_init):
    """The port's zoo class writes the JAX zoo's JSON, and the parameter
    tree the JAX network takes."""
    jnet = getattr(jzoo, name)(**MODELS[name]).init()
    tnet = getattr(tzoo, name)(device="cpu", **MODELS[name]).init(
        _params(name))
    assert json.loads(tnet.conf.to_json()) == json.loads(jnet.conf.to_json())
    key = jax.random.key(0)
    layers = (jnet.layers.items()
              if isinstance(jnet, jgraph.ComputationGraph)
              else enumerate(jnet.layers))
    want = {n: jax.eval_shape(layer.init, key) for n, layer in layers}
    if not isinstance(jnet, jgraph.ComputationGraph):
        want = [want[i] for i in range(len(jnet.layers))]
    assert jax.tree.map(lambda a: tuple(a.shape), want) == jax.tree.map(
        np.shape, _params(name))


def _f64_state(trees, device="cpu"):
    return tuple(map_tree(lambda v: v.double(), t)
                 for t in tzoo.graph_state_from_numpy(*trees, device=device))


def _port_f64_step(tnet, trees, step, xs, ys):
    """The port's train step in float64 from ``trees`` (params, layer
    state, updater state as numpy): its score and trees after the step."""
    tnet.params, tnet.net_state, tnet.opt_state = _f64_state(trees)
    tnet.iteration_count = step
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    # one thread: the CPU's float64 grouped convolution runs a parallel
    # region a group, whose barriers take ~100x longer beside other test
    # workers (Xception's step: 0.7 s alone, 71 s at 8 threads beside 5
    # busy processes)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if isinstance(tnet, tgraph.ComputationGraph):
            score = tnet._train_step({tnet.conf.network_inputs[0]: x},
                                     {tnet.conf.network_outputs[0]: y},
                                     None, None)
        else:
            score, _ = tnet._train_step(x, y, None, None)
    finally:
        torch.set_num_threads(threads)
    return float(score), _host(tnet.params), _host(tnet.opt_state)


def _jax_step(jnet, trees, xs, ys):
    """The JAX network's ``fit`` step from ``trees`` in the inputs' float
    type (float64 under ``jax.enable_x64``): its score and trees after
    the step."""
    with jax.enable_x64(xs.dtype == np.float64):
        jnet.params, jnet.net_state, jnet.opt_state = (
            jax.tree.map(lambda a: jnp.asarray(a, xs.dtype), t)
            for t in trees)
        jnet.fit(xs, ys, batch_size=xs.shape[0])
        return (float(jnet.score()), _host(jnet.params), _host(jnet.net_state),
                _host(jnet.opt_state))


# the fit cases run in four files, so that the test run's workers take
# the heavy models in parallel: this file the light ones, and
# test_torch_zoo_alexnet.py, test_torch_zoo_vgg.py, test_torch_zoo_deep.py
FIT_FILES = {"test_torch_zoo_alexnet": ("AlexNet", "Darknet19"),
             "test_torch_zoo_vgg": ("VGG16", "VGG19"),
             "test_torch_zoo_deep": ("Xception", "InceptionResNetV1")}
FIT_HERE = [m for m in TRAINABLE
            if not any(m in ms for ms in FIT_FILES.values())]


@pytest.mark.parametrize("name", FIT_HERE)
def test_zoo_output_and_two_fit_steps_match_jax(name, monkeypatch):
    check_output_and_two_fit_steps(name, monkeypatch)


def check_output_and_two_fit_steps(name, monkeypatch):
    """``output`` in float32, then two ``fit`` steps of batch 4, each from
    one state in every network (the JAX network's after the step before),
    held to the port's step in float64 from that state.

    The JAX network's ``fit`` under ``jax.enable_x64`` holds the two
    packages' arithmetic: score, parameters and updater state to 1e-9 of
    the port's float64 step. Xception's JAX step runs in float32 instead:
    XLA's float64 depthwise convolution on the CPU takes seconds a layer;
    it is held as the port's float32 step is. The port's float32 ``fit``:
    its score to 1e-4 of the float64 score, its parameters and updater
    state within 5% (relative L2 norm of the step) of the float64 ones: a
    random relu network's float32 step crosses relu and max-pool
    boundaries that lie a rounding away, in either package (the JAX
    package's own float32 step lands 1.9% from its float64 step on VGG16
    here)."""
    jnet, tnet = _nets(name, monkeypatch)  # each takes every step below
    jax_dtype = np.float32 if name in F32_JAX else np.float64
    x, _ = _data(name)
    np.testing.assert_allclose(_first(tnet.output(x)),
                               np.asarray(_first(jnet.output(x))), **OUT)
    trees = (_params(name), _host(jnet.net_state), _host(jnet.opt_state))
    for step in range(2):
        xs, ys = _data(name, n=BATCH, seed=10 + step)
        score, p64, s64 = _port_f64_step(tnet, trees, step,
                                         xs.astype(np.float64),
                                         ys.astype(np.float64))
        before, p64, s64 = _flat(trees[0]), _flat(p64), _flat(s64)
        j_score, j_params, j_state, j_opt = _jax_step(
            jnet, trees, xs.astype(jax_dtype), ys.astype(jax_dtype))
        score_tol, step_tol = ((F64, F64) if jax_dtype == np.float64
                               else (F32_SCORE, F32_STEP))
        np.testing.assert_allclose(j_score, score, rtol=score_tol)
        assert _rel(_flat(j_params), p64, p64 - before) <= step_tol, step
        assert _rel(_flat(j_opt), s64, s64) <= step_tol, step
        # the port's float32 fit from the same state
        tnet.params, tnet.net_state, tnet.opt_state = (
            tzoo.graph_state_from_numpy(*trees, device="cpu"))
        tnet.iteration_count = step
        tnet.fit(xs, ys, batch_size=BATCH)
        np.testing.assert_allclose(tnet.score(), score, rtol=F32_SCORE)
        move = _rel(_flat(tnet.params), p64, p64 - before)
        assert move <= F32_STEP, (step, move)
        state = _rel(tnet.updater_state_flat(), s64, s64)
        assert state <= F32_STEP, (step, state)
        trees = tuple(jax.tree.map(lambda a: a.astype(np.float32), t)
                      for t in (j_params, j_state, j_opt))
    assert tnet.iteration_count == jnet.iteration_count == 2


@pytest.mark.parametrize("name", ["TinyYOLO", "YOLO2"])
def test_detector_output_and_yolo_loss_match_jax(name, monkeypatch):
    """The raw head and the YOLOv2 loss (with its gradient w.r.t. the
    prediction) from the JAX parameters; the JAX YOLO2 has no
    ``yolo_loss`` method, so both sides score it with TinyYOLO's."""
    jnet, tnet = _nets(name, monkeypatch)
    tzoo_model = getattr(tzoo, name)(device="cpu", **MODELS[name])
    x, _ = _data(name)
    pj = np.asarray(_first(jnet.output(x)))
    pt = _first(tnet.output(x))
    np.testing.assert_allclose(pt, pj, **OUT)
    b, k = MODELS[name]["num_boxes"], MODELS[name]["num_classes"]
    assert pt.shape == (2, 2, 2, b * (5 + k))
    rng = np.random.default_rng(4)
    target = np.zeros((2, 2, 2, b, 5 + k), np.float32)
    target[..., :4] = rng.random((2, 2, 2, b, 4))
    target[:, 1, 1, 0, 4] = 1.0
    target[:, 1, 1, 0, 5] = 1.0
    jloss_fn = jzoo.TinyYOLO(**{a: v for a, v in MODELS[name].items()})
    lj, gj = jax.value_and_grad(
        lambda p: jloss_fn.yolo_loss(p, jnp.asarray(target)))(jnp.asarray(pt))
    p = torch.tensor(pt, requires_grad=True)
    lt = tzoo_model.yolo_loss(p, torch.from_numpy(target))
    (gt,) = torch.autograd.grad(lt, p)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-7)
    assert np.isfinite(float(lj)) and float(lj) > 0


def test_graph_state_from_numpy_carries_the_batch_norm_state(monkeypatch):
    """A JAX graph's parameters, BN running statistics and updater state
    after a step carry across: the port's inference output equals the
    JAX one, and so does its updater state."""
    jnet, tnet = _nets("Xception", monkeypatch)
    x, y = _data("Xception", n=BATCH)
    jnet.fit(x, y, batch_size=BATCH)
    params, state, opt = tzoo.graph_state_from_numpy(
        _host(jnet.params), _host(jnet.net_state), _host(jnet.opt_state),
        device="cpu")
    tnet.params, tnet.net_state, tnet.opt_state = params, state, opt
    np.testing.assert_array_equal(tnet.updater_state_flat(),
                                  _flat(jnet.opt_state).astype(np.float32))
    np.testing.assert_allclose(tnet.output(x)[0],
                               np.asarray(jnet.output(x)[0]), **OUT)


def test_gpt_entry_takes_the_jax_weights():
    jm = jzoo.GPT("tiny", seed=3).init()
    tm = tzoo.GPT("tiny", seed=3, device="cpu").init(_host(jm.params))
    ids = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, (2, 9))
    np.testing.assert_allclose(tm.logits(ids), jm.logits(ids), rtol=1e-4,
                               atol=1e-4)
    assert tm.cfg.to_json() == jm.cfg.to_json()
    with pytest.raises(ValueError, match="unknown GPT preset"):
        tzoo.GPT("huge", device="cpu")


def test_zoo_defaults_are_the_reference_constructor_defaults():
    for name in MODELS:
        j, t = getattr(jzoo, name)(), getattr(tzoo, name)(device="cpu")
        for attr in ("num_classes", "seed", "input_shape", "num_boxes",
                     "n_channels_out", "base", "middle_repeats", "blocks",
                     "embedding_size"):
            if hasattr(j, attr):
                assert getattr(t, attr) == getattr(j, attr), (name, attr)
        assert t.updater == Updater.from_dict(j.updater.to_dict()), name


def test_zoo_cnn_cells_name_the_zoo_updaters():
    """chip_smoke's zoo_cnn cells (``testing/zoo_cnn.py``) name each
    model's zoo default updater, and the detectors serve at 416×416."""
    for name, _, updater in zoo_cnn.TRAIN:
        zoo = getattr(tzoo, name)(device="cpu")
        assert type(zoo.updater).__name__ == updater, name
    for name, _ in zoo_cnn.DETECT:
        assert getattr(tzoo, name)(device="cpu").input_shape == (416, 416, 3)


def test_step_flops_counts_the_conv_and_dense_shapes():
    """2 × multiply-adds: forward, weight gradient, and input gradient
    for every layer not fed by the network input."""
    conf = (tnn.builder().list()
            .layer(tnn.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                        convolution_mode="same"))
            .layer(tnn.SeparableConvolution2D(
                n_out=5, kernel=(3, 3), stride=(2, 2), depth_multiplier=2,
                convolution_mode="same"))
            .layer(tnn.OutputLayer(n_out=3))
            .set_input_type(tnn.InputType.convolutional(6, 6, 2)).build())
    net = tnn.MultiLayerNetwork(conf, device="cpu")
    conv = 2 * 6 * 6 * 2 * 4 * 9
    sep = 2 * 3 * 3 * 8 * (9 + 5)
    dense = 2 * 45 * 3
    flops = zoo_cnn.step_flops(net, 2)
    assert flops["forward"] == 2 * (conv + sep + dense)
    assert flops["step"] == 2 * (2 * conv + 3 * sep + 3 * dense)


def test_chip_smoke_zoo_cnn_phase_runs_on_the_cpu():
    """chip_smoke's ``zoo_cnn`` phase, rehearsed on the CPU at small
    shapes (a MultiLayerNetwork, the loss-less UNet, a detector): every
    check passes but the updater's launch counts, which only the card's
    kernel makes."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    small = {"SimpleCNN": dict(input_shape=(16, 16, 3), num_classes=5),
             "UNet": dict(input_shape=(16, 16, 1), base=4),
             "TinyYOLO": dict(input_shape=(64, 64, 3), num_classes=4,
                              num_boxes=2)}
    problems, launches = chip_smoke.zoo_cnn_phase(
        torch.device("cpu"), "cpu", train=[("SimpleCNN", 4, "Adam"),
                                           ("UNet", 2, "Adam")],
        detect=[("TinyYOLO", 2)], kwargs=small)
    assert launches == {"fused_updater": 0}
    assert problems and all("fused_updater" in p for p in problems)
