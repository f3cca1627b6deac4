"""Graph checking of the PyTorch port against the JAX package (CPU):
``check_samediff``, ``SameDiff.check``, ``SameDiff(validate=True)`` and
``check_network``.

Each graph is recorded through both packages' SameDiff API by one builder
(the JAX ``analysis/fixtures.py`` recipes, the class passed in); the
reports must carry the same findings — GC code, node position and
severity — as the JAX package's. The seeded GC003 promotion case is left
out: it fails in the JAX package itself (ROADMAP.md, "Not port faults").
Networks are built through both packages' builders and checked with
``check_network``, clean and with a planted fault. Also: the importers'
``validate`` defaults against the JAX ones, and the report's raise
policy.
"""

import inspect

import numpy as np
import pytest

from deeplearning4j_tpu import analysis as janalysis
from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.autodiff import samediff as jsd
from deeplearning4j_tpu.imports import keras_import as JK
from deeplearning4j_tpu.imports import onnx_import as JO
from deeplearning4j_tpu.imports import tf_import as JT
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu_torch import analysis as tanalysis
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.autodiff import samediff as tsd
from deeplearning4j_tpu_torch.imports import keras_import as TK
from deeplearning4j_tpu_torch.imports import onnx_import as TO
from deeplearning4j_tpu_torch.imports import tf_import as TT
from deeplearning4j_tpu_torch.nn import graph as tgraph

PKGS = {"jax": (jsd, janalysis), "port": (tsd, tanalysis)}


def _sd(mod):
    return mod.SameDiff() if mod is jsd else mod.SameDiff(device="cpu")


def mlp_sym_batch(mod):
    r = np.random.RandomState(0)
    sd = _sd(mod)
    x = sd.placeholder("x", shape=(None, 8))
    labels = sd.placeholder("labels", shape=(None, 3))
    w0 = sd.var("w0", r.randn(8, 16).astype(np.float32) * 0.2)
    b0 = sd.var("b0", np.zeros(16, np.float32))
    w1 = sd.var("w1", r.randn(16, 3).astype(np.float32) * 0.2)
    h = sd.nn.relu(x @ w0 + b0)
    logits = h @ w1
    sd.loss.softmax_cross_entropy(logits, labels).rename("loss")
    logits.rename("logits")
    sd.graph_inputs, sd.graph_outputs = ["x", "labels"], ["logits", "loss"]
    return sd


def cnn_sym_batch(mod):
    r = np.random.RandomState(1)
    sd = _sd(mod)
    img = sd.placeholder("img", shape=(None, 28, 28, 1))
    w1 = sd.var("wc1", (r.randn(3, 3, 1, 8) * 0.1).astype(np.float32))
    w2 = sd.var("wc2", (r.randn(3, 3, 8, 16) * 0.1).astype(np.float32))
    c1 = sd.cnn.conv2d(img, w1, stride=1, padding="same")
    p1 = sd.cnn.max_pooling2d(sd.nn.relu(c1), kernel=2, stride=2)
    c2 = sd.cnn.conv2d(p1, w2, stride=1, padding="same")
    p2 = sd.cnn.avg_pooling2d(sd.nn.relu(c2), kernel=2, stride=2)
    p2.rename("features")
    sd.graph_inputs, sd.graph_outputs = ["img"], ["features"]
    return sd


def shape_chain(mod):
    sd = _sd(mod)
    x = sd.var("x", np.ones((6, 4), np.float32))
    s = sd.op("shape_of", x)
    a, b = sd.op("unstack", s, n_out=2)
    tgt = sd.op("stack", b, a)
    sd.op("reshape_dynamic", x, tgt).rename("y")
    sd.graph_inputs, sd.graph_outputs = [], ["y"]
    return sd


def layer_norm_gelu(mod):
    """The pattern the optimizer fuses into ``fused_layer_norm``."""
    r = np.random.RandomState(4)
    sd = _sd(mod)
    x = sd.placeholder("x", shape=(None, 16, 32))
    g = sd.var("g", np.ones(32, np.float32))
    b = sd.var("b", r.randn(32).astype(np.float32) * 0.1)
    sd.nn.gelu(sd.nn.layer_norm(x, g, b)).rename("y")
    sd.graph_inputs, sd.graph_outputs = ["x"], ["y"]
    return sd


def layer_norm_op(mod, axis=-1, batch=2):
    """The registry's ``layer_norm`` (ONNX LayerNormalization's op), which
    the port infers by a rule and the JAX package by its shape probe
    (which does not run on a symbolic batch: a GC006 warning in both)."""
    sd = _sd(mod)
    x = sd.placeholder("x", shape=(batch, 9, 24))
    g = sd.var("g", np.ones(24, np.float32))
    b = sd.var("b", np.zeros(24, np.float32))
    sd.op("layer_norm", x, g, b, axis=axis).rename("y")
    sd.graph_inputs, sd.graph_outputs = ["x"], ["y"]
    return sd


def layer_norm_bad_axis(mod):
    return layer_norm_op(mod, axis=5)


def layer_norm_symbolic(mod):
    return layer_norm_op(mod, batch=None)


def rank_mismatch(mod):
    sd = _sd(mod)
    x = sd.placeholder("x", (2, 3))
    sd._record("transpose", [x], {"axes": (0, 1, 2)})
    return sd


def broadcast_failure(mod):
    sd = _sd(mod)
    a = sd.placeholder("a", (2, 3))
    b = sd.placeholder("b", (4, 5))
    a + b
    return sd


def dangling_input(mod):
    sd = _sd(mod)
    sd.placeholder("x", (3,))
    sd._nodes.append(mod._Node("add", ["x", "ghost"], {}, ["dangling_out"]))
    return sd


def reshape_count(mod):
    sd = _sd(mod)
    x = sd.placeholder("x", (4, 3))
    x.reshape(5, 3)
    return sd


def unknown_op(mod):
    sd = _sd(mod)
    x = sd.placeholder("x", (None, 8))
    sd.op("top_k", x, k=2, n_out=2)
    return sd


def missing_output(mod):
    sd = mlp_sym_batch(mod)
    sd.graph_outputs = ["logits", "nowhere"]
    return sd


GRAPHS = {f.__name__: (code, f) for code, f in (
    (None, mlp_sym_batch), (None, cnn_sym_batch), (None, shape_chain),
    (None, layer_norm_gelu), (None, layer_norm_op),
    ("GC006", layer_norm_bad_axis), ("GC006", layer_norm_symbolic),
    ("GC001", rank_mismatch),
    ("GC002", broadcast_failure), ("GC004", dangling_input),
    ("GC005", reshape_count), ("GC006", unknown_op),
    ("GC004", missing_output))}


def _findings(report):
    return [(f.rule, f.line, f.severity) for f in report.findings]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_check_samediff_matches_jax(name):
    code, build = GRAPHS[name]
    reports = {k: an.check_samediff(build(mod), graph_name=name)
               for k, (mod, an) in PKGS.items()}
    assert _findings(reports["port"]) == _findings(reports["jax"])
    assert reports["port"].ok == reports["jax"].ok
    if code is None:
        assert reports["port"].findings == []
    else:
        assert code in {f.rule for f in reports["port"].findings}
    assert reports["port"].graph_name == name
    assert reports["port"].seconds >= 0.0


@pytest.mark.parametrize("name", ["mlp_sym_batch", "reshape_count",
                                  "broadcast_failure"])
def test_samediff_check_and_validate_match_jax(name):
    """``SameDiff.check()`` keeps its report and raises nothing; outputs
    restrict the walk to their ancestors; with ``validate=True`` a run of
    a faulty graph raises GraphCheckError with the JAX findings."""
    code, build = GRAPHS[name]
    got = {}
    for k, (mod, an) in PKGS.items():
        sd = build(mod)
        report = sd.check()
        assert sd.last_check_report is report
        outs = sd.graph_outputs or [sd._nodes[-1].outputs[0]]
        got[k] = (_findings(report), _findings(sd.check(outputs=outs[:1])))
        if code is not None:
            sd.validate = True
            with pytest.raises(an.GraphCheckError) as err:
                sd.output({n: np.ones([2 if d is None else d
                                       for d in v.shape], np.float32)
                           for n, v in sd._vars.items()
                           if v.vtype == "PLACEHOLDER"},
                          [sd._nodes[-1].outputs[0]])
            got[k] += ([(f.rule, f.line) for f in err.value.findings],)
    assert got["port"] == got["jax"]


def _mln(pkg, n_in_out=4):
    return (pkg.builder().list()
            .layer(pkg.DenseLayer(n_in=4, n_out=6))
            .layer(pkg.OutputLayer(n_in=n_in_out, n_out=2))
            .set_input_type(pkg.InputType.feed_forward(4)).build())


def _residual(g, pkg, missing=False):
    b = (g.graph_builder().seed(0).add_inputs("in")
         .set_input_types(**{"in": pkg.InputType.feed_forward(6)})
         .add_layer("d", pkg.DenseLayer(n_in=6, n_out=6, activation="relu"),
                    "in")
         .add_vertex("add", g.ElementWiseVertex(op="add"), "d", "in")
         .add_layer("out", pkg.OutputLayer(n_in=6, n_out=2,
                                           activation="softmax",
                                           loss="mcxent"),
                    "ghost" if missing else "add")
         .set_outputs("out"))
    conf = b.build() if not missing else b._conf
    return conf


@pytest.mark.parametrize("case", ["mln_clean", "mln_n_in", "graph_clean",
                                  "graph_missing_input", "capsnet"])
def test_check_network_matches_jax(case):
    from deeplearning4j_tpu_torch.testing import layer_nets as L

    def build(pkg, g):
        if case == "mln_clean":
            return _mln(pkg, 6)
        if case == "mln_n_in":
            return _mln(pkg, 5)
        if case == "capsnet":
            return L.build("capsnet", pkg, L.SMALL["capsnet"])
        return _residual(g, pkg, missing=case == "graph_missing_input")

    want = janalysis.check_network(build(jnn, jgraph), graph_name=case)
    got = tanalysis.check_network(build(tnn, tgraph), graph_name=case)
    assert _findings(got) == _findings(want)
    expect = {"mln_n_in": "GC002", "graph_missing_input": "GC004"}.get(case)
    assert [f.rule for f in got.findings] == ([expect] if expect else [])


def test_report_raises_on_errors_only():
    clean = tanalysis.check_samediff(mlp_sym_batch(tsd))
    assert clean.raise_on_errors() is clean
    assert "clean" in clean.render()
    warn = tanalysis.check_samediff(unknown_op(tsd))
    assert warn.ok and warn.warnings and warn.raise_on_errors() is warn
    bad = tanalysis.check_samediff(reshape_count(tsd))
    with pytest.raises(tanalysis.GraphCheckError, match="GC005"):
        bad.raise_on_errors()
    assert "GC005" in repr(bad.errors[0].render()) and not bad.ok


def test_validate_defaults_are_the_jax_ones():
    """``validate`` defaults to True in every importer entry point and to
    False in SameDiff, as in the JAX package."""
    def default(fn):
        return inspect.signature(fn).parameters["validate"].default

    pairs = [(JO.import_onnx, TO.import_onnx),
             (JO.OnnxImporter.__init__, TO.OnnxImporter.__init__),
             (JK.import_keras_model_and_weights,
              TK.import_keras_model_and_weights),
             (JK.import_keras_sequential_model_and_weights,
              TK.import_keras_sequential_model_and_weights),
             (JK.import_keras_functional_config,
              TK.import_keras_functional_config),
             (jsd.SameDiff.__init__, tsd.SameDiff.__init__)]
    for j, t in pairs:
        assert default(t) == default(j), t.__qualname__
    assert default(TT.TensorflowImporter.__init__) is True
    assert default(TT.import_frozen_graph) is True
    assert default(TT.import_saved_model) is True
    assert tsd.SameDiff(device="cpu").validate is False
    assert default(JT.TensorflowImporter.run_import) is True
