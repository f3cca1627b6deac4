"""The port's TF importer against the JAX package's on the same bytes (CPU).

* Every golden graph of the JAX package's ``TestTfImport``,
  ``TestTfImportWidened``, ``TestRound4OpBreadth`` and
  ``TestSpaceBatchOps`` (``tests/test_tf_import.py``), frozen with the
  installed TensorFlow and imported by both packages: the
  port's outputs within 1e-5 × max(1, max |JAX|) of the JAX package's
  (float32; integer and bool outputs equal; dtypes equal), and within the
  JAX test's own tolerance of TF's. The imported-variables case also
  compares the gradients.
* Both importers hold the same 204 rule names; an op without a rule
  raises at import, naming it.
* ``tf_proto.make_ndarray`` equals ``tensor_util.MakeNdarray`` on every
  dtype the rules meet and on the padded ``*_val`` form.
* The narrow ``testing/tf_builder`` BERT: TF parses and runs it, and TF,
  JAX and the port agree on the logits and the two packages on the
  optimizer's fusions, with a static batch ({attention 2, epilogue 14})
  and with a dynamic one (epilogue 14 only).
* ``GraphRunner`` on TF and ONNX bytes in both packages.
* Importing and running the port's TF importer in a fresh interpreter
  leaves ``tensorflow``, ``jax``, ``google.protobuf`` and the JAX
  package out of ``sys.modules``.

The tests need TensorFlow to write the graphs; the port never imports
it. TF32 is pinned off, as ``tests/torch_parity.py`` pins it.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from deeplearning4j_tpu.imports import GraphRunner as JGraphRunner
from deeplearning4j_tpu.imports import TensorflowImporter as JImporter
from deeplearning4j_tpu.imports import tf_import as jtf
from deeplearning4j_tpu_torch.imports import GraphRunner, TensorflowImporter
from deeplearning4j_tpu_torch.imports import tf_import as ptf
from deeplearning4j_tpu_torch.imports import tf_proto
from deeplearning4j_tpu_torch.testing import onnx_builder as ob
from deeplearning4j_tpu_torch.testing import tf_builder as tb

torch.backends.cuda.matmul.allow_tf32 = False
REL = 1e-5


def freeze(fn, *specs, lower_control_flow=True):
    """Concrete function → frozen GraphDef (variables inlined as Consts),
    as the JAX package's test freezes."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    cf = tf.function(fn).get_concrete_function(*specs)
    frozen = convert_variables_to_constants_v2(
        cf, lower_control_flow=lower_control_flow)
    return (frozen.graph.as_graph_def(),
            [t.name.split(":")[0] for t in frozen.inputs],
            [t.name.split(":")[0] for t in frozen.outputs])


def assert_port(port, ref):
    """The port's array against the JAX package's: same shape and dtype,
    floats within REL × max(1, max |ref|), the rest equal."""
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (
        port.shape, port.dtype, ref.shape, ref.dtype)
    if ref.dtype.kind == "f":
        scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
        np.testing.assert_allclose(port, ref, rtol=0, atol=REL * scale)
    else:
        np.testing.assert_array_equal(port, ref)


def both(gd, feeds, fetch):
    """(port, JAX) outputs of ``fetch`` on the same bytes and feeds."""
    data = gd.SerializeToString()
    psd = TensorflowImporter(device="cpu").run_import(data)
    jsd = JImporter().run_import(data)
    return (psd.output(feeds, fetch)[fetch], jsd.output(feeds, fetch)[fetch],
            psd, jsd)


# ---------------------------------------------------------------------------
# the JAX package's golden graphs
# ---------------------------------------------------------------------------


def _mlp():
    rng = np.random.RandomState(0)
    w0 = tf.Variable(rng.randn(4, 8).astype(np.float32))
    b0 = tf.Variable(np.zeros(8, np.float32))
    w1 = tf.Variable(rng.randn(8, 3).astype(np.float32))

    def model(x):
        h = tf.nn.relu(tf.matmul(x, w0) + b0)
        return tf.nn.softmax(tf.matmul(h, w1))

    return model, [tf.TensorSpec([None, 4], tf.float32)], \
        [rng.randn(5, 4).astype(np.float32)], (1e-5, 1e-6)


def _elementwise_chain():
    def model(x):
        y = tf.sqrt(tf.abs(x) + 1.0) * tf.tanh(x) - tf.sigmoid(x)
        return tf.reduce_mean(y, axis=1)

    return model, [tf.TensorSpec([3, 6], tf.float32)], \
        [np.random.RandomState(1).randn(3, 6).astype(np.float32)], \
        (1e-5, 1e-6)


def _reshape_transpose():
    def model(x):
        y = tf.transpose(tf.reshape(x, [2, 3, 4]), perm=[0, 2, 1])
        return tf.reduce_sum(y, axis=[1], keepdims=True)

    return model, [tf.TensorSpec([2, 12], tf.float32)], \
        [np.arange(24, dtype=np.float32).reshape(2, 12)], (1e-6, 0.0)


def _conv_pool():
    rng = np.random.RandomState(2)
    k = tf.Variable(rng.randn(3, 3, 2, 4).astype(np.float32) * 0.1)

    def model(x):
        y = tf.nn.conv2d(x, k, strides=[1, 1, 1, 1], padding="SAME")
        y = tf.nn.relu(y)
        return tf.nn.max_pool2d(y, ksize=2, strides=2, padding="VALID")

    return model, [tf.TensorSpec([1, 8, 8, 2], tf.float32)], \
        [rng.randn(1, 8, 8, 2).astype(np.float32)], (1e-4, 1e-5)


def _gelu_composite():
    def model(x):
        return 0.5 * x * (1.0 + tf.math.erf(x / tf.sqrt(2.0)))

    return model, [tf.TensorSpec([4], tf.float32)], \
        [np.linspace(-2, 2, 4).astype(np.float32)], (1e-5, 1e-6)


def _cnn_bn():
    rng = np.random.RandomState(7)
    w = tf.Variable((rng.randn(3, 3, 3, 8) * 0.3).astype(np.float32))
    dw = tf.Variable((rng.randn(3, 3, 8, 1) * 0.3).astype(np.float32))
    gamma = tf.Variable((np.abs(rng.randn(8)) + 0.5).astype(np.float32))
    beta = tf.Variable(rng.randn(8).astype(np.float32))
    mean = tf.Variable(rng.randn(8).astype(np.float32))
    var = tf.Variable((np.abs(rng.randn(8)) + 0.5).astype(np.float32))

    def model(x):
        y = tf.nn.conv2d(x, w, strides=1, padding="SAME")
        y, _, _ = tf.compat.v1.nn.fused_batch_norm(
            y, gamma, beta, mean=mean, variance=var, is_training=False)
        y = tf.nn.leaky_relu(y, alpha=0.1)
        y = tf.nn.depthwise_conv2d(y, dw, strides=[1, 1, 1, 1],
                                   padding="VALID")
        y = tf.pad(y, [[0, 0], [1, 1], [1, 1], [0, 0]])
        return tf.reduce_mean(y, axis=[1, 2])

    return model, [tf.TensorSpec([2, 8, 8, 3], tf.float32)], \
        [rng.randn(2, 8, 8, 3).astype(np.float32)], (1e-4, 1e-5)


def _strided_slice_clip_cumsum():
    def model(x):
        y = tf.strided_slice(x, [0, 1], [3, 7], [1, 2])
        y = tf.clip_by_value(y, -0.5, 0.5)
        return tf.cumsum(y, axis=1)

    return model, [tf.TensorSpec([3, 8], tf.float32)], \
        [np.random.RandomState(8).randn(3, 8).astype(np.float32)], \
        (1e-5, 1e-6)


def _einsum():
    def model(a, b):
        return tf.einsum("bij,bjk->bik", a, b)

    r = np.random.RandomState(0)
    return model, [tf.TensorSpec([2, 3, 4], tf.float32),
                   tf.TensorSpec([2, 4, 5], tf.float32)], \
        [r.randn(2, 3, 4).astype(np.float32),
         r.randn(2, 4, 5).astype(np.float32)], (1e-4, 1e-6)


def _gather_nd_addn_cumprod():
    def model(x):
        idx = tf.constant([[0, 1], [1, 0]])
        g = tf.gather_nd(x, idx)
        s = tf.add_n([x, x * 2.0, x + 1.0])
        c = tf.math.cumprod(x, axis=1)
        return tf.reduce_sum(s) + tf.reduce_sum(c) + tf.reduce_sum(g)

    x = np.random.RandomState(1).rand(2, 3).astype(np.float32) + 0.5
    return model, [tf.TensorSpec([2, 3], tf.float32)], [x], (1e-4, 1e-6)


def _mirror_pad_and_logicals():
    def model(x):
        p = tf.pad(x, [[1, 1], [2, 2]], mode="REFLECT")
        m = tf.logical_and(x > 0.3, tf.logical_not(x > 0.7))
        return p * 1.0 + tf.reduce_sum(tf.cast(m, tf.float32))

    x = np.random.RandomState(2).rand(3, 4).astype(np.float32)
    return model, [tf.TensorSpec([3, 4], tf.float32)], [x], (1e-5, 1e-6)


def _xdivy_and_select():
    def model(x, y):
        return tf.math.xdivy(x, y) + tf.where(x > 0.5, x, -y)

    r = np.random.RandomState(3)
    x = r.rand(3, 4).astype(np.float32)
    x[0, 0] = 0.0
    y = np.zeros((3, 4), np.float32)
    y[0, 0] = 0.0
    y += r.rand(3, 4).astype(np.float32) * (x != 0)
    y[y == 0] = 1.0
    y[0, 0] = 0.0
    return model, [tf.TensorSpec([3, 4], tf.float32),
                   tf.TensorSpec([3, 4], tf.float32)], [x, y], (1e-5, 1e-6)


def _reduce_all_any():
    def model(x):
        a = tf.reduce_all(x > 0.2, axis=1)
        b = tf.reduce_any(x > 0.8, axis=0)
        return tf.cast(a, tf.float32)[None, :] + \
            tf.cast(b, tf.float32)[:, None] * 0.5

    x = np.random.RandomState(4).rand(3, 3).astype(np.float32)
    return model, [tf.TensorSpec([3, 3], tf.float32)], [x], (1e-5, 1e-6)


def _conv2d_transpose():
    w = np.random.RandomState(5).randn(3, 3, 5, 2).astype(np.float32)

    def model(x):
        return tf.nn.conv2d_transpose(
            x, tf.constant(w), output_shape=[2, 8, 8, 5],
            strides=[1, 2, 2, 1], padding="SAME")

    x = np.random.RandomState(6).randn(2, 4, 4, 2).astype(np.float32)
    return model, [tf.TensorSpec([2, 4, 4, 2], tf.float32)], [x], \
        (1e-4, 1e-4)


def _inverse_hyperbolics():
    def model(x):
        return tf.asinh(x) + tf.math.expm1(x) + tf.math.erfc(x) + \
            tf.acosh(x + 2.0) + tf.atanh(x * 0.5)

    x = np.random.RandomState(7).rand(8).astype(np.float32)
    return model, [tf.TensorSpec([8], tf.float32)], [x], (1e-4, 1e-5)


def _newaxis_and_ellipsis_slicing():
    def model(x):
        a = x[None]
        b = x[..., None]
        c = x[:, None, 1:, 0]
        return tf.reduce_sum(a) + tf.reduce_sum(b * 2.0) + \
            tf.reduce_sum(c * 3.0)

    x = np.random.RandomState(8).rand(3, 4, 5).astype(np.float32)
    return model, [tf.TensorSpec([3, 4, 5], tf.float32)], [x], (1e-4, 1e-6)


def _atrous_conv():
    w = np.random.RandomState(0).randn(3, 3, 2, 4).astype(np.float32)

    def model(x):
        return tf.nn.atrous_conv2d(x, tf.constant(w), rate=2, padding="SAME")

    x = np.random.RandomState(1).rand(1, 8, 8, 2).astype(np.float32)
    return model, [tf.TensorSpec([1, 8, 8, 2], tf.float32)], [x], \
        (1e-4, 1e-5)


def _space_batch_round_trip():
    def model(x):
        y = tf.space_to_batch(x, paddings=[[0, 0], [0, 0]],
                              block_shape=[2, 2])
        return tf.batch_to_space(y, crops=[[0, 0], [0, 0]],
                                 block_shape=[2, 2])

    x = np.random.RandomState(2).rand(2, 4, 4, 3).astype(np.float32)
    return model, [tf.TensorSpec([2, 4, 4, 3], tf.float32)], [x], \
        (1e-6, 0.0)


GOLDEN = {
    "TestTfImport::mlp": _mlp,
    "TestTfImport::elementwise_chain": _elementwise_chain,
    "TestTfImport::reshape_transpose": _reshape_transpose,
    "TestTfImport::conv_pool": _conv_pool,
    "TestTfImport::gelu_composite": _gelu_composite,
    "TestTfImportWidened::cnn_bn": _cnn_bn,
    "TestTfImportWidened::strided_slice_clip_cumsum":
        _strided_slice_clip_cumsum,
    "TestRound4OpBreadth::einsum": _einsum,
    "TestRound4OpBreadth::gather_nd_addn_cumprod": _gather_nd_addn_cumprod,
    "TestRound4OpBreadth::mirror_pad_and_logicals": _mirror_pad_and_logicals,
    "TestRound4OpBreadth::xdivy_and_select": _xdivy_and_select,
    "TestRound4OpBreadth::reduce_all_any": _reduce_all_any,
    "TestRound4OpBreadth::conv2d_transpose": _conv2d_transpose,
    "TestRound4OpBreadth::inverse_hyperbolics": _inverse_hyperbolics,
    "TestRound4OpBreadth::newaxis_and_ellipsis_slicing":
        _newaxis_and_ellipsis_slicing,
    "TestSpaceBatchOps::atrous_conv_via_space_to_batch": _atrous_conv,
    "TestSpaceBatchOps::space_batch_round_trip": _space_batch_round_trip,
}


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_graph_both_packages(case):
    model, specs, feeds, (rtol, atol) = GOLDEN[case]()
    gd, ins, outs = freeze(model, *specs)
    golden = model(*[tf.constant(f) for f in feeds]).numpy()
    port, ref, _, _ = both(gd, dict(zip(ins, feeds)), outs[0])
    assert_port(port, ref)
    np.testing.assert_allclose(port, golden, rtol=rtol, atol=atol)


def test_imported_variables_are_trainable_gradients():
    w = tf.Variable(np.random.RandomState(3).randn(2, 2).astype(np.float32))

    def model(x):
        return tf.matmul(x, w)

    gd, ins, outs = freeze(model, tf.TensorSpec([1, 2], tf.float32))
    data = gd.SerializeToString()
    grads = []
    for sd in (TensorflowImporter(device="cpu").run_import(data),
               JImporter().run_import(data)):
        trainables = [n for n, v in sd._vars.items() if v.vtype == "VARIABLE"]
        assert len(trainables) == 1
        sd.get_variable(outs[0]).sum().rename("loss")
        g = sd.calculate_gradients({ins[0]: np.float32([[1.5, -2.0]])},
                                   "loss", wrt=trainables)
        grads.append(g[trainables[0]])
    assert_port(grads[0], grads[1])
    np.testing.assert_allclose(grads[0], [[1.5, 1.5], [-2.0, -2.0]])


def test_unsupported_op_raises_naming_it():
    def model(x):
        return tf.raw_ops.Angle(input=tf.complex(x, x))

    gd, _, _ = freeze(model, tf.TensorSpec([2], tf.float32))
    with pytest.raises(NotImplementedError, match="Angle|Complex"):
        TensorflowImporter(device="cpu").run_import(gd.SerializeToString())


def test_same_rule_names_as_the_jax_importer():
    assert len(ptf.TF_OP_MAPPERS) == 204
    assert sorted(ptf.TF_OP_MAPPERS) == sorted(jtf.TF_OP_MAPPERS)
    assert ptf._NEEDS_CONSTS == jtf._NEEDS_CONSTS
    assert ptf._CONTROL_FLOW_OPS == jtf._CONTROL_FLOW_OPS
    assert ptf._CALL_OPS == jtf._CALL_OPS
    assert ptf._VARIABLE_OPS == jtf._VARIABLE_OPS


def test_validate_true_raises():
    """``validate=True`` (the default in both packages) checks the
    imported GraphDef: the same bytes give the JAX importer's findings,
    and a MatMul whose contraction cannot agree is refused by both with
    GC002 at the same node."""
    from deeplearning4j_tpu.analysis import GraphCheckError as JErr
    from deeplearning4j_tpu_torch.analysis import GraphCheckError as TErr

    gd, _, _ = freeze(lambda x: x * 2.0, tf.TensorSpec([2], tf.float32))
    got = TensorflowImporter(device="cpu", validate=True).run_import(
        gd.SerializeToString())
    want = JImporter().run_import(gd.SerializeToString())
    assert got.last_check_report.ok
    assert [(f.rule, f.line) for f in got.last_check_report.findings] == \
        [(f.rule, f.line) for f in want.last_check_report.findings]
    f32 = tb.a_type(tb.DT_FLOAT)
    bad = tb.graph_def([
        tb.node_def("x", "Placeholder", dtype=f32, shape=tb.a_shape((2, 3))),
        tb.node_def("w", "Const", dtype=f32,
                    value=tb.a_tensor(np.ones((5, 4), np.float32))),
        tb.node_def("y", "MatMul", ["x", "w"], T=f32)])
    with pytest.raises(TErr) as terr:
        TensorflowImporter(device="cpu").run_import(bad)
    with pytest.raises(JErr) as jerr:
        JImporter().run_import(bad)
    assert [(f.rule, f.line) for f in terr.value.findings] == \
        [(f.rule, f.line) for f in jerr.value.findings]
    assert terr.value.findings[0].rule == "GC002"


# ---------------------------------------------------------------------------
# TensorProto decoding against MakeNdarray
# ---------------------------------------------------------------------------


def _protos():
    import ml_dtypes
    from tensorflow.core.framework import tensor_pb2

    out = [tf.make_tensor_proto(a) for a in (
        np.arange(6, dtype=np.float32).reshape(2, 3), np.int32([-7, 5, 0]),
        np.int64([[-(2 ** 40), 3]]), np.array([True, False, True]),
        np.float16([1.5, -2.25, 65504.0]), np.float64([1e-300, -2.0]),
        np.uint8([0, 200, 255]), np.int8([-128, 127]),
        np.array([b"ab", b"", b"\xff\x00"], dtype=object),
        np.float32(3.25), np.zeros((0, 3), np.float32))]
    out.append(tf.make_tensor_proto(tf.constant([1.5, -3.0], tf.bfloat16)))
    # the typed *_val fields, fewer values than the shape: padded with the
    # last one (make_tensor_proto writes this form for a broadcast scalar)
    out.append(tf.make_tensor_proto(np.float32(2.5), shape=[2, 3]))
    out.append(tf.make_tensor_proto(7, dtype=tf.int64, shape=[4]))
    out.append(tf.make_tensor_proto(True, shape=[3]))
    out.append(tf.make_tensor_proto(b"s", shape=[2]))
    half = tensor_pb2.TensorProto(dtype=19, half_val=[
        int(np.float16(1.5).view(np.uint16)),
        int(np.float16(-0.5).view(np.uint16))])
    half.tensor_shape.dim.add().size = 4
    bf = tensor_pb2.TensorProto(dtype=14, half_val=[int(np.array(
        -2.5, ml_dtypes.bfloat16).view(np.uint16))])
    bf.tensor_shape.dim.add().size = 2
    empty = tensor_pb2.TensorProto(dtype=1)
    empty.tensor_shape.dim.add().size = 3
    return out + [half, bf, empty]


@pytest.mark.parametrize("k", range(len(_protos())))
def test_tensor_proto_decoding_equals_make_ndarray(k):
    from tensorflow.python.framework import tensor_util

    proto = _protos()[k]
    got = tf_proto.make_ndarray(proto.SerializeToString())
    want = tensor_util.MakeNdarray(proto)
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == object:
        assert got.tolist() == want.tolist()
    else:
        np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                      want.reshape(-1).view(np.uint8))


def test_graph_def_fields_equal_tf_parse():
    """Nodes, inputs and every attr kind the importer reads, from the same
    bytes through tf_proto and through TF's own protobuf classes."""
    gd, _, _ = freeze(_cnn_bn()[0], tf.TensorSpec([2, 8, 8, 3], tf.float32),
                      lower_control_flow=False)
    mine = tf_proto.parse_graph_def(gd.SerializeToString())
    assert [n.name for n in mine.node] == [n.name for n in gd.node]
    for a, b in zip(mine.node, gd.node):
        assert (a.op, a.input, a.device) == (b.op, list(b.input), b.device)
        assert sorted(a.attr) == sorted(b.attr)
        for k, v in b.attr.items():
            assert a.attr[k].kind == v.WhichOneof("value"), (a.name, k)
            jv, pv = jtf._attr_value(v), ptf._attr_value(a.attr[k])
            if v.WhichOneof("value") == "shape":
                assert [d.size for d in pv.dim] == [d.size for d in jv.dim]
            elif v.WhichOneof("value") != "tensor":
                assert pv == jv, (a.name, k, pv, jv)


# ---------------------------------------------------------------------------
# the builder's BERT, static and dynamic batch
# ---------------------------------------------------------------------------

NARROW = dict(layers=2, batch=2, seq=16, d=64, heads=2, ff=128, vocab=50,
              max_pos=32)


@pytest.mark.parametrize("dynamic", [False, True])
def test_builder_bert_tf_jax_and_port_agree(dynamic):
    data = tb.bert_tf_graph(dynamic_batch=dynamic, **NARROW)
    feeds = tb.tf_feeds(NARROW["batch"], NARROW["seq"], NARROW["vocab"])
    gd = tf.compat.v1.GraphDef.FromString(data)
    with tf.Graph().as_default() as g:
        tf.graph_util.import_graph_def(gd, name="")
        with tf.compat.v1.Session(graph=g) as s:
            golden = s.run("logits:0",
                           {k + ":0": v for k, v in feeds.items()})
    port, ref, psd, jsd = both(gd, feeds, "logits")
    assert_port(port, ref)
    np.testing.assert_allclose(port, golden, rtol=0,
                               atol=REL * max(1.0, np.abs(golden).max()))
    want = ({"epilogue": 14} if dynamic
            else {"attention": 2, "epilogue": 14})
    assert psd.last_compile_stats.fusions == jsd.last_compile_stats.fusions \
        == want
    assert psd.last_compile_stats.nodes_after == \
        jsd.last_compile_stats.nodes_after
    leaves = [n for n, v in psd._vars.items() if v.vtype == "VARIABLE"]
    assert len(leaves) == 5 + 16 * NARROW["layers"] + 4


# ---------------------------------------------------------------------------
# GraphRunner
# ---------------------------------------------------------------------------


def test_graph_runner_tf_and_onnx_bytes_both_packages():
    tfd = tb.bert_tf_graph(**NARROW)
    tf_feeds = tb.tf_feeds(NARROW["batch"], NARROW["seq"], NARROW["vocab"])
    onnx_cfg = dict(layers=1, batch=2, seq=8, d=32, heads=2, ff=64, vocab=20)
    onx = ob.bert_onnx_model(**onnx_cfg)
    onnx_feeds = ob.bert_onnx_feeds(2, 8, 20, min_len=4)
    for data, feeds, fw, fetch in ((tfd, tf_feeds, "tensorflow", "logits"),
                                   (onx, onnx_feeds, "onnx", "y")):
        pr = GraphRunner(data, device="cpu")
        jr = JGraphRunner(data)
        assert pr.framework == jr.framework == fw
        assert pr.output_names == jr.output_names
        assert sorted(pr.input_names) == sorted(jr.input_names)
        assert_port(pr.run(feeds, [fetch])[fetch], jr.run(feeds, [fetch])[fetch])
        assert pr.compile_stats.fusions == jr.compile_stats.fusions
    with pytest.raises(ValueError, match="sniff"):
        GraphRunner(b"\x12\x00", device="cpu")


def test_port_tf_import_needs_neither_tensorflow_nor_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from deeplearning4j_tpu_torch.imports import GraphRunner, "
        "import_frozen_graph\n"
        "from deeplearning4j_tpu_torch.testing import tf_builder as tb\n"
        "cfg = dict(layers=1, batch=2, seq=8, d=32, heads=2, ff=64, "
        "vocab=20, max_pos=16)\n"
        "data = tb.bert_tf_graph(**cfg)\n"
        "feeds = tb.tf_feeds(2, 8, 20, min_len=4)\n"
        "y = import_frozen_graph(data, device='cpu').output(feeds, "
        "'logits')['logits']\n"
        "r = GraphRunner(data, device='cpu').run(feeds)['logits']\n"
        "assert y.shape == (2, 2) and np.array_equal(y, r)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('tensorflow', 'jax', 'jaxlib', 'deeplearning4j_tpu') "
        "or m.startswith('google.protobuf'))\n"
        "print('LEAKED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout, out.stdout


# ---------------------------------------------------------------------------
# the importer's own graph ops and the seeded random rules
# ---------------------------------------------------------------------------

SQ = np.random.RandomState(11).randn(4, 4).astype(np.float32)
SYM = (SQ + SQ.T).astype(np.float32)


def _lu(x):
    lu, p = tf.linalg.lu(x)
    return lu, p


def _eigh(x):
    e, v = tf.linalg.eigh(x)
    return e, tf.matmul(v * e[None, :], v, transpose_b=True)


def _svd(x):
    s, u, v = tf.linalg.svd(x)
    return s, tf.matmul(u * s[None, :], v, transpose_b=True)


def _stitch(a, b):
    return tf.dynamic_stitch([tf.constant([0, 2]), tf.constant([1, 3])],
                             [a, b])


def _xent(logits):
    # the raw ops a training graph's freeze carries: (loss, backprop) each
    labels = tf.constant(np.eye(4, dtype=np.float32)[[0, 3, 1, 2]])
    sparse = tf.constant([2, 0, 3, 1])
    return (tf.raw_ops.SoftmaxCrossEntropyWithLogits(features=logits,
                                                     labels=labels)
            + tf.raw_ops.SparseSoftmaxCrossEntropyWithLogits(
                features=logits, labels=sparse))


def _matrix_diag(x):
    return tf.linalg.diag(x, num_rows=3, num_cols=5)


LOCAL = {"lu_tf_outputs": (_lu, [SQ]), "eigh_pair": (_eigh, [SYM]),
         "matrix_transpose": (_svd, [SQ]),
         "stitch_pair": (_stitch, [SQ[:2], SQ[2:]]),
         "tf_softmax_xent+tf_sparse_softmax_xent": (_xent, [SQ]),
         "pad_to_matrix_shape": (_matrix_diag, [SQ[0, :3]])}


@pytest.mark.parametrize("op", sorted(LOCAL))
def test_local_graph_ops_against_jax_and_tf(op):
    """The seven graph ops the importer registers, through a graph that
    reaches each: every output against the JAX import and TF (eigh and svd
    through their reconstructions, whose signs do not matter)."""
    model, feeds = LOCAL[op]
    gd, ins, outs = freeze(model, *[tf.TensorSpec(f.shape, tf.float32)
                                    for f in feeds])
    golden = model(*[tf.constant(f) for f in feeds])
    golden = golden if isinstance(golden, tuple) else (golden,)
    data = gd.SerializeToString()
    psd = TensorflowImporter(device="cpu").run_import(data)
    jsd = JImporter().run_import(data)
    fd = dict(zip(ins, feeds))
    for name, want in zip(outs, golden):
        port = psd.output(fd, name)[name]
        assert_port(port, jsd.output(fd, name)[name])
        np.testing.assert_allclose(port, want.numpy(), rtol=1e-4, atol=1e-4)
    for name in op.split("+"):
        assert any(n.op == name for n in psd._nodes), name


def test_seeded_random_rules_by_moments_and_repeatability():
    def model(x):
        n = tf.random.normal([64, 64], seed=3)
        u = tf.random.uniform([64, 64], seed=4)
        t = tf.random.truncated_normal([64, 64], seed=5)
        return n + x, u + x, t + x

    gd, ins, outs = freeze(model, tf.TensorSpec([], tf.float32))
    data = gd.SerializeToString()
    fd = {ins[0]: np.float32(0.0)}
    psd = TensorflowImporter(device="cpu").run_import(data)
    jsd = JImporter().run_import(data)
    first = psd.output(fd, outs)
    again = TensorflowImporter(device="cpu").run_import(data).output(fd, outs)
    ref = jsd.output(fd, outs)
    (normal, uniform, trunc) = (first[o] for o in outs)
    for o in outs:
        assert first[o].shape == ref[o].shape == (64, 64)
        assert first[o].dtype == ref[o].dtype == np.float32
        np.testing.assert_array_equal(first[o], again[o])  # the same seed
    # 4096 draws: the mean within 0.1σ is ~6 standard errors
    assert abs(normal.mean()) < 0.1 and abs(normal.std() - 1.0) < 0.1
    assert 0.0 <= uniform.min() and uniform.max() < 1.0
    assert abs(uniform.mean() - 0.5) < 0.03
    assert np.abs(trunc).max() <= 2.0 and abs(trunc.mean()) < 0.1
    assert abs(trunc.std() - 0.8796) < 0.05  # N(0, 1) truncated at ±2
    assert len({normal.tobytes(), uniform.tobytes(), trunc.tobytes()}) == 3
