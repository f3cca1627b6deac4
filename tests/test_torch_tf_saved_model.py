"""SavedModel import: the port against the JAX package on one directory
(CPU).

* The JAX package's ``TestSavedModelImport`` cases — a ``tf.Module``
  golden, the restored variables as trainable leaves with three SGD steps,
  a trained Keras model (optimizer slots and two same-shaped layers) and a
  two-output signature — through both packages' ``import_saved_model``
  from the same directory: outputs within 1e-5 × max(1, max |JAX|) of the
  JAX import (dtypes equal) and within the JAX test's tolerance of TF.
* ``tensor_bundle`` (the port's checkpoint reader; its lane-parallel
  crc32c equals the byte loop and the standard check value) equals
  ``tf.train.load_checkpoint`` on every key, dtype, shape and value of
  two checkpoints (the Keras model with its Adam state and iteration count,
  the MiniBert), the object graph's string tensor included.
* ``TestBertSavedModelFinetune``'s MiniBert: the port's import against
  the JAX package's (1e-5 relative), three Adam steps' losses against the
  JAX package's (1e-5 relative), and the port's own convergence at the
  JAX test's sizes (30 epochs of 4 batches: the loss halves, training
  accuracy above 0.8).

The tests need TensorFlow to write the SavedModels; the port never
imports it.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JConfig
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import (
    ListDataSetIterator as JIterator)
from deeplearning4j_tpu.imports.tf_import import (
    import_saved_model as j_import, load_saved_model_variables as j_values)
from deeplearning4j_tpu_torch.autodiff import TrainingConfig
from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, ListDataSetIterator)
from deeplearning4j_tpu_torch.imports import tensor_bundle
from deeplearning4j_tpu_torch.imports.tf_import import (
    import_saved_model as p_import, load_saved_model_variables as p_values)
from deeplearning4j_tpu_torch.nn.updater import Adam, Sgd

torch.backends.cuda.matmul.allow_tf32 = False
REL = 1e-5


def assert_port(port, ref, rel=REL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (
        port.shape, port.dtype, ref.shape, ref.dtype)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=rel * scale)


def both(path):
    return p_import(path, device="cpu"), j_import(path)


def run(sd, x):
    return sd.output({sd.graph_inputs[0]: x},
                     sd.graph_outputs[0])[sd.graph_outputs[0]]


@pytest.fixture(scope="module")
def module_model(tmp_path_factory):
    rng = np.random.RandomState(7)

    class M(tf.Module):
        def __init__(self):
            super().__init__()
            self.w = tf.Variable(rng.randn(6, 3).astype(np.float32), name="w")
            self.b = tf.Variable(rng.randn(3).astype(np.float32), name="b")

        @tf.function(input_signature=[tf.TensorSpec([None, 6], tf.float32)])
        def __call__(self, x):
            return tf.nn.softmax(tf.tanh(x @ self.w) + self.b)

    m = M()
    path = str(tmp_path_factory.mktemp("sm") / "sm")
    tf.saved_model.save(m, path)
    return m, path


@pytest.fixture(scope="module")
def keras_model(tmp_path_factory):
    rng = np.random.RandomState(3)
    model = tf.keras.Sequential([
        tf.keras.layers.Input((8,)),
        tf.keras.layers.Dense(8, activation="tanh", name="d1"),
        tf.keras.layers.Dense(8, activation="tanh", name="d2"),
        tf.keras.layers.Dense(2, name="out"),
    ])
    model.compile(optimizer="adam", loss="mse")
    x = rng.randn(64, 8).astype(np.float32)
    y = rng.randn(64, 2).astype(np.float32)
    model.fit(x, y, epochs=1, verbose=0)  # creates Adam m/v slots
    path = str(tmp_path_factory.mktemp("keras") / "keras_sm")
    tf.saved_model.save(model, path)
    return model, path, x


def test_saved_model_golden(module_model):
    m, path = module_model
    psd, jsd = both(path)
    x = np.random.RandomState(0).randn(5, 6).astype(np.float32)
    golden = m(tf.constant(x)).numpy()
    assert psd.graph_inputs == jsd.graph_inputs
    assert psd.graph_outputs == jsd.graph_outputs
    got = run(psd, x)
    assert_port(got, run(jsd, x))
    np.testing.assert_allclose(got, golden, rtol=1e-5, atol=1e-6)


def test_variables_restored_as_trainable_and_fine_tuned(module_model):
    m, path = module_model
    rng = np.random.RandomState(1)
    x = rng.randn(32, 6).astype(np.float32)
    y = np.eye(3)[rng.randint(0, 3, 32)].astype(np.float32)
    hist, after = [], []
    for sd, cfg, sgd, ds, it in (
            (p_import(path, device="cpu"), TrainingConfig, Sgd, DataSet,
             ListDataSetIterator),
            (j_import(path), JConfig, jnn.Sgd, JDataSet, JIterator)):
        names = [n for n, v in sd._vars.items() if v.vtype == "VARIABLE"]
        assert len(names) == 2, names
        restored = sorted((np.asarray(sd.get_arr(n)).shape, n)
                          for n in names)
        assert restored[0][0] == (3,) and restored[1][0] == (6, 3)
        w_name = restored[1][1]
        np.testing.assert_allclose(sd.get_arr(w_name), m.w.numpy(),
                                   rtol=1e-6)
        labels = sd.placeholder("labels", shape=(None, 3))
        out_var = sd._vars[sd.graph_outputs[0]]
        sd.loss.mean_squared_error(out_var, labels).rename("ft_loss")
        sd.set_training_config(cfg(
            updater=sgd(learning_rate=0.5),
            data_set_feature_mapping=[sd.graph_inputs[0]],
            data_set_label_mapping=["labels"], loss_variables=["ft_loss"]))
        before = np.asarray(sd.get_arr(w_name)).copy()
        hist.append(sd.fit(it(ds(x, y), batch_size=32), epochs=3))
        after.append(np.asarray(sd.get_arr(w_name)))
        assert not np.allclose(before, after[-1])
    np.testing.assert_allclose(hist[0], hist[1], rtol=REL)
    assert_port(after[0], after[1])


def test_keras_saved_model_with_optimizer_slots(keras_model):
    model, path, x = keras_model
    psd, jsd = both(path)
    golden = model(tf.constant(x[:5])).numpy()
    got = run(psd, x[:5])
    assert_port(got, run(jsd, x[:5]))
    np.testing.assert_allclose(got, golden, rtol=1e-4, atol=1e-5)
    for sd in (psd, jsd):
        n_vars = sum(1 for v in sd._vars.values() if v.vtype == "VARIABLE")
        assert n_vars == 6, n_vars  # 3 kernels + 3 biases, no Adam slots
    pv, jv = p_values(path), j_values(path)
    assert sorted(pv) == sorted(jv)
    for k in jv:
        np.testing.assert_array_equal(pv[k], jv[k])


def test_multi_output_signature_slots(tmp_path):
    class M(tf.Module):
        @tf.function(input_signature=[tf.TensorSpec([4], tf.float32)])
        def __call__(self, x):
            return {"double": x * 2.0, "neg": -x}

    path = str(tmp_path / "multi_sm")
    tf.saved_model.save(M(), path)
    psd, jsd = both(path)
    assert psd.graph_outputs == jsd.graph_outputs
    assert len(set(psd.graph_outputs)) == 2, psd.graph_outputs
    x = np.array([1.0, -2.0, 3.0, -4.0], np.float32)
    pres = psd.output({psd.graph_inputs[0]: x}, psd.graph_outputs)
    jres = jsd.output({jsd.graph_inputs[0]: x}, jsd.graph_outputs)
    for k in psd.graph_outputs:
        assert_port(pres[k], jres[k])
    vals = sorted(np.asarray(v).tolist() for v in pres.values())
    assert vals == sorted([(x * 2.0).tolist(), (-x).tolist()])


# ---------------------------------------------------------------------------
# the MiniBert of TestBertSavedModelFinetune
# ---------------------------------------------------------------------------

D, HEADS, FF, T, VOCAB = 32, 4, 64, 12, 50


def _mini_bert():
    d, heads, ff = D, HEADS, FF

    class MiniBert(tf.Module):
        def __init__(self):
            super().__init__()
            r = np.random.RandomState(0)

            def g(name, *s):
                return tf.Variable(r.randn(*s).astype(np.float32) * 0.08,
                                   name=name)

            self.emb = g("emb", VOCAB, d)
            self.pos = g("pos", T, d)
            self.wq, self.wk = g("wq", d, d), g("wk", d, d)
            self.wv, self.wo = g("wv", d, d), g("wo", d, d)
            self.ln1_g = tf.Variable(np.ones(d, np.float32), name="ln1_g")
            self.ln1_b = tf.Variable(np.zeros(d, np.float32), name="ln1_b")
            self.w1, self.b1 = g("w1", d, ff), tf.Variable(
                np.zeros(ff, np.float32), name="b1")
            self.w2, self.b2 = g("w2", ff, d), tf.Variable(
                np.zeros(d, np.float32), name="b2")
            self.ln2_g = tf.Variable(np.ones(d, np.float32), name="ln2_g")
            self.ln2_b = tf.Variable(np.zeros(d, np.float32), name="ln2_b")
            self.cls_w = g("cls_w", d, 2)
            self.cls_b = tf.Variable(np.zeros(2, np.float32), name="cls_b")

        def ln(self, x, gv, bv):
            m = tf.reduce_mean(x, axis=-1, keepdims=True)
            v = tf.reduce_mean(tf.square(x - m), axis=-1, keepdims=True)
            return (x - m) * tf.math.rsqrt(v + 1e-6) * gv + bv

        @tf.function(input_signature=[tf.TensorSpec([None, T], tf.int32)])
        def __call__(self, ids):
            x = tf.gather(self.emb, ids) + self.pos
            hd = d // heads

            def split(t):
                s = tf.shape(t)
                return tf.transpose(
                    tf.reshape(t, [s[0], T, heads, hd]), [0, 2, 1, 3])

            q, k, v = split(x @ self.wq), split(x @ self.wk), \
                split(x @ self.wv)
            scores = tf.einsum("bhqd,bhkd->bhqk", q, k) / \
                np.sqrt(hd).astype(np.float32)
            att = tf.einsum("bhqk,bhkd->bhqd",
                            tf.nn.softmax(scores, axis=-1), v)
            att = tf.reshape(tf.transpose(att, [0, 2, 1, 3]),
                             [tf.shape(x)[0], T, d])
            x = self.ln(x + att @ self.wo, self.ln1_g, self.ln1_b)
            h = tf.nn.gelu(x @ self.w1 + self.b1)
            x = self.ln(x + h @ self.w2 + self.b2, self.ln2_g, self.ln2_b)
            return tf.nn.softmax(x[:, 0] @ self.cls_w + self.cls_b)

    return MiniBert()


@pytest.fixture(scope="module")
def mini_bert(tmp_path_factory):
    m = _mini_bert()
    path = str(tmp_path_factory.mktemp("minibert") / "minibert")
    tf.saved_model.save(m, path)
    return m, path


def _finetune_setup(sd, cfg, adam):
    labels = sd.placeholder("labels", shape=(None, 2))
    out_var = sd._vars[sd.graph_outputs[0]]
    sd.loss.mean_squared_error(out_var, labels).rename("ft_loss")
    sd.set_training_config(cfg(
        updater=adam(learning_rate=3e-3),
        data_set_feature_mapping=[sd.graph_inputs[0]],
        data_set_label_mapping=["labels"], loss_variables=["ft_loss"]))


def _task(n, seed=1):
    """The JAX test's learnable task: class = token-0 parity."""
    rng = np.random.RandomState(seed)
    xs = rng.randint(0, VOCAB, (n, T)).astype(np.int32)
    return xs, np.eye(2, dtype=np.float32)[xs[:, 0] % 2]


def test_mini_bert_import_and_three_steps_against_jax(mini_bert):
    m, path = mini_bert
    psd, jsd = both(path)
    ids = np.random.RandomState(1).randint(0, VOCAB, (4, T)).astype(np.int32)
    golden = m(tf.constant(ids)).numpy()
    got = run(psd, ids)
    assert_port(got, run(jsd, ids))
    np.testing.assert_allclose(got, golden, rtol=1e-3, atol=1e-5)
    xs, ys = _task(32)
    hist = []
    for sd, cfg, adam, ds, it in (
            (psd, TrainingConfig, Adam, DataSet, ListDataSetIterator),
            (jsd, JConfig, jnn.Adam, JDataSet, JIterator)):
        _finetune_setup(sd, cfg, adam)
        hist.append(sd.fit(it(ds(xs, ys), batch_size=32), epochs=3))
    np.testing.assert_allclose(hist[0], hist[1], rtol=REL)


def test_mini_bert_fine_tune_converges(mini_bert):
    _, path = mini_bert
    sd = p_import(path, device="cpu")
    xs, ys = _task(128)
    _finetune_setup(sd, TrainingConfig, Adam)
    hist = sd.fit(ListDataSetIterator(DataSet(xs, ys), batch_size=32),
                  epochs=30)
    assert hist[-1] < hist[0] * 0.5, (hist[0], hist[-1])
    pred = run(sd, xs)
    acc = (pred.argmax(1) == ys.argmax(1)).mean()
    assert acc > 0.8, acc


# ---------------------------------------------------------------------------
# the checkpoint reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["keras", "mini_bert"])
def test_tensor_bundle_equals_tf_checkpoint_reader(which, request):
    path = request.getfixturevalue(
        "keras_model" if which == "keras" else "mini_bert")[1]
    prefix = f"{path}/variables/variables"
    ref = tf.train.load_checkpoint(prefix)
    mine = tensor_bundle.load_checkpoint(path)
    shapes = ref.get_variable_to_shape_map()
    dtypes = ref.get_variable_to_dtype_map()
    assert sorted(mine.get_variable_to_shape_map()) == sorted(shapes)
    assert "_CHECKPOINTABLE_OBJECT_GRAPH" in shapes
    if which == "keras":  # the Adam state: Keras 3 keeps it under optimizer/
        assert sum(k.startswith("optimizer/") for k in shapes) > 6
    for key in shapes:
        got = mine.get_tensor(key)
        want = ref.get_tensor(key)
        assert tuple(got.shape) == tuple(shapes[key]), key
        if dtypes[key] == tf.string:
            assert got.dtype == object
            assert got.reshape(-1).tolist() == np.asarray(
                want, dtype=object).reshape(-1).tolist(), key
        else:
            assert got.dtype == dtypes[key].as_numpy_dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_tensor_bundle_rejects_a_corrupted_block(keras_model, tmp_path):
    src = f"{keras_model[1]}/variables/variables.index"
    data = bytearray(open(src, "rb").read())
    data[3] ^= 0xFF  # inside the first data block
    bad = tmp_path / "variables.index"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="crc32c"):
        tensor_bundle.read_table(bytes(data), where=str(bad))
    data = bytearray(open(src, "rb").read())
    data[-1] ^= 0xFF  # the magic
    with pytest.raises(ValueError, match="magic"):
        tensor_bundle.read_table(bytes(data))


@pytest.mark.parametrize("n", [0, 1, 9, 100_003, (1 << 20) + 7, 3 << 20])
def test_crc32c_lanes_equal_the_byte_loop(n):
    data = np.random.RandomState(n % 97).randint(0, 256, n).astype(
        np.uint8).tobytes()
    want = tensor_bundle._crc_bytes(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    assert tensor_bundle.crc32c(data) == want
    cut = n // 3
    assert tensor_bundle.crc32c(data[cut:],
                                tensor_bundle.crc32c(data[:cut])) == want
    assert tensor_bundle.crc32c(b"123456789") == 0xE3069283  # check value

