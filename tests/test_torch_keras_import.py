"""The port's Keras importer against the JAX package's on the same files
(CPU).

* One case per mapper that does not reject (86 of the 89): a small Keras
  model around the layer, saved with the installed Keras as a legacy
  ``.h5`` (the five classes Keras 3 no longer has — ``ThresholdedReLU``,
  ``LocallyConnected1D/2D``, ``CuDNNLSTM``, ``CuDNNGRU`` — and
  ``RandomBrightness``, which Keras 3.13 fails to save, written with h5py
  in the legacy layout, as the JAX package's own tests write them),
  imported by both packages: every parameter and state leaf equal bit for
  bit, the outputs within 1e-5 × max(1, max |JAX|) (float32). Where the
  JAX package's ``.keras`` path reads the model, the ``.keras`` form too.
* Both tables hold the same 89 names; the three rejecting mappers, a
  missing mapper (Sequential and functional) and ``validate=True`` raise
  the same messages.
* A ``.keras`` file holding a ``MultiHeadAttention`` fails the same way in
  both packages (the sub-group order ROADMAP.md lists under "Not port
  faults").
* ``import_keras_model`` on live Keras models, and
  ``import_keras_sequential_model_and_weights`` (the JAX package's loads
  the file through ``tf.keras``) against the JAX package's.
* ``testing/keras_builder``'s 2-layer BERT-like encoder is a real Keras
  file: ``keras.models.load_model`` predicts within 1e-4 of both imports.
* Importing the port's importer in a fresh interpreter loads none of
  ``jax``, ``h5py``, ``keras``, ``tensorflow`` or the JAX package.

Keras and h5py write the files; the port reads them with neither.
"""

import json
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")
h5py = pytest.importorskip("h5py")

from keras import layers as L

from deeplearning4j_tpu.imports import keras_import as J
from deeplearning4j_tpu_torch.imports import keras_import as K
from deeplearning4j_tpu_torch.testing import keras_builder as kb

torch.backends.cuda.matmul.allow_tf32 = False
REL = 1e-5


def _x(shape, seed=0, ints=None):
    r = np.random.RandomState(seed)
    if ints is not None:
        return r.randint(0, ints, shape).astype(np.float32)
    return r.standard_normal(shape).astype(np.float32)


def _seq(*layers, shape, dtype="float32"):
    return keras.Sequential([keras.Input(shape, dtype=dtype)] + list(layers))


def _randomize(model, seed=7, positive=()):
    """Every weight drawn anew (a BatchNormalization's variance and the
    named positive weights kept positive), so that no leaf sits at its
    initializer's zeros or ones."""
    r = np.random.RandomState(seed)
    for layer in model.layers:
        ws = layer.get_weights()
        if not ws:
            continue
        new = []
        for w, v in zip(layer.weights, ws):
            a = (r.standard_normal(v.shape) * 0.3).astype(v.dtype)
            if any(p in w.path for p in ("variance", "count") + positive):
                a = np.abs(a) + 0.5
            new.append(a)
        layer.set_weights(new)
    return model


def _functional(inputs, outputs):
    return keras.Model(inputs, outputs)


def _mha():
    q, v = keras.Input((5, 8)), keras.Input((7, 8))
    out = L.MultiHeadAttention(num_heads=2, key_dim=4)(q, v)
    return _functional([q, v], L.Dense(3)(out)), [_x((2, 5, 8)),
                                                   _x((2, 7, 8), 1)]


def _attention(cls):
    def build():
        q, v = keras.Input((5, 8)), keras.Input((7, 8))
        out = getattr(L, cls)()([q, v])
        return _functional([q, v], out), [_x((2, 5, 8)), _x((2, 7, 8), 1)]
    return build


def _masked():
    x = _x((2, 6, 3))
    x[0, 4:] = 0.0
    x[1, 2:] = 0.0
    return x


def _normalization():
    norm = L.Normalization()
    norm.adapt(_x((64, 5), 3) * 2.0 + 1.0)
    return _seq(norm, shape=(5,)), _x((3, 5))


def _lambda():
    # a function over bare globals: Keras deep-copies the layer's config,
    # and a module in the function's globals cannot be copied
    fn = types.FunctionType((lambda t: t * 1.0).__code__, {})
    return _seq(L.Dense(4), L.Lambda(fn, name="scale_lambda"),
                shape=(5,)), _x((3, 5))


# mapper name -> () -> (keras model, input(s))
KERAS_CASES = {
    "Dense": lambda: (_seq(L.Dense(5, activation="relu"), shape=(6,)),
                      _x((3, 6))),
    "Conv2D": lambda: (_seq(L.Conv2D(4, 3, padding="same",
                                     activation="relu"), L.Flatten(),
                            L.Dense(3), shape=(6, 6, 2)),
                       _x((2, 6, 6, 2))),
    "MaxPooling2D": lambda: (_seq(L.Conv2D(3, 3), L.MaxPooling2D(2),
                                  L.Flatten(), L.Dense(2), shape=(8, 8, 2)),
                             _x((2, 8, 8, 2))),
    "AveragePooling2D": lambda: (_seq(L.AveragePooling2D(2, padding="same"),
                                      L.GlobalAveragePooling2D(),
                                      shape=(7, 7, 2)), _x((2, 7, 7, 2))),
    "GlobalAveragePooling2D": lambda: (_seq(L.Conv2D(3, 3),
                                            L.GlobalAveragePooling2D(),
                                            shape=(6, 6, 2)),
                                       _x((2, 6, 6, 2))),
    "Flatten": lambda: (_seq(L.Conv2D(3, 2), L.Flatten(), L.Dense(4),
                             shape=(5, 5, 2)), _x((2, 5, 5, 2))),
    "Dropout": lambda: (_seq(L.Dense(4), L.Dropout(0.3), L.Dense(2),
                             shape=(5,)), _x((3, 5))),
    "Activation": lambda: (_seq(L.Dense(4), L.Activation("tanh"),
                                shape=(5,)), _x((3, 5))),
    "BatchNormalization": lambda: (_seq(L.Dense(4), L.BatchNormalization(),
                                        shape=(5,)), _x((3, 5))),
    "Embedding": lambda: (_seq(L.Embedding(20, 4),
                               L.GlobalAveragePooling1D(), shape=(6,),
                               dtype="int32"), _x((3, 6), ints=20)),
    "LSTM": lambda: (_seq(L.LSTM(4), shape=(5, 3)), _x((2, 5, 3))),
    "DepthwiseConv2D": lambda: (_seq(L.DepthwiseConv2D(
        3, depth_multiplier=2, padding="same"), shape=(6, 6, 2)),
        _x((2, 6, 6, 2))),
    "SeparableConv2D": lambda: (_seq(L.SeparableConv2D(4, 3),
                                     shape=(6, 6, 2)), _x((2, 6, 6, 2))),
    "Conv2DTranspose": lambda: (_seq(L.Conv2DTranspose(3, 3, strides=2),
                                     shape=(4, 4, 2)), _x((2, 4, 4, 2))),
    "GlobalMaxPooling2D": lambda: (_seq(L.Conv2D(3, 3),
                                        L.GlobalMaxPooling2D(),
                                        shape=(6, 6, 2)), _x((2, 6, 6, 2))),
    "UpSampling2D": lambda: (_seq(L.UpSampling2D(2), shape=(3, 3, 2)),
                             _x((2, 3, 3, 2))),
    "SimpleRNN": lambda: (_seq(L.SimpleRNN(4, return_sequences=True),
                               shape=(5, 3)), _x((2, 5, 3))),
    "Bidirectional": lambda: (_seq(L.Bidirectional(
        L.LSTM(3, return_sequences=True)), shape=(5, 3)), _x((2, 5, 3))),
    "LeakyReLU": lambda: (_seq(L.Dense(4), L.LeakyReLU(negative_slope=0.2),
                               shape=(5,)), _x((3, 5))),
    "ReLU": lambda: (_seq(L.Dense(4), L.ReLU(), shape=(5,)), _x((3, 5))),
    "ELU": lambda: (_seq(L.Dense(4), L.ELU(), shape=(5,)), _x((3, 5))),
    "Softmax": lambda: (_seq(L.Dense(4), L.Softmax(), shape=(5,)),
                        _x((3, 5))),
    "SpatialDropout2D": lambda: (_seq(L.Conv2D(3, 3),
                                      L.SpatialDropout2D(0.2),
                                      shape=(5, 5, 2)), _x((2, 5, 5, 2))),
    "GaussianDropout": lambda: (_seq(L.Dense(4), L.GaussianDropout(0.2),
                                     shape=(5,)), _x((3, 5))),
    "Conv1D": lambda: (_seq(L.Conv1D(4, 3, padding="same"), shape=(8, 3)),
                       _x((2, 8, 3))),
    "Conv3D": lambda: (_seq(L.Conv3D(3, 2), shape=(4, 4, 4, 2)),
                       _x((2, 4, 4, 4, 2))),
    "MaxPooling3D": lambda: (_seq(L.MaxPooling3D(2), shape=(4, 4, 4, 2)),
                             _x((2, 4, 4, 4, 2))),
    "AveragePooling3D": lambda: (_seq(L.AveragePooling3D(2),
                                      shape=(4, 4, 4, 2)),
                                 _x((2, 4, 4, 4, 2))),
    "PReLU": lambda: (_seq(L.Dense(4), L.PReLU(), shape=(5,)), _x((3, 5))),
    "GlobalAveragePooling1D": lambda: (_seq(L.Conv1D(3, 2),
                                            L.GlobalAveragePooling1D(),
                                            shape=(6, 2)), _x((2, 6, 2))),
    "GlobalMaxPooling1D": lambda: (_seq(L.GlobalMaxPooling1D(),
                                        shape=(6, 2)), _x((2, 6, 2))),
    "ZeroPadding1D": lambda: (_seq(L.ZeroPadding1D((1, 2)), L.Conv1D(3, 2),
                                   shape=(5, 2)), _x((2, 5, 2))),
    "ZeroPadding2D": lambda: (_seq(L.ZeroPadding2D(((1, 2), (0, 1))),
                                   shape=(4, 4, 2)), _x((2, 4, 4, 2))),
    "ZeroPadding3D": lambda: (_seq(L.ZeroPadding3D(1), shape=(3, 3, 3, 2)),
                              _x((2, 3, 3, 3, 2))),
    "Cropping1D": lambda: (_seq(L.Cropping1D((1, 2)), shape=(7, 2)),
                           _x((2, 7, 2))),
    "Cropping2D": lambda: (_seq(L.Cropping2D(((1, 0), (1, 2))),
                                shape=(6, 6, 2)), _x((2, 6, 6, 2))),
    "Cropping3D": lambda: (_seq(L.Cropping3D(1), shape=(5, 5, 5, 2)),
                           _x((2, 5, 5, 5, 2))),
    "UpSampling1D": lambda: (_seq(L.UpSampling1D(2), shape=(4, 2)),
                             _x((2, 4, 2))),
    "UpSampling3D": lambda: (_seq(L.UpSampling3D(2), shape=(2, 2, 2, 2)),
                             _x((2, 2, 2, 2, 2))),
    "MaxPooling1D": lambda: (_seq(L.MaxPooling1D(2), shape=(7, 3)),
                             _x((2, 7, 3))),
    "AveragePooling1D": lambda: (_seq(L.AveragePooling1D(
        3, strides=2, padding="same"), shape=(7, 3)), _x((2, 7, 3))),
    "GlobalAveragePooling3D": lambda: (_seq(L.Conv3D(3, 2),
                                            L.GlobalAveragePooling3D(),
                                            shape=(3, 3, 3, 2)),
                                       _x((2, 3, 3, 3, 2))),
    "GlobalMaxPooling3D": lambda: (_seq(L.GlobalMaxPooling3D(),
                                        shape=(3, 3, 3, 2)),
                                   _x((2, 3, 3, 3, 2))),
    "Conv3DTranspose": lambda: (_seq(L.Conv3DTranspose(2, 2, strides=2),
                                     shape=(2, 2, 2, 3)),
                                _x((2, 2, 2, 2, 3))),
    "RepeatVector": lambda: (_seq(L.Dense(3), L.RepeatVector(4),
                                  shape=(5,)), _x((3, 5))),
    "Masking": lambda: (_seq(L.Masking(0.0), L.LSTM(3), shape=(6, 3)),
                        _masked()),
    "TimeDistributed": lambda: (_seq(L.TimeDistributed(L.Dense(4)),
                                     shape=(5, 3)), _x((2, 5, 3))),
    "SpatialDropout1D": lambda: (_seq(L.Conv1D(3, 2),
                                      L.SpatialDropout1D(0.2),
                                      shape=(6, 2)), _x((2, 6, 2))),
    "SpatialDropout3D": lambda: (_seq(L.SpatialDropout3D(0.2),
                                      shape=(3, 3, 3, 2)),
                                 _x((2, 3, 3, 3, 2))),
    "AlphaDropout": lambda: (_seq(L.Dense(4), L.AlphaDropout(0.2),
                                  shape=(5,)), _x((3, 5))),
    "GaussianNoise": lambda: (_seq(L.Dense(4), L.GaussianNoise(0.1),
                                   shape=(5,)), _x((3, 5))),
    "GRU": lambda: (_seq(L.GRU(4), shape=(5, 3)), _x((2, 5, 3))),
    "LayerNormalization": lambda: (_seq(L.Dense(6), L.LayerNormalization(),
                                        shape=(5,)), _x((3, 5))),
    "GroupNormalization": lambda: (_seq(L.GroupNormalization(groups=2),
                                        shape=(4, 4, 4)), _x((2, 4, 4, 4))),
    "Permute": lambda: (_seq(L.Permute((2, 1)), L.Dense(3), shape=(4, 6)),
                        _x((2, 4, 6))),
    "Reshape": lambda: (_seq(L.Dense(12), L.Reshape((3, 4)), shape=(5,)),
                        _x((3, 5))),
    "UnitNormalization": lambda: (_seq(L.UnitNormalization(), shape=(5,)),
                                  _x((3, 5))),
    "Rescaling": lambda: (_seq(L.Rescaling(2.0, offset=0.5), shape=(5,)),
                          _x((3, 5))),
    "Normalization": _normalization,
    "ActivityRegularization": lambda: (_seq(L.Dense(4),
                                            L.ActivityRegularization(l2=0.1),
                                            shape=(5,)), _x((3, 5))),
    "Identity": lambda: (_seq(L.Dense(4), L.Identity(), shape=(5,)),
                         _x((3, 5))),
    "RandomFlip": lambda: (_seq(L.RandomFlip(), L.GlobalAveragePooling2D(),
                                shape=(6, 6, 3)), _x((2, 6, 6, 3))),
    "RandomRotation": lambda: (_seq(L.RandomRotation(0.1),
                                    L.GlobalAveragePooling2D(),
                                    shape=(6, 6, 3)), _x((2, 6, 6, 3))),
    "RandomZoom": lambda: (_seq(L.RandomZoom(0.1),
                                L.GlobalAveragePooling2D(),
                                shape=(6, 6, 3)), _x((2, 6, 6, 3))),
    "RandomTranslation": lambda: (_seq(L.RandomTranslation(0.1, 0.1),
                                       L.GlobalAveragePooling2D(),
                                       shape=(6, 6, 3)), _x((2, 6, 6, 3))),
    "RandomContrast": lambda: (_seq(L.RandomContrast(0.2),
                                    L.GlobalAveragePooling2D(),
                                    shape=(6, 6, 3)), _x((2, 6, 6, 3))),
    "ConvLSTM2D": lambda: (_seq(L.ConvLSTM2D(3, 3, padding="same"),
                                shape=(4, 5, 5, 2)), _x((2, 4, 5, 5, 2))),
    "SeparableConv1D": lambda: (_seq(L.SeparableConv1D(
        4, 3, padding="same", depth_multiplier=2), shape=(8, 3)),
        _x((2, 8, 3))),
    "Lambda": _lambda,
    "MultiHeadAttention": _mha,
    "Attention": _attention("Attention"),
    "AdditiveAttention": _attention("AdditiveAttention"),
    "Conv1DTranspose": lambda: (_seq(L.Conv1DTranspose(5, 3, strides=2,
                                                       padding="same"),
                                     shape=(8, 3)), _x((2, 8, 3))),
    "Resizing": lambda: (_seq(L.Resizing(8, 10), shape=(5, 6, 2)),
                         _x((2, 5, 6, 2))),
    "CenterCrop": lambda: (_seq(L.CenterCrop(4, 4), shape=(6, 7, 2)),
                           _x((2, 6, 7, 2))),
    "RNN": lambda: (_seq(L.RNN(L.LSTMCell(4), return_sequences=True),
                         shape=(5, 3)), _x((2, 5, 3))),
    "EinsumDense": lambda: (_seq(L.EinsumDense("ab,bc->ac", output_shape=4,
                                               bias_axes="c"), shape=(6,)),
                            _x((3, 6))),
    "RandomCrop": lambda: (_seq(L.RandomCrop(6, 6),
                                L.GlobalAveragePooling2D(),
                                shape=(6, 6, 2)), _x((2, 6, 6, 2))),
    "Discretization": lambda: (_seq(L.Discretization(
        bin_boundaries=[-1.0, 0.0, 1.0]), shape=(4,)), _x((3, 4))),
    "CategoryEncoding": lambda: (_seq(L.CategoryEncoding(
        num_tokens=5, output_mode="count"), shape=(4,)),
        _x((3, 4), ints=5)),
}


def _lstm_weights(r, i, h, gates=4):
    return [(r.randn(i, gates * h) * 0.3).astype(np.float32),
            (r.randn(h, gates * h) * 0.3).astype(np.float32)]


def _legacy_cases():
    """The classes Keras 3 no longer has, and RandomBrightness, which it
    cannot save: (layer config, weights, batch input shape, input) for a
    one-layer legacy Sequential file."""
    r = np.random.RandomState(5)
    lstm = _lstm_weights(r, 3, 4) + [(r.randn(8 * 4) * 0.1).astype(
        np.float32)]
    gru = _lstm_weights(r, 3, 4, 3) + [(r.randn(6 * 4) * 0.1).astype(
        np.float32)]
    lc1 = [(r.randn(8, 3 * 4, 5) * 0.3).astype(np.float32),
           (r.randn(8, 5) * 0.1).astype(np.float32)]
    lc2 = [(r.randn(16, 3 * 3 * 2, 3) * 0.3).astype(np.float32),
           (r.randn(4, 4, 3) * 0.1).astype(np.float32)]
    return {
        "ThresholdedReLU": ({"theta": 1.0}, [], [None, 6], _x((3, 6)) * 2),
        "LocallyConnected1D": ({"filters": 5, "kernel_size": [3],
                                "strides": [1], "activation": "tanh",
                                "use_bias": True}, lc1, [None, 10, 4],
                               _x((2, 10, 4))),
        "LocallyConnected2D": ({"filters": 3, "kernel_size": [3, 3],
                                "strides": [1, 1], "padding": "valid",
                                "activation": "relu", "use_bias": True},
                               lc2, [None, 6, 6, 2], _x((2, 6, 6, 2))),
        "CuDNNLSTM": ({"units": 4, "return_sequences": True}, lstm,
                      [None, 5, 3], _x((2, 5, 3))),
        "CuDNNGRU": ({"units": 4, "return_sequences": True}, gru,
                     [None, 5, 3], _x((2, 5, 3))),
        # Keras 3.13 cannot save this one (its config deep-copy fails)
        "RandomBrightness": ({"factor": [-0.2, 0.2],
                              "value_range": [0, 255]}, [], [None, 6, 6, 3],
                             _x((2, 6, 6, 3))),
    }


def _write_legacy(path, cls, cfg, weights, batch_shape):
    name = "layer0"
    arch = {"class_name": "Sequential", "config": {"name": "m", "layers": [
        {"class_name": cls, "config": dict(cfg, name=name,
                                           batch_input_shape=batch_shape)}]}}
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(arch)
        g = f.create_group("model_weights").create_group(name)
        names = [f"{name}/w{i}:0".encode() for i in range(len(weights))]
        g.attrs["weight_names"] = names if names else np.zeros((0,))
        for n, w in zip(names, weights):
            g.create_dataset(n.decode(), data=w)


NON_REJECTING = sorted(set(KERAS_CASES) | set(_legacy_cases()))
REJECTING = ["Hashing", "StringLookup", "TextVectorization"]
# the cases whose .keras form the JAX package reads (its sub-group order
# breaks MultiHeadAttention; the legacy classes have no .keras form)
NO_KERAS_V3 = {"MultiHeadAttention", "Lambda"}
FORMS = ([(n, "h5") for n in NON_REJECTING]
         + [(n, "keras") for n in sorted(KERAS_CASES)
            if n not in NO_KERAS_V3])


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Every case's file(s) and input, written once."""
    root = tmp_path_factory.mktemp("keras")
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, build in KERAS_CASES.items():
            model, x = build()
            _randomize(model)
            paths = {}
            for ext in ("h5", "keras"):
                paths[ext] = str(root / f"{name}.{ext}")
                model.save(paths[ext])
            out[name] = (paths, x)
    for name, (cfg, weights, shape, x) in _legacy_cases().items():
        path = str(root / f"{name}.h5")
        _write_legacy(path, name, cfg, weights, shape)
        out[name] = ({"h5": path}, x)
    return out


@pytest.fixture(scope="module", autouse=True)
def lambda_registered():
    """The Lambda case's implementation, registered in both packages (the
    reference's registerLambdaLayer contract)."""
    from deeplearning4j_tpu.nn import conf as JC
    from deeplearning4j_tpu_torch.nn import conf as PC

    J.register_lambda("scale_lambda", lambda cfg, w: (
        JC.ActivationLayer(activation="identity"), {}))
    K.register_lambda("scale_lambda", lambda cfg, w: (
        PC.ActivationLayer(activation="identity"), {}))
    yield
    J._KERAS_LAMBDAS.pop("scale_lambda", None)
    K._KERAS_LAMBDAS.pop("scale_lambda", None)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def _outputs(net, x):
    xs = x if isinstance(x, list) else [x]
    out = net.output(*xs)
    return [np.asarray(o) for o in (out if isinstance(out, list) else [out])]


def _same_networks(jnet, pnet, x):
    assert type(jnet).__name__ == type(pnet).__name__
    for attr in ("params", "net_state"):
        jl, pl = _flat(getattr(jnet, attr)), _flat(getattr(pnet, attr))
        assert sorted(jl) == sorted(pl), attr
        for k in jl:
            assert jl[k].shape == pl[k].shape and jl[k].dtype == pl[k].dtype, k
            assert np.array_equal(jl[k], pl[k]), k
    jo, po = _outputs(jnet, x), _outputs(pnet, x)
    assert len(jo) == len(po)
    for a, b in zip(jo, po):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.all(np.isfinite(b))
        tol = REL * max(1.0, float(np.abs(a).max()) if a.size else 1.0)
        np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def test_mapper_tables_equal():
    assert sorted(J.KerasLayerMapper.MAPPERS) == sorted(
        K.KerasLayerMapper.MAPPERS)
    assert len(K.KerasLayerMapper.MAPPERS) == 89
    assert len(NON_REJECTING) + len(REJECTING) == 89
    assert set(NON_REJECTING) | set(REJECTING) == set(
        K.KerasLayerMapper.MAPPERS)


@pytest.mark.parametrize("name,form", FORMS)
def test_mapper_matches_jax_import(saved, name, form):
    paths, x = saved[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet = J.import_keras_model_and_weights(paths[form], validate=False)
        pnet = K.import_keras_model_and_weights(paths[form], device="cpu")
    _same_networks(jnet, pnet, x)


def _one_layer_config(cls, functional):
    layer = {"class_name": cls, "config": {"name": "l"}}
    if not functional:
        return {"class_name": "Sequential", "config": {"layers": [
            {"class_name": "InputLayer",
             "config": {"batch_shape": [None, 4], "name": "in"}}, layer]}}
    layer["inbound_nodes"] = [[["in", 0, 0, {}]]]
    return {"class_name": "Functional", "config": {
        "layers": [{"class_name": "InputLayer", "name": "in",
                    "config": {"batch_shape": [None, 4], "name": "in"},
                    "inbound_nodes": []}, layer],
        "input_layers": [["in", 0, 0]], "output_layers": [["l", 0, 0]]}}


def _message(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


@pytest.mark.parametrize("cls", REJECTING + ["NoSuchLayer"])
@pytest.mark.parametrize("functional", [False, True])
def test_rejections_same_message(cls, functional):
    config = _one_layer_config(cls, functional)
    entry = (J.import_keras_functional_config if functional
             else J.import_keras_sequential_config)
    pentry = (K.import_keras_functional_config if functional
              else K.import_keras_sequential_config)
    want = _message(lambda: entry(config, {}, validate=False))
    got = _message(lambda: pentry(config, {}, device="cpu"))
    assert got == want
    assert got[0] is NotImplementedError and cls in got[1]


def test_validate_raises(saved):
    with pytest.raises(NotImplementedError, match="check_network"):
        K.import_keras_model_and_weights(saved["Dense"][0]["h5"],
                                         validate=True, device="cpu")


def test_mha_keras_v3_defect_fails_alike(saved):
    """The JAX package reads a ``.keras`` MultiHeadAttention's sub-groups
    in sorted order (key, output, query, value) where its mapper expects
    q, k, v, o; the port mirrors it, so both raise the same error."""
    path = saved["MultiHeadAttention"][0]["keras"]
    want = _message(lambda: J.import_keras_model_and_weights(
        path, validate=False))
    got = _message(lambda: K.import_keras_model_and_weights(path,
                                                            device="cpu"))
    assert got == want
    assert got[0] is ValueError and "cannot reshape array" in got[1]


@pytest.mark.parametrize("name", ["Conv2D", "LSTM", "MultiHeadAttention",
                                  "BatchNormalization"])
def test_live_model(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model, x = KERAS_CASES[name]()
        _randomize(model)
        jnet = J.import_keras_model(model, validate=False)
        pnet = K.import_keras_model(model, device="cpu")
    _same_networks(jnet, pnet, x)


def test_sequential_model_and_weights(saved):
    path, x = saved["Conv2D"][0]["h5"], saved["Conv2D"][1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet = J.import_keras_sequential_model_and_weights(path,
                                                           validate=False)
    pnet = K.import_keras_sequential_model_and_weights(path, device="cpu")
    _same_networks(jnet, pnet, x)
    with pytest.raises(ValueError, match="not a Sequential"):
        K.import_keras_sequential_model_and_weights(
            saved["MultiHeadAttention"][0]["h5"], device="cpu")


def test_builder_bert_is_a_keras_file(tmp_path):
    """The card's fixture at 2 narrow layers: Keras loads it, and its
    prediction agrees with both imports (Keras's exact GELU against the
    packages' tanh form: 1e-4 on the probabilities; the imports against
    each other to 1e-5)."""
    cfg = dict(layers=2, hidden=64, heads=4, ff=256, vocab=500,
               max_positions=64, seq=16)
    path = str(tmp_path / "bert.h5")
    _, arrays = kb.bert_keras_h5(path, std=0.2, **cfg)
    ids, pos = kb.bert_inputs(4, cfg["seq"], cfg["vocab"], seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = keras.models.load_model(path, compile=False)
        want = np.asarray(model.predict([ids, pos], verbose=0))
        jnet = J.import_keras_model_and_weights(path, validate=False)
    pnet = K.import_keras_model_and_weights(path, device="cpu")
    feeds = [ids.astype(np.float32), pos.astype(np.float32)]
    _same_networks(jnet, pnet, feeds)
    got = pnet.output(*feeds)[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the builder's arrays are the file's
    kweights = {l.name: l.get_weights() for l in model.layers}
    for name, arrs in arrays.items():
        assert len(arrs) == len(kweights[name])
        for a, b in zip(arrs, kweights[name]):
            assert np.array_equal(a, b)


def test_port_importer_imports_no_jax_h5py_keras_tensorflow():
    code = (
        "import sys\n"
        "from deeplearning4j_tpu_torch.imports import keras_import, hdf5\n"
        "from deeplearning4j_tpu_torch.testing import keras_builder as kb\n"
        "data, _ = kb.conv1d_keras_h5(None, vocab=30, seq=8)\n"
        "net = keras_import.import_keras_model_and_weights(data, "
        "device='cpu')\n"
        "import numpy as np\n"
        "print(net.output(np.zeros((2, 8), np.float32)).shape)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'h5py', 'keras', 'tensorflow', "
        "'deeplearning4j_tpu')]\n"
        "print('LEAKED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout, out.stdout
    assert "(2, 4)" in out.stdout
