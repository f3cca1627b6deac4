"""The 34 layer types and the preprocessor the Keras importer builds,
against the JAX package's (CPU).

For each case (every type, some in several configurations):

* the port's config writes the JAX config's JSON, each package reads the
  other's, and ``output_type`` gives the same ``InputType``;
* ``apply`` (``apply_multi`` for the multi-input ``AttentionVertex`` and
  ``DotAttentionLayer``) on the same numpy inputs, with the JAX layer's
  initial parameters carried across, within 1e-5 × max(1, max |JAX|)
  (float32), masks too; the port's ``init`` draws the same shapes.

``Cnn3DToFeedForwardPreProcessor`` is held the same way through
``apply_preprocessor``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu_torch.nn import conf as PC
from deeplearning4j_tpu_torch.nn import layers as PL

torch.backends.cuda.matmul.allow_tf32 = False
REL = 1e-5


def _r(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _ints(*shape, n, seed=0):
    return np.random.RandomState(seed).randint(0, n, shape).astype(
        np.float32)


def _mask(n, t, lengths):
    m = np.zeros((n, t), np.float32)
    for i, length in enumerate(lengths):
        m[i, :length] = 1.0
    return m


def _zero_steps():
    x = _r(2, 6, 3)
    x[0, 4:] = 0.0
    x[1, 1:3] = 0.0
    return x


R = ("recurrent",)
# (id, type, config kwargs, input type (kind, *args), inputs, mask)
CASES = [
    ("attention", "AttentionVertex",
     dict(n_out=8, n_heads=2, n_in_queries=6, n_in_keys=6, n_in_values=6),
     R + (6, 4), [_r(2, 4, 6), _r(2, 5, 6, seed=1), _r(2, 5, 6, seed=2)],
     _mask(2, 5, (5, 3))),
    ("attention_keras", "AttentionVertex",
     dict(n_out=8, n_heads=2, n_in_queries=6, n_in_keys=6, n_in_values=6,
          keras_order=True, has_bias=True, d_out=5),
     R + (6, 4), [_r(2, 4, 6), _r(2, 5, 6, seed=1)], None),
    ("conv1d_same", "Convolution1D",
     dict(n_in=3, n_out=4, kernel=3, stride=2, convolution_mode="same"),
     R + (3, 9), _r(2, 9, 3), _mask(2, 9, (9, 5))),
    ("conv1d_valid", "Convolution1D",
     dict(n_in=3, n_out=4, kernel=3, convolution_mode="valid", dilation=2),
     R + (3, 9), _r(2, 9, 3), None),
    ("conv3d_same", "Convolution3D",
     dict(n_in=2, n_out=3, kernel=(2, 2, 2), stride=(1, 2, 1)),
     ("convolutional3d", 4, 5, 4, 2), _r(2, 4, 5, 4, 2), None),
    ("conv3d_valid", "Convolution3D",
     dict(n_in=2, n_out=3, kernel=(2, 3, 2), convolution_mode="valid"),
     ("convolutional3d", 4, 5, 4, 2), _r(2, 4, 5, 4, 2), None),
    ("pool3d_max", "Subsampling3DLayer",
     dict(kernel=(2, 2, 2), stride=(2, 1, 2)),
     ("convolutional3d", 4, 4, 4, 2), _r(2, 4, 4, 4, 2), None),
    ("pool3d_avg", "Subsampling3DLayer",
     dict(kernel=(2, 2, 1), stride=(1, 2, 1), pooling_type="avg"),
     ("convolutional3d", 4, 4, 3, 2), _r(2, 4, 4, 3, 2), None),
    ("local2d", "LocallyConnected2D",
     dict(n_in=2, n_out=3, kernel=(2, 3), stride=(1, 2), input_size=(5, 6),
          activation="tanh"),
     ("convolutional", 5, 6, 2), _r(2, 5, 6, 2), None),
    ("local1d", "LocallyConnected1D",
     dict(n_in=3, n_out=4, kernel=3, stride=2, input_size=9),
     R + (3, 9), _r(2, 9, 3), None),
    ("prelu", "PReLULayer", dict(n_in=5), ("feedforward", 5), _r(3, 5),
     None),
    ("zeropad1d", "ZeroPadding1DLayer", dict(padding=(1, 2)), R + (3, 5),
     _r(2, 5, 3), _mask(2, 5, (5, 2))),
    ("zeropad2d", "ZeroPaddingLayer", dict(padding=(1, 2, 0, 1)),
     ("convolutional", 4, 4, 2), _r(2, 4, 4, 2), None),
    ("zeropad3d", "ZeroPadding3DLayer", dict(padding=(1, 0, 0, 1, 2, 1)),
     ("convolutional3d", 2, 3, 2, 2), _r(2, 2, 3, 2, 2), None),
    ("crop1d", "Cropping1D", dict(cropping=(1, 2)), R + (3, 7), _r(2, 7, 3),
     _mask(2, 7, (7, 4))),
    ("crop2d", "Cropping2D", dict(cropping=(1, 0, 1, 2)),
     ("convolutional", 5, 6, 2), _r(2, 5, 6, 2), None),
    ("crop3d", "Cropping3D", dict(cropping=(1, 0, 0, 1, 1, 1)),
     ("convolutional3d", 4, 4, 5, 2), _r(2, 4, 4, 5, 2), None),
    ("upsample1d", "Upsampling1D", dict(size=3), R + (2, 4), _r(2, 4, 2),
     _mask(2, 4, (4, 2))),
    ("upsample3d", "Upsampling3D", dict(size=(2, 1, 2)),
     ("convolutional3d", 2, 3, 2, 2), _r(2, 2, 3, 2, 2), None),
    ("pool1d_max_same", "Subsampling1DLayer",
     dict(kernel=3, stride=2, convolution_mode="same"), R + (3, 8),
     _r(2, 8, 3), _mask(2, 8, (8, 3))),
    ("pool1d_avg_same", "Subsampling1DLayer",
     dict(kernel=3, stride=2, pooling_type="avg", convolution_mode="same"),
     R + (3, 7), _r(2, 7, 3), None),
    ("pool1d_avg_valid", "Subsampling1DLayer",
     dict(kernel=2, stride=2, pooling_type="avg"), R + (3, 7), _r(2, 7, 3),
     _mask(2, 7, (7, 4))),
    ("deconv3d_valid", "Deconvolution3D",
     dict(n_in=2, n_out=3, kernel=(2, 3, 2), stride=(2, 1, 2)),
     ("convolutional3d", 2, 3, 2, 2), _r(2, 2, 3, 2, 2), None),
    ("deconv3d_same", "Deconvolution3D",
     dict(n_in=2, n_out=3, kernel=(3, 2, 2), stride=(2, 2, 1),
          convolution_mode="same"),
     ("convolutional3d", 2, 3, 2, 2), _r(2, 2, 3, 2, 2), None),
    ("maskzero", "MaskZeroLayer",
     dict(underlying={"@type": "SimpleRnn", "n_in": 3, "n_out": 4,
                      "activation": "tanh"}, mask_value=0.0),
     R + (3, 6), _zero_steps(), None),
    ("repeat", "RepeatVector", dict(n=3), ("feedforward", 5), _r(2, 5),
     None),
    ("permute_rnn", "PermuteLayer", dict(dims=(2, 1)), R + (6, 4),
     _r(2, 4, 6), None),
    ("permute_cnn", "PermuteLayer", dict(dims=(3, 1, 2)),
     ("convolutional", 3, 4, 5), _r(2, 3, 4, 5), None),
    ("reshape", "ReshapeLayer", dict(target_shape=(3, -1)),
     ("feedforward", 12), _r(2, 12), None),
    ("layernorm", "LayerNormalization", dict(n_out=6, eps=1e-3),
     R + (6, 3), _r(2, 3, 6), None),
    ("groupnorm", "GroupNormalization", dict(n_out=4, groups=2),
     ("convolutional", 3, 3, 4), _r(2, 3, 3, 4), None),
    ("groupnorm_instance", "GroupNormalization",
     dict(n_out=4, groups=-1, eps=1e-5), ("convolutional", 3, 3, 4),
     _r(2, 3, 3, 4), None),
    ("rescale", "RescaleLayer", dict(scale=(1.5, -2.0, 0.5), offset=0.25),
     ("feedforward", 3), _r(3, 3), None),
    ("discretize", "DiscretizationLayer",
     dict(bin_boundaries=(-1.0, 0.0, 0.5)), ("feedforward", 4), _r(3, 4),
     None),
    ("category_one_hot", "CategoryEncodingLayer",
     dict(num_tokens=5, output_mode="one_hot"), ("feedforward", 1),
     _ints(3, 1, n=5), None),
    ("category_multi_hot", "CategoryEncodingLayer",
     dict(num_tokens=5), ("feedforward", 4), _ints(3, 4, n=6), None),
    ("category_count", "CategoryEncodingLayer",
     dict(num_tokens=5, output_mode="count"), ("feedforward", 4),
     _ints(3, 4, n=5), None),
    ("einsum_seq", "EinsumDenseLayer",
     dict(equation="...d,de->...e", out_shape=(5,), bias_shape=(5,),
          activation="relu"), R + (6, 4), _r(2, 4, 6), None),
    ("einsum_ff", "EinsumDenseLayer",
     dict(equation="ab,bc->ac", out_shape=(5,)), ("feedforward", 6),
     _r(3, 6), None),
    ("unitnorm", "UnitNormLayer", {}, ("feedforward", 5), _r(3, 5), None),
    ("convlstm_same", "ConvLSTM2D",
     dict(n_in=2, filters=3, kernel=(3, 3), activation="tanh",
          gate_activation="hardsigmoid"),
     ("convolutional3d", 3, 5, 5, 2), _r(2, 3, 5, 5, 2), None),
    ("convlstm_valid_seq", "ConvLSTM2D",
     dict(n_in=2, filters=3, kernel=(3, 3), padding="valid",
          return_sequences=True, activation="tanh"),
     ("convolutional3d", 3, 5, 5, 2), _r(2, 3, 5, 5, 2), None),
    ("dot_attention", "DotAttentionLayer", dict(use_scale=True, scale=0.5),
     R + (6, 4), [_r(2, 4, 6), _r(2, 5, 6, seed=1)], _mask(2, 5, (5, 2))),
    ("additive_attention", "DotAttentionLayer",
     dict(additive=True, use_scale=True, scale=(0.5, -1.0, 0.25, 1.0, 2.0,
                                               0.1)),
     R + (6, 4), [_r(2, 4, 6), _r(2, 5, 6, seed=1), _r(2, 5, 6, seed=2)],
     None),
    ("sepconv1d_same", "SeparableConvolution1D",
     dict(n_in=3, n_out=4, kernel=3, stride=2, convolution_mode="same",
          depth_multiplier=2), R + (3, 9), _r(2, 9, 3), _mask(2, 9, (9, 4))),
    ("sepconv1d_valid", "SeparableConvolution1D",
     dict(n_in=3, n_out=4, kernel=3, has_bias=False), R + (3, 8),
     _r(2, 8, 3), None),
    ("deconv1d_valid", "Deconvolution1D",
     dict(n_in=3, n_out=4, kernel=3, stride=2), R + (3, 5), _r(2, 5, 3),
     None),
    ("deconv1d_same", "Deconvolution1D",
     dict(n_in=3, n_out=4, kernel=3, stride=2, convolution_mode="same"),
     R + (3, 5), _r(2, 5, 3), None),
    ("deconv1d_wide_stride", "Deconvolution1D",
     dict(n_in=3, n_out=4, kernel=2, stride=3), R + (3, 4), _r(2, 4, 3),
     None),
    ("resize_bilinear", "ResizeLayer", dict(height=7, width=5),
     ("convolutional", 4, 6, 2), _r(2, 4, 6, 2), None),
    ("resize_nearest", "ResizeLayer",
     dict(height=8, width=3, method="nearest"), ("convolutional", 4, 6, 2),
     _r(2, 4, 6, 2), None),
    ("resize_bicubic", "ResizeLayer",
     dict(height=6, width=9, method="bicubic"), ("convolutional", 4, 6, 2),
     _r(2, 4, 6, 2), None),
    ("center_crop", "CenterCropLayer", dict(height=3, width=4),
     ("convolutional", 6, 7, 2), _r(2, 6, 7, 2), None),
]
TYPES = sorted({c[1] for c in CASES})


def _itype(mod, spec):
    kind, *args = spec
    if kind == "recurrent":
        return mod.InputType.recurrent(*args)
    if kind == "feedforward":
        return mod.InputType.feed_forward(*args)
    if kind == "convolutional":
        return mod.InputType.convolutional(*args)
    return mod.InputType.convolutional3d(*args)


def _confs(name, kw):
    return getattr(JC, name)(**kw), getattr(PC, name)(**kw)


def test_every_type_has_a_case():
    assert len(TYPES) == 34
    for name in TYPES:
        assert name in PC.LAYER_TYPES
        assert PL.LAYER_IMPLS[PC.LAYER_TYPES[name]].__name__ == \
            JL.LAYER_IMPLS[JC.LAYER_TYPES[name]].__name__


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_conf_json_and_output_type(case):
    _, name, kw, spec, _, _ = case
    jc, pc = _confs(name, kw)
    jd = json.loads(json.dumps(jc.to_dict()))
    pd = json.loads(json.dumps(pc.to_dict()))
    assert pd == jd
    assert PC.LayerConf.from_dict(jd) == pc
    assert JC.LayerConf.from_dict(pd) == jc
    jt = jc.output_type(_itype(JC, spec))
    pt = pc.output_type(_itype(PC, spec))
    assert pt.to_dict() == jt.to_dict()


def _carry(tree):
    if isinstance(tree, dict):
        return {k: _carry(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_apply_matches_jax(case):
    _, name, kw, spec, xs, mask = case
    jc, pc = _confs(name, kw)
    jlayer = JL.build_layer(JC.MultiLayerConfiguration(), jc,
                            _itype(JC, spec))
    player = PL.build_layer(PC.MultiLayerConfiguration(), pc,
                            _itype(PC, spec), torch.device("cpu"))
    jp = jlayer.init(jax.random.key(3))
    own = player.init(torch.Generator().manual_seed(3))
    assert jax.tree.map(np.shape, jp) == jax.tree.map(
        lambda t: tuple(t.shape), own)
    pp = _carry(jp)
    jm = None if mask is None else jax.numpy.asarray(mask)
    pm = None if mask is None else torch.from_numpy(mask)
    if isinstance(xs, list):
        jy, _, jmask = jlayer.apply_multi(
            jp, [jax.numpy.asarray(x) for x in xs], {}, train=False,
            rng=None, mask=jm)
        py, _, pmask = player.apply_multi(
            pp, [torch.from_numpy(x) for x in xs], {}, train=False,
            rng=None, mask=pm)
    else:
        jy, _, jmask = jlayer.apply(jp, jax.numpy.asarray(xs),
                                    jlayer.init_state(), train=False,
                                    rng=None, mask=jm)
        py, _, pmask = player.apply(pp, torch.from_numpy(xs),
                                    player.init_state(), train=False,
                                    rng=None, mask=pm)
    jy, py = np.asarray(jy), py.numpy()
    assert py.shape == jy.shape and py.dtype == jy.dtype
    tol = REL * max(1.0, float(np.abs(jy).max()))
    np.testing.assert_allclose(py, jy, rtol=0, atol=tol)
    assert (jmask is None) == (pmask is None)
    if jmask is not None:
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))


def test_cnn3d_preprocessor():
    kw = dict(depth=2, height=3, width=4, channels=5)
    jp = JC.Cnn3DToFeedForwardPreProcessor(**kw)
    pp = PC.Cnn3DToFeedForwardPreProcessor(**kw)
    assert json.loads(json.dumps(pp.to_dict())) == jp.to_dict()
    assert PC.InputPreProcessor.from_dict(jp.to_dict()) == pp
    x = _r(2, 2, 3, 4, 5)
    want = np.asarray(JL.apply_preprocessor(jp, jax.numpy.asarray(x)))
    got = PL.apply_preprocessor(pp, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dense_after_3d_input_gets_the_preprocessor():
    """A Dense after a volumetric layer: the same inserted preprocessor,
    filled n_in and network output in both packages."""
    def net(C, mln, **kw):
        conf = (C.builder().list()
                .layer(C.Convolution3D(n_out=2, kernel=(2, 2, 2)))
                .layer(C.DenseLayer(n_out=3))
                .set_input_type(C.InputType.convolutional3d(3, 3, 3, 2))
                .build())
        return mln(conf, **kw).init()

    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as PM

    jn, pn = net(JC, JM), net(PC, PM, device="cpu")
    assert pn.conf.preprocessors[1].to_dict() == \
        jn.conf.preprocessors[1].to_dict()
    assert pn.conf.layers[1].n_in == jn.conf.layers[1].n_in == 54
    pn.init(jax.tree.map(np.asarray, jn.params))
    x = _r(2, 3, 3, 3, 2)
    np.testing.assert_allclose(pn.output(x), jn.output(x), rtol=0,
                               atol=1e-5)
