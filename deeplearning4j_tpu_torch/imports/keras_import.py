"""Keras model import: legacy ``.h5`` and Keras-3 ``.keras`` files, and
live models, read without h5py, Keras or TensorFlow.

Counterpart of ``deeplearning4j_tpu/imports/keras_import.py``
(deeplearning4j-modelimport's KerasModelImport): the same
:class:`KerasLayerMapper` table of 89 per-layer mappers (``Dense``,
``Conv1D``-``Conv3D`` and their transposes, the poolings, recurrent
layers with the LSTM / GRU / ConvLSTM gate regrouping, normalizations,
``MultiHeadAttention``, shape and preprocessing layers, the rejecting
``Hashing`` / ``StringLookup`` / ``TextVectorization``), with the same
messages, :func:`register_custom_layer` and :func:`register_lambda`.

* A Sequential model becomes a :class:`~..nn.multilayer.MultiLayerNetwork`
  (:func:`_assemble_sequential`: a ``Dense`` kernel after the 2-D or 3-D
  flatten preprocessor gets its rows reordered from Keras's HWC flatten to
  the channel-major one), a functional model a
  :class:`~..nn.graph.ComputationGraph` (:func:`import_keras_functional_config`,
  the merge layers, ``Dot`` and ``Flatten`` as vertices).
* Files are read by the port's own HDF5 reader
  (:mod:`~deeplearning4j_tpu_torch.imports.hdf5`): :func:`read_keras_h5`
  (``model_config`` and ``model_weights``) and :func:`read_keras_v3`
  (``config.json`` and ``model.weights.h5`` of the zip; weight groups
  keyed by snake_case class name and a per-class counter, sub-groups in
  the JAX importer's order — which for ``MultiHeadAttention`` is not
  Keras's, so such a ``.keras`` file fails in both packages, as
  ROADMAP.md records).
* :func:`import_keras_model` takes a live Keras model, duck-typed
  (``layers``, ``get_config()``, ``get_weights()``, ``input_shape``, the
  class names of ``type(model).__mro__``); nothing here imports Keras.

Each network is built on ``device`` (the card unless the caller passes
``device="cpu"``) and its leaves replaced by the file's arrays, one
``torch.from_numpy(...).to(device)`` a leaf (float64 arrays as float32,
int64 as int32, as the JAX package's ``jnp.asarray`` takes them).
``validate=True`` raises: post-import network checking
(``analysis.check_network``) is not ported.
"""

from __future__ import annotations

import io
import json
import warnings
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.imports import hdf5
from deeplearning4j_tpu_torch.nn import conf as C

_ACT_MAP = {
    "relu": "relu", "softmax": "softmax", "tanh": "tanh", "sigmoid": "sigmoid",
    "linear": "identity", "elu": "elu", "selu": "selu", "gelu": "gelu",
    "softplus": "softplus", "softsign": "softsign", "swish": "swish",
    "hard_sigmoid": "hardsigmoid", "leaky_relu": "leakyrelu",
}


def _act(cfg) -> str:
    a = cfg.get("activation", "linear")
    if isinstance(a, dict):
        a = a.get("class_name", "linear").lower()
    return _ACT_MAP.get(a, a)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class KerasLayerMapper:
    """Registry of per-layer-class mappers (the KerasLayer subclass
    table): ``fn(cfg, weights) -> (LayerConf, params)``."""

    MAPPERS: Dict[str, Any] = {}

    @classmethod
    def register(cls, name):
        def wrap(fn):
            cls.MAPPERS[name] = fn
            return fn

        return wrap


@KerasLayerMapper.register("Dense")
def _dense(cfg, weights):
    lc = C.DenseLayer(n_out=cfg["units"], activation=_act(cfg),
                       has_bias=cfg.get("use_bias", True), name=cfg.get("name"))
    p = {"W": weights[0]}
    if cfg.get("use_bias", True) and len(weights) > 1:
        p["b"] = weights[1]
    return lc, p


@KerasLayerMapper.register("Conv2D")
def _conv2d(cfg, weights):
    pad = "same" if cfg.get("padding", "valid") == "same" else "truncate"
    lc = C.ConvolutionLayer(
        n_out=cfg["filters"], kernel=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", 1)), convolution_mode=pad,
        dilation=_pair(cfg.get("dilation_rate", 1)), activation=_act(cfg),
        has_bias=cfg.get("use_bias", True), name=cfg.get("name"))
    p = {"W": weights[0]}  # keras kernel is HWIO — matches our layout
    if cfg.get("use_bias", True) and len(weights) > 1:
        p["b"] = weights[1]
    return lc, p


@KerasLayerMapper.register("MaxPooling2D")
def _maxpool(cfg, weights):
    pad = "same" if cfg.get("padding", "valid") == "same" else "truncate"
    return C.SubsamplingLayer(
        pooling_type="max", kernel=_pair(cfg.get("pool_size", 2)),
        stride=_pair(cfg.get("strides") or cfg.get("pool_size", 2)),
        convolution_mode=pad, name=cfg.get("name")), {}


@KerasLayerMapper.register("AveragePooling2D")
def _avgpool(cfg, weights):
    pad = "same" if cfg.get("padding", "valid") == "same" else "truncate"
    return C.SubsamplingLayer(
        pooling_type="avg", kernel=_pair(cfg.get("pool_size", 2)),
        stride=_pair(cfg.get("strides") or cfg.get("pool_size", 2)),
        convolution_mode=pad, name=cfg.get("name")), {}


@KerasLayerMapper.register("GlobalAveragePooling2D")
def _gap(cfg, weights):
    return C.GlobalPoolingLayer(pooling_type="avg", name=cfg.get("name")), {}


@KerasLayerMapper.register("Flatten")
def _flatten(cfg, weights):
    return "FLATTEN", {}


@KerasLayerMapper.register("Dropout")
def _dropout(cfg, weights):
    return C.DropoutLayer(rate=cfg.get("rate", 0.5), name=cfg.get("name")), {}


@KerasLayerMapper.register("Activation")
def _activation(cfg, weights):
    return C.ActivationLayer(activation=_act(cfg), name=cfg.get("name")), {}


@KerasLayerMapper.register("BatchNormalization")
def _bn(cfg, weights):
    lc = C.BatchNormalization(eps=cfg.get("epsilon", 1e-3),
                               decay=cfg.get("momentum", 0.99),
                               name=cfg.get("name"))
    # keras order: gamma, beta, moving_mean, moving_variance
    p = {"gamma": weights[0], "beta": weights[1]}
    state = {"mean": weights[2], "var": weights[3]}
    return lc, {"__params__": p, "__state__": state}


@KerasLayerMapper.register("Embedding")
def _embedding(cfg, weights):
    lc = C.EmbeddingSequenceLayer(n_in=cfg["input_dim"], n_out=cfg["output_dim"],
                                   name=cfg.get("name"))
    return lc, {"W": weights[0]}


@KerasLayerMapper.register("LSTM")
def _lstm(cfg, weights):
    units = cfg["units"]
    if cfg.get("go_backwards", False):
        raise NotImplementedError("LSTM import with go_backwards=True")
    lc = C.LSTM(n_out=units, activation=_act(cfg),
                 gate_activation=_ACT_MAP.get(cfg.get("recurrent_activation",
                                                      "sigmoid"), "sigmoid"),
                 forget_gate_bias_init=0.0, name=cfg.get("name"))
    kernel, recurrent, bias = weights[0], weights[1], weights[2]

    def regate(w):
        # keras gate order [i, f, c, o] → ours [i, f, o, g(c)]
        i, f, c, o = np.split(w, 4, axis=-1)
        return np.concatenate([i, f, o, c], axis=-1)

    p = {"W": regate(kernel), "RW": regate(recurrent), "b": regate(bias)}
    if not cfg.get("return_sequences", False):
        # keras default emits the LAST step only → wrap in LastTimeStep
        return C.LastTimeStep(fwd=lc.to_dict(), name=cfg.get("name")), \
            {"inner": p}
    return lc, p


def _check_validate(validate: bool) -> None:
    if validate:
        raise NotImplementedError(
            "validate=True: post-import network checking "
            "(analysis.check_network) is not ported to "
            "deeplearning4j_tpu_torch yet; import with validate=False")


def _leaf(w, device: torch.device) -> torch.Tensor:
    """One array as a tensor on ``device``, in the dtype ``jnp.asarray``
    gives it with 64-bit types off."""
    a = np.asarray(w)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _graft(tree, device: torch.device):
    """A mapper's parameter tree (arbitrarily nested dicts: a
    Bidirectional inside a LastTimeStep is two levels deep) as tensors."""
    if isinstance(tree, dict):
        return {k: _graft(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def _assemble_sequential(specs, input_type, validate: bool = False,
                         device=None):
    """Shared Sequential assembly and weight grafting: ``specs`` are
    (class_name, layer_cfg, weights) triples from a live Keras model or a
    parsed file. Keras flattens conv activations HWC-major while the
    CnnToFeedForward preprocessor flattens CHW-major, so the input rows of
    a Dense W right after that preprocessor (or its 3-D twin) are
    reordered while grafting."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    _check_validate(validate)
    layer_confs: List[C.LayerConf] = []
    params_list: List[Dict[str, Any]] = []
    states_list: List[Dict[str, Any]] = []
    for cls, cfg, weights in specs:
        mapper = KerasLayerMapper.MAPPERS.get(cls)
        if mapper is None:
            raise NotImplementedError(
                f"Keras layer '{cls}' has no import mapper; register one on "
                f"KerasLayerMapper")
        out = mapper(cfg, weights)
        # a mapper may expand ONE keras layer into several of ours
        # (RNN(cell=StackedRNNCells) → one recurrent layer per cell)
        items = out if isinstance(out, list) else [out]
        for lc, p in items:
            if lc == "FLATTEN":
                continue  # shape inference inserts CnnToFeedForward
            state = {}
            if isinstance(p, dict) and "__params__" in p:
                state = p["__state__"]
                p = p["__params__"]
            layer_confs.append(lc)
            params_list.append(p)
            states_list.append(state)
    b = C.builder().list()
    for lc in layer_confs:
        b.layer(lc)
    conf = b.set_input_type(input_type).build()
    net = MultiLayerNetwork(conf, device=device).init()
    dev = net.device
    for i, (p, st) in enumerate(zip(params_list, states_list)):
        pre = net.conf.preprocessors.get(i)
        for k, w in p.items():
            if (k == "W" and isinstance(pre, C.CnnToFeedForwardPreProcessor)
                    and hasattr(w, "ndim") and w.ndim == 2
                    and w.shape[0] == pre.height * pre.width * pre.channels):
                w = (w.reshape(pre.height, pre.width, pre.channels, -1)
                     .transpose(2, 0, 1, 3)
                     .reshape(w.shape[0], -1))
            if (k == "W"
                    and isinstance(pre, C.Cnn3DToFeedForwardPreProcessor)
                    and hasattr(w, "ndim") and w.ndim == 2
                    and w.shape[0] == pre.depth * pre.height * pre.width
                    * pre.channels):
                # keras flattens NDHWC; the 3-D preprocessor channel-major
                w = (w.reshape(pre.depth, pre.height, pre.width,
                               pre.channels, -1)
                     .transpose(3, 0, 1, 2, 4)
                     .reshape(w.shape[0], -1))
            net.params[i][k] = _graft(w, dev)
        for k, v in st.items():
            net.net_state[i][k] = _leaf(v, dev)
    return net


def import_keras_model(model, input_type: Optional[C.InputType] = None,
                       validate: bool = False, device=None):
    """A live Keras model → MultiLayerNetwork (Sequential) or
    ComputationGraph (functional), the KerasModelImport.importKeras*
    dispatch for live models. Duck-typed: Keras is not imported."""
    if not any(c.__name__ == "Sequential" for c in type(model).__mro__):
        weights_map = {kl.name: [np.asarray(w) for w in kl.get_weights()]
                       for kl in model.layers}
        config = {"class_name": "Functional", "config": model.get_config()}
        return import_keras_functional_config(config, weights_map,
                                              validate=validate,
                                              device=device)
    specs = []
    for kl in model.layers:
        cls = type(kl).__name__
        if cls == "InputLayer":
            continue
        specs.append((cls, kl.get_config(),
                      [np.asarray(w) for w in kl.get_weights()]))
    if input_type is None:
        input_type = _infer_input_type_from_shape(model.input_shape)
    return _assemble_sequential(specs, input_type, validate=validate,
                                device=device)


def import_keras_sequential_model_and_weights(path, validate: bool = False,
                                              device=None):
    """KerasModelImport.importKerasSequentialModelAndWeights: a saved
    ``.h5`` or ``.keras`` file (path or bytes) holding a Sequential
    model → MultiLayerNetwork, read by the port's own reader (the JAX
    package loads it through ``tf.keras``; both give the same network)."""
    config, weights = _read(path)
    if config.get("class_name") != "Sequential":
        raise ValueError(
            f"import_keras_sequential_model_and_weights: the file holds a "
            f"{config.get('class_name')!r} model, not a Sequential one; "
            f"use import_keras_model_and_weights")
    return import_keras_sequential_config(config, weights, validate=validate,
                                          device=device)


# ---------------------------------------------------------------------------
# Widened mapper table (round 3): conv variants, poolings, RNNs, advanced
# activations — KerasLayer subclass coverage toward the reference's ~100.
# ---------------------------------------------------------------------------


@KerasLayerMapper.register("DepthwiseConv2D")
def _depthwise(cfg, weights):
    k = _pair(cfg["kernel_size"])
    dw = weights[0]  # (kh, kw, C, mult) — matches our layout
    lc = C.DepthwiseConvolution2D(
        n_in=dw.shape[2], n_out=dw.shape[2] * dw.shape[3], kernel=k,
        stride=_pair(cfg.get("strides", 1)),
        convolution_mode=cfg.get("padding", "valid"),
        activation=_act(cfg), has_bias=cfg.get("use_bias", True),
        depth_multiplier=dw.shape[3])
    p = {"W": dw}
    if cfg.get("use_bias", True) and len(weights) > 1:
        p["b"] = weights[1]
    return lc, p


@KerasLayerMapper.register("SeparableConv2D")
def _separable(cfg, weights):
    k = _pair(cfg["kernel_size"])
    dw, pw = weights[0], weights[1]  # (kh,kw,C,mult), (1,1,C*mult,out)
    lc = C.SeparableConvolution2D(
        n_in=dw.shape[2], n_out=pw.shape[3], kernel=k,
        stride=_pair(cfg.get("strides", 1)),
        convolution_mode=cfg.get("padding", "valid"),
        activation=_act(cfg), has_bias=cfg.get("use_bias", True),
        depth_multiplier=dw.shape[3])
    p = {"dW": dw, "pW": pw}
    if cfg.get("use_bias", True) and len(weights) > 2:
        p["b"] = weights[2]
    return lc, p


@KerasLayerMapper.register("Conv2DTranspose")
def _deconv(cfg, weights):
    k = _pair(cfg["kernel_size"])
    w = weights[0]  # keras: (kh, kw, out, in) → ours: (kh, kw, in, out)
    lc = C.Deconvolution2D(
        n_in=w.shape[3], n_out=w.shape[2], kernel=k,
        stride=_pair(cfg.get("strides", 1)),
        convolution_mode=cfg.get("padding", "valid"),
        activation=_act(cfg), has_bias=cfg.get("use_bias", True))
    p = {"W": w.transpose(0, 1, 3, 2)}
    if cfg.get("use_bias", True) and len(weights) > 1:
        p["b"] = weights[1]
    return lc, p


@KerasLayerMapper.register("GlobalMaxPooling2D")
def _gmp(cfg, weights):
    return C.GlobalPoolingLayer(pooling_type="max"), {}


@KerasLayerMapper.register("UpSampling2D")
def _upsampling(cfg, weights):
    return C.Upsampling2D(size=_pair(cfg.get("size", 2))), {}


@KerasLayerMapper.register("SimpleRNN")
def _simple_rnn(cfg, weights):
    w, rw, b = weights[0], weights[1], (weights[2] if len(weights) > 2
                                        else np.zeros(weights[0].shape[1]))
    lc = C.SimpleRnn(n_in=w.shape[0], n_out=w.shape[1],
                     activation=_act(cfg))
    return lc, {"W": w, "RW": rw, "b": b}


@KerasLayerMapper.register("Bidirectional")
def _bidirectional(cfg, weights):
    inner_spec = cfg["layer"]
    if inner_spec["class_name"] != "LSTM":
        raise NotImplementedError(
            f"Bidirectional({inner_spec['class_name']}) import")
    half = len(weights) // 2
    inner_cfg = inner_spec["config"]
    fwd_lc, fwd_p = _lstm(inner_cfg, weights[:half])
    _, bwd_p = _lstm(inner_cfg, weights[half:])
    merge = cfg.get("merge_mode", "concat")
    mode = {"sum": "add", "ave": "average", "mul": "mul",
            "concat": "concat", "add": "add", "average": "average"}.get(merge)
    if mode is None:
        raise NotImplementedError(
            f"Bidirectional merge_mode={merge!r} import (None means "
            "two-output mode, which MultiLayerNetwork cannot represent)")
    lc = C.Bidirectional(fwd=fwd_lc.to_dict(), mode=mode)
    return lc, {"fwd": fwd_p, "bwd": bwd_p}


@KerasLayerMapper.register("LeakyReLU")
def _leaky_relu(cfg, weights):
    # keras defaults alpha=0.3 (ours 0.01) — bind the exact slope as a
    # callable activation (get_activation passes callables through)
    import functools

    from deeplearning4j_tpu_torch.ops.activations import leakyrelu

    alpha = float(cfg.get("negative_slope", cfg.get("alpha", 0.3)))
    return C.ActivationLayer(
        activation=functools.partial(leakyrelu, alpha=alpha)), {}


@KerasLayerMapper.register("ReLU")
def _relu_layer(cfg, weights):
    if cfg.get("max_value") not in (None, 0) or cfg.get("threshold", 0):
        raise NotImplementedError("ReLU with max_value/threshold import")
    slope = float(cfg.get("negative_slope", 0) or 0)
    if slope:
        import functools

        from deeplearning4j_tpu_torch.ops.activations import leakyrelu

        return C.ActivationLayer(
            activation=functools.partial(leakyrelu, alpha=slope)), {}
    return C.ActivationLayer(activation="relu"), {}


@KerasLayerMapper.register("ELU")
def _elu_layer(cfg, weights):
    return C.ActivationLayer(activation="elu"), {}


@KerasLayerMapper.register("Softmax")
def _softmax_layer(cfg, weights):
    return C.ActivationLayer(activation="softmax"), {}


@KerasLayerMapper.register("SpatialDropout2D")
def _spatial_dropout(cfg, weights):
    return C.DropoutLayer(rate=float(cfg.get("rate", 0.5)),
                          mode="spatial", name=cfg.get("name")), {}


@KerasLayerMapper.register("GaussianDropout")
def _gaussian_dropout(cfg, weights):
    return C.DropoutLayer(rate=float(cfg.get("rate", 0.5)),
                          mode="gaussian", name=cfg.get("name")), {}


# ---------------------------------------------------------------------------
# Reading the files (Hdf5Archive.java's role), through the port's HDF5 reader
# ---------------------------------------------------------------------------


def read_keras_h5(path):
    """A legacy Keras ``.h5`` file (path or bytes) → (model_config dict,
    {layer_name: [weight arrays in weight_names order]}), the two pieces
    the reference's Hdf5Archive reads."""
    with hdf5.File(path) as f:
        raw = f.attrs["model_config"]
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8")
        config = json.loads(raw)
        weights: Dict[str, List[np.ndarray]] = {}
        mw = f["model_weights"]
        for lname in mw:
            g = mw[lname]
            names = [n.decode() if isinstance(n, bytes) else str(n)
                     for n in g.attrs.get("weight_names", [])]
            arrs = []
            for n in names:
                node = g[n] if n in g else f["model_weights"][n]
                arrs.append(np.asarray(node))
            weights[lname] = arrs
    return config, weights


def _layer_specs_from_config(config):
    """[(class_name, layer_cfg, layer_name)] from a Sequential config."""
    out = []
    for entry in config["config"]["layers"]:
        cls = entry["class_name"]
        cfg = entry.get("config", {})
        out.append((cls, cfg, cfg.get("name", entry.get("name", ""))))
    return out


def _infer_input_type_from_shape(shape):
    shape = tuple(shape)
    if len(shape) == 2:
        return C.InputType.feed_forward(shape[1])
    if len(shape) == 4:
        return C.InputType.convolutional(shape[1], shape[2], shape[3])
    if len(shape) == 3:
        # keep the static sequence length when keras declares one — layers
        # like Permute/LocallyConnected1D need it for shape inference
        return C.InputType.recurrent(shape[2], shape[1] or -1)
    if len(shape) == 5:
        return C.InputType.convolutional3d(shape[1], shape[2], shape[3],
                                           shape[4])
    raise ValueError(f"cannot infer InputType from {shape}")


def import_keras_sequential_config(config, weights_map,
                                   validate: bool = False, device=None):
    """Sequential model_config + weights dict → MultiLayerNetwork (the
    file path; shares _assemble_sequential with the live-model path)."""
    specs = []
    input_shape = None
    for cls, cfg, name in _layer_specs_from_config(config):
        if cls == "InputLayer":
            input_shape = cfg.get("batch_shape") or cfg.get("batch_input_shape")
            continue
        if input_shape is None and "batch_input_shape" in cfg:
            input_shape = cfg["batch_input_shape"]
        specs.append((cls, cfg, weights_map.get(name, [])))
    return _assemble_sequential(
        specs, _infer_input_type_from_shape(input_shape), validate=validate,
        device=device)


# ---------------------------------------------------------------------------
# Functional-API import → ComputationGraph (KerasModel.java analog)
# ---------------------------------------------------------------------------

_MERGE_LAYERS = {
    "Add": ("elementwise", "add"),
    "Subtract": ("elementwise", "subtract"),
    "Multiply": ("elementwise", "product"),
    "Average": ("elementwise", "average"),
    "Maximum": ("elementwise", "max"),
    "Minimum": ("elementwise", "min"),
    "Concatenate": ("merge", None),
}


def _inbound_names(layer) -> List[str]:
    """Input layer-names of a functional-config layer — handles both the
    keras-3 __keras_tensor__ args form and the legacy nested-list form."""
    names: List[str] = []

    def walk(o):
        if isinstance(o, dict):
            if o.get("class_name") == "__keras_tensor__":
                names.append(o["config"]["keras_history"][0])
            else:
                for v in o.values():
                    walk(v)
        elif isinstance(o, (list, tuple)):
            if (len(o) >= 3 and isinstance(o[0], str)
                    and isinstance(o[1], int)):
                names.append(o[0])  # legacy ["name", node_idx, tensor_idx, {}]
            else:
                for v in o:
                    walk(v)

    walk(layer.get("inbound_nodes") or [])
    return names


def _out_names(spec) -> List[str]:
    """Normalize input_layers/output_layers: 'n' | ['n',0,0] | [['n',0,0],…]."""
    if isinstance(spec, str):
        return [spec]
    if (isinstance(spec, (list, tuple)) and spec
            and isinstance(spec[0], str)):
        return [spec[0]]
    return [s[0] if isinstance(s, (list, tuple)) else s for s in (spec or [])]


def import_keras_functional_config(config, weights_map,
                                   validate: bool = False, device=None):
    """Functional model_config + weights → ComputationGraph."""
    from deeplearning4j_tpu_torch.nn import graph as G

    _check_validate(validate)
    gcfg = config["config"]
    gb = G.graph_builder()
    params_by_name: Dict[str, Dict[str, Any]] = {}
    input_types: Dict[str, Any] = {}

    for entry in gcfg["layers"]:
        cls = entry["class_name"]
        cfg = entry.get("config", {})
        name = cfg.get("name", entry.get("name", ""))
        inputs = _inbound_names(entry)
        if cls == "InputLayer":
            shape = cfg.get("batch_shape") or cfg.get("batch_input_shape")
            gb.add_inputs(name)
            input_types[name] = _infer_input_type_from_shape(shape)
            continue
        if cls in _MERGE_LAYERS:
            kind, op = _MERGE_LAYERS[cls]
            if kind == "merge":
                gb.add_vertex(name, G.MergeVertex(), *inputs)
            else:
                gb.add_vertex(name, G.ElementWiseVertex(op=op), *inputs)
            continue
        if cls == "Dot":
            axes = cfg.get("axes", -1)
            if isinstance(axes, (list, tuple)):
                if len(set(axes)) != 1:
                    raise NotImplementedError(
                        "Dot merge with differing per-input axes import")
                axes = axes[0]
            gb.add_vertex(name, G.DotProductVertex(
                axes=int(axes), normalize=bool(cfg.get("normalize", False))),
                *inputs)
            continue
        if cls == "Flatten":
            # our conv activations are NHWC like keras's — a batch-preserving
            # flatten keeps keras Dense weight order (no CHW reorder needed)
            gb.add_vertex(name, G.FlattenVertex(), *inputs)
            continue
        mapper = KerasLayerMapper.MAPPERS.get(cls)
        if mapper is None:
            raise NotImplementedError(
                f"Keras layer '{cls}' has no import mapper (functional)")
        out = mapper(cfg, weights_map.get(name, []))
        if isinstance(out, list):
            if len(out) != 1:
                raise NotImplementedError(
                    f"Keras layer '{cls}' ({name}) expands to {len(out)} "
                    f"layers (StackedRNNCells) — supported in Sequential "
                    f"models only; restructure the functional graph with "
                    f"explicit RNN layers")
            out = out[0]
        lc, p = out
        state = {}
        if isinstance(p, dict) and "__params__" in p:
            state = p["__state__"]
            p = p["__params__"]
        gb.add_layer(name, lc, *inputs)
        params_by_name[name] = {"params": p, "state": state}

    for out in _out_names(gcfg.get("output_layers")):
        gb.set_outputs(out)
    gb.set_input_types(**input_types)
    net = G.ComputationGraph(gb.build(), device=device).init()
    dev = net.device
    for name, blob in params_by_name.items():
        for k, w in blob["params"].items():
            net.params[name][k] = _graft(w, dev)
        for k, v in blob["state"].items():
            net.net_state[name][k] = _leaf(v, dev)
    return net


def _read(path):
    """(config, weights) of a ``.keras`` zip or a legacy ``.h5`` file,
    given as a path or bytes."""
    probe = io.BytesIO(path) if isinstance(path, (bytes, bytearray)) \
        else path
    if zipfile.is_zipfile(probe):
        return read_keras_v3(path)
    return read_keras_h5(path)


def import_keras_model_and_weights(path, validate: bool = False,
                                   device=None):
    """KerasModelImport.importKerasModelAndWeights: a legacy ``.h5`` or a
    Keras-3 ``.keras`` zip (path or bytes), read by the port's own
    parsing; Sequential → MultiLayerNetwork, Functional →
    ComputationGraph, on ``device`` (the card when None)."""
    config, weights = _read(path)
    if config.get("class_name") == "Sequential":
        return import_keras_sequential_config(config, weights,
                                              validate=validate,
                                              device=device)
    return import_keras_functional_config(config, weights,
                                          validate=validate, device=device)


# layer classes that legitimately save no weight group in a .keras zip
_WEIGHTLESS_KERAS_LAYERS = {
    "InputLayer", "Dropout", "SpatialDropout1D", "SpatialDropout2D",
    "SpatialDropout3D", "Flatten", "Reshape", "Permute", "RepeatVector",
    "Activation", "ActivityRegularization", "Masking", "Lambda",
    "Add", "Subtract", "Multiply", "Average", "Maximum", "Minimum",
    "Concatenate", "Dot", "MaxPooling1D", "MaxPooling2D", "MaxPooling3D",
    "AveragePooling1D", "AveragePooling2D", "AveragePooling3D",
    "GlobalMaxPooling1D", "GlobalMaxPooling2D", "GlobalMaxPooling3D",
    "GlobalAveragePooling1D", "GlobalAveragePooling2D",
    "GlobalAveragePooling3D", "UpSampling1D", "UpSampling2D", "UpSampling3D",
    "ZeroPadding1D", "ZeroPadding2D", "ZeroPadding3D", "Cropping1D",
    "Cropping2D", "Cropping3D", "Resizing", "CenterCrop", "Rescaling",
    "GaussianNoise", "GaussianDropout", "AlphaDropout",
    "LeakyReLU", "ELU", "ThresholdedReLU", "ReLU", "Softmax",
}


def _keras_snake_case(name: str) -> str:
    """Keras's to_snake_case: the rule behind .keras weight-group names."""
    import re

    name = re.sub(r"\W+", "", name)
    name = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z])([A-Z])", r"\1_\2", name).lower()


def read_keras_v3(path):
    """A Keras-3 ``.keras`` zip (config.json + model.weights.h5; path or
    bytes) without Keras. Weight groups are keyed by snake_case(class
    name) with a per-class counter in model order (not layer.name), so
    the mapping is re-derived from the config's layer sequence. Returns
    (model_config, weights keyed by the config's layer names). Sub-layer
    groups are taken as the JAX importer takes them: ``cell``,
    ``forward_layer``, ``backward_layer`` first, the others in sorted
    order (for MultiHeadAttention that is key, output, query, value, which
    the mapper does not expect: ROADMAP.md, "Not port faults")."""
    src = io.BytesIO(path) if isinstance(path, (bytes, bytearray)) else path
    with zipfile.ZipFile(src) as z:
        config = json.loads(z.read("config.json"))
        h5bytes = z.read("model.weights.h5")

    weights_map: Dict[str, List[np.ndarray]] = {}
    with hdf5.File(h5bytes) as h:
        layers_grp = h.get("layers")
        counters: Dict[str, int] = {}
        for entry in config.get("config", {}).get("layers", []):
            cls = entry.get("class_name", "")
            name = entry.get("config", {}).get("name", cls)
            snake = _keras_snake_case(cls)
            idx = counters.get(snake, 0)
            counters[snake] = idx + 1
            gname = snake if idx == 0 else f"{snake}_{idx}"
            if layers_grp is None or gname not in layers_grp:
                # a weightless layer (Dropout/Flatten/…) legitimately has no
                # group; for anything else a naming divergence from keras's
                # saving_lib would silently leave the layer on random init —
                # warn loudly
                if cls not in _WEIGHTLESS_KERAS_LAYERS:
                    warnings.warn(
                        f"keras-3 import: no weight group '{gname}' in "
                        f"model.weights.h5 for layer '{name}' ({cls}); the "
                        f"layer will use random initialization", stacklevel=2)
                continue
            grp = layers_grp[gname]
            ws: List[np.ndarray] = []

            def collect(g):
                # direct vars first, then sublayers in get_weights() order:
                # RNNs store under cell/vars; Bidirectional under
                # forward_layer then backward_layer
                vg = g.get("vars")
                if vg is not None:
                    for k in sorted(vg, key=lambda s: int(s)):
                        ws.append(np.asarray(vg[k]))
                priority = ["cell", "forward_layer", "backward_layer"]
                subs = [s for s in priority if s in g] + sorted(
                    s for s in g
                    if s not in priority and s != "vars"
                    and isinstance(g[s], type(g)))
                for s in subs:
                    collect(g[s])

            collect(grp)
            weights_map[name] = ws
    return config, weights_map


@KerasLayerMapper.register("Conv1D")
def _conv1d(cfg, weights):
    w = weights[0]  # (k, C_in, C_out) — matches our layout
    k = cfg["kernel_size"]
    k = int(k[0] if isinstance(k, (list, tuple)) else k)
    st = cfg.get("strides", 1)
    st = int(st[0] if isinstance(st, (list, tuple)) else st)
    if cfg.get("padding") == "causal":
        raise NotImplementedError("causal Conv1D import")
    lc = C.Convolution1D(
        n_in=w.shape[1], n_out=w.shape[2], kernel=k, stride=st,
        convolution_mode=cfg.get("padding", "valid"),
        dilation=int(np.atleast_1d(cfg.get("dilation_rate", 1))[0]),
        activation=_act(cfg))
    p = {"W": w}
    if cfg.get("use_bias", True) and len(weights) > 1:
        p["b"] = weights[1]
    return lc, p


def _triple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v, v)


@KerasLayerMapper.register("Conv3D")
def _conv3d(cfg, weights):
    w = weights[0]  # (kd, kh, kw, C_in, C_out) — matches our layout
    lc = C.Convolution3D(
        n_in=w.shape[3], n_out=w.shape[4],
        kernel=tuple(int(x) for x in cfg["kernel_size"]),
        stride=tuple(int(x) for x in _triple(cfg.get("strides", (1, 1, 1)))),
        convolution_mode=cfg.get("padding", "valid"),
        activation=_act(cfg))
    p = {"W": w}
    if cfg.get("use_bias", True) and len(weights) > 1:
        p["b"] = weights[1]
    return lc, p


@KerasLayerMapper.register("MaxPooling3D")
def _maxpool3d(cfg, weights):
    return C.Subsampling3DLayer(
        kernel=tuple(int(x) for x in _triple(cfg.get("pool_size", 2))),
        stride=tuple(int(x) for x in _triple(cfg.get("strides")
                                             or cfg.get("pool_size", 2))),
        pooling_type="max"), {}


@KerasLayerMapper.register("AveragePooling3D")
def _avgpool3d(cfg, weights):
    return C.Subsampling3DLayer(
        kernel=tuple(int(x) for x in _triple(cfg.get("pool_size", 2))),
        stride=tuple(int(x) for x in _triple(cfg.get("strides")
                                             or cfg.get("pool_size", 2))),
        pooling_type="avg"), {}


@KerasLayerMapper.register("PReLU")
def _prelu_keras(cfg, weights):
    alpha = weights[0]
    if alpha.ndim > 1:
        if not np.allclose(alpha, alpha.reshape(-1, alpha.shape[-1])[0]):
            raise NotImplementedError(
                "PReLU with non-broadcast (per-position) alpha import")
        alpha = alpha.reshape(-1, alpha.shape[-1])[0]
    lc = C.PReLULayer(n_in=alpha.shape[-1])
    return lc, {"alpha": alpha}


@KerasLayerMapper.register("GlobalAveragePooling1D")
def _gap1d(cfg, weights):
    return C.GlobalPoolingLayer(pooling_type="avg"), {}


@KerasLayerMapper.register("GlobalMaxPooling1D")
def _gmp1d(cfg, weights):
    return C.GlobalPoolingLayer(pooling_type="max"), {}


# ---------------------------------------------------------------------------
# Mapper table, round 3 continued: padding/cropping/upsampling, 1-D pooling,
# Conv3DTranspose, RepeatVector, Masking, TimeDistributed, noise dropouts.
# ---------------------------------------------------------------------------


@KerasLayerMapper.register("ZeroPadding1D")
def _zeropad1d(cfg, weights):
    return C.ZeroPadding1DLayer(padding=_pair(cfg.get("padding", 1))), {}


@KerasLayerMapper.register("ZeroPadding2D")
def _zeropad2d(cfg, weights):
    p = cfg.get("padding", 1)
    if isinstance(p, (list, tuple)):
        (t, b), (l, r) = (_pair(p[0]), _pair(p[1]))
    else:
        t = b = l = r = int(p)
    return C.ZeroPaddingLayer(padding=(t, b, l, r)), {}


@KerasLayerMapper.register("ZeroPadding3D")
def _zeropad3d(cfg, weights):
    p = cfg.get("padding", 1)
    if isinstance(p, (list, tuple)):
        (a, b), (c, d), (e, f) = (_pair(p[0]), _pair(p[1]), _pair(p[2]))
    else:
        a = b = c = d = e = f = int(p)
    return C.ZeroPadding3DLayer(padding=(a, b, c, d, e, f)), {}


@KerasLayerMapper.register("Cropping1D")
def _crop1d(cfg, weights):
    return C.Cropping1D(cropping=_pair(cfg.get("cropping", 1))), {}


@KerasLayerMapper.register("Cropping2D")
def _crop2d(cfg, weights):
    p = cfg.get("cropping", 1)
    if isinstance(p, (list, tuple)):
        (t, b), (l, r) = (_pair(p[0]), _pair(p[1]))
    else:
        t = b = l = r = int(p)
    return C.Cropping2D(cropping=(t, b, l, r)), {}


@KerasLayerMapper.register("Cropping3D")
def _crop3d(cfg, weights):
    p = cfg.get("cropping", 1)
    if isinstance(p, (list, tuple)):
        (a, b), (c, d), (e, f) = (_pair(p[0]), _pair(p[1]), _pair(p[2]))
    else:
        a = b = c = d = e = f = int(p)
    return C.Cropping3D(cropping=(a, b, c, d, e, f)), {}


@KerasLayerMapper.register("UpSampling1D")
def _upsampling1d(cfg, weights):
    return C.Upsampling1D(size=int(cfg.get("size", 2))), {}


@KerasLayerMapper.register("UpSampling3D")
def _upsampling3d(cfg, weights):
    return C.Upsampling3D(size=_triple(cfg.get("size", 2))), {}


@KerasLayerMapper.register("MaxPooling1D")
def _maxpool1d(cfg, weights):
    ps = cfg.get("pool_size", 2)
    ps = int(ps[0] if isinstance(ps, (list, tuple)) else ps)
    st = cfg.get("strides") or ps
    st = int(st[0] if isinstance(st, (list, tuple)) else st)
    return C.Subsampling1DLayer(
        kernel=ps, stride=st, pooling_type="max",
        convolution_mode=cfg.get("padding", "valid")), {}


@KerasLayerMapper.register("AveragePooling1D")
def _avgpool1d(cfg, weights):
    ps = cfg.get("pool_size", 2)
    ps = int(ps[0] if isinstance(ps, (list, tuple)) else ps)
    st = cfg.get("strides") or ps
    st = int(st[0] if isinstance(st, (list, tuple)) else st)
    return C.Subsampling1DLayer(
        kernel=ps, stride=st, pooling_type="avg",
        convolution_mode=cfg.get("padding", "valid")), {}


@KerasLayerMapper.register("GlobalAveragePooling3D")
def _gap3d(cfg, weights):
    return C.GlobalPoolingLayer(pooling_type="avg"), {}


@KerasLayerMapper.register("GlobalMaxPooling3D")
def _gmp3d(cfg, weights):
    return C.GlobalPoolingLayer(pooling_type="max"), {}


@KerasLayerMapper.register("Conv3DTranspose")
def _deconv3d(cfg, weights):
    w = weights[0]  # keras: (kd, kh, kw, out, in) → ours: (kd, kh, kw, in, out)
    lc = C.Deconvolution3D(
        n_in=w.shape[4], n_out=w.shape[3],
        kernel=tuple(int(x) for x in cfg["kernel_size"]),
        stride=tuple(int(x) for x in _triple(cfg.get("strides", (1, 1, 1)))),
        convolution_mode=cfg.get("padding", "valid"),
        activation=_act(cfg))
    p = {"W": w.transpose(0, 1, 2, 4, 3)}
    if cfg.get("use_bias", True) and len(weights) > 1:
        p["b"] = weights[1]
    return lc, p


@KerasLayerMapper.register("RepeatVector")
def _repeat_vector(cfg, weights):
    return C.RepeatVector(n=int(cfg["n"])), {}


@KerasLayerMapper.register("Masking")
def _masking(cfg, weights):
    # keras Masking emits a downstream mask for steps != mask_value; our
    # MaskZeroLayer derives the same mask — wrap an identity layer so the
    # mask propagates through the sequential stack
    return C.MaskZeroLayer(
        underlying=C.ActivationLayer(activation="identity"),
        mask_value=float(cfg.get("mask_value", 0.0))), {"inner": {}}


@KerasLayerMapper.register("TimeDistributed")
def _time_distributed(cfg, weights):
    inner = cfg["layer"]
    if inner["class_name"] != "Dense":
        raise NotImplementedError(
            f"TimeDistributed({inner['class_name']}) import — only Dense is "
            "time-broadcastable in a sequential stack")
    # our DenseLayer broadcasts over (N, T, F) natively
    return KerasLayerMapper.MAPPERS["Dense"](inner["config"], weights)


@KerasLayerMapper.register("SpatialDropout1D")
@KerasLayerMapper.register("SpatialDropout3D")
def _spatial_dropout_1d3d(cfg, weights):
    # mask broadcasts over every non-batch, non-channel dim, so one
    # spatial mode covers 1D/2D/3D (KerasSpatialDropout analog)
    return C.DropoutLayer(rate=float(cfg.get("rate", 0.5)),
                          mode="spatial", name=cfg.get("name")), {}


@KerasLayerMapper.register("AlphaDropout")
def _alpha_dropout(cfg, weights):
    return C.DropoutLayer(rate=float(cfg.get("rate", 0.5)),
                          mode="alpha", name=cfg.get("name")), {}


@KerasLayerMapper.register("GaussianNoise")
def _gaussian_noise(cfg, weights):
    # train-time-only additive noise: identity at inference (import targets
    # inference parity; DL4J maps this to its GaussianNoise IDropout the
    # same way)
    return C.ActivationLayer(activation="identity"), {}


def register_custom_layer(name: str):
    """KerasLayer.registerCustomLayer analog — decorate a mapper
    ``fn(cfg, weights) -> (LayerConf, params)`` for a custom Keras layer
    class name so import resolves it like a built-in:

        @register_custom_layer("MyAttention")
        def _my_attention(cfg, weights):
            return C.SelfAttentionLayer(...), {"Wq": weights[0], ...}
    """
    return KerasLayerMapper.register(name)


@KerasLayerMapper.register("GRU")
def _gru(cfg, weights):
    """Keras GRU (reset_after=True, the TF2 default) → C.GRU. Keras gate
    order is [z, r, h]; ours (the gru_cell op / PyTorch convention) is
    [r, z, n] — columns reorder, and the (2, 3H) bias splits into the
    input/recurrent halves."""
    if not cfg.get("reset_after", True):
        raise NotImplementedError(
            "GRU import with reset_after=False (legacy CuDNN-incompatible "
            "variant) — re-export with reset_after=True")
    if cfg.get("go_backwards", False):
        raise NotImplementedError("GRU import with go_backwards=True")
    if _act(cfg) != "tanh" or _ACT_MAP.get(
            cfg.get("recurrent_activation", "sigmoid"),
            cfg.get("recurrent_activation")) != "sigmoid":
        raise NotImplementedError(
            "GRU import requires tanh/sigmoid activations (gru_cell ABI)")
    units = cfg["units"]
    kernel, recurrent = weights[0], weights[1]
    if cfg.get("use_bias", True) and len(weights) > 2:
        b = np.asarray(weights[2])  # reset_after=True ⇒ always (2, 3H)
        b_in, b_rec = b[0], b[1]
    else:
        b_in = np.zeros(3 * units, np.float32)
        b_rec = np.zeros(3 * units, np.float32)

    def regate(w):
        z, r, h = np.split(w, 3, axis=-1)
        return np.concatenate([r, z, h], axis=-1)

    lc = C.GRU(n_in=kernel.shape[0], n_out=units, name=cfg.get("name"))
    p = {"W": regate(kernel), "RW": regate(recurrent),
         "b": regate(b_in), "rb": regate(b_rec)}
    if not cfg.get("return_sequences", False):
        # keras default emits the LAST step only → wrap in LastTimeStep
        return C.LastTimeStep(fwd=lc.to_dict(), name=cfg.get("name")), \
            {"inner": p}
    return lc, p


# ---------------------------------------------------------------------------
# Widened mapper table (round 4): normalization, shape ops, ConvLSTM2D,
# locally-connected, attention, preprocessing layers — toward the
# reference's ~100 KerasLayer mappers (SURVEY §3.3).
# ---------------------------------------------------------------------------


@KerasLayerMapper.register("LayerNormalization")
def _layer_norm(cfg, weights):
    axis = cfg.get("axis", -1)
    if isinstance(axis, (list, tuple)):
        if len(axis) != 1:
            raise NotImplementedError("LayerNormalization over multiple axes")
        axis = axis[0]
    if axis not in (-1,):
        raise NotImplementedError("LayerNormalization import requires the "
                                  "trailing axis (keras default)")
    lc = C.LayerNormalization(eps=float(cfg.get("epsilon", 1e-3)),
                              activation="identity", name=cfg.get("name"))
    p = {}
    idx = 0
    if cfg.get("scale", True):
        p["gain"] = weights[idx]; idx += 1
    if cfg.get("center", True):
        p["b"] = weights[idx]
    return lc, p


@KerasLayerMapper.register("GroupNormalization")
def _group_norm(cfg, weights):
    if cfg.get("axis", -1) not in (-1,):
        raise NotImplementedError("GroupNormalization import requires the "
                                  "trailing (channels_last) axis")
    lc = C.GroupNormalization(groups=int(cfg.get("groups", 32)),
                              eps=float(cfg.get("epsilon", 1e-3)),
                              activation="identity", name=cfg.get("name"))
    p = {}
    idx = 0
    if cfg.get("scale", True):
        p["gamma"] = weights[idx]; idx += 1
    if cfg.get("center", True):
        p["beta"] = weights[idx]
    return lc, p


@KerasLayerMapper.register("Permute")
def _permute(cfg, weights):
    return C.PermuteLayer(dims=tuple(cfg["dims"]), name=cfg.get("name")), {}


@KerasLayerMapper.register("Reshape")
def _reshape_layer(cfg, weights):
    return C.ReshapeLayer(target_shape=tuple(cfg["target_shape"]),
                          name=cfg.get("name")), {}


@KerasLayerMapper.register("UnitNormalization")
def _unit_norm(cfg, weights):
    return C.UnitNormLayer(name=cfg.get("name")), {}


@KerasLayerMapper.register("Rescaling")
def _rescaling(cfg, weights):
    return C.RescaleLayer(scale=cfg.get("scale", 1.0),
                          offset=cfg.get("offset", 0.0),
                          name=cfg.get("name")), {}


@KerasLayerMapper.register("Normalization")
def _normalization(cfg, weights):
    # adapted Normalization stores mean/variance as weights [mean, var(, count)]
    if len(weights) >= 2:
        mean, var = np.asarray(weights[0]), np.asarray(weights[1])
    else:
        mean = np.asarray(cfg.get("mean", 0.0))
        var = np.asarray(cfg.get("variance", 1.0))
    inv = 1.0 / np.sqrt(var + 1e-12)
    return C.RescaleLayer(scale=inv.tolist(), offset=(-mean * inv).tolist(),
                          name=cfg.get("name")), {}


@KerasLayerMapper.register("ThresholdedReLU")
def _thresholded_relu(cfg, weights):
    if float(cfg.get("theta", 1.0)) != 1.0:
        raise NotImplementedError("ThresholdedReLU import with theta != 1.0")
    return C.ActivationLayer(activation="thresholdedrelu",
                             name=cfg.get("name")), {}


@KerasLayerMapper.register("ActivityRegularization")
def _activity_reg(cfg, weights):
    import warnings

    warnings.warn("ActivityRegularization imports as identity: activation "
                  "penalties do not transfer (inference parity only)",
                  stacklevel=2)
    return C.ActivationLayer(activation="identity", name=cfg.get("name")), {}


@KerasLayerMapper.register("Identity")
def _identity_layer(cfg, weights):
    return C.ActivationLayer(activation="identity", name=cfg.get("name")), {}


# train-time data-augmentation layers: identity at inference by definition
for _aug in ("RandomFlip", "RandomRotation", "RandomZoom",
             "RandomTranslation", "RandomContrast", "RandomBrightness"):
    def _aug_mapper(cfg, weights, _cls=_aug):
        import warnings

        warnings.warn(f"{_cls} imports as identity (augmentation is "
                      "train-time only; re-augment in your input pipeline)",
                      stacklevel=2)
        return C.ActivationLayer(activation="identity",
                                 name=cfg.get("name")), {}

    KerasLayerMapper.register(_aug)(_aug_mapper)


@KerasLayerMapper.register("LocallyConnected1D")
def _locally_connected_1d(cfg, weights):
    lc = C.LocallyConnected1D(
        n_out=int(cfg["filters"]),
        kernel=int(cfg["kernel_size"][0] if isinstance(cfg["kernel_size"],
                                                       (list, tuple))
                   else cfg["kernel_size"]),
        stride=int(cfg.get("strides", [1])[0] if isinstance(
            cfg.get("strides", 1), (list, tuple)) else cfg.get("strides", 1)),
        activation=_act(cfg), name=cfg.get("name"))
    p = {"W": weights[0]}
    if cfg.get("use_bias", True) and len(weights) > 1:
        p["b"] = weights[1]
    return lc, p


@KerasLayerMapper.register("LocallyConnected2D")
def _locally_connected_2d(cfg, weights):
    if cfg.get("padding", "valid") != "valid":
        raise NotImplementedError("LocallyConnected2D 'same' padding import")
    kh, kw = _pair(cfg["kernel_size"])
    lc = C.LocallyConnected2D(
        n_out=int(cfg["filters"]), kernel=(kh, kw),
        stride=_pair(cfg.get("strides", 1)), activation=_act(cfg),
        name=cfg.get("name"))
    w = np.asarray(weights[0])  # (oh*ow, kh*kw*cin, filters), (kh,kw,C) order
    pos, feat, fo = w.shape
    cin = feat // (kh * kw)
    # our impl consumes conv_general_dilated_patches features in (C, kh, kw)
    # order — permute the keras (kh, kw, C) flatten accordingly
    w = w.reshape(pos, kh, kw, cin, fo).transpose(0, 3, 1, 2, 4)
    p = {"W": w.reshape(pos, feat, fo)}
    if cfg.get("use_bias", True) and len(weights) > 1:
        p["b"] = weights[1]
    return lc, p


@KerasLayerMapper.register("ConvLSTM2D")
def _conv_lstm_2d(cfg, weights):
    if cfg.get("go_backwards", False):
        raise NotImplementedError("ConvLSTM2D with go_backwards=True")
    if _pair(cfg.get("dilation_rate", 1)) != (1, 1):
        raise NotImplementedError("ConvLSTM2D import with dilation_rate != 1")
    strides = cfg.get("strides", (1, 1))
    if _pair(strides) != (1, 1):
        raise NotImplementedError("ConvLSTM2D import with strides != 1")
    lc = C.ConvLSTM2D(
        filters=int(cfg["filters"]), kernel=_pair(cfg["kernel_size"]),
        padding="same" if cfg.get("padding", "valid") == "same" else "truncate",
        return_sequences=bool(cfg.get("return_sequences", False)),
        activation=_ACT_MAP.get(cfg.get("activation", "tanh"), "tanh"),
        gate_activation=_ACT_MAP.get(cfg.get("recurrent_activation",
                                             "hard_sigmoid"), "hardsigmoid"),
        name=cfg.get("name"))

    def regate(w):
        i, f, c, o = np.split(w, 4, axis=-1)  # keras i,f,c,o -> ours i,f,o,g
        return np.concatenate([i, f, o, c], axis=-1)

    p = {"W": regate(weights[0]), "RW": regate(weights[1])}
    if cfg.get("use_bias", True) and len(weights) > 2:
        p["b"] = regate(weights[2])
    return lc, p


@KerasLayerMapper.register("SeparableConv1D")
def _separable_conv1d(cfg, weights):
    dil = cfg.get("dilation_rate", 1)
    if int(dil[0] if isinstance(dil, (list, tuple)) else dil) != 1:
        raise NotImplementedError("SeparableConv1D import with dilation_rate != 1")
    k = cfg["kernel_size"]
    k = int(k[0] if isinstance(k, (list, tuple)) else k)
    s = cfg.get("strides", 1)
    s = int(s[0] if isinstance(s, (list, tuple)) else s)
    lc = C.SeparableConvolution1D(
        n_out=int(cfg["filters"]), kernel=k, stride=s,
        convolution_mode="same" if cfg.get("padding", "valid") == "same"
        else "truncate",
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        activation=_act(cfg), has_bias=cfg.get("use_bias", True),
        name=cfg.get("name"))
    dw = np.asarray(weights[0])  # keras (k, cin, mult)
    kk, cin, mult = dw.shape
    p = {"dW": dw.reshape(kk, 1, cin * mult),
         "pW": np.asarray(weights[1])}  # (1, cin*mult, cout)
    if cfg.get("use_bias", True) and len(weights) > 2:
        p["b"] = weights[2]
    return lc, p


_KERAS_LAMBDAS: Dict[str, Any] = {}


def register_lambda(name: str, layer_conf_factory):
    """KerasLambda parity: the reference requires user-registered lambda
    implementations (KerasLayer.registerLambdaLayer). Register a factory
    ``fn(cfg, weights) -> (LayerConf, params)`` under the Lambda layer's
    NAME."""
    _KERAS_LAMBDAS[name] = layer_conf_factory
    return layer_conf_factory


@KerasLayerMapper.register("Lambda")
def _lambda_layer(cfg, weights):
    name = cfg.get("name")
    factory = _KERAS_LAMBDAS.get(name)
    if factory is None:
        raise NotImplementedError(
            f"Keras Lambda layer '{name}' needs a registered implementation "
            f"— call keras_import.register_lambda('{name}', factory) first "
            f"(the reference's registerLambdaLayer contract)")
    return factory(cfg, weights)


@KerasLayerMapper.register("MultiHeadAttention")
def _multi_head_attention(cfg, weights):
    """Keras MHA → AttentionVertex (multi-input graph layer; functional
    models wire (query, value[, key]) — keras_order handles the swap).
    Keras kernels (d, H, hd) / (H, hd, d_out) flatten to our 2-D Wq..Wo."""
    heads = int(cfg["num_heads"])
    key_dim = int(cfg["key_dim"])
    value_dim = cfg.get("value_dim")
    if value_dim is not None and int(value_dim) != key_dim:
        raise NotImplementedError(
            "MultiHeadAttention import with value_dim != key_dim")
    d = heads * key_dim
    use_bias = bool(cfg.get("use_bias", True))
    ws = [np.asarray(w) for w in weights]
    if use_bias:
        wq, bq, wk, bk, wv, bv, wo, bo = ws[:8]
    else:
        wq, wk, wv, wo = ws[:4]
        bq = bk = bv = bo = None
    lc = C.AttentionVertex(n_out=d, n_heads=heads, keras_order=True,
                           has_bias=use_bias, d_out=wo.shape[-1],
                           name=cfg.get("name"))
    p = {"Wq": wq.reshape(wq.shape[0], d), "Wk": wk.reshape(wk.shape[0], d),
         "Wv": wv.reshape(wv.shape[0], d), "Wo": wo.reshape(d, wo.shape[-1])}
    if use_bias:
        p.update({"bq": bq.reshape(d), "bk": bk.reshape(d),
                  "bv": bv.reshape(d), "bo": bo.reshape(-1)})
    return lc, p


@KerasLayerMapper.register("Attention")
def _attention_layer(cfg, weights):
    scale = np.asarray(weights[0]) if (cfg.get("use_scale") and weights) \
        else None
    if cfg.get("score_mode", "dot") != "dot":
        raise NotImplementedError("Keras Attention score_mode != 'dot'")
    return C.DotAttentionLayer(use_scale=bool(cfg.get("use_scale", False)),
                               additive=False,
                               scale=None if scale is None else scale.tolist(),
                               name=cfg.get("name")), {}


@KerasLayerMapper.register("AdditiveAttention")
def _additive_attention_layer(cfg, weights):
    scale = np.asarray(weights[0]).tolist() if (cfg.get("use_scale", True)
                                                and weights) else None
    return C.DotAttentionLayer(use_scale=bool(cfg.get("use_scale", True)),
                               additive=True, scale=scale,
                               name=cfg.get("name")), {}


@KerasLayerMapper.register("Conv1DTranspose")
def _conv1d_transpose(cfg, weights):
    dil = cfg.get("dilation_rate", 1)
    if int(dil[0] if isinstance(dil, (list, tuple)) else dil) != 1:
        raise NotImplementedError("Conv1DTranspose import with dilation_rate != 1")
    op = cfg.get("output_padding")
    if op not in (None, [None]) and any(v for v in (op if isinstance(op, (list, tuple)) else [op])):
        raise NotImplementedError("Conv1DTranspose import with output_padding")
    k = cfg["kernel_size"]
    k = int(k[0] if isinstance(k, (list, tuple)) else k)
    s = cfg.get("strides", 1)
    s = int(s[0] if isinstance(s, (list, tuple)) else s)
    w = np.asarray(weights[0])  # keras: (k, out, in)
    lc = C.Deconvolution1D(
        n_in=w.shape[2], n_out=w.shape[1], kernel=k, stride=s,
        convolution_mode="same" if cfg.get("padding", "valid") == "same"
        else "truncate",
        activation=_act(cfg), has_bias=cfg.get("use_bias", True),
        name=cfg.get("name"))
    p = {"W": w.transpose(0, 2, 1)}  # (k, in, out)
    if cfg.get("use_bias", True) and len(weights) > 1:
        p["b"] = weights[1]
    return lc, p


@KerasLayerMapper.register("Resizing")
def _resizing(cfg, weights):
    method = cfg.get("interpolation", "bilinear")
    if method not in ("bilinear", "nearest", "bicubic"):
        raise NotImplementedError(f"Resizing interpolation={method} import")
    if cfg.get("crop_to_aspect_ratio") or cfg.get("pad_to_aspect_ratio"):
        raise NotImplementedError("Resizing with aspect-ratio fitting import")
    return C.ResizeLayer(height=int(cfg["height"]), width=int(cfg["width"]),
                         method=method, name=cfg.get("name")), {}


@KerasLayerMapper.register("CenterCrop")
def _center_crop(cfg, weights):
    return C.CenterCropLayer(height=int(cfg["height"]),
                             width=int(cfg["width"]),
                             name=cfg.get("name")), {}


# ---------------------------------------------------------------------------
# Legacy recurrent forms (round 5, verdict item 9): CuDNNLSTM/CuDNNGRU (the
# tf.keras v1 CuDNN-backed layers common in older h5 files) and the generic
# RNN(cell=...) / StackedRNNCells wrappers. Reference: keras-import's
# KerasLstm/KerasSimpleRnn layer table (SURVEY §3.3).
# ---------------------------------------------------------------------------


@KerasLayerMapper.register("CuDNNLSTM")
def _cudnn_lstm(cfg, weights):
    """CuDNNLSTM ≡ LSTM(activation=tanh, recurrent_activation=sigmoid,
    unit_forget_bias) with a CuDNN weight layout: bias is the (8H,) stack of
    input+recurrent biases (or (2,4H)) — they sum into the standard (4H,)."""
    w = list(weights)
    if len(w) > 2:
        b = np.asarray(w[2])
        units = int(cfg.get("units", 0))
        if b.ndim == 2:                      # (2, 4H)
            b = b[0] + b[1]
        elif b.ndim == 1 and units and b.size == 8 * units:  # (8H,)
            # only an exact 8H stack is the CuDNN input+recurrent pair; a
            # fused (4H,) bias with even H is also divisible by 8 and must
            # pass through unchanged (round-5 advice)
            half = b.size // 2
            b = b[:half] + b[half:]
        w[2] = b
    cfg = dict(cfg)
    cfg.setdefault("activation", "tanh")
    cfg.setdefault("recurrent_activation", "sigmoid")
    return KerasLayerMapper.MAPPERS["LSTM"](cfg, w)


@KerasLayerMapper.register("CuDNNGRU")
def _cudnn_gru(cfg, weights):
    """CuDNNGRU ≡ GRU(reset_after=True, tanh/sigmoid). Bias arrives as
    (6H,) or (2, 3H); the GRU mapper wants the (2, 3H) split form."""
    w = list(weights)
    if len(w) > 2:
        b = np.asarray(w[2])
        if b.ndim == 1:
            b = b.reshape(2, -1)
        w[2] = b
    cfg = dict(cfg)
    cfg.setdefault("activation", "tanh")
    cfg.setdefault("recurrent_activation", "sigmoid")
    cfg["reset_after"] = True
    return KerasLayerMapper.MAPPERS["GRU"](cfg, w)


_RNN_CELL_TO_LAYER = {"LSTMCell": "LSTM", "GRUCell": "GRU",
                      "SimpleRNNCell": "SimpleRNN"}


def _cell_spec(cell):
    cls = cell.get("class_name")
    layer = _RNN_CELL_TO_LAYER.get(cls)
    if layer is None:
        raise NotImplementedError(
            f"RNN(cell={cls}) import: no mapper for this cell type")
    return layer, dict(cell.get("config", {}))


@KerasLayerMapper.register("RNN")
def _rnn_wrapper(cfg, weights):
    """keras.layers.RNN(cell=...) — delegate to the cell's layer mapper
    with the wrapper's sequence semantics (return_sequences/go_backwards).
    StackedRNNCells expands to one layer per cell (weights are concatenated
    in cell order, 3 arrays per cell when biased)."""
    cell = cfg.get("cell") or {}
    if cell.get("class_name") == "StackedRNNCells":
        cells = cell.get("config", {}).get("cells", [])
        out = []
        off = 0
        for ci, c in enumerate(cells):
            layer, ccfg = _cell_spec(c)
            n_w = 3 if ccfg.get("use_bias", True) else 2
            ccfg["name"] = f"{cfg.get('name', 'rnn')}_cell{ci}"
            # every stacked cell but the LAST returns the full sequence
            ccfg["return_sequences"] = (True if ci < len(cells) - 1
                                        else cfg.get("return_sequences", False))
            ccfg["go_backwards"] = cfg.get("go_backwards", False)
            out.append(KerasLayerMapper.MAPPERS[layer](
                ccfg, list(weights[off:off + n_w])))
            off += n_w
        return out  # list of (conf, params) — sequential assembly expands
    layer, ccfg = _cell_spec(cell)
    ccfg["name"] = cfg.get("name")
    ccfg["return_sequences"] = cfg.get("return_sequences", False)
    ccfg["go_backwards"] = cfg.get("go_backwards", False)
    return KerasLayerMapper.MAPPERS[layer](ccfg, weights)


@KerasLayerMapper.register("EinsumDense")
def _einsum_dense(cfg, weights):
    """keras.layers.EinsumDense → C.EinsumDenseLayer (the keras-nlp
    transformer projection)."""
    out_shape = cfg.get("output_shape")
    out_shape = (tuple(out_shape) if isinstance(out_shape, (list, tuple))
                 else (out_shape,))
    # None entries are batch/sequence dims preserved by the equation —
    # only concrete (weight-bearing) dims size the kernel
    out_shape = tuple(s for s in out_shape if s is not None)
    bias_axes = cfg.get("bias_axes")
    lc = C.EinsumDenseLayer(
        equation=cfg["equation"], out_shape=tuple(int(s) for s in out_shape),
        bias_shape=tuple(np.asarray(weights[1]).shape) if
        (bias_axes and len(weights) > 1) else (),
        activation=_act(cfg), name=cfg.get("name"))
    p = {"W": weights[0]}
    if bias_axes and len(weights) > 1:
        p["b"] = weights[1]
    return lc, p


@KerasLayerMapper.register("RandomCrop")
def _random_crop(cfg, weights):
    # keras-3 inference semantics: RandomCrop is a PASSTHROUGH (it only
    # crops in training; keras 2 did an aspect-crop+resize — models that
    # relied on that must resize explicitly). Passthrough keeps parity
    # with the installed keras and fails shapes loudly downstream exactly
    # where keras itself would.
    return C.ActivationLayer(activation="identity",
                              name=cfg.get("name")), {}


def _keras_reject(name, why):
    def mapper(cfg, weights):
        raise NotImplementedError(
            f"Keras layer '{name}': {why}. Apply this preprocessing outside "
            f"the imported graph (DataVec transforms cover the same role).")

    return mapper


for _nm, _why in [
        ("StringLookup", "string-tensor vocabularies are unsupported"),
        ("Hashing", "string hashing is unsupported"),
        ("TextVectorization", "string tokenization inside the graph is "
                              "unsupported (use nlp.wordpiece)")]:
    KerasLayerMapper.MAPPERS[_nm] = _keras_reject(_nm, _why)


@KerasLayerMapper.register("Discretization")
def _discretization(cfg, weights):
    bounds = cfg.get("bin_boundaries") or []
    if not bounds:
        raise NotImplementedError(
            "Discretization without explicit bin_boundaries (adapt()-ed "
            "state) — re-export with the learned boundaries in the config")
    if list(bounds) != sorted(float(b) for b in bounds):
        raise ValueError(
            f"Discretization: bin_boundaries must be ascending, got "
            f"{bounds} (searchsorted semantics require sorted bounds)")
    return C.DiscretizationLayer(
        bin_boundaries=tuple(float(b) for b in bounds),
        name=cfg.get("name")), {}


@KerasLayerMapper.register("CategoryEncoding")
def _category_encoding(cfg, weights):
    mode = cfg.get("output_mode", "multi_hot")
    if mode not in ("one_hot", "multi_hot", "count"):
        raise NotImplementedError(f"CategoryEncoding output_mode={mode}")
    return C.CategoryEncodingLayer(
        num_tokens=int(cfg["num_tokens"]), output_mode=mode,
        name=cfg.get("name")), {}
