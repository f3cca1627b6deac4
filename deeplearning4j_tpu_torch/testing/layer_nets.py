"""The networks of the last fourteen layer types and the Keras transfer
recipe, written once for the CPU tests and for ``chip_smoke.py``.

Every builder takes ``pkg``, a package's ``nn`` module (this port's, or
the reference's in the tests: both have the same builder API), and a
dims dict (:data:`SMALL` for the CPU tests, :data:`CARD` for the card);
:func:`batch` draws a batch with numpy from a seed. The networks:

* ``capsnet`` — Sabour et al. 2017 on 28×28×1 at the card: Conv 256 9×9 →
  PrimaryCapsules(32, 8, 9×9, stride 2) → CapsuleLayer(10, 16, routings
  3) → CapsuleStrengthLayer → a squared-error loss on the strengths;
* ``vae`` — VariationalAutoencoder 784 → 256 → latent 32 → 256 → 784,
  bernoulli, trained by its ELBO (:func:`fit_elbo`; the JAX networks have
  no ELBO fit, so the CPU test holds one step against ``jax.grad`` of its
  ``elbo_loss``);
* ``seq_classifier`` — SelfAttentionLayer → LearnedSelfAttentionLayer →
  average pooling → CenterLossOutputLayer (batch 32 × T 256, width 256,
  4 heads, 8 learned queries at the card: the learned queries reach the
  flash kernels);
* ``recurrent_tagger`` — RecurrentAttentionLayer → RnnOutputLayer (T 64);
* ``mask`` — SimpleRnn → MaskLayer → RnnOutputLayer under a ragged mask;
* ``elementwise`` — Dense → ElementWiseMultiplicationLayer → Output;
* ``frozen_with_backprop`` — Dense → FrozenLayerWithBackprop(Dense) →
  Output;
* ``cnn_loss`` — a 3×3 convolution → CnnLossLayer (per-pixel softmax);
* ``yolo2`` — a 1×1 convolution to 5 × (5 + 20) channels over a 13×13
  grid → Yolo2OutputLayer with TinyYOLO's anchors;
* ``samediff_layer`` — a SameDiffLayer (x·W + b, tanh) → Output.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

NETWORKS = ("capsnet", "vae", "seq_classifier", "recurrent_tagger", "mask",
            "elementwise", "frozen_with_backprop", "cnn_loss", "yolo2",
            "samediff_layer")

# TinyYOLO's anchors (the reference's TinyYOLO, VOC)
TINY_YOLO_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                     (9.42, 5.11), (16.62, 10.52))

SMALL: Dict[str, dict] = {
    "capsnet": dict(batch=3, image=11, conv=4, conv_k=3, primary=2,
                    primary_dim=4, primary_k=3, caps=3, caps_dim=4,
                    routings=3),
    "vae": dict(batch=5, n_in=12, hidden=8, latent=4),
    "seq_classifier": dict(batch=4, t=9, width=8, heads=2, queries=3,
                           classes=3),
    "recurrent_tagger": dict(batch=4, t=9, n_in=8, width=6, heads=2,
                             classes=3),
    "mask": dict(batch=4, t=9, n_in=8, width=6, classes=3),
    "elementwise": dict(batch=5, n_in=6, width=5, classes=3),
    "frozen_with_backprop": dict(batch=5, n_in=6, width=5, classes=3),
    "cnn_loss": dict(batch=3, image=5, channels=2, classes=3),
    "yolo2": dict(batch=2, grid=4, channels=3, anchors=2, classes=3),
    "samediff_layer": dict(batch=4, n_in=6, width=5, classes=3),
}

CARD: Dict[str, dict] = {
    "capsnet": dict(batch=64, image=28, conv=256, conv_k=9, primary=32,
                    primary_dim=8, primary_k=9, caps=10, caps_dim=16,
                    routings=3),
    "vae": dict(batch=64, n_in=784, hidden=256, latent=32),
    "seq_classifier": dict(batch=32, t=256, width=256, heads=4, queries=8,
                           classes=10),
    "recurrent_tagger": dict(batch=32, t=64, n_in=64, width=128, heads=4,
                             classes=8),
    "mask": dict(batch=32, t=64, n_in=64, width=128, classes=8),
    "elementwise": dict(batch=256, n_in=512, width=512, classes=10),
    "frozen_with_backprop": dict(batch=256, n_in=512, width=512,
                                 classes=10),
    "cnn_loss": dict(batch=16, image=64, channels=3, classes=21),
    "yolo2": dict(batch=8, grid=13, channels=1024, anchors=5, classes=20),
    "samediff_layer": dict(batch=256, n_in=512, width=512, classes=10),
}


def samediff_block(sd, x, p):
    """The SameDiffLayer's block: x·W + b (its activation, tanh, is the
    layer's own)."""
    return (x.mmul(p["W"]) + p["b"]).rename("sdl_out")


def build(name: str, pkg, d: dict, updater=None):
    """The configuration of network ``name`` at dims ``d``, built through
    ``pkg``'s builder (seed 7, ``updater`` or Adam 1e-3)."""
    b = pkg.builder().seed(7).updater(
        updater if updater is not None else pkg.Adam(learning_rate=1e-3))
    b = b.list()
    it = pkg.InputType
    out = dict(activation="softmax", loss="mcxent")
    if name == "capsnet":
        (b.layer(pkg.ConvolutionLayer(n_out=d["conv"],
                                      kernel=(d["conv_k"],) * 2,
                                      activation="relu"))
         .layer(pkg.PrimaryCapsules(capsules=d["primary"],
                                    capsule_dim=d["primary_dim"],
                                    kernel=(d["primary_k"],) * 2,
                                    stride=(2, 2)))
         .layer(pkg.CapsuleLayer(capsules=d["caps"], capsule_dim=d["caps_dim"],
                                 routings=d["routings"]))
         .layer(pkg.CapsuleStrengthLayer())
         .layer(pkg.LossLayer(activation="identity", loss="mse"))
         .set_input_type(it.convolutional(d["image"], d["image"], 1)))
    elif name == "vae":
        (b.layer(pkg.VariationalAutoencoder(
            n_in=d["n_in"], n_out=d["latent"],
            encoder_layer_sizes=(d["hidden"],),
            decoder_layer_sizes=(d["hidden"],),
            reconstruction_distribution="bernoulli"))
         .set_input_type(it.feed_forward(d["n_in"])))
    elif name == "seq_classifier":
        w = d["width"]
        (b.layer(pkg.SelfAttentionLayer(n_in=w, n_out=w, n_heads=d["heads"]))
         .layer(pkg.LearnedSelfAttentionLayer(n_in=w, n_out=w,
                                              n_heads=d["heads"],
                                              n_queries=d["queries"]))
         .layer(pkg.GlobalPoolingLayer(pooling_type="avg"))
         .layer(pkg.CenterLossOutputLayer(n_in=w, n_out=d["classes"],
                                          alpha=0.5, lambda_=0.1,
                                          activation="softmax"))
         .set_input_type(it.recurrent(w, d["t"])))
    elif name == "recurrent_tagger":
        (b.layer(pkg.RecurrentAttentionLayer(n_in=d["n_in"],
                                             n_out=d["width"],
                                             n_heads=d["heads"]))
         .layer(pkg.RnnOutputLayer(n_in=d["width"], n_out=d["classes"],
                                   **out))
         .set_input_type(it.recurrent(d["n_in"], d["t"])))
    elif name == "mask":
        (b.layer(pkg.SimpleRnn(n_in=d["n_in"], n_out=d["width"],
                               activation="tanh"))
         .layer(pkg.MaskLayer())
         .layer(pkg.RnnOutputLayer(n_in=d["width"], n_out=d["classes"],
                                   **out))
         .set_input_type(it.recurrent(d["n_in"], d["t"])))
    elif name == "elementwise":
        (b.layer(pkg.DenseLayer(n_in=d["n_in"], n_out=d["width"],
                                activation="tanh"))
         .layer(pkg.ElementWiseMultiplicationLayer(
             n_in=d["width"], n_out=d["width"], activation="relu"))
         .layer(pkg.OutputLayer(n_in=d["width"], n_out=d["classes"], **out))
         .set_input_type(it.feed_forward(d["n_in"])))
    elif name == "frozen_with_backprop":
        inner = pkg.DenseLayer(n_in=d["width"], n_out=d["width"],
                               activation="tanh")
        (b.layer(pkg.DenseLayer(n_in=d["n_in"], n_out=d["width"],
                                activation="tanh"))
         .layer(pkg.FrozenLayerWithBackprop(underlying=inner.to_dict()))
         .layer(pkg.OutputLayer(n_in=d["width"], n_out=d["classes"], **out))
         .set_input_type(it.feed_forward(d["n_in"])))
    elif name == "cnn_loss":
        (b.layer(pkg.ConvolutionLayer(n_out=d["classes"], kernel=(3, 3),
                                      convolution_mode="same",
                                      activation="identity"))
         .layer(pkg.CnnLossLayer(**out))
         .set_input_type(it.convolutional(d["image"], d["image"],
                                          d["channels"])))
    elif name == "yolo2":
        anchors = TINY_YOLO_ANCHORS[:d["anchors"]]
        (b.layer(pkg.ConvolutionLayer(
            n_out=d["anchors"] * (5 + d["classes"]), kernel=(1, 1),
            activation="identity"))
         .layer(pkg.Yolo2OutputLayer(anchors=anchors))
         .set_input_type(it.convolutional(d["grid"], d["grid"],
                                          d["channels"])))
    elif name == "samediff_layer":
        # the reference's nn package does not export SameDiffLayer
        (b.layer(pkg.conf.SameDiffLayer(
            define=samediff_block,
            param_shapes={"W": (d["n_in"], d["width"]), "b": (d["width"],)},
            n_out=d["width"], activation="tanh"))
         .layer(pkg.OutputLayer(n_in=d["width"], n_out=d["classes"], **out))
         .set_input_type(it.feed_forward(d["n_in"])))
    else:
        raise KeyError(name)
    return b.build()


def batch(name: str, d: dict, seed: int = 0):
    """(features, labels, features mask or None) of one batch of network
    ``name`` at dims ``d``, drawn with numpy ``RandomState(seed)``."""
    r = np.random.RandomState(seed)
    n = d["batch"]

    def onehot(k, shape):
        return np.eye(k, dtype=np.float32)[r.randint(0, k, shape)]

    if name == "capsnet":
        return (r.rand(n, d["image"], d["image"], 1).astype(np.float32),
                onehot(d["caps"], n), None)
    if name == "vae":
        return (r.rand(n, d["n_in"]) > 0.5).astype(np.float32), None, None
    if name in ("seq_classifier", "recurrent_tagger", "mask"):
        t = d["t"]
        f = d["width"] if name == "seq_classifier" else d["n_in"]
        x = r.randn(n, t, f).astype(np.float32)
        lengths = np.maximum(t - (np.arange(n) * 3 * t) // (4 * n), 1)
        m = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
        y = (onehot(d["classes"], n) if name == "seq_classifier"
             else onehot(d["classes"], (n, t)))
        return x, y, m
    if name in ("elementwise", "frozen_with_backprop", "samediff_layer"):
        return (r.randn(n, d["n_in"]).astype(np.float32),
                onehot(d["classes"], n), None)
    if name == "cnn_loss":
        return (r.randn(n, d["image"], d["image"], d["channels"]).astype(
            np.float32), onehot(d["classes"], (n, d["image"], d["image"])),
            None)
    if name == "yolo2":
        g, a, c = d["grid"], d["anchors"], d["classes"]
        # backbone features of a modest scale: at unit scale the head's
        # exp(w, h) makes the loss ~1e6
        x = (0.1 * r.randn(n, g, g, d["channels"])).astype(np.float32)
        y = np.zeros((n, g, g, a, 5 + c), np.float32)
        y[..., 0:2] = r.rand(n, g, g, a, 2)
        y[..., 2:4] = r.rand(n, g, g, a, 2) + 0.5
        y[..., 4] = r.rand(n, g, g, a) > 0.8
        y[..., 5:] = onehot(c, (n, g, g, a))
        return x, y, None
    raise KeyError(name)


def fit_elbo(net, x, eps, step: int):
    """One ELBO step of a network whose first layer is the VAE: autograd
    of the layer's negative ELBO (the noise ``eps`` given) and the
    network's update tail (the fused updater on the card). Returns the
    loss (a 0-d tensor). The parameters are rebound (out of place)."""
    import torch

    from deeplearning4j_tpu_torch.nn import multilayer as M

    layer = net.layers[0]
    x = net._feed(x)
    params = M.autograd_leaves(net.params[0])
    with torch.enable_grad():
        loss = layer.elbo_loss(params, x, eps=eps)
        grads = M.grad_tree(loss, params)
    with torch.no_grad():
        ((new_p, new_s),) = M.apply_layer_updates(
            net.conf, [(net.params[0], grads, net.opt_state[0],
                        net.updaters[0], net.conf.layers[0])], step)
    net.params[0], net.opt_state[0] = new_p, new_s
    return loss.detach()


# ---------------------------------------------------------------------------
# the Keras encoder's transfer recipe
# ---------------------------------------------------------------------------


def transfer_keras_encoder(pkg, net, *, freeze_at: str, classes: int,
                           hidden: int, updater):
    """The imported Keras encoder (``testing/keras_builder``) made a
    classifier through ``pkg.graph_transfer_builder``: the 2-way
    ``classifier`` head removed, a softmax ``OutputLayer(hidden →
    classes)`` on ``pooler`` as the new output, everything up to and
    including ``freeze_at`` frozen, and ``updater`` by a
    ``FineTuneConfiguration``."""
    return (pkg.graph_transfer_builder(net)
            .fine_tune_configuration(pkg.FineTuneConfiguration(
                updater=updater))
            .remove_vertex_and_connections("classifier")
            .add_layer("head", pkg.OutputLayer(n_in=hidden, n_out=classes,
                                               activation="softmax",
                                               loss="mcxent"), "pooler")
            .set_feature_extractor(freeze_at)
            .set_outputs("head")
            .build())
