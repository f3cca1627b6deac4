"""The last fourteen layer types of the PyTorch port against the JAX
package (CPU): SelfAttentionLayer, LearnedSelfAttentionLayer,
RecurrentAttentionLayer, VariationalAutoencoder, CnnLossLayer, MaskLayer,
ElementWiseMultiplicationLayer, FrozenLayerWithBackprop,
CenterLossOutputLayer, Yolo2OutputLayer, PrimaryCapsules, CapsuleLayer,
CapsuleStrengthLayer and SameDiffLayer.

Each case is a small MultiLayerNetwork built by one builder through both
packages' API; the JAX package draws the parameters and they are carried
across (``init(params=...)``); inputs are drawn with numpy. A case holds
the network's output, the gradients of a fixed projection
``sum(output · c)`` over every parameter, and the parameters after one
``fit`` step (plain SGD, so the step is lr·g and the comparison stays
tight). Also: the JSON both ways, model zips both ways, the VAE's ELBO and
its gradients with the reparameterization noise injected (a
``torch.Generator`` cannot match ``jax.random``), ``dl4j_drop_out``, and
the public names against the JAX package's.

Tolerances (float32; the two frameworks sum in other orders): outputs
1e-5 relative + 1e-6 absolute; gradients 1e-4 relative + 1e-6 absolute
(the attention and routing softmaxes chain three or four reductions);
parameters after the step 1e-5 relative + 1e-6 absolute (lr 0.1 × the
gradient's error).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.testing import layer_nets as L

OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
STEP = dict(rtol=1e-5, atol=1e-6)


def _host(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _np(tree):
    return jax.tree.map(lambda t: t.detach().cpu().numpy(), tree)


def _assert_trees(want, got, tol, what):
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree.leaves(got)
    assert len(wl) == len(gl), what
    for (path, w), g in zip(wl, gl):
        np.testing.assert_allclose(g, w, err_msg=f"{what} {path}", **tol)


# ------------------------------------------------------------------ cases
# the card's networks (testing/layer_nets.py) at small dims; together they
# hold all fourteen layer types


def _nets(name):
    d = L.SMALL[name]
    jconf = L.build(name, jnn, d, updater=jnn.Sgd(learning_rate=0.1))
    tconf = L.build(name, tnn, d, updater=tnn.Sgd(learning_rate=0.1))
    x, y, m = L.batch(name, d, seed=1)
    jnet = jnn.MultiLayerNetwork(jconf).init()
    start = _host(jnet.params)
    tnet = tnn.MultiLayerNetwork(tconf, device="cpu").init(params=start)
    return jnet, tnet, start, x, y, m


def test_the_networks_hold_every_new_layer_type():
    seen = {type(lc).__name__ for name in L.NETWORKS
            for lc in L.build(name, tnn, L.SMALL[name]).layers}
    seen |= {type(lc.inner()).__name__ for name in L.NETWORKS
             for lc in L.build(name, tnn, L.SMALL[name]).layers
             if hasattr(lc, "inner")}
    assert NEW_TYPES <= seen, NEW_TYPES - seen


NEW_TYPES = {"SelfAttentionLayer", "LearnedSelfAttentionLayer",
             "RecurrentAttentionLayer", "VariationalAutoencoder",
             "CnnLossLayer", "MaskLayer", "ElementWiseMultiplicationLayer",
             "FrozenLayerWithBackprop", "CenterLossOutputLayer",
             "Yolo2OutputLayer", "PrimaryCapsules", "CapsuleLayer",
             "CapsuleStrengthLayer", "SameDiffLayer"}
CASES = L.NETWORKS


@pytest.mark.parametrize("name", CASES)
def test_layer_matches_jax(name):
    """Output, the gradients of a fixed projection of it, and one SGD
    step, through both packages from the JAX package's parameters."""
    jnet, tnet, start, x, y, m = _nets(name)
    # the output (inference forward)
    want = np.asarray(jnet.output(x, m))
    got = tnet.output(x, m)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **OUT)
    # gradients of sum(output · c), training-mode forward
    c = np.random.RandomState(99).randn(*want.shape).astype(np.float32)
    jm = None if m is None else jnp.asarray(m)

    def jproj(p):
        out, _ = jnet._forward(p, jnet.net_state, jnp.asarray(x), jm,
                               train=True, rng=jax.random.key(0))
        return jnp.sum(out * c)

    jg = jax.grad(jproj)(jnet.params)
    params = jax.tree.map(lambda t: t.detach().requires_grad_(True),
                          tnet.params)
    out, _ = tnet._forward(params, tnet.net_state, torch.from_numpy(x),
                           None if m is None else torch.from_numpy(m),
                           train=True, rng=None)
    leaves = jax.tree.leaves(params)
    tg = torch.autograd.grad((out * torch.from_numpy(c)).sum(), leaves,
                             allow_unused=True)
    tg = [np.zeros(tuple(p.shape), np.float32) if g is None else g.numpy()
          for p, g in zip(leaves, tg)]
    _assert_trees(_host(jg), tg, GRAD, f"{name} gradient")
    if name == "vae":  # trained by its ELBO: test_vae_elbo_...
        return
    # one fit step (SGD 0.1)
    jnet.fit(JDataSet(x, y, m, m if y.ndim == 3 else None),
             batch_size=len(x))
    tnet.fit(DataSet(x, y, m, m if y.ndim == 3 else None),
             batch_size=len(x))
    np.testing.assert_allclose(tnet.score(), float(jnet.score()), rtol=1e-5)
    _assert_trees(_host(jnet.params), _np(tnet.params), STEP,
                  f"{name} step")
    if name == "frozen_with_backprop":  # the wrapped layer did not move
        _assert_trees(start[1], _np(tnet.params[1]), dict(rtol=0, atol=0),
                      "frozen")
    if name == "seq_classifier":  # the center-loss centers moved
        assert np.abs(_np(tnet.params[-1]["centers"])).sum() > 0


@pytest.mark.parametrize("name", [n for n in CASES if n != "samediff_layer"])
def test_json_both_ways(name):
    """Each configuration's JSON, written by either package, loads in the
    other and writes the same JSON back."""
    jconf = L.build(name, jnn, L.SMALL[name])
    tconf = L.build(name, tnn, L.SMALL[name])
    js, ts = jconf.to_json(), tconf.to_json()
    assert json.loads(js) == json.loads(ts)
    assert json.loads(TC.MultiLayerConfiguration.from_json(js).to_json()) \
        == json.loads(js)
    assert json.loads(JC.MultiLayerConfiguration.from_json(ts).to_json()) \
        == json.loads(ts)


@pytest.mark.parametrize("name", ["seq_classifier", "capsnet", "yolo2",
                                  "recurrent_tagger"])
def test_zip_both_ways(name, tmp_path):
    """A JAX model zip restores in the port with the same output, and the
    port's zip restores in the JAX package. (The VAE is left out: the JAX
    ``save_model`` cannot flatten its list-of-dicts parameter tree.)"""
    jnet, tnet, _, x, _, m = _nets(name)
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jnn.save_model(jnet, jpath)
    got = tnn.restore_model(jpath, device="cpu")
    np.testing.assert_allclose(got.output(x, m), np.asarray(jnet.output(x, m)),
                               **OUT)
    tnn.save_model(tnet, tpath)
    back = jnn.restore_model(tpath)
    np.testing.assert_allclose(np.asarray(back.output(x, m)),
                               tnet.output(x, m), **OUT)


def test_vae_elbo_with_injected_noise(monkeypatch):
    """The VAE's negative ELBO and its gradients over every parameter,
    with the same reparameterization noise in both packages (the JAX draw
    replaced by the injected array), bernoulli and gaussian; and the
    reconstruction log-probability is the ELBO's reconstruction term."""
    for dist in ("bernoulli", "gaussian"):
        confs = []
        for pkg in (jnn, tnn):
            confs.append((pkg.builder().seed(3).list()
                          .layer(pkg.VariationalAutoencoder(
                              n_in=12, n_out=4, encoder_layer_sizes=(10,),
                              decoder_layer_sizes=(8, 6),
                              reconstruction_distribution=dist))
                          .set_input_type(pkg.InputType.feed_forward(12))
                          .build()))
        jnet = jnn.MultiLayerNetwork(confs[0]).init()
        tnet = tnn.MultiLayerNetwork(confs[1], device="cpu").init(
            params=_host(jnet.params))
        r = np.random.RandomState(12)
        x = (r.rand(6, 12) > 0.4).astype(np.float32)
        eps = r.randn(6, 4).astype(np.float32)
        with monkeypatch.context() as mp:
            mp.setattr(jax.random, "normal",
                       lambda key, shape, dtype: jnp.asarray(eps, dtype))
            jl, jg = jax.value_and_grad(
                lambda p: jnet.layers[0].elbo_loss(p, jnp.asarray(x),
                                                   jax.random.key(0)))(
                jnet.params[0])
        p = jax.tree.map(lambda t: t.detach().requires_grad_(True),
                         tnet.params[0])
        tl = tnet.layers[0].elbo_loss(p, torch.from_numpy(x),
                                      eps=torch.from_numpy(eps))
        tg = torch.autograd.grad(tl, jax.tree.leaves(p))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _assert_trees(_host(jg), [g.numpy() for g in tg], GRAD,
                      f"elbo {dist}")
        layer = tnet.layers[0]
        with torch.no_grad():
            logp = layer.reconstruction_log_probability(
                tnet.params[0], torch.from_numpy(x),
                eps=torch.from_numpy(eps))
            mean, logvar = layer._encode(tnet.params[0], torch.from_numpy(x))
            kl = -0.5 * torch.sum(1 + logvar - mean ** 2 - logvar.exp(), -1)
        np.testing.assert_allclose(float(torch.mean(-logp + kl)), float(jl),
                                   rtol=1e-5)


def test_fit_elbo_step_matches_a_jax_sgd_step(monkeypatch):
    """``layer_nets.fit_elbo`` (the card's VAE step: autograd of the ELBO,
    the network's update tail) against p − 0.1·∇ELBO from ``jax.grad`` of
    the JAX layer's ``elbo_loss`` with the same noise."""
    d = L.SMALL["vae"]
    jnet = jnn.MultiLayerNetwork(L.build(
        "vae", jnn, d, updater=jnn.Sgd(learning_rate=0.1))).init()
    tnet = tnn.MultiLayerNetwork(L.build(
        "vae", tnn, d, updater=tnn.Sgd(learning_rate=0.1)),
        device="cpu").init(params=_host(jnet.params))
    x = L.batch("vae", d, seed=2)[0]
    eps = np.random.RandomState(5).randn(d["batch"], d["latent"]).astype(
        np.float32)
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype: jnp.asarray(eps, dtype))
        jl, jg = jax.value_and_grad(
            lambda p: jnet.layers[0].elbo_loss(p, jnp.asarray(x),
                                               jax.random.key(0)))(
            jnet.params[0])
    want = jax.tree.map(lambda p, g: np.asarray(p - 0.1 * g),
                        jnet.params[0], jg)
    loss = L.fit_elbo(tnet, x, torch.from_numpy(eps), step=0)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_trees(want, _np(tnet.params[0]), STEP, "fit_elbo")


def test_dl4j_drop_out_matches_jax():
    for v in (0.0, 0.25, 0.8, 1.0):
        assert tnn.dl4j_drop_out(v) == jnn.dl4j_drop_out(v)
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError):
            tnn.dl4j_drop_out(bad)


def test_layer_types_are_the_jax_ones():
    """Every JAX layer type is ported: MoELayer came with the parallel
    package, DuelingQLayer with reinforcement learning (76 types)."""
    assert set(TC.LAYER_TYPES) == set(JC.LAYER_TYPES)
    assert len(TC.LAYER_TYPES) == 76


def test_public_names_hold_the_jax_transfer_and_layer_names():
    """The port's ``nn.__all__`` holds every public name the JAX ``nn``
    package takes from ``transfer.py``, ``earlystopping.py`` and its new
    layer types."""
    from deeplearning4j_tpu.nn import earlystopping as jes
    from deeplearning4j_tpu.nn import transfer as jtr

    jax_names = {n for n in dir(jnn) if not n.startswith("_")
                 and getattr(getattr(jnn, n), "__module__", "") in (
                     jtr.__name__, jes.__name__)}
    jax_names |= {n for n in dir(jes) if not n.startswith("_")
                  and getattr(getattr(jes, n), "__module__", "")
                  == jes.__name__}
    jax_names |= {n for n in dir(jtr) if not n.startswith("_")
                  and getattr(getattr(jtr, n), "__module__", "")
                  == jtr.__name__}
    assert {"FineTuneConfiguration", "EarlyStoppingTrainer"} <= jax_names
    assert jax_names - set(tnn.__all__) == set()
    layer_names = set(JC.LAYER_TYPES)
    assert {n for n in layer_names if hasattr(jnn, n)} <= set(tnn.__all__) \
        | {n for n in layer_names if hasattr(tnn, n)}
