"""The training slice's plain ops against the JAX package (CPU): every
activation and loss of the two name tables, the pooling modes and the
weight-init schemes.

Inputs are drawn with numpy and fed to both. Tolerances: activations and
losses 1e-5 relative + 1e-6 absolute on values and 1e-4 on gradients
(float32, the same formula in another library's kernels); pooling is
exact for max and 1e-6 for sums/means. Weight init draws from a
``torch.Generator`` and cannot reproduce ``jax.random``, so each scheme
is checked by its moments: the standard deviation of 20000 draws within
5% of the scheme's (a 5-sigma margin is ~2.5% at that count).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import losses as jloss
from deeplearning4j_tpu.ops import nn_ops as jops
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import losses as tloss
from deeplearning4j_tpu_torch.ops import nn_ops as tops
from deeplearning4j_tpu_torch.ops.weight_init import init_weights

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-4)


def test_name_tables_match():
    assert sorted(tact.ACTIVATIONS) == sorted(jact.ACTIVATIONS)
    assert sorted(tloss.LOSSES) == sorted(jloss.LOSSES)


@pytest.mark.parametrize("name", sorted(jact.ACTIVATIONS))
def test_activation_matches_jax(name):
    x = np.random.RandomState(0).randn(4, 7).astype(np.float32) * 2
    x[0, :3] = [0.5, -0.5, 1.5]  # away from kinks at 0 and theta=1
    jf = jact.get_activation(name)
    tf = tact.get_activation(name)
    yj, vjp = jax.vjp(jf, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    yt = tf(xt)
    dy = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    yt.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **VAL)
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(dy))[0]), **GRAD)


def _loss_inputs(name, r):
    shape = (5, 6)
    if name == "yolo2":
        pred = r.randn(2, 3, 3, 2 * 7).astype(np.float32)
        target = np.abs(r.randn(2, 3, 3, 2, 7)).astype(np.float32)
        target[..., 4] = (r.rand(2, 3, 3, 2) > 0.5)
        return pred, target
    if name == "sparse_mcxent":
        return r.randn(*shape).astype(np.float32), r.randint(0, 6, 5)
    if name in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        p = np.exp(r.randn(*shape)).astype(np.float32)
        y = np.eye(6, dtype=np.float32)[r.randint(0, 6, 5)]
        return p / p.sum(-1, keepdims=True), y
    if name in ("xent", "reconstruction_crossentropy"):
        return (r.rand(*shape).astype(np.float32) * 0.9 + 0.05,
                (r.rand(*shape) > 0.5).astype(np.float32))
    if name in ("hinge", "squared_hinge"):
        return (r.randn(*shape).astype(np.float32),
                np.sign(r.randn(*shape)).astype(np.float32))
    if name in ("poisson", "mean_squared_logarithmic_error"):
        return (r.rand(*shape).astype(np.float32) + 0.1,
                r.rand(*shape).astype(np.float32) + 0.1)
    return r.randn(*shape).astype(np.float32), r.randn(*shape).astype(
        np.float32)


@pytest.mark.parametrize("name", sorted(jloss.LOSSES))
def test_loss_matches_jax(name):
    pred, lab = _loss_inputs(name, np.random.RandomState(2))
    lj, gj = jax.value_and_grad(
        lambda p: jloss.get_loss(name)(p, jnp.asarray(lab)))(jnp.asarray(pred))
    pt = torch.tensor(pred, requires_grad=True)
    lt = tloss.get_loss(name)(pt, torch.from_numpy(lab))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), **VAL)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gj), **GRAD)


def test_masked_loss_matches_jax():
    pred, lab = _loss_inputs("mse", np.random.RandomState(3))
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    lj = jloss.mse(jnp.asarray(pred), jnp.asarray(lab), jnp.asarray(mask))
    lt = tloss.mse(torch.from_numpy(pred), torch.from_numpy(lab),
                   torch.from_numpy(mask))
    np.testing.assert_allclose(float(lt), float(lj), **VAL)


@pytest.mark.parametrize("op,kw", [
    ("maxpool2d", dict(kernel=(2, 2), stride=(2, 2), padding="valid")),
    ("maxpool2d", dict(kernel=(3, 3), stride=(1, 1), padding=(1, 1))),
    ("avgpool2d", dict(kernel=(3, 3), stride=(2, 2), padding="same")),
    ("avgpool2d", dict(kernel=(3, 3), stride=(2, 2), padding="same",
                       count_include_pad=False)),
    ("avgpool2d", dict(kernel=(2, 2), stride=(2, 2), padding="valid")),
    ("pnormpool2d", dict(kernel=(2, 2), stride=(1, 1), padding="valid",
                         p=3.0)),
])
def test_pooling_matches_jax(op, kw):
    x = np.random.RandomState(4).randn(2, 7, 7, 3).astype(np.float32)
    yj = getattr(jops, op).fn(jnp.asarray(x), **kw)
    yt = getattr(tops, op).fn(torch.from_numpy(x), **kw)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("scheme,std", [
    ("relu", lambda fi, fo: math.sqrt(2.0 / fi)),
    ("xavier", lambda fi, fo: math.sqrt(2.0 / (fi + fo))),
    ("normal", lambda fi, fo: 1.0 / math.sqrt(fi)),
    ("uniform", lambda fi, fo: 1.0 / math.sqrt(fi) / math.sqrt(3.0)),
    ("relu_uniform", lambda fi, fo: math.sqrt(6.0 / fi) / math.sqrt(3.0)),
    ("var_scaling_normal_fan_avg",
     lambda fi, fo: 1.0 / math.sqrt((fi + fo) / 2)),
])
def test_weight_init_scheme_moments(scheme, std):
    shape = (3, 3, 40, 56)  # fan_in 360, fan_out 504; 20160 draws
    w = init_weights(torch.Generator().manual_seed(0), shape, scheme,
                     device="cpu")
    assert w.shape == shape and w.dtype == torch.float32
    assert abs(w.mean().item()) < 0.05 * std(360.0, 504.0)
    assert w.std().item() == pytest.approx(std(360.0, 504.0), rel=0.05)
    again = init_weights(torch.Generator().manual_seed(0), shape, scheme,
                         device="cpu")
    assert torch.equal(w, again)
