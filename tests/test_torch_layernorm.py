"""The fused LayerNorm + activation of the PyTorch port against the JAX
package (CPU).

Inputs are drawn with numpy and fed to both packages.

* The plain version (``cuda_layernorm.fused_layer_norm_reference``, and
  the kernel wrapper, which takes it for CPU tensors) against the Pallas
  kernel in interpret mode (``fused_layer_norm_pallas(...,
  interpret=True)``) and against ``_generic_f32``, for all five
  activations, float32 and bfloat16, 2-D and 3-D x, D of 96, 128 and 200,
  with and without a bias. All compute float32 statistics and a float32
  epilogue and round once: float32 within 1e-5 relative and 1e-5
  absolute (the same sums in another order); bfloat16 within one bf16
  unit (2^-7 relative) and 1e-5 absolute.
* The generic op (``nn_ops.fused_layer_norm``) against the JAX generic
  (``pallas_layernorm.fused_layer_norm``) in
  float32: 1e-5 relative and absolute. (In bfloat16 each generic rounds
  after every op of the chain, in different places.)
* The ``fused_layer_norm`` operator's gradients against ``jax.vjp`` of ``_fused_ln``
  (the Pallas forward in interpret mode, ``jax.vjp`` of the float32 math
  backward): float32 1e-5 relative and absolute; bfloat16 x one unit of
  the bf16 gradient (2^-7 relative) and 1e-5 absolute. And, apart from
  the JAX package: in float32, equal (1e-5) to the gradients
  ``sd.calculate_gradients`` takes through a SameDiff plan holding the
  fused node, whose float64 gradients ``check_samediff_gradients`` holds
  to central finite differences (1e-5 relative).
* The gate against the JAX ``_usable`` over a grid, with the device check
  stubbed and the TPU limits taken out: the ``min_rows`` crossover and
  the Mosaic tile rule (the JAX gate is asked about shapes whose rows are
  multiplied by 8 and whose trailing lengths by 128, which keeps every other
  decision; the CUDA kernel takes any rows and any D).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import pallas_layernorm as J
from deeplearning4j_tpu.ops import tuning as jtuning
from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.autodiff.gradcheck import (
    check_samediff_gradients)
from deeplearning4j_tpu_torch.ops import cuda_layernorm as T
from deeplearning4j_tpu_torch.ops import exec_op
from deeplearning4j_tpu_torch.ops import nn_ops as tops

ACTS = ["none", "relu", "tanh", "gelu", "gelu_exact"]
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": {"rtol": 1e-5, "atol": 1e-5},
       "bfloat16": {"rtol": 2.0 ** -7, "atol": 1e-5}}
# (x shape): 2-D and 3-D, D 96 / 128 / 200
SHAPES = [(16, 96), (2, 8, 128), (8, 200)]


def _inputs(shape, seed):
    r = np.random.RandomState(seed)
    d = shape[-1]
    x = (r.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    g = (r.rand(d) + 0.5).astype(np.float32)
    b = r.randn(d).astype(np.float32)
    return x, g, b


def _to_np(t):
    return t.detach().float().numpy()


def _jnp_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_version_matches_the_pallas_kernel(dtype, act):
    for i, shape in enumerate(SHAPES):
        x, g, b = _inputs(shape, seed=i)
        rows = int(np.prod(shape[:-1]))
        for bias in (b, None):
            jx = jnp.asarray(x, JD[dtype])
            jb = None if bias is None else jnp.asarray(bias)
            want = J.fused_layer_norm_pallas(
                jx, jnp.asarray(g), jb, activation=act, block_rows=rows,
                interpret=True)
            want_f32 = J._generic_f32(
                jx, jnp.asarray(g), jnp.zeros(shape[-1]) if jb is None else jb,
                1e-5, act).astype(JD[dtype])
            tx = torch.from_numpy(x).to(TD[dtype])
            tb = None if bias is None else torch.from_numpy(bias)
            got = T.fused_layer_norm_reference(tx, torch.from_numpy(g), tb,
                                               activation=act)
            via_wrapper = T.fused_layer_norm_kernel(
                tx, torch.from_numpy(g), tb, activation=act)
            assert got.dtype == TD[dtype] and got.shape == want.shape
            assert torch.equal(got, via_wrapper)
            np.testing.assert_allclose(_to_np(got), _jnp_np(want),
                                       **TOL[dtype])
            np.testing.assert_allclose(_to_np(got), _jnp_np(want_f32),
                                       **TOL[dtype])


@pytest.mark.parametrize("act", ACTS)
def test_generic_matches_the_jax_generic(act):
    for i, shape in enumerate(SHAPES):
        x, g, b = _inputs(shape, seed=10 + i)
        for bias in (b, None):
            want = J.fused_layer_norm.fn(
                jnp.asarray(x), jnp.asarray(g),
                None if bias is None else jnp.asarray(bias), activation=act)
            got = tops.fused_layer_norm.fn(
                torch.from_numpy(x), torch.from_numpy(g),
                None if bias is None else torch.from_numpy(bias),
                activation=act)
            np.testing.assert_allclose(_to_np(got), np.asarray(want),
                                       **TOL["float32"])


@pytest.mark.parametrize("act,dtype,shape", [
    (a, "float32", (2, 8, 128)) for a in ACTS] + [
    ("gelu", "bfloat16", (16, 96)), ("gelu_exact", "bfloat16", (8, 200))])
def test_gradients_match_jax_vjp(act, dtype, shape):
    x, g, b = _inputs(shape, seed=20)
    dy = np.random.RandomState(21).randn(*shape).astype(np.float32)
    jx = jnp.asarray(x, JD[dtype])
    out, vjp = jax.vjp(lambda xx, gg, bb: J._fused_ln(xx, gg, bb, 1e-5, act),
                       jx, jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(dy, JD[dtype]))
    leaves = [torch.from_numpy(x).to(TD[dtype]).requires_grad_(True),
              torch.from_numpy(g).requires_grad_(True),
              torch.from_numpy(b).requires_grad_(True)]
    got_out = T.fused_layer_norm_kernel(*leaves, eps=1e-5, activation=act)
    assert got_out.grad_fn is not None
    np.testing.assert_allclose(_to_np(got_out), _jnp_np(out), **TOL[dtype])
    got = torch.autograd.grad(got_out, leaves,
                              torch.from_numpy(dy).to(TD[dtype]))
    for a, e, leaf in zip(got, want, leaves):
        assert a.dtype == leaf.dtype
        np.testing.assert_allclose(_to_np(a), _jnp_np(e), **TOL[dtype])


def _ln_gelu_graph(x, g, b):
    """loss = sum(gelu(layer_norm(x @ w, g, b)) * c): the plan holds one
    fused_layer_norm node; x, g and b are the VARIABLEs."""
    sd = SameDiff(device="cpu")
    xv = sd.var("x", x)
    w = sd.constant("w", np.eye(x.shape[-1], dtype=np.float32))
    h = sd.nn.gelu(sd.nn.layer_norm(xv @ w, sd.var("g", g), sd.var("b", b)))
    c = sd.constant("c", np.random.RandomState(5).randn(*x.shape)
                    .astype(np.float32))
    (h * c).sum().rename("loss")
    return sd


def test_fused_node_gradients_against_finite_differences():
    x, g, b = _inputs((3, 4, 24), seed=30)
    sd = _ln_gelu_graph(x, g, b)
    grads = sd.calculate_gradients({}, "loss")
    assert sd.last_compile_stats.fusions.get("layernorm") == 1
    assert check_samediff_gradients(sd, {}, "loss", max_per_param=12)
    # the fused_layer_norm operator (its autograd formula; on the CPU its
    # plain forward) gives the gradients the checked plan gives
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, b)]
    c = torch.from_numpy(np.random.RandomState(5).randn(*x.shape)
                         .astype(np.float32))
    y = T.fused_layer_norm_kernel(*leaves, eps=1e-5, activation="gelu")
    got = torch.autograd.grad((y * c).sum(), leaves)
    for name, a in zip("xgb", got):
        np.testing.assert_allclose(_to_np(a), grads[name],
                                   **TOL["float32"])


def _tile_scaled(shape, rows: bool):
    """``shape`` with its trailing length multiplied by 128 and, for x
    (``rows``), its first dim by 8: the Mosaic tile rule passes and every
    other decision (ranks, equal lengths) stays as it was."""
    s = list(shape)
    s[-1] *= 128
    if rows and len(s) >= 2:
        s[0] *= 8
    return tuple(s)


def test_gate_decides_as_the_jax_gate(monkeypatch):
    monkeypatch.setattr(T, "_on_cuda", lambda *ts: True)
    real = jtuning.tuned
    monkeypatch.setattr(
        jtuning, "tuned",
        lambda op, key, default=None, bucket=None:
        0 if key == "min_rows" else real(op, key, default, bucket))
    z = np.zeros
    n_taken = n_untiled = 0
    for x_shape in ((8, 128), (3, 96), (2, 4, 200), (7,), (2, 2, 2, 64)):
        d = x_shape[-1]
        for g_shape in ((d,), (d + 1,), (1, d)):
            for b_shape in (None, (d,), (2,), (1, d)):
                for dt in (np.float32, np.int32):
                    for kw in ({}, {"activation": "gelu_exact"},
                               {"activation": "swish"}, {"axis": 0},
                               {"axis": len(x_shape) - 1}):
                        want = bool(J._usable(
                            z(_tile_scaled(x_shape, True), dt),
                            z(_tile_scaled(g_shape, False), np.float32),
                            None if b_shape is None else
                            z(_tile_scaled(b_shape, False), np.float32),
                            **kw))
                        x = torch.from_numpy(z(x_shape, dt))
                        g = torch.from_numpy(z(g_shape, np.float32))
                        b = (None if b_shape is None else
                             torch.from_numpy(z(b_shape, np.float32)))
                        got = T.fused_layer_norm_usable(x, g, b, **kw)
                        assert got == want, (x_shape, g_shape, b_shape, dt,
                                             kw)
                        n_taken += want
                        n_untiled += want and not J._usable(
                            z(x_shape, dt), z(g_shape, np.float32),
                            None if b_shape is None else
                            z(b_shape, np.float32), **kw)
    assert n_taken > 0
    assert n_untiled > 0  # shapes the Mosaic tile rule refuses are taken


def test_registry_runs_the_generic_on_cpu_and_counts_no_launch():
    x, g, b = (torch.from_numpy(a) for a in _inputs((4, 64), seed=40))
    before = T.fused_layer_norm_kernel.launches
    assert not T.fused_layer_norm_usable(x, g, b)
    out = exec_op("fused_layer_norm", x, g, b, activation="gelu")
    assert T.fused_layer_norm_kernel.launches == before
    torch.testing.assert_close(
        out, tops.apply_fused_activation(
            tops.layer_norm.fn(x, g, b, axis=-1), "gelu"))


def test_kernel_tolerance_is_one_unit_in_low_precision():
    assert T.kernel_tolerance(torch.float32) == (1e-5, 1e-5)
    assert T.kernel_tolerance(torch.bfloat16)[1] == 2.0 ** -7
    assert T.kernel_tolerance(torch.float16)[1] == 2.0 ** -10
