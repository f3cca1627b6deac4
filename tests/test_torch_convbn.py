"""Fused BN-apply → matmul → BN-stats parity of the PyTorch port against
the JAX package (CPU).

Inputs are drawn with numpy and fed to both packages.

* Forward: the port's plain version (and its kernel wrapper, which takes
  the plain version for CPU tensors) against the JAX
  ``reference_bn_matmul_stats`` and the Pallas kernel in interpret mode
  (``fused_bn_matmul_stats(interpret=True)``, as
  ``tests/test_perf_levers.py`` runs it), with the prologue on and off and
  relu on and off, in bfloat16 and float32.
  Tolerances: against the JAX reference, which takes the statistics from
  the rounded z as the port does, z within one bf16 unit (2^-7 relative)
  and 1e-5 absolute (float32: 1e-5 relative) — the same products summed in
  another order — and mean/var 1e-5 + 1e-5 relative. Against the Pallas
  kernel, which takes them from the float32 accumulator, the bound of
  ``cuda_convbn.kernel_tolerance`` (its docstring derives it) — the same
  bound ``chip_smoke.py`` holds the CUDA kernel to.
* Backward: the port's ``fused_matmul_bn`` against ``jax.vjp`` of the JAX
  one, with cotangents on z, mean and var: float32 1e-4 relative/absolute
  (two matmuls and column sums of the same numbers in another order);
  bfloat16 inputs 2^-7 relative (one bf16 rounding of dx/dw) and 1e-3
  absolute.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import pallas_convbn as J
from deeplearning4j_tpu_torch.environment import environment
from deeplearning4j_tpu_torch.ops import cuda_convbn as T
from deeplearning4j_tpu_torch.ops import exec_op

CASES = [(True, True), (True, False), (False, False), (False, True)]


def _inputs(m, k, n, seed, dtype):
    r = np.random.RandomState(seed)
    x = r.randn(m, k).astype(np.float32)
    sc = (r.rand(k) + 0.5).astype(np.float32)
    sh = (r.randn(k) * 0.1).astype(np.float32)
    w = (r.randn(k, n) * k ** -0.5).astype(np.float32)
    ss = (r.randn(n) * 0.1).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = (jnp.asarray(x).astype(jd), jnp.asarray(sc), jnp.asarray(sh),
          jnp.asarray(w).astype(jd), jnp.asarray(ss))
    tx = (torch.from_numpy(x).to(td), torch.from_numpy(sc),
          torch.from_numpy(sh), torch.from_numpy(w).to(td),
          torch.from_numpy(ss))
    return jx, tx


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("prologue,relu", CASES)
def test_plain_matches_the_jax_reference_and_pallas(dtype, prologue, relu):
    m, k, n = 512, 128, 64
    jx, tx = _inputs(m, k, n, 0, dtype)
    kw = dict(relu=relu, fuse_prologue=prologue)
    zr, mr, vr = J.reference_bn_matmul_stats(*jx, **kw)
    zt, mt, vt = T.reference_bn_matmul_stats(*tx, **kw)
    zw, mw, vw = T.bn_matmul_stats(*tx, **kw)  # CPU: the plain version
    assert zt.dtype == tx[0].dtype and zt.shape == (m, n)
    assert torch.equal(zt, zw) and torch.equal(mt, mw) and torch.equal(vt, vw)
    zt_np = zt.float().numpy()
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(zt_np, _np(zr), rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(mt.numpy(), _np(mr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vt.numpy(), _np(vr), rtol=1e-5, atol=1e-5)
    if dtype == "bfloat16":
        # the Pallas kernel (TPU-only gate aside) in interpret mode
        zp, mp, vp = J.fused_bn_matmul_stats(*jx, interpret=True, **kw)
        z_atol, z_rtol, m_tol, v_tol = T.kernel_tolerance(*tx, zt, **kw)
        assert (np.abs(_np(zp) - zt_np)
                <= z_atol + z_rtol * np.abs(zt_np)).all()
        assert (np.abs(_np(mp) - mt.numpy()) <= m_tol.numpy()).all()
        assert (np.abs(_np(vp) - vt.numpy()) <= v_tol.numpy()).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("prologue,relu", CASES)
def test_gradients_match_jax_vjp(dtype, prologue, relu):
    m, k, n = 256, 64, 64
    jx, tx = _inputs(m, k, n, 1, dtype)
    r = np.random.RandomState(2)
    dz = r.randn(m, n).astype(np.float32)
    dmean = r.randn(n).astype(np.float32)
    dvar = r.randn(n).astype(np.float32)
    x, a, b, w, ss = jx
    (zj, mj, vj), vjp = jax.vjp(
        lambda x, a, b, w: J.fused_matmul_bn(x, a, b, w, ss, prologue, relu),
        x, a, b, w)
    gj = vjp((jnp.asarray(dz).astype(zj.dtype), jnp.asarray(dmean),
              jnp.asarray(dvar)))
    leaves = [t.clone().requires_grad_(True) for t in tx[:4]]
    zt, mt, vt = T.fused_matmul_bn(*leaves, tx[4], prologue, relu)
    torch.autograd.backward(
        (zt, mt, vt), (torch.from_numpy(dz).to(zt.dtype),
                       torch.from_numpy(dmean), torch.from_numpy(dvar)))
    tol = (dict(rtol=2.0 ** -7, atol=1e-3) if dtype == "bfloat16"
           else dict(rtol=1e-4, atol=1e-4))
    np.testing.assert_allclose(zt.detach().float().numpy(), _np(zj), **tol)
    names = ["x", "scale", "shift", "w"] if prologue else ["x", "w"]
    for name in names:
        i = ["x", "scale", "shift", "w"].index(name)
        got = leaves[i].grad
        assert got is not None, name
        np.testing.assert_allclose(got.float().numpy(), _np(gj[i]), **tol,
                                   err_msg=name)
    if not prologue:  # the constant affine gets no gradient
        assert leaves[1].grad is None and leaves[2].grad is None


def test_gate_and_dispatch_on_cpu():
    _, tx = _inputs(256, 64, 64, 3, "bfloat16")
    assert not T.bn_matmul_stats_usable(*tx)
    before = T.bn_matmul_stats.launches
    env = environment()
    old = env.helper_mode
    try:
        for mode in ("auto", "generic"):
            env.helper_mode = mode
            z, _, _ = exec_op("fused_bn_matmul_stats", *tx)
            assert torch.equal(z, T.reference_bn_matmul_stats(*tx)[0])
        env.helper_mode = "kernel"
        with pytest.raises(RuntimeError, match="kernel"):
            exec_op("fused_bn_matmul_stats", *tx)
    finally:
        env.helper_mode = old
    assert T.bn_matmul_stats.launches == before


def test_running_mean_shift_gets_no_gradient():
    _, tx = _inputs(128, 64, 64, 4, "float32")
    x = tx[0].clone().requires_grad_(True)
    ss = tx[4].clone().requires_grad_(True)
    z, m, v = T.fused_matmul_bn(x, tx[1], tx[2], tx[3], ss, True, True)
    (z.sum() + m.sum() + v.sum()).backward()
    assert x.grad is not None and ss.grad is None
