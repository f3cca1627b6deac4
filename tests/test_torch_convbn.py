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
* The sm90 design's routing and check: ``convbn_design`` by pointer
  alignment, ``convbn_tile_n`` over train_fused's 15 distinct (M, K, N), the
  per-block partial sums (CPU: the plain z's) and their reduction, and
  the float32-accumulator arithmetic inside ``kernel_tolerance`` and
  ``partials_tolerance`` while each faulted variant of
  ``testing/matmul_check.py`` (prologue skipped, last K slab dropped, a
  row block counted twice) lies beyond them — the last one only through
  the per-block check at stage-3's 196 blocks.
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


# ------------------------------------------------ the sm90 design's routing
# ``convbn_design`` sends TMA-readable operands to the tensor-core kernel;
# ``convbn_tile_n`` picks its tile width; ``bn_matmul_stats_partials``
# exposes the per-128-row-block sums the kernel writes, checked per block by
# ``partials_tolerance`` (testing/matmul_check.py's faulted variants must
# break that check where the mean and variance checks cannot see them).

def _offset(t):
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("moved", [None, "x", "w"])
def test_convbn_design_by_alignment(moved):
    """sm90 for 16-byte-aligned x and w (the gate's shapes give 16-byte
    rows), wmma when either is off that alignment."""
    x = torch.zeros((256, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 128), dtype=torch.bfloat16)
    assert x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if moved == "x":
        x = _offset(x)
    elif moved == "w":
        w = _offset(w)
    want = "sm90" if moved is None else "wmma"
    assert T.convbn_design(x, w) == want


# train_fused's 15 distinct (M, K, N) at batch 128 (chip_smoke's census)
# and the tile width each takes on 132 SMs: the fuller last wave, BN 128 on
# a tie; N 64 fits one BN-64 tile
CENSUS = [((401408, 64, 64), 64), ((401408, 64, 256), 128),
          ((401408, 256, 64), 64), ((100352, 256, 128), 128),
          ((100352, 128, 512), 128), ((100352, 256, 512), 128),
          ((100352, 512, 128), 128), ((25088, 512, 256), 128),
          ((25088, 256, 1024), 128), ((25088, 512, 1024), 128),
          ((25088, 1024, 256), 128), ((6272, 1024, 512), 64),
          ((6272, 512, 2048), 128), ((6272, 1024, 2048), 128),
          ((6272, 2048, 512), 64)]


@pytest.mark.parametrize("mkn,bn", CENSUS)
def test_convbn_tile_n_fills_the_waves(mkn, bn):
    m, _, n = mkn
    assert T.convbn_tile_n(m, n, 132) == bn
    tiles = m // 128 * -(-n // bn)
    other = 64 if bn == 128 else 128
    others = m // 128 * -(-n // other)
    waste = -(-tiles // 132) * 132 * 128 * bn - m * n
    waste_other = -(-others // 132) * 132 * 128 * other - m * n
    assert waste <= waste_other


@pytest.mark.parametrize("prologue,relu", CASES)
def test_partials_are_the_plain_block_sums(prologue, relu):
    """On the CPU the partials are :func:`reference_partials` of the plain
    z, and :func:`reduce_partials` gives back the plain mean and var."""
    _, tx = _inputs(512, 128, 192, 5, "bfloat16")
    kw = dict(relu=relu, fuse_prologue=prologue)
    z, parts = T.bn_matmul_stats_partials(*tx, **kw)
    zr, mr, vr = T.reference_bn_matmul_stats(*tx, **kw)
    assert torch.equal(z, zr) and parts.shape == (2, 4, 192)
    c = zr.float() - tx[4]
    torch.testing.assert_close(parts[0], c.reshape(4, 128, 192).sum(1))
    torch.testing.assert_close(parts[1], (c * c).reshape(4, 128, 192).sum(1))
    mean, var = T.reduce_partials(parts, tx[4])
    torch.testing.assert_close(mean, mr, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(var, vr, rtol=1e-5, atol=1e-6)


def _kernel_like(tx, kw):
    """What the kernel computes, in float32 on the CPU: the accumulator
    rounded once to z, the partial sums taken from the accumulator."""
    from deeplearning4j_tpu_torch.testing import matmul_check as mc

    x, sc, sh, w, ss = tx
    y = x.float()
    if kw["fuse_prologue"]:
        y = y * sc + sh
        if kw["relu"]:
            y = torch.clamp_min(y, 0.0)
    acc = torch.matmul(y.to(x.dtype).float(), w.float())
    parts = T.reference_partials(acc, ss)
    got = (acc.to(x.dtype), parts) + T.reduce_partials(parts, ss)
    zr, mr, vr = T.reference_bn_matmul_stats(*tx, **kw)
    return mc, got, (zr, T.reference_partials(zr, ss), mr, vr)


@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("m,k,n", [(256, 64, 64), (512, 128, 192),
                                   (1024, 192, 128)])
def test_kernel_arithmetic_passes_and_each_fault_breaks_the_check(
        prologue, m, k, n):
    """Statistics from the float32 accumulator sit inside the check
    (``kernel_tolerance`` and ``partials_tolerance``); each faulted plain
    variant — prologue skipped, last K slab dropped, a row block's
    statistics counted twice — lies beyond it."""
    _, tx = _inputs(m, k, n, m + k, "bfloat16")
    kw = dict(relu=prologue, fuse_prologue=prologue)
    mc, got, plain = _kernel_like(tx, kw)
    assert mc.convbn_share(got, plain, tx, **kw) <= 1.0
    faults = mc.convbn_faults(prologue)
    assert ("prologue_skipped" in faults) == prologue
    for fault in faults:
        bad = mc.bn_matmul_stats_variant(*tx, **kw, fault=fault)
        assert mc.convbn_share(bad, plain, tx, **kw) > 1.0, fault


def test_a_doubled_block_hides_from_the_moments_but_not_the_partials():
    """At stage-3's 196 row blocks (M 25088) a block counted twice moves
    the mean and variance by less than their tolerance; only the per-block
    check sees it."""
    from deeplearning4j_tpu_torch.testing import matmul_check as mc

    _, tx = _inputs(128 * 196, 64, 64, 6, "bfloat16")
    kw = dict(relu=False, fuse_prologue=False)
    zr, mr, vr = T.reference_bn_matmul_stats(*tx, **kw)
    bad = mc.bn_matmul_stats_variant(*tx, **kw,
                                     fault="block_counted_twice")
    _, _, m_tol, v_tol = T.kernel_tolerance(*tx, zr, **kw)
    assert ((bad[2] - mr).abs() <= m_tol).all()
    assert ((bad[3] - vr).abs() <= v_tol).all()
    pr = T.reference_partials(zr, tx[4])
    assert ((bad[1] - pr).abs() > T.partials_tolerance(zr, tx[4])).any()
