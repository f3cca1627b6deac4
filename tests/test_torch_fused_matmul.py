"""The fused matmul epilogue act(x @ w + b) of the PyTorch port against the
JAX package (CPU).

Inputs are drawn with numpy and fed to both packages.

* The plain version (``cuda_matmul.fused_matmul_bias_act_reference``, and
  the kernel wrapper, which takes it for CPU tensors) against the Pallas
  kernel in interpret mode (``fused_matmul_bias_act_pallas(...,
  interpret=True)``), in float32 and bfloat16, for all five activations,
  2-D and 3-D x, with and without a bias. Both multiply in float32, add
  the float32 bias, activate in float32 and round once: float32 within
  1e-5 relative and 1e-5 absolute (the same products summed in another
  order); bfloat16 within one bf16 unit (2^-7 relative) and 1e-5
  absolute.
* The generic op against the JAX generic (``nn_ops.fused_matmul_bias_act``,
  op by op in the operands' dtype), transposes included: float32 1e-5;
  bfloat16 within one bf16 unit per rounding (the product and the bias add
  each round once): 2^-6 relative, 1e-2 absolute.
* the differentiable operator's gradients against ``jax.vjp`` of ``_fused_mm``
  (Pallas forward in interpret mode, the plain two-matmul backward):
  float32 1e-4 relative and absolute (matmuls and column sums of the same
  numbers in another order).
* The gate against the JAX ``_usable`` over a grid, with the device check
  stubbed and the TPU limits taken out: the ``pallas_min_m`` crossover
  and the Mosaic tile rule (the JAX gate is asked about the shapes padded
  to M % 8, K % 128, N % 128; the CUDA kernel takes any M, K and N).
* ``matmul_design``'s static choice of kernel for each dtype, K and N
  alignment and pointer alignment (float32: sm90_f32 where TMA reads x), and the faulted plain variants of
  ``testing/matmul_check.py`` (the last K slab dropped, a slab added
  twice), which must exceed ``kernel_tolerance`` where the plain version
  itself sits at 0.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import nn_ops as jops
from deeplearning4j_tpu.ops import pallas_matmul as J
from deeplearning4j_tpu.ops import tuning as jtuning
from deeplearning4j_tpu_torch.ops import cuda_matmul as T
from deeplearning4j_tpu_torch.ops import exec_op
from deeplearning4j_tpu_torch.ops import nn_ops as tops
from deeplearning4j_tpu_torch.testing import matmul_check as mc

ACTS = ["none", "relu", "tanh", "gelu", "gelu_exact"]
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(x_shape, k, n, seed):
    r = np.random.RandomState(seed)
    x = r.randn(*x_shape, k).astype(np.float32)
    w = (r.randn(k, n) / np.sqrt(k)).astype(np.float32)
    b = r.randn(n).astype(np.float32)
    return x, w, b


def _to_np(t):
    return t.detach().float().numpy()


def _jnp_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_version_matches_the_pallas_kernel(dtype, act):
    tol = ({"rtol": 1e-5, "atol": 1e-5} if dtype == "float32"
           else {"rtol": 2.0 ** -7, "atol": 1e-5})
    for x_shape in ((16,), (2, 8)):
        x, w, b = _inputs(x_shape, 128, 256, seed=len(x_shape))
        for bias in (b, None):
            want = J.fused_matmul_bias_act_pallas(
                jnp.asarray(x, JD[dtype]), jnp.asarray(w, JD[dtype]),
                None if bias is None else jnp.asarray(bias),
                activation=act, interpret=True)
            tx, tw = (torch.from_numpy(a).to(TD[dtype]) for a in (x, w))
            tb = None if bias is None else torch.from_numpy(bias)
            got = T.fused_matmul_bias_act_reference(tx, tw, tb,
                                                    activation=act)
            via_wrapper = T.fused_matmul(tx, tw, tb, activation=act)
            assert got.dtype == TD[dtype] and got.shape == want.shape
            assert torch.equal(got, via_wrapper)
            np.testing.assert_allclose(_to_np(got), _jnp_np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True)])
def test_generic_matches_the_jax_generic(dtype, act, ta, tb):
    x, w, b = _inputs((3, 5), 24, 40, seed=7)
    if ta:
        x = np.ascontiguousarray(np.swapaxes(x, -1, -2))
    if tb:
        w = np.ascontiguousarray(w.T)
    kw = dict(activation=act, transpose_a=ta, transpose_b=tb)
    want = jops.fused_matmul_bias_act.fn(
        jnp.asarray(x, JD[dtype]), jnp.asarray(w, JD[dtype]),
        jnp.asarray(b), **kw)
    got = tops.fused_matmul_bias_act.fn(
        torch.from_numpy(x).to(TD[dtype]), torch.from_numpy(w).to(TD[dtype]),
        torch.from_numpy(b), **kw)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    tol = ({"rtol": 1e-5, "atol": 1e-5} if dtype == "float32"
           else {"rtol": 2.0 ** -6, "atol": 1e-2})
    np.testing.assert_allclose(_to_np(got), _jnp_np(want), **tol)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("x_shape,bias,trans_b", [
    ((16,), True, False), ((2, 8), True, False), ((16,), False, False),
    ((16,), True, True)])
def test_gradients_match_jax_vjp(act, x_shape, bias, trans_b):
    x, w, b = _inputs(x_shape, 128, 128, seed=11)
    if trans_b:
        w = np.ascontiguousarray(w.T)
    g = np.random.RandomState(12).randn(*x_shape, 128).astype(np.float32)
    jb = jnp.asarray(b) if bias else None

    def f(xx, ww, bb):
        return J._fused_mm(xx, ww, bb, act, False, trans_b)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jb)
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w)]
    tb = torch.from_numpy(b).requires_grad_(True) if bias else None
    got_out = T.fused_matmul(leaves[0], leaves[1], tb, activation=act,
                             transpose_b=trans_b)
    assert got_out.grad_fn is not None
    np.testing.assert_allclose(_to_np(got_out), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    inputs = leaves + ([tb] if bias else [])
    got = torch.autograd.grad(got_out, inputs, torch.from_numpy(g))
    for a, e in zip(got, want):
        np.testing.assert_allclose(_to_np(a), np.asarray(e), rtol=1e-4,
                                   atol=1e-4)


def _tile_padded(shape, rows: bool):
    """``shape`` with its trailing dim rounded up to 128 and, for x
    (``rows``), its row dim to 8: the sizes that pass the Mosaic tile rule,
    so the JAX gate decides on everything else."""
    up = lambda v, m: -(-v // m) * m  # noqa: E731
    s = list(shape)
    s[-1] = up(s[-1], 128)
    if len(s) >= 2:
        s[-2] = up(s[-2], 8 if rows else 128)
    return tuple(s)


def test_gate_decides_as_the_jax_gate(monkeypatch):
    monkeypatch.setattr(T, "_on_cuda", lambda *ts: True)
    real = jtuning.tuned
    monkeypatch.setattr(
        jtuning, "tuned",
        lambda op, key, default=None, bucket=None:
        0 if key == "pallas_min_m" else real(op, key, default, bucket))
    z = np.zeros
    n_taken = n_untiled = 0
    for x_shape in ((8, 128), (12, 128), (2, 4, 128), (16, 64), (16, 256),
                    (1, 3, 128), (128,), (2, 2, 2, 128)):
        for w_shape in ((128, 128), (x_shape[-1], 128), (x_shape[-1], 96),
                        (x_shape[-1],)):
            for b_shape in (None, (w_shape[-1],), (1, w_shape[-1])):
                for dt in (np.float32, np.int32):
                    for kw in ({}, {"activation": "gelu_exact"},
                               {"activation": "swish"},
                               {"transpose_b": True}):
                        want = bool(J._usable(
                            z(_tile_padded(x_shape, True), dt),
                            z(_tile_padded(w_shape, False), dt),
                            None if b_shape is None else
                            z(_tile_padded(b_shape, False), np.float32),
                            **kw))
                        x, w = z(x_shape, dt), z(w_shape, dt)
                        b = None if b_shape is None else z(b_shape,
                                                           np.float32)
                        got = T.fused_matmul_usable(
                            torch.from_numpy(x), torch.from_numpy(w),
                            None if b is None else torch.from_numpy(b),
                            **kw)
                        assert got == want, (x_shape, w_shape, b_shape,
                                             dt, kw)
                        n_taken += want
                        n_untiled += want and not J._usable(x, w, b, **kw)
    assert n_taken > 0
    assert n_untiled > 0  # shapes the Mosaic tile rule refuses are taken


def test_registry_runs_the_generic_on_cpu_and_counts_no_launch():
    x, w, b = (torch.from_numpy(a) for a in _inputs((16,), 128, 128, 3))
    before = T.fused_matmul.launches
    assert not T.fused_matmul_usable(x, w, b)
    out = exec_op("fused_matmul_bias_act", x, w, b, activation="relu")
    assert T.fused_matmul.launches == before
    torch.testing.assert_close(out, torch.relu(x @ w + b))


def test_kernel_tolerance_is_one_unit_in_low_precision():
    x, w, _ = (torch.from_numpy(a) for a in _inputs((16,), 256, 128, 4))
    atol, rtol = T.kernel_tolerance(x, w, torch.zeros(1))
    assert rtol == 1e-6
    assert 0 < atol < 1e-3  # 2·K·2^-24·max|x|·max|w| at K = 256
    _, rtol = T.kernel_tolerance(x.bfloat16(), w.bfloat16(),
                                 torch.zeros(1, dtype=torch.bfloat16))
    assert rtol == 2.0 ** -7


def _offset(t, elements: int):
    """``t``'s values in a fresh buffer, starting ``elements`` in."""
    buf = torch.zeros(t.numel() + elements, dtype=t.dtype)
    buf[elements:] = t.reshape(-1)
    return buf[elements:].view(t.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("k,n", [(64, 64), (776, 1000), (8, 8), (68, 64),
                                 (64, 60), (33, 65), (1, 1), (30, 9),
                                 (770, 768), (3072, 9)])
@pytest.mark.parametrize("moved", [None, "x", "w", "out"])
def test_matmul_design_by_dtype_shape_and_alignment(dtype, k, n, moved):
    """sm90 for 16-bit operands with K and N multiples of 8 and x, w and
    out 16-byte aligned; wmma for every other 16-bit case; sm90_f32 for
    float32 with K % 4 == 0 and x 16-byte aligned (w and out do not
    enter: the kernel reads w's own K-major copy and masks any N); simt
    for every other float32 case."""
    t = {"x": torch.zeros((5, k), dtype=dtype),
         "w": torch.zeros((k, n), dtype=dtype),
         "out": torch.zeros((5, n), dtype=dtype)}
    assert all(v.data_ptr() % 16 == 0 for v in t.values())
    if moved is not None:
        t[moved] = _offset(t[moved], 1)
        assert t[moved].data_ptr() % 16 != 0
    if dtype == torch.float32:
        want = "sm90_f32" if k % 4 == 0 and moved != "x" else "simt"
    elif k % 8 == 0 and n % 8 == 0 and moved is None:
        want = "sm90"
    else:
        want = "wmma"
    assert T.matmul_design(t["x"], t["w"], t["out"]) == want


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fault", mc.FAULTS)
@pytest.mark.parametrize("x_shape,k,n,act", [
    ((64,), 768, 96, "none"), ((2, 33), 776, 200, "gelu"),
    ((40,), 128, 64, "gelu_exact")])
def test_each_faulted_variant_exceeds_the_tolerance(dtype, fault, x_shape, k,
                                                    n, act):
    """The faults a slab ring could bring (testing/matmul_check.py) leave
    kernel_tolerance far behind; the plain version is the reference."""
    x, w, b = (torch.from_numpy(a).to(TD[dtype])
               for a in _inputs(x_shape, k, n, 11))
    b = b.float()
    ref = T.fused_matmul_bias_act_reference(x, w, b, activation=act)
    atol, rtol = T.kernel_tolerance(x, w, ref)
    bad = mc.fused_matmul_variant(x, w, b, activation=act, fault=fault)
    err = (bad.float() - ref.float()).abs()
    assert (err / (atol + rtol * ref.float().abs())).max().item() > 1.0
