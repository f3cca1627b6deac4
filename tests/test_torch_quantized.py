"""The int8 serving matmul of the PyTorch port against the JAX package (CPU).

Inputs are drawn with numpy and fed to both packages; torch's TF32 switch
is pinned off (it only matters on the card, where the straight-through
backward is a float32 product).

* ``quantize_int8`` in float32, bfloat16 and float16 at axes None, 0, 1 and
  (0, 1), and ``dequantize_int8``: bit for bit against the JAX ``.fn``s —
  the same amax, scale, division in x's dtype and half-to-even rounding.
  A row with a known answer pins the rounding: ``[127, 2.5, 3.5, -2.5]``
  has scale 1 and quantizes to ``[127, 2, 4, -2]``.
* ``matmul_int8`` (the plain version, and the kernel wrapper, which takes
  it for CPU tensors) in the three dtypes, 2-D and 3-D, with the scale as
  (N,) and as (1, N): bit for bit against the JAX generic, and in float32
  against the numpy int64 oracle of ``_check_matmul_int8``. At K = 2048 the
  exact dot exceeds 2^24, where a float32 accumulation would round: the
  port is still exact.
* The Pallas kernel in interpret mode at aligned shapes: bit for bit (its
  float32 accumulator is exact while |acc| < 2^24, which these inputs
  keep).
* The straight-through gradient against ``jax.vjp``: dx is the same
  float32 product in another summation order, 1e-5 relative and absolute;
  the scale's gradient is zero.
* The gate against the JAX ``_usable`` with its TPU rules taken out (the
  ``pallas_min_m`` crossover and the Mosaic tile rule: the JAX gate is
  asked about the shapes padded to M % 32, K % 128, N % 128), restricted
  to what the kernel takes (float32/bfloat16/float16 x, matching K and
  scale), which the port's gate checks itself.
* ``_check_quantize_round_trip`` of the reference, on the port's ops.
* The sm90 GEMM's routing: ``int8_design`` by K and q's alignment,
  ``int8_tile_n``, the K-major weight copy (made once, reused, remade
  after an in-place change; never made for CPU tensors) and the faulted
  variants of ``testing/matmul_check.py`` breaking bit-exactness.
"""

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import quantized as J
from deeplearning4j_tpu.ops import tuning as jtuning
from deeplearning4j_tpu_torch.ops import cuda_quantized as CQ
from deeplearning4j_tpu_torch.ops import exec_op
from deeplearning4j_tpu_torch.ops import quantized as T

DTYPES = ["float32", "bfloat16", "float16"]
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16,
      "float16": torch.float16}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
      "float16": jnp.float16}


@pytest.fixture(autouse=True)
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _pair(a, dtype):
    """The same numpy float32 values as a JAX and a torch array of
    ``dtype`` (both round to nearest even)."""
    return jnp.asarray(a, JD[dtype]), torch.from_numpy(a).to(TD[dtype])


def _np(t):
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_equal(got, want):
    got, want = _np(got), _jnp(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def _weights(k, n, seed):
    r = np.random.RandomState(seed)
    w = (r.randn(k, n) / np.sqrt(k)).astype(np.float32)
    return T.quantize_int8.fn(torch.from_numpy(w), axis=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)],
                         ids=["none", "0", "1", "both"])
def test_quantize_and_dequantize_are_bit_exact(dtype, axis):
    r = np.random.RandomState(3)
    x = (r.randn(24, 40) * 3.0).astype(np.float32)
    x[5] *= 1e-3  # a row and a column of small values
    x[:, 7] *= 1e-3
    jx, tx = _pair(x, dtype)
    jq, js = J.quantize_int8.fn(jx, axis=axis)
    tq, ts = T.quantize_int8.fn(tx, axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _assert_equal(tq, jq)
    _assert_equal(ts, js)
    _assert_equal(T.dequantize_int8.fn(tq, ts), J.dequantize_int8.fn(jq, js))
    assert _np(tq).min() >= -127 and _np(tq).max() <= 127


def test_rounding_is_half_to_even():
    row = np.array([[127.0, 2.5, 3.5, -2.5]], np.float32)
    want = np.array([[127, 2, 4, -2]], np.int8)
    for dtype in DTYPES:
        jx, tx = _pair(row, dtype)
        for tq, ts in (T._row_quantize(tx), T.quantize_int8.fn(tx, axis=1),
                       CQ.row_quantize(tx)):
            np.testing.assert_array_equal(_np(tq), want)
            np.testing.assert_array_equal(_np(ts), [[1.0]])
        np.testing.assert_array_equal(np.asarray(J._row_quantize(jx)[0]),
                                      want)


def _oracle(x, wq, ws):
    """``_check_matmul_int8``'s numpy oracle: int64 dot, float32
    de-scale."""
    xs = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-12) / 127.0
    xq = np.clip(np.round(x / xs), -127, 127).astype(np.int8)
    return (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32) \
        * xs * ws.reshape(1, -1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead", [(20,), (3, 7)], ids=["2d", "3d"])
@pytest.mark.parametrize("scale_2d", [False, True], ids=["n", "1n"])
def test_matmul_int8_matches_jax_and_the_int64_oracle(dtype, lead, scale_2d):
    k, n = 96, 40
    r = np.random.RandomState(len(lead) + 5 * scale_2d)
    x = r.randn(*lead, k).astype(np.float32)
    wq, ws = _weights(k, n, 8)
    if not scale_2d:
        ws = ws.reshape(n)
    jx, tx = _pair(x, dtype)
    want = J.matmul_int8.fn(jx, jnp.asarray(wq.numpy()),
                            jnp.asarray(ws.numpy()))
    got = T.matmul_int8.fn(tx, wq, ws)
    assert got.dtype == TD[dtype] and got.shape == lead + (n,)
    _assert_equal(got, want)
    _assert_equal(CQ.matmul_int8(tx, wq, ws), want)  # CPU: the plain version
    _assert_equal(exec_op("matmul_int8", tx, wq, ws), want)
    if dtype == "float32":
        np.testing.assert_array_equal(
            _np(got), _oracle(x, wq.numpy(), ws.numpy()).reshape(got.shape))


def test_matmul_int8_is_exact_where_float32_accumulation_is_not():
    k, n = 2048, 24
    r = np.random.RandomState(11)
    x = (1.0 + 0.01 * r.rand(16, k)).astype(np.float32)  # q near 127
    wq = torch.from_numpy(r.randint(100, 128, (k, n)).astype(np.int8))
    ws = torch.full((1, n), 0.01, dtype=torch.float32)
    xq, xs = T._row_quantize(torch.from_numpy(x))
    exact = xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64)
    assert np.abs(exact).max() > 2 ** 24  # past float32's exact integers
    want = exact.astype(np.float32) * xs.numpy() * ws.numpy()
    got = T.matmul_int8.fn(torch.from_numpy(x), wq, ws)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _oracle(x, wq.numpy(),
                                                       ws.numpy()))
    jwant = J.matmul_int8.fn(jnp.asarray(x), jnp.asarray(wq.numpy()),
                             jnp.asarray(ws.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(64,), (2, 32)], ids=["2d", "3d"])
def test_plain_version_matches_the_pallas_kernel(dtype, lead):
    k, n = 256, 128
    x = np.random.RandomState(4).randn(*lead, k).astype(np.float32)
    wq, ws = _weights(k, n, 9)
    jx, tx = _pair(x, dtype)
    want = J.matmul_int8_pallas(jx, jnp.asarray(wq.numpy()),
                                jnp.asarray(ws.numpy()), block_m=32,
                                block_k=128, block_n=128, interpret=True)
    _assert_equal(CQ.matmul_int8_reference(tx, wq, ws), want)
    xq, xs = CQ.row_quantize(tx.reshape(-1, k))
    _assert_equal(CQ.int8_matmul(xq, xs, wq, ws, TD[dtype]),
                  np.asarray(want, np.float32).reshape(-1, n))


@pytest.mark.parametrize("lead", [(12,), (2, 5)], ids=["2d", "3d"])
def test_straight_through_gradient_matches_jax_vjp(lead):
    k, n = 64, 48
    r = np.random.RandomState(6)
    x = r.randn(*lead, k).astype(np.float32)
    g = r.randn(*lead, n).astype(np.float32)
    wq, ws = _weights(k, n, 10)
    jwq, jws = jnp.asarray(wq.numpy()), jnp.asarray(ws.numpy())
    out, vjp = jax.vjp(lambda a, s: J.matmul_int8.fn(a, jwq, s),
                       jnp.asarray(x), jws)
    jdx, jdws = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tws = ws.clone().requires_grad_(True)
    y = exec_op("matmul_int8", tx, wq, tws)
    _assert_equal(y, out)
    dx, dws = torch.autograd.grad(y, (tx, tws), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    assert not dws.any() and not np.asarray(jdws).any()
    assert dws.shape == tws.shape


def _tile_padded(shape, rows: bool, m_mult: int = 32):
    """``shape`` with its trailing dim rounded up to 128 and, for x
    (``rows``), its row dim to 32 (K for a weight: 128): sizes that pass
    the Mosaic tile rule, so the JAX gate decides on everything else."""
    up = lambda v, m: -(-v // m) * m  # noqa: E731
    s = list(shape)
    s[-1] = up(s[-1], 128)
    if len(s) >= 2:
        s[-2] = up(s[-2], m_mult if rows else 128)
    return tuple(s)


def test_gate_decides_as_the_jax_gate(monkeypatch):
    monkeypatch.setattr(CQ, "_on_cuda", lambda *ts: True)
    real = jtuning.tuned
    monkeypatch.setattr(
        jtuning, "tuned",
        lambda op, key, default=None, bucket=None:
        0 if key == "pallas_min_m" else real(op, key, default, bucket))
    x_dtypes = {"float32": (np.float32, torch.float32),
                "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
                "float16": (np.float16, torch.float16),
                "float64": (np.float64, torch.float64),
                "int32": (np.int32, torch.int32)}
    n_taken = n_untiled = 0
    for x_shape in ((8, 128), (12, 96), (2, 4, 128), (1, 3, 40), (128,),
                    (2, 2, 2, 128)):
        k = x_shape[-1]
        for w_shape in ((k, 128), (k, 2), (k,), (k + 8, 128)):
            n = w_shape[-1]
            for w_dt in (np.int8, np.int32):
                for s_shape in ((n,), (1, n)):
                    for name, (np_dt, t_dt) in x_dtypes.items():
                        want = bool(J._usable(
                            np.zeros(_tile_padded(x_shape, True), np_dt),
                            np.zeros(_tile_padded(w_shape, False), w_dt),
                            np.zeros(s_shape, np.float32)))
                        kernel_takes = (name in DTYPES and len(w_shape) == 2
                                        and w_shape[0] == k)
                        got = CQ.matmul_int8_usable(
                            torch.zeros(x_shape, dtype=t_dt),
                            torch.from_numpy(np.zeros(w_shape, w_dt)),
                            torch.zeros(s_shape))
                        assert got == (want and kernel_takes), (
                            x_shape, w_shape, w_dt, s_shape, name)
                        n_taken += got
                        n_untiled += got and not J._usable(
                            np.zeros(x_shape, np_dt),
                            np.zeros(w_shape, w_dt), None)
    assert n_taken > 0
    assert n_untiled > 0  # shapes the Mosaic tile rule refuses are taken
    x, wq = torch.zeros(8, 128), torch.zeros(128, 16, dtype=torch.int8)
    for bad_scale in (torch.zeros(8), torch.zeros(16, 1), torch.zeros(2, 16),
                      torch.zeros(16, dtype=torch.int32)):
        assert not CQ.matmul_int8_usable(x, wq, bad_scale)
    assert not CQ.matmul_int8_usable(torch.zeros(8, 0),
                                     torch.zeros(0, 16, dtype=torch.int8),
                                     torch.zeros(16))


def test_gate_refuses_cpu_tensors_and_the_registry_runs_the_generic():
    x = torch.from_numpy(np.random.RandomState(2).randn(32, 128)
                         .astype(np.float32))
    wq, ws = _weights(128, 128, 12)
    assert not CQ.matmul_int8_usable(x, wq, ws)
    CQ.reset_launch_counts()
    out = exec_op("matmul_int8", x, wq, ws)
    assert CQ.launch_counts() == {"matmul_int8": 0, "row_quantize": 0}
    torch.testing.assert_close(out, T._matmul_int8_raw(x, wq, ws),
                               rtol=0, atol=0)


def test_quantize_round_trip_as_the_reference_checks_it():
    """``_check_quantize_round_trip`` on the port's ops, and the JAX
    check itself."""
    r = np.random.RandomState(23)
    x = r.randn(8, 16).astype(np.float32)
    for axis in (None, 0, 1):
        q, s = T.quantize_int8.fn(torch.from_numpy(x), axis=axis)
        qn, sn = q.numpy(), s.numpy()
        amax = np.abs(x).max() if axis is None else \
            np.abs(x).max(axis=axis, keepdims=True)
        np.testing.assert_allclose(sn, np.maximum(amax, 1e-12) / 127.0,
                                   rtol=1e-6)
        assert qn.dtype == np.int8 and np.abs(qn).max() <= 127
        back = T.dequantize_int8.fn(q, s).numpy()
        assert (np.abs(back - x) <= np.broadcast_to(sn / 2 + 1e-9,
                                                    x.shape)).all()
    J._check_quantize_round_trip()
    J._check_matmul_int8()


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_row_arithmetic_transcribed_is_bit_exact(dtype):
    """``dl4j_row_quantize``'s arithmetic transcribed in numpy float32 —
    amax, ``max(amax, 1e-12 in x's dtype) / 127``, the scale rounded to
    x's dtype, the IEEE float32 quotient rounded to x's dtype, ``rint``,
    the clip — equals the plain version bit for bit, ties included."""
    np_dt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
             "float16": np.float16}[dtype]
    r = np.random.RandomState(13)
    x = (r.randn(64, 200) * np.exp(r.randn(64, 1))).astype(np.float32)
    x[:8, :4] = [127.0, 2.5, 3.5, -2.5]  # exact ties at scale 1
    x[:8, 4] = 127.0
    xt = x.astype(np_dt).astype(np.float32)  # the values x's dtype holds
    amax = np.abs(xt).max(-1, keepdims=True)
    floor = np.float32(np.float32(1e-12).astype(np_dt))
    scale = np.maximum(amax, floor) / np.float32(127.0)
    s_t = scale.astype(np_dt).astype(np.float32)
    quot = (xt / s_t).astype(np.float32).astype(np_dt).astype(np.float32)
    q = np.clip(np.rint(quot), -127, 127).astype(np.int8)
    tq, ts = T._row_quantize(torch.from_numpy(x).to(TD[dtype]))
    np.testing.assert_array_equal(ts.numpy(), scale)
    np.testing.assert_array_equal(tq.numpy(), q)


# ------------------------------------------- the sm90 GEMM's routing (CPU)
# ``int8_design`` sends a q TMA can read to the wgmma kernel, which reads
# the weight as its K-major (N, K) copy (``kmajor_weight``, kept on the
# weight and remade when it changes); ``int8_tile_n`` picks its tile
# width; ``testing/matmul_check.py``'s faulted variants must break the
# bit-exact check.

@pytest.mark.parametrize("k", [16, 768, 3072, 7, 776, 8])
@pytest.mark.parametrize("offset", [0, 1])
def test_int8_design_by_k_and_alignment(k, offset):
    """sm90 for K % 16 == 0 and a 16-byte-aligned q (TMA's row stride and
    address), wmma otherwise — whatever the weight."""
    buf = torch.zeros(5 * k + 16, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0
    xq = buf[offset:offset + 5 * k].view(5, k)
    want = "sm90" if k % 16 == 0 and offset == 0 else "wmma"
    assert CQ.int8_design(xq) == want


@pytest.mark.parametrize("m,n,bn", [(4096, 768, 192), (4096, 3072, 192),
                                    (4096, 2, 128), (4096, 200, 128),
                                    (17, 768, 128)])
def test_int8_tile_n_fills_the_waves(m, n, bn):
    """BN 192 gives M 4096 × N 768 one wave of 128 tiles on 132 SMs (BN 128
    would take 192 tiles, a second wave 45% full); at N 3072 the two waste
    the same and the first, 192, wins; a narrow N takes 128."""
    assert CQ.int8_tile_n(m, n, 132) == bn


def test_kmajor_weight_is_made_once_and_remade_after_a_change():
    wq, _ = _weights(96, 40, 31)
    copies = CQ.kmajor_weight.copies
    wt = CQ.kmajor_weight(wq)
    assert wt.shape == (40, 96) and wt.is_contiguous()
    assert torch.equal(wt, wq.t())
    assert CQ.kmajor_weight(wq) is wt  # reused
    assert CQ.kmajor_weight.copies == copies + 1
    wq.mul_(-1)  # in place: the version moves, the copy is stale
    wt2 = CQ.kmajor_weight(wq)
    assert wt2 is not wt and torch.equal(wt2, wq.t())
    assert CQ.kmajor_weight.copies == copies + 2
    other = wq.clone()  # same values, another tensor: its own copy
    assert CQ.kmajor_weight(other) is not wt2
    assert CQ.kmajor_weight.copies == copies + 3


def test_kmajor_weight_of_an_inference_tensor_is_made_at_every_call():
    """A weight made under ``torch.inference_mode`` has no version
    counter to key on: its copy is made afresh each call, never kept."""
    with torch.inference_mode():
        wq, _ = _weights(64, 24, 33)
    copies = CQ.kmajor_weight.copies
    for _ in range(2):
        wt = CQ.kmajor_weight(wq)
        assert torch.equal(wt, wq.t()) and wt.is_contiguous()
    assert CQ.kmajor_weight.copies == copies + 2
    assert not hasattr(wq, "_dl4j_kmajor")


def test_cpu_int8_matmul_never_makes_the_kmajor_copy():
    """CPU tensors take the plain version: no K-major copy, no launch."""
    x = torch.from_numpy(np.random.RandomState(3).randn(33, 256)
                         .astype(np.float32))
    wq, ws = _weights(256, 96, 32)
    copies = CQ.kmajor_weight.copies
    CQ.reset_launch_counts()
    xq, xs = CQ.row_quantize(x)
    y = CQ.int8_matmul(xq, xs, wq, ws, torch.float32)
    assert torch.equal(y, CQ.int8_matmul_reference(xq, xs, wq, ws,
                                                   torch.float32))
    assert torch.equal(CQ.matmul_int8(x, wq, ws), T._matmul_int8_raw(x, wq,
                                                                     ws))
    assert CQ.kmajor_weight.copies == copies
    assert not hasattr(wq, "_dl4j_kmajor")
    assert CQ.int8_matmul.sm90_launches == 0
    assert CQ.launch_counts() == {"matmul_int8": 0, "row_quantize": 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [256, 768])
def test_int8_faulted_variants_break_the_bit_exact_check(dtype, k):
    """Each faulted plain variant of the sm90 GEMM (the last 128-deep K
    slab dropped, the scales read along the wrong axis) differs from the
    plain version; without a fault its arithmetic is the plain version's."""
    from deeplearning4j_tpu_torch.testing import matmul_check as mc

    x = torch.from_numpy(np.random.RandomState(k).randn(64, k)
                         .astype(np.float32)).to(TD[dtype])
    wq, ws = _weights(k, 48, k + 1)
    xq, xs = T._row_quantize(x)
    ref = CQ.int8_matmul_reference(xq, xs, wq, ws, TD[dtype])
    for fault in mc.INT8_FAULTS:
        bad = mc.int8_matmul_variant(xq, xs, wq, ws, TD[dtype], fault=fault)
        assert bad.shape == ref.shape and not torch.equal(bad, ref), fault
