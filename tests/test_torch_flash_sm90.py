"""The check of the tensor-core ("sm90") flash kernels, on the CPU.

The sm90 forward and dk/dv kernels round P and dS to the input dtype
before the products that take them, as the TPU kernels do
(``pallas_attention.py`` ``_mm``); the plain versions keep them in float32.
``testing/flash_check.py`` states the bound that holds the kernels to the
plain versions with that rounding added. Here, with no card:

* :func:`~deeplearning4j_tpu_torch.ops.cuda_attention.flash_design` over
  every dtype, head dim and kernel: bfloat16 and float16 with D <= 128
  take the sm90 design, the float32 forward with D <= 128 and the float32
  dq and dk/dv with D <= 64 the sm90_f32 one
  (``tests/test_torch_split_f32.py`` checks its arithmetic), everything
  else the CUDA-core one;
* a plain version that rounds P̃ and dS as the kernels do passes the
  bound, and each faulted variant fails it: the keep mask shifted by one
  key column, the last streamed tile dropped, and (forward) the rescale
  skipped for one tile; dq rounds dS unscaled, as the TPU dq does, and its
  bound adds ``u·scale·(|dS|·|K|)``;
* the plain forward, dq and dk/dv in bfloat16 against the JAX
  ``_flash_fwd`` / ``_flash_bwd`` Pallas kernels run in interpret mode in
  bfloat16 (the TPU kernels' own rounding), under the same bound: the
  yardstick the card check uses is the one the TPU kernel itself meets.

Tolerances: the card check's, ``ATOL + RTOL·|plain| + slack`` — forward
ATOL 1e-5, dq and dk/dv 1e-4, RTOL one unit in the last place (2^-7 bfloat16,
2^-10 float16), slack ``u·(|A|·|B|)`` with ``u`` twice the unit roundoff.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu_torch.ops import cuda_attention as ca
from deeplearning4j_tpu_torch.testing import flash_check as fc

RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
FWD_ATOL = 1e-5
DKV_ATOL = 1e-4


def _inputs(dtype, bh, t, d, masked, seed):
    g = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(g.standard_normal(
        (bh, t, d), dtype=np.float32)).to(dtype) for _ in range(4))
    m = None
    if masked:  # end-padded rows, one of them with every key masked
        lens = torch.tensor([t, t // 3, 0][:bh])
        m = (torch.arange(t)[None] < lens[:, None]).float()
    return q, k, v, do, m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("d", [8, 16, 40, 64, 96, 120, 128, 136, 192, 256])
def test_flash_design_by_dtype_and_head_dim(dtype, d):
    sm90 = dtype in (torch.bfloat16, torch.float16) and d <= 128
    # float32 has tensor-core designs of its own: the forward up to D 128,
    # dq and dk/dv up to D 64
    f32_limit = {"fwd": 128, "dq": 64, "dkv": 64}
    for kernel in ca.FLASH_KERNELS:
        f32 = dtype == torch.float32 and d <= f32_limit[kernel]
        want = "sm90" if sm90 else "sm90_f32" if f32 else "simt"
        assert ca.flash_design(dtype, d, kernel) == want, kernel
    with pytest.raises(ValueError, match="kernel"):
        ca.flash_design(dtype, d, "bwd")
    design = ca.flash_design(dtype, d, "dq")
    # the check adds the rounding term for the sm90 design alone
    unit = fc.rounding_unit(dtype, design)
    assert unit == (fc.ROUNDING[dtype] if sm90 else 0.0)
    assert fc.rounding_unit(dtype, ca.flash_design(dtype, d, "fwd")) == unit
    # ... and so does dq's term, which the sm90 dq needs as dk/dv do
    q, k, v, do, _ = _inputs(torch.float32, 1, 9, d, False, 3)
    out, lse = ca.flash_attention_reference(q, k, v, scale=0.5)
    delta = ca.attention_delta(do, out)
    slack = fc.dq_slack(q, k, v, None, None, do, lse, delta, scale=0.5,
                        unit=unit)
    assert slack.shape == q.shape
    assert bool((slack > 0).any()) == sm90 and bool((slack >= 0).all())


CASES = [  # (bh, t, d, causal, masked, rate)
    (3, 130, 64, False, True, 0.1),
    (3, 130, 40, True, False, 0.1),
    (2, 200, 128, False, True, 0.0),
    (2, 65, 96, True, True, 0.1),
]
# the faults show where dropout is on and a second tile carries weight
FAULT_CASES = [c for c in CASES if c[-1] > 0 and c[1] >= 128]


def _forward(dtype, case, seed=0, **variant):
    bh, t, d, causal, masked, rate = case
    q, k, v, do, m = _inputs(dtype, bh, t, d, masked, seed)
    s = torch.tensor([1234 + seed], dtype=torch.int32)
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, dropout_rate=rate)
    ref, lse = ca.flash_attention_reference(q, k, v, m, s, **kw)
    slack = fc.forward_slack(q, k, v, m, s, unit=fc.ROUNDING[dtype], **kw)
    got, got_lse = fc.forward_variant(q, k, v, m, s, round_to=dtype,
                                      **variant, **kw)
    _, share = fc.excess(got, ref, slack, FWD_ATOL, RTOL[dtype])
    return share, (got_lse - lse).abs().max().item()


def _dkv(dtype, case, seed=0, **variant):
    bh, t, d, causal, masked, rate = case
    q, k, v, do, m = _inputs(dtype, bh, t, d, masked, seed)
    s = torch.tensor([99 - seed], dtype=torch.int32)
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, dropout_rate=rate)
    out, lse = ca.flash_attention_reference(q, k, v, m, s, **kw)
    delta = ca.attention_delta(do, out)
    args = (q, k, v, m, s, do, lse, delta)
    ref_dk, ref_dv = ca.flash_attention_dkv_reference(*args, **kw)
    slack_dk, slack_dv = fc.dkv_slack(*args, unit=fc.ROUNDING[dtype], **kw)
    dk, dv = fc.dkv_variant(*args, round_to=dtype, **variant, **kw)
    return (fc.excess(dk, ref_dk, slack_dk, DKV_ATOL, RTOL[dtype])[1],
            fc.excess(dv, ref_dv, slack_dv, DKV_ATOL, RTOL[dtype])[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", CASES)
def test_rounded_plain_forward_passes_the_bound(dtype, case):
    share, lse_err = _forward(dtype, case)
    assert share <= 1.0
    assert lse_err <= 1e-4  # the tiles' lse is the plain logsumexp


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", CASES)
def test_rounded_plain_dkv_passes_the_bound(dtype, case):
    assert max(_dkv(dtype, case)) <= 1.0


def _dq(dtype, case, seed=0, slack=True, **variant):
    bh, t, d, causal, masked, rate = case
    q, k, v, do, m = _inputs(dtype, bh, t, d, masked, seed + 20)
    s = torch.tensor([4321 + seed], dtype=torch.int32)
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, dropout_rate=rate)
    out, lse = ca.flash_attention_reference(q, k, v, m, s, **kw)
    delta = ca.attention_delta(do, out)
    args = (q, k, v, m, s, do, lse, delta)
    ref = ca.flash_attention_dq_reference(*args, **kw)
    sl = fc.dq_slack(*args, unit=fc.ROUNDING[dtype] if slack else 0.0, **kw)
    dq = fc.dq_variant(*args, round_to=dtype, **variant, **kw)
    return fc.excess(dq, ref, sl, DKV_ATOL, RTOL[dtype])[1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", CASES)
def test_rounded_plain_dq_passes_the_bound(dtype, case):
    assert _dq(dtype, case) <= 1.0


@pytest.mark.parametrize("case", CASES)
def test_the_dq_rounding_needs_the_slack(case):
    """Without the slack term the plain dq with dS rounded to bfloat16, as
    the sm90 and TPU kernels round it, fails the old one-unit check."""
    assert _dq(torch.bfloat16, case, slack=False) > 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("fault", fc.DQ_FAULTS)
@pytest.mark.parametrize("case", FAULT_CASES)
def test_each_dq_fault_exceeds_the_bound(dtype, fault, case):
    assert _dq(dtype, case, fault=fault) > 1.0, fault


@pytest.mark.parametrize("causal", [False, True])
def test_unfaulted_tiled_dq_is_the_plain_version(causal):
    """Without rounding or fault the dq variant computes the plain dq
    (float32: the scale applied after the sum instead of before)."""
    q, k, v, do, m = _inputs(torch.float32, 3, 130, 64, not causal, 6)
    s = torch.tensor([9], dtype=torch.int32)
    kw = dict(scale=0.125, causal=causal, dropout_rate=0.1)
    out, lse = ca.flash_attention_reference(q, k, v, m, s, **kw)
    args = (q, k, v, m, s, do, lse, ca.attention_delta(do, out))
    np.testing.assert_allclose(fc.dq_variant(*args, **kw).numpy(),
                               ca.flash_attention_dq_reference(
                                   *args, **kw).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", CASES)
def test_the_rounding_needs_the_slack(dtype, case):
    """Without the slack term the rounded plain version fails the old
    one-unit check: the term is what the rounding needs, not spare room."""
    bh, t, d, causal, masked, rate = case
    q, k, v, do, m = _inputs(dtype, bh, t, d, masked, 0)
    s = torch.tensor([1234], dtype=torch.int32)
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, dropout_rate=rate)
    ref, _ = ca.flash_attention_reference(q, k, v, m, s, **kw)
    got, _ = fc.forward_variant(q, k, v, m, s, round_to=dtype, **kw)
    zero = torch.zeros(ref.shape)
    assert fc.excess(got, ref, zero, FWD_ATOL, RTOL[dtype])[1] > 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("fault", fc.FAULTS)
@pytest.mark.parametrize("case", FAULT_CASES)
def test_each_forward_fault_exceeds_the_bound(dtype, fault, case):
    share, _ = _forward(dtype, case, fault=fault)
    assert share > 1.0, (fault, share)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("fault", fc.DKV_FAULTS)
@pytest.mark.parametrize("case", FAULT_CASES)
def test_each_dkv_fault_exceeds_the_bound(dtype, fault, case):
    assert max(_dkv(dtype, case, fault=fault)) > 1.0, fault


def test_unfaulted_tiled_forward_is_the_plain_version():
    """Without rounding or fault the tiled variant computes the plain
    forward (float32: another summation order)."""
    q, k, v, _, m = _inputs(torch.float32, 3, 130, 64, True, 5)
    s = torch.tensor([8], dtype=torch.int32)
    kw = dict(scale=0.125, causal=False, dropout_rate=0.1)
    ref, lse = ca.flash_attention_reference(q, k, v, m, s, **kw)
    got, got_lse = fc.forward_variant(q, k, v, m, s, **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), lse.numpy(), rtol=1e-5,
                               atol=1e-5)


# T 128 where a row is fully masked: the Pallas wrapper pads T to whole
# blocks, and a fully masked row then averages the zero padding too
JAX_CASES = [  # (bh, t, d, causal, masked, rate)
    (3, 128, 64, False, True, 0.1),
    (3, 130, 64, False, False, 0.1),
    (2, 96, 32, True, False, 0.1),
    (2, 80, 64, False, False, 0.0),
]


def _jnp_bf16(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("case", JAX_CASES)
def test_plain_bf16_forward_vs_pallas_interpret_under_the_bound(case):
    """The TPU forward kernel in bfloat16 (interpret mode) rounds p before
    p @ v: it sits within the sm90 bound of the port's plain version."""
    bh, t, d, causal, masked, rate = case
    q, k, v, _, m = _inputs(torch.bfloat16, bh, t, d, masked, 7)
    scale = 1.0 / math.sqrt(d)
    seed = 20260917
    out, lse = jpa._flash_fwd(
        _jnp_bf16(q), _jnp_bf16(k), _jnp_bf16(v),
        None if m is None else jnp.asarray(m.numpy()),
        jnp.array([[seed]], jnp.int32), scale=scale, causal=causal,
        block_q=64, block_k=64, interpret=True, dropout_rate=rate)
    assert out.dtype == jnp.bfloat16
    kw = dict(scale=scale, causal=causal, dropout_rate=rate)
    ref, ref_lse = ca.flash_attention_reference(q, k, v, m, seed, **kw)
    slack = fc.forward_slack(q, k, v, m, seed, unit=fc.ROUNDING[
        torch.bfloat16], **kw)
    tpu = torch.from_numpy(np.asarray(out.astype(jnp.float32)))
    assert fc.excess(tpu, ref, slack, FWD_ATOL,
                     RTOL[torch.bfloat16])[1] <= 1.0
    np.testing.assert_allclose(np.asarray(lse)[..., 0], ref_lse.numpy(),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", JAX_CASES)
def test_plain_bf16_dkv_vs_pallas_interpret_under_the_bound(case):
    """The TPU dk/dv kernel in bfloat16 (interpret mode, from the port's
    plain out and lse) rounds scale·ds and p̃ before its products: it sits
    within the sm90 bound of the port's plain dk/dv."""
    bh, t, d, causal, masked, rate = case
    q, k, v, do, m = _inputs(torch.bfloat16, bh, t, d, masked, 8)
    scale = 1.0 / math.sqrt(d)
    seed = -31337
    kw = dict(scale=scale, causal=causal, dropout_rate=rate)
    out, lse = ca.flash_attention_reference(q, k, v, m, seed, **kw)
    _, jdk, jdv = jpa._flash_bwd(
        _jnp_bf16(q), _jnp_bf16(k), _jnp_bf16(v),
        None if m is None else jnp.asarray(m.numpy()),
        jnp.array([[seed]], jnp.int32), _jnp_bf16(out),
        jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None], (bh, t, 8)),
        _jnp_bf16(do), scale=scale, causal=causal, block_q=64, block_k=64,
        interpret=True, dropout_rate=rate)
    delta = ca.attention_delta(do, out)
    args = (q, k, v, m, seed, do, lse, delta)
    ref_dk, ref_dv = ca.flash_attention_dkv_reference(*args, **kw)
    slack_dk, slack_dv = fc.dkv_slack(*args, unit=fc.ROUNDING[
        torch.bfloat16], **kw)
    for got, ref, slack in ((jdk, ref_dk, slack_dk), (jdv, ref_dv, slack_dv)):
        got = torch.from_numpy(np.asarray(got.astype(jnp.float32)))
        assert fc.excess(got, ref, slack, DKV_ATOL,
                         RTOL[torch.bfloat16])[1] <= 1.0


@pytest.mark.parametrize("case", JAX_CASES)
def test_plain_bf16_dq_vs_pallas_interpret_under_the_bound(case):
    """The TPU dq kernel in bfloat16 (interpret mode, from the port's plain
    out and lse) rounds the unscaled ds before ds @ k and scales the
    float32 sum: it sits within the sm90 dq bound of the port's plain
    dq."""
    bh, t, d, causal, masked, rate = case
    q, k, v, do, m = _inputs(torch.bfloat16, bh, t, d, masked, 10)
    scale = 1.0 / math.sqrt(d)
    seed = 7777
    kw = dict(scale=scale, causal=causal, dropout_rate=rate)
    out, lse = ca.flash_attention_reference(q, k, v, m, seed, **kw)
    jdq, _, _ = jpa._flash_bwd(
        _jnp_bf16(q), _jnp_bf16(k), _jnp_bf16(v),
        None if m is None else jnp.asarray(m.numpy()),
        jnp.array([[seed]], jnp.int32), _jnp_bf16(out),
        jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None], (bh, t, 8)),
        _jnp_bf16(do), scale=scale, causal=causal, block_q=64, block_k=64,
        interpret=True, dropout_rate=rate)
    assert jdq.dtype == jnp.bfloat16
    delta = ca.attention_delta(do, out)
    args = (q, k, v, m, seed, do, lse, delta)
    ref = ca.flash_attention_dq_reference(*args, **kw)
    slack = fc.dq_slack(*args, unit=fc.ROUNDING[torch.bfloat16], **kw)
    got = torch.from_numpy(np.asarray(jdq.astype(jnp.float32)))
    assert fc.excess(got, ref, slack, DKV_ATOL,
                     RTOL[torch.bfloat16])[1] <= 1.0
