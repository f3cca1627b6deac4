"""The split-TF32 arithmetic of the float32 tensor-core kernels, on the CPU.

``csrc/fused_matmul_f32_sm90.cu``, ``csrc/flash_attn_fwd_f32_sm90.cu``,
``csrc/flash_attn_dq_f32_sm90.cu`` and ``csrc/flash_attn_dkv_f32_sm90.cu``
form every float32 product from TF32 parts — hi = tf32(v), lo = tf32(v −
hi), then lo·hi + hi·lo + hi·hi — and are held on the card to the float32
checks, unchanged. ``testing/split_f32.py`` transcribes that arithmetic in
plain PyTorch. With no card, these tests check:

* (a) the transcription sits inside the float32 checks against the plain
  versions: ``cuda_matmul.kernel_tolerance`` for the fused matmul (at most
  :data:`SHARE_MM` of it here), the card's float32 flash bounds for the
  forward (out within 1e-4, at most :data:`SHARE_FLASH` of it; lse within
  1e-4) and for dq, dk and dv (``chip_smoke.BWD_ATOL`` 1e-4 +
  ``BWD_RTOL`` 1e-5·|plain|, at most :data:`SHARE_FLASH` of it), masked,
  causal and with dropout;
* (b) a single TF32 pass, and the split with one lo pass dropped, break
  the same checks — so a kernel that quietly ran either fails on the card
  (the backward's by at least :data:`BWD_FAULT_MARGIN` × here; the
  backward's tile faults, the keep mask shifted a column and the last
  32-wide tile dropped, break its bound too);
* (c) the transcription against the JAX package's Pallas kernels run in
  interpret mode in float32 (``fused_matmul_bias_act_pallas``,
  ``_flash_fwd``, ``_flash_bwd``'s dq, dk and dv): the yardstick the TPU
  kernels themselves meet;
* (d) P·V as the flash kernel feeds it to the tensor cores — P's
  accumulator registers handed as the TF32 A fragment, Vᵀ's keys permuted
  0, 2, 4, 6, 1, 3, 5, 7 within each group of 8 — is the plain P·V, and
  without the permutation it is not; likewise the backward's dS·K (Kᵀ's
  keys permuted), P̃ᵀ·dO and dSᵀ·Q (dOᵀ's and Qᵀ's queries permuted, the
  accumulators transposed: a row is a key) at its 32-wide tiles;
* (e) the split weight copy: TF32 parts, made once, remade after an
  in-place change. ``matmul_design`` and ``flash_design`` are pinned over
  every dtype, K and N residue, alignment, head dim and kernel by
  ``tests/test_torch_fused_matmul.py`` and ``tests/test_torch_flash_sm90.py``.

Measured here: the transcription at 0.018–0.034 of ``kernel_tolerance``
and 0.006–0.012 of the flash bound; one TF32 pass 7.9–18.9× and 6.1–10.6×
over them, one lo pass dropped 5.7–13.8× and 4.0–4.5×. The backward's
dq, dk and dv at 0.010–0.117 of their bound (the highest with a row
whose keys are all masked, where p = 1), one TF32 pass 11.9–174× over it,
one lo pass dropped 7.6–143×. On the H100 the
kernels sit higher (PERF.md): the tensor cores add each wgmma's sum into
their accumulator in a rounding of their own, which no transcription
reproduces, and which the matmul kernel bounds by promoting its partial
sums every 64 K values.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu.ops import pallas_matmul as jpm
from deeplearning4j_tpu_torch.ops import cuda_attention as ca
from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
from deeplearning4j_tpu_torch.testing import flash_check as fc
from deeplearning4j_tpu_torch.testing import split_f32 as sf

SHARE_MM = 0.25     # of kernel_tolerance, the transcription at most
SHARE_FLASH = 0.25  # of the 1e-4 flash bound, the transcription at most
BWD_FAULT_MARGIN = 2.0  # the backward's faults break its bound by this

MM_CASES = [  # (lead, K, N, activation)
    ((64,), 768, 96, "none"),
    ((2, 40), 3072, 64, "gelu_exact"),
    ((96,), 776, 100, "gelu"),
]
FLASH_CASES = [  # (bh, t, d, causal, masked, rate)
    (3, 130, 64, False, True, 0.1),
    (2, 96, 32, True, False, 0.0),
    (2, 80, 128, False, False, 0.1),
]
# the float32 dq and dk/dv take D <= 64; no causal case with a row whose
# keys are all masked (the kernels, as the sm90 ones, give past-diagonal
# keys of such a row p = 0 where the plain version's -1e30 fill gives 1)
BWD_CASES = [  # (bh, t, d, causal, masked, rate)
    (3, 130, 64, False, True, 0.1),
    (2, 96, 32, True, False, 0.0),
    (2, 200, 64, True, True, 0.1),
]


def _mm_inputs(lead, k, n, seed=6):
    g = np.random.default_rng(seed)
    x = g.standard_normal(lead + (k,), dtype=np.float32)
    w = (0.02 * g.standard_normal((k, n))).astype(np.float32)
    b = (0.1 * g.standard_normal(n)).astype(np.float32)
    return x, w, b


def _mm_share(got, x, w, ref):
    atol, rtol = cm.kernel_tolerance(x, w, ref)
    return ((got - ref).abs() / (atol + rtol * ref.abs())).max().item()


def _flash_inputs(bh, t, d, masked, seed=7):
    g = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(g.standard_normal((bh, t, d),
                                                  dtype=np.float32))
               for _ in range(3))
    m = None
    if masked:  # end-padded rows, one with every key masked
        lens = torch.tensor([t, t // 3, 0][:bh])
        m = (torch.arange(t)[None] < lens[:, None]).float()
    return q, k, v, m


def _flash(case, passes="split"):
    bh, t, d, causal, masked, rate = case
    q, k, v, m = _flash_inputs(bh, t, d, masked)
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, dropout_rate=rate)
    ref, ref_lse = ca.flash_attention_reference(q, k, v, m, 20260917, **kw)
    out, lse = sf.flash_forward_split(q, k, v, m, 20260917, passes=passes,
                                      **kw)
    return (out - ref).abs().max().item(), (lse - ref_lse).abs().max().item()


def _bwd_args(case, seed=9):
    bh, t, d, causal, masked, rate = case
    q, k, v, m = _flash_inputs(bh, t, d, masked, seed)
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (bh, t, d), dtype=np.float32))
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, dropout_rate=rate)
    out, lse = ca.flash_attention_reference(q, k, v, m, 4321, **kw)
    return (q, k, v, m, 4321, do, lse, ca.attention_delta(do, out)), kw, out


def _bwd_share(got, ref):
    """The share of the card's float32 backward bound a gradient uses."""
    return fc.excess(got, ref, torch.zeros(()), chip_smoke.BWD_ATOL,
                     chip_smoke.BWD_RTOL["float32"])[1]


def _bwd(case, passes="split"):
    """The shares of dq, dk and dv of the transcription (``passes``)."""
    args, kw, _ = _bwd_args(case)
    ref = (ca.flash_attention_dq_reference(*args, **kw),
           *ca.flash_attention_dkv_reference(*args, **kw))
    got = (sf.flash_dq_split(*args, passes=passes, **kw),
           *sf.flash_dkv_split(*args, passes=passes, **kw))
    assert all(g.shape == r.shape for g, r in zip(got, ref))
    return [_bwd_share(g, r) for g, r in zip(got, ref)]


def test_the_bounds_are_the_card_checks():
    assert sf.F32_ATOL == chip_smoke.ATOL["float32"]
    assert chip_smoke.RTOL["float32"] == 0.0
    assert sf.F32_LSE_TOL == chip_smoke.TOL_LSE
    # the backward's: 1e-4 + 1e-5·|plain|, as the CUDA-core kernels were held
    assert (chip_smoke.BWD_ATOL, chip_smoke.BWD_RTOL["float32"]) == (1e-4,
                                                                      1e-5)


# ------------------------------------------------------------ (a), (b)


@pytest.mark.parametrize("case", MM_CASES)
def test_split_matmul_sits_inside_kernel_tolerance(case):
    lead, k, n, act = case
    x, w, b = (torch.from_numpy(a) for a in _mm_inputs(lead, k, n))
    ref = cm.fused_matmul_bias_act_reference(x, w, b, activation=act)
    got = sf.fused_matmul_split(x, w, b, activation=act)
    assert got.shape == ref.shape
    assert _mm_share(got, x, w, ref) <= SHARE_MM


@pytest.mark.parametrize("passes", ["single", "lo_dropped"])
@pytest.mark.parametrize("case", MM_CASES)
def test_single_pass_and_a_dropped_lo_pass_break_kernel_tolerance(case,
                                                                  passes):
    lead, k, n, act = case
    x, w, b = (torch.from_numpy(a) for a in _mm_inputs(lead, k, n))
    ref = cm.fused_matmul_bias_act_reference(x, w, b, activation=act)
    got = sf.fused_matmul_split(x, w, b, activation=act, passes=passes)
    assert _mm_share(got, x, w, ref) > 1.0


@pytest.mark.parametrize("case", FLASH_CASES)
def test_split_flash_forward_sits_inside_the_float32_bounds(case):
    err, lse_err = _flash(case)
    assert err <= SHARE_FLASH * sf.F32_ATOL
    assert lse_err <= sf.F32_LSE_TOL


@pytest.mark.parametrize("passes", ["single", "lo_dropped"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_single_pass_and_a_dropped_lo_pass_break_the_flash_bound(case,
                                                                 passes):
    err, _ = _flash(case, passes)
    assert err > sf.F32_ATOL


@pytest.mark.parametrize("case", BWD_CASES)
def test_split_flash_backward_sits_inside_the_float32_bound(case):
    shares = _bwd(case)
    assert max(shares) <= SHARE_FLASH, shares


@pytest.mark.parametrize("passes", ["single", "lo_dropped"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_single_pass_and_a_dropped_lo_pass_break_the_backward_bound(case,
                                                                    passes):
    shares = _bwd(case, passes)  # each of dq, dk and dv
    assert min(shares) > BWD_FAULT_MARGIN, shares


@pytest.mark.parametrize("fault", fc.DQ_FAULTS)
@pytest.mark.parametrize("case", [c for c in BWD_CASES if c[-1] > 0])
def test_backward_tile_faults_break_the_float32_bound(case, fault):
    """The faulted plain variants chip_smoke holds the float32 kernels'
    bound against, at their 32-wide tiles: each breaks it."""
    args, kw, _ = _bwd_args(case)
    tile = sf.FLASH_BWD_TILE
    dq = fc.dq_variant(*args, fault=fault, tile=tile, **kw)
    dk, dv = fc.dkv_variant(*args, fault=fault, tile=tile, **kw)
    ref_dk, ref_dv = ca.flash_attention_dkv_reference(*args, **kw)
    assert _bwd_share(dq, ca.flash_attention_dq_reference(*args, **kw)) > 1
    assert max(_bwd_share(dk, ref_dk), _bwd_share(dv, ref_dv)) > 1


# ------------------------------------------------------------------ (c)


@pytest.mark.parametrize("case", MM_CASES)
def test_split_matmul_vs_pallas_interpret_float32(case):
    lead, k, n, act = case
    x, w, b = _mm_inputs(lead, k, n)
    want = jpm.fused_matmul_bias_act_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), activation=act,
        interpret=True)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = sf.fused_matmul_split(tx, tw, tb, activation=act)
    tpu = torch.from_numpy(np.array(want))
    assert _mm_share(got, tx, tw, tpu) <= 1.0


@pytest.mark.parametrize("case", FLASH_CASES)
def test_split_flash_forward_vs_pallas_interpret_float32(case):
    bh, t, d, causal, masked, rate = case
    if masked:  # the Pallas wrapper pads T to whole blocks, and a fully
        t = 128  # masked row then averages the padding too: T 128 here
    q, k, v, m = _flash_inputs(bh, t, d, masked)
    scale = 1.0 / math.sqrt(d)
    seed = 20260917
    out, lse = jpa._flash_fwd(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), None if m is None else jnp.asarray(m.numpy()),
        jnp.array([[seed]], jnp.int32), scale=scale, causal=causal,
        block_q=64, block_k=64, interpret=True, dropout_rate=rate)
    got, got_lse = sf.flash_forward_split(q, k, v, m, seed, scale=scale,
                                          causal=causal, dropout_rate=rate)
    tpu = torch.from_numpy(np.array(out))
    assert (got - tpu).abs().max().item() <= sf.F32_ATOL
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0],
                               rtol=0, atol=sf.F32_LSE_TOL)


@pytest.mark.parametrize("case", BWD_CASES)
def test_split_flash_backward_vs_pallas_interpret_float32(case):
    """dq, dk and dv of the transcription against ``_flash_bwd``'s Pallas
    kernels in interpret mode in float32 (from the port's plain out and
    lse), under the card's float32 backward bound."""
    bh, t, d, causal, masked, rate = case
    if masked:  # the Pallas wrapper pads T to whole blocks (see above)
        t = 128
    args, kw, out = _bwd_args((bh, t, d, causal, masked, rate))
    q, k, v, m, seed, do, lse, _ = args
    jdq, jdk, jdv = jpa._flash_bwd(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)),
        None if m is None else jnp.asarray(m.numpy()),
        jnp.array([[seed]], jnp.int32), jnp.asarray(out.numpy()),
        jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None], (bh, t, 8)),
        jnp.asarray(do.numpy()), scale=kw["scale"], causal=causal,
        block_q=64, block_k=64, interpret=True, dropout_rate=rate)
    got = (sf.flash_dq_split(*args, **kw), *sf.flash_dkv_split(*args, **kw))
    for g, want in zip(got, (jdq, jdk, jdv)):
        assert want.dtype == jnp.float32
        assert _bwd_share(g, torch.from_numpy(np.array(want))) <= 1.0


# ------------------------------------------------------------------ (d)


@pytest.mark.parametrize("keys,d", [(64, 64), (32, 128)])
def test_the_register_a_operand_and_the_permuted_v_give_p_times_v(keys, d):
    g = np.random.default_rng(keys + d)
    p = torch.from_numpy(g.random((64, keys)).astype(np.float64))
    v = torch.from_numpy(g.standard_normal((keys, d)))
    a, pv = sf.register_pv(p, v)
    assert not torch.isnan(a).any()  # every A entry comes from a register
    np.testing.assert_allclose(pv.numpy(), (p @ v).numpy(), rtol=1e-12,
                               atol=1e-12)
    # the permutation is what makes it right: V in key order is not
    assert not torch.allclose(a @ v, p @ v)
    assert sorted(sf.group_key(j) for j in range(keys)) == list(range(keys))


@pytest.mark.parametrize("product", ["dS·K", "P̃ᵀ·dO", "dSᵀ·Q"])
def test_the_backward_register_a_operands_and_permuted_copies(product):
    """The float32 dq hands dS (64 queries × 32 keys) as the A operand of
    dS·K against Kᵀ's keys permuted; its dk/dv hands the transposed
    accumulators P̃ᵀ and dSᵀ (64 keys × 32 queries) against dOᵀ's and Qᵀ's
    queries permuted. Each gives the plain product, and only with the
    permutation."""
    g = np.random.default_rng(len(product.encode()))
    tile = sf.FLASH_BWD_TILE
    acc = g.standard_normal((64, tile))
    if product == "P̃ᵀ·dO":  # probabilities: non-negative
        acc = np.abs(acc) / tile
    acc = torch.from_numpy(acc)
    b = torch.from_numpy(g.standard_normal((tile, 64)))
    a, got = sf.register_pv(acc, b)
    assert not torch.isnan(a).any()
    np.testing.assert_allclose(got.numpy(), (acc @ b).numpy(), rtol=1e-12,
                               atol=1e-12)
    assert not torch.allclose(a @ b, acc @ b)


def test_the_split_weight_copy_is_made_once_and_kept(monkeypatch):
    w = torch.from_numpy(_mm_inputs((1,), 96, 40)[1])
    # the copy's kernel runs on the card only (a card test holds its bits
    # to tf32_split's); here the transcription stands in for it
    with pytest.raises(ValueError, match="unsupported device"):
        cm.kmajor_split(w)
    monkeypatch.setattr(cm, "kmajor_split", lambda t: sf.tf32_split(t.t()))
    copies = cm.kmajor_weight.copies
    ws = cm.kmajor_weight(w, split=True)
    assert ws.shape == (2, 40, 96) and ws.is_contiguous()
    hi, lo = ws
    assert torch.equal(hi, sf.tf32_round(w.t().contiguous()))
    assert torch.equal(lo, sf.tf32_round(w.t() - hi))
    # the low 13 bits of both parts are clear: TF32 values
    for part in (hi, lo):
        assert not (part.contiguous().view(torch.int32) & 0x1FFF).any()
    assert cm.kmajor_weight(w, split=True) is ws
    assert cm.kmajor_weight.copies == copies + 1
    w.add_(1.0)  # an in-place change remakes it
    assert not torch.equal(cm.kmajor_weight(w, split=True)[0], hi)
    assert cm.kmajor_weight.copies == copies + 2
