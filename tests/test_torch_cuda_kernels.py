"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a GPU (the
decision is taken inside the ``cuda`` fixture, never at import). Run them
on the card with::

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

``chip_smoke.py`` holds each kernel against its plain version at the
main path's shapes; these cover the edges. Attention: ragged lengths,
one-row queries, non-causal and rectangular attention, head dims of every
instantiation (padded and exact), other page sizes, empty (inactive)
decode slots, the split-KV paged decode with every slot at full context,
one page a slot and 32 heads (split over blocks at D 256), one launch a
call, and the three dtypes; in-kernel dropout (the dropped
entries read out and compared with ``keep_mask``), the dq and dk/dv
kernels with and without dropout (the tensor-core "sm90" forward, dq and
dk/dv for bfloat16/float16 at D 16…128 × T 1…512 × causal / key mask /
dropout under the sm90 bound of ``testing/flash_check.py``, the same bits
twice, routing by counters; the float32 tensor-core "sm90_f32" forward at
D 8…128 and dq and dk/dv at D 8…64 × T 1…512 × the same variants under
the float32 tolerance itself, the same bits twice, and their faulted
variants — one TF32 pass among them — beyond it), gradients through the
registry's
``dot_product_attention``, and a small BERT trained through all three
flash kernels. Training: every updater kind on
ragged, aligned and unaligned leaves in the three dtypes, one leaf a
launch and a tree of them in one multi-tensor launch (and two past
``TABLE_LEAVES``), launches and leaves counted apart; the convbn
kernel's gate edges, prologue/relu on and off, its backward against
autograd of the plain chain, and a small ResNet-50 in both
configurations; its tensor-core "sm90" design at every tile width, one
and many K slabs and row blocks (the same bits twice), each 128-row
block's partial sums
to ``partials_tolerance``, the faulted plain variants of
``testing/matmul_check.py`` beyond that check at a stage-3 shape, and
the WMMA design on operands off 16-byte alignment. The fused matmul epilogue: ragged M and N and K that are
not tile multiples, every activation, the three dtypes, unaligned
operands (element loads), the tensor-core "sm90" design at ragged M, K
and N (multiples of 8) for bfloat16/float16 and which design
``matmul_design`` picks, by counters, gradients through the registry, the gate and
the wrapper's refusals, and a small imported BERT whose every epilogue
fusion launches the kernel; the float32 tensor-core "sm90_f32" design
(three TF32 passes a product) at ragged M, K (multiples of 4) and N (odd
included), every activation, 2-D and 3-D x, to ``kernel_tolerance``, the
same bits twice, its K-major split weight copy made once and remade after
an in-place change, and its faulted variants (one TF32 pass, the last
32-deep slab dropped, a slab added twice) beyond the tolerance. The fused LayerNorm + activation: rows 1, 7
and 4096, D 64 / 96 / 768 / 1000 / 4096 (the warp and the block path)
and an odd D and unaligned rows (element accesses), every activation,
the three dtypes, bias on and off, gradients through the registry, the
gate and the wrapper's refusals, a failed build and a failed launch
raising, and a small imported BERT fine-tuned through ``sd.fit`` whose
head's LayerNorm → GELU launches the kernel once a step. The int8
serving matmul: the row quantization, the GEMM and both together bit for
bit against their plain versions at ragged M (1, 17, 4095), N (2, 9, 130)
and K (7, 768, 3072), 2-D and 3-D x, (N,) and (1, N) scales, unaligned
operands (element paths), the three dtypes; the straight-through
gradients through the registry against the generic run's; the gate and
the wrappers' refusals; and a small int8 encoder recorded through
SameDiff whose every dense MatMul launches the kernels; the sm90 int8
GEMM bit for bit at ragged M (1, 130, 4095), N (2, 9, 200, 768) and K
(16, 784, 3072), the same bits twice, the s32 accumulator map read out
of a product whose every entry is known (r + 4096·c) in both tile
widths, its faulted variants breaking bit-exactness, and routing by
counters with the K-major weight copy made once and remade after an
in-place change. Attention at a
head dim past the kernels (D = 320) runs the plain op and counts a
generic dispatch. ``lstm_layer``'s cuDNN helper (a library call, not a
hand-written kernel) against its generic: outputs at every position, the
last h and c and the gradients, forward and reverse, with no mask and a
right-padded one, from a zero and a carried state; float16; the padded
positions (the last h forward, the initial h reverse); the gate's
refusals (interior mask, hardsigmoid gates, a non-tanh cell, bfloat16)
tallied as generic, and a BiLSTM tagger dispatching cuDNN once a
direction.

Tolerances, elementwise ``|kernel - plain| <= ATOL + RTOL * |plain|``:
float32 1e-4 absolute (same math, another summation order; ~1e-6 seen);
bfloat16 and float16 one unit in the last place of the plain output
(RTOL 2^-7 and 2^-10, ATOL 1e-5): both sides compute in float32 and round
once, so they differ by at most one rounding step. The float32 lse:
1e-4 absolute. The backward: 1e-4 absolute plus, relative, 1e-5 in
float32 and one unit in the last place in bfloat16/float16 (sums of up
to T products whose terms reach ~16 at D = 256). The fused matmul:
``cuda_matmul.kernel_tolerance`` (the float32 summation bound of K terms
plus one unit in the last place in bfloat16/float16); its gradients, two
products of the same numbers in another order, 1e-4 in float32 and one
bfloat16 unit (2^-6 relative, 1e-2 absolute) in bfloat16. The fused
LayerNorm: ``cuda_layernorm.kernel_tolerance`` (float32 1e-5 relative and
absolute; bfloat16/float16 one unit in the last place plus 1e-5); its
gradients, the same autograd of the same float32 math on both sides,
1e-5 in float32. cuDNN's LSTM against the generic scan, float32 with
TF32 off: outputs, h and c 1e-5, gradients 1e-4 (the same products
summed in cuDNN's order over 12 steps); float16 1e-2 absolute (outputs
in (-1, 1), ten float16 units at 1).
"""

import functools
import math

import numpy as np
import pytest

import torch

from deeplearning4j_tpu_torch.datasets import synthetic_image_batch
from deeplearning4j_tpu_torch.environment import environment
from deeplearning4j_tpu_torch.models import ResNet50
from deeplearning4j_tpu_torch.models.gpt import (
    GptConfig, GptModel, init_gpt_params, reference_generate)
from deeplearning4j_tpu_torch.nn import updater as U
from deeplearning4j_tpu_torch.ops import cuda_attention as ca
from deeplearning4j_tpu_torch.ops import cuda_convbn as cc
from deeplearning4j_tpu_torch.ops import cuda_updater as cu
from deeplearning4j_tpu_torch.ops import exec_op
from deeplearning4j_tpu_torch.serving import GenerativeEngine
from deeplearning4j_tpu_torch.testing import flash_check as fc

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-5, torch.float16: 1e-5}
LSE_TOL = 1e-4
# one head dim per instantiation at its full width and one padded below it
HEAD_DIMS = [8, 32, 48, 64, 96, 128, 200, 256]


def _assert_close(out, ref, dtype, slack=0.0):
    ref = ref.float()
    err = (out.float() - ref).abs()
    lim = ATOL[dtype] + RTOL[dtype] * ref.abs() + slack
    worst = (err / lim).max().item()
    assert worst <= 1.0, (f"max |kernel - plain| {err.max().item():.3g}, "
                          f"{worst:.3g} x the tolerance")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(shape, dtype, dev, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape, dtype=np.float32)).to(
        dev, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t_q,t_k,causal,masked", [
    (1, 1, True, False),       # one row
    (70, 70, True, True),      # ragged edge, two tiles, causal skip
    (64, 64, True, False),     # exactly one tile
    (130, 130, False, True),   # non-causal, masked, three tiles
    (20, 90, False, False),    # rectangular
])
def test_flash_matches_plain(cuda, dtype, d, t_q, t_k, causal, masked):
    bh = 3
    q = _randn((bh, t_q, d), dtype, cuda, 0)
    k = _randn((bh, t_k, d), dtype, cuda, 1)
    v = _randn((bh, t_k, d), dtype, cuda, 2)
    m = None
    if masked:
        lens = torch.tensor([t_k, max(1, t_k // 3), 1], device=cuda)
        m = (torch.arange(t_k, device=cuda)[None] < lens[:, None]).float()
    before = ca.flash_attention.launches
    out, lse = ca.flash_attention(q, k, v, m, causal=causal)
    ref, ref_lse = ca.flash_attention_reference(q, k, v, m, causal=causal)
    torch.cuda.synchronize()
    assert ca.flash_attention.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    # the sm90 design rounds P to the input dtype (testing/flash_check.py)
    unit = fc.rounding_unit(dtype, ca.flash_design(dtype, d, "fwd"))
    _assert_close(out, ref, dtype, fc.forward_slack(
        q, k, v, m, scale=1.0 / math.sqrt(d), causal=causal, unit=unit))
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


def test_flash_fully_masked_rows_are_finite(cuda):
    q = _randn((2, 40, 64), torch.float32, cuda, 3)
    m = torch.zeros(2, 40, device=cuda)
    out, lse = ca.flash_attention(q, q, q, m, causal=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


def test_flash_rejects_what_it_does_not_take(cuda):
    for d in (44, 264):  # not a multiple of 8; past the largest tile
        q = _randn((2, 16, d), torch.float32, cuda, 4)
        with pytest.raises(ValueError, match="head dim"):
            ca.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="head dim"):
            ca.paged_decode_attention(
                q[:, :1].contiguous(), q.reshape(2, 16, 1, d),
                q.reshape(2, 16, 1, d),
                torch.zeros(2, 2, dtype=torch.int32, device=cuda),
                torch.ones(2, dtype=torch.int32, device=cuda))
    q = _randn((2, 16, 64), torch.float64, cuda, 4)
    with pytest.raises(ValueError, match="dtypes"):
        ca.flash_attention(q, q, q)
    q = _randn((2, 16, 64), torch.float32, cuda, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ca.flash_attention(q.transpose(0, 1), q.transpose(0, 1),
                           q.transpose(0, 1))


def test_flash_dropout_matches_plain_and_drops_the_same(cuda):
    """The dropout forward against its plain version, and the masks read
    out with V = identity columns (out[i, j] = kept, scaled p_ij): the
    kernel drops exactly the entries :func:`keep_mask` drops."""
    bh, t, d, rate = 6, 64, 64, 0.3
    q = _randn((bh, t, d), torch.float32, cuda, 40)
    k = _randn((bh, t, d), torch.float32, cuda, 41)
    v = torch.eye(t, d, device=cuda).expand(bh, t, d).contiguous()
    lens = torch.tensor([64, 50, 33, 17, 64, 1], device=cuda)
    m = (torch.arange(t, device=cuda)[None] < lens[:, None]).float()
    seed = torch.tensor([-987654321], dtype=torch.int32, device=cuda)
    for causal in (False, True):
        out, lse = ca.flash_attention(q, k, v, m, seed, causal=causal,
                                      dropout_rate=rate)
        ref, ref_lse = ca.flash_attention_reference(
            q, k, v, m, seed, causal=causal, dropout_rate=rate)
        torch.cuda.synchronize()
        _assert_close(out, ref, torch.float32)
        assert (lse - ref_lse).abs().max().item() <= LSE_TOL
        visible = (m[:, None, :] > 0.5).expand(bh, t, t)
        if causal:
            visible = visible & torch.ones(t, t, dtype=torch.bool,
                                           device=cuda).tril()
        keep = ca._tile_keep(seed, bh, t, t, rate, cuda)
        assert torch.equal(out[..., :t] != 0, keep & visible)
        assert 0.6 < keep.float().mean().item() < 0.8


BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}
BWD_ATOL = 1e-4  # float32 sums of up to T products of O(1-16) terms


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t_q,t_k,causal,masked", [
    (70, 70, True, True),      # ragged, causal tile skips, masked
    (130, 130, False, True),   # non-causal, masked, several tiles
    (20, 90, False, False),    # rectangular, one query tile
    (1, 1, True, False),       # one row
])
def test_flash_backward_matches_plain(cuda, dtype, d, rate, t_q, t_k,
                                      causal, masked):
    """dq and dk/dv kernels against their plain versions, from the plain
    forward's lse and a torch Δ."""
    bh = 3
    q = _randn((bh, t_q, d), dtype, cuda, 50)
    k = _randn((bh, t_k, d), dtype, cuda, 51)
    v = _randn((bh, t_k, d), dtype, cuda, 52)
    dout = _randn((bh, t_q, d), dtype, cuda, 53)
    m = None
    if masked:
        lens = torch.tensor([t_k, max(1, t_k // 3), 1], device=cuda)
        m = (torch.arange(t_k, device=cuda)[None] < lens[:, None]).float()
    seed = torch.tensor([7], dtype=torch.int32, device=cuda)
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, dropout_rate=rate)
    out, lse = ca.flash_attention_reference(q, k, v, m, seed, **kw)
    delta = ca.attention_delta(dout, out)
    design = ca.flash_design(dtype, d, "dq")
    ca.reset_launch_counts()
    dq = ca.flash_attention_dq(q, k, v, m, seed, dout, lse, delta, **kw)
    dk, dv = ca.flash_attention_dkv(q, k, v, m, seed, dout, lse, delta, **kw)
    ref_dq = ca.flash_attention_dq_reference(q, k, v, m, seed, dout, lse,
                                             delta, **kw)
    ref_dk, ref_dv = ca.flash_attention_dkv_reference(
        q, k, v, m, seed, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    # each launched once, on its design (float32 D <= 64: the sm90_f32
    # tensor-core kernels, held to the float32 bound itself)
    counts = ca.launch_counts()
    for kernel in ("dq", "dkv"):
        assert counts[f"flash_attn_{kernel}"] == 1
        assert counts[f"flash_attn_{kernel}_sm90"] == int(design == "sm90")
        assert counts[f"flash_attn_{kernel}_f32_sm90"] == int(
            design == "sm90_f32")
    # the sm90 dq and dk/dv round dS (and P̃) to the input dtype
    unit = fc.rounding_unit(dtype, design)
    args = (q, k, v, m, seed, dout, lse, delta)
    slack_dq = fc.dq_slack(*args, unit=unit, **kw)
    slack_dk, slack_dv = fc.dkv_slack(*args, unit=unit, **kw)
    for name, got, ref, slack in (("dq", dq, ref_dq, slack_dq),
                                  ("dk", dk, ref_dk, slack_dk),
                                  ("dv", dv, ref_dv, slack_dv)):
        assert got.dtype == dtype and torch.isfinite(got.float()).all()
        _, worst = fc.excess(got, ref, slack, BWD_ATOL, BWD_RTOL[dtype])
        assert worst <= 1.0, (name, worst)


def test_flash_backward_fully_masked_rows_are_finite(cuda):
    q = _randn((2, 40, 64), torch.float32, cuda, 54)
    q.requires_grad_(True)
    m = torch.zeros(2, 40, device=cuda)
    out, _ = ca.flash_attention(q, q, q, m)
    (g,) = torch.autograd.grad(out.sum(), (q,))
    assert torch.isfinite(g).all()


SM90_DTYPES = [torch.bfloat16, torch.float16]
SM90_HEAD_DIMS = [16, 40, 64, 96, 128]
# the tensor-core dq and dk/dv: 16-bit up to D 128 (sm90), float32 up to
# D 64 (sm90_f32, held to the float32 bound itself: no rounding slack)
SM90_BWD_CASES = ([(dt, d) for dt in SM90_DTYPES for d in SM90_HEAD_DIMS]
                  + [(torch.float32, d) for d in (8, 16, 40, 64)])
SM90_LENGTHS = [1, 63, 64, 65, 130, 512]
# (causal, key mask, dropout): causal runs Tq == Tk, the rest Tq != Tk;
# "full" masks every key of one batch·head row
SM90_VARIANTS = [(c, m, r) for c in (False, True)
                 for m in (None, "pad", "full") for r in (0.0, 0.1)
                 if not (c and m == "full")]


def _sm90_inputs(dtype, d, t, causal, masked, dev, seed):
    t_k = t if causal else t + 7
    q, dout = (_randn((3, t, d), dtype, dev, seed + i) for i in (0, 1))
    k, v = (_randn((3, t_k, d), dtype, dev, seed + i) for i in (2, 3))
    m = None
    if masked:
        lens = torch.tensor([t_k, max(1, t_k // 3),
                             0 if masked == "full" else 1], device=dev)
        m = (torch.arange(t_k, device=dev)[None] < lens[:, None]).float()
    return q, k, v, dout, m


@pytest.mark.parametrize("dtype", SM90_DTYPES)
@pytest.mark.parametrize("d", SM90_HEAD_DIMS)
@pytest.mark.parametrize("t", SM90_LENGTHS)
def test_sm90_forward_matches_plain(cuda, dtype, d, t):
    """The tensor-core forward against its plain version under the sm90
    bound, every causal / key-mask / dropout variant; lse to 1e-4; a fully
    masked row equal to the plain version's mean of V."""
    assert ca.flash_design(dtype, d, "fwd") == "sm90"
    for i, (causal, masked, rate) in enumerate(SM90_VARIANTS):
        q, k, v, _, m = _sm90_inputs(dtype, d, t, causal, masked, cuda,
                                     100 * i)
        seed = torch.tensor([i - 77], dtype=torch.int32, device=cuda)
        kw = dict(scale=1.0 / math.sqrt(d), causal=causal,
                  dropout_rate=rate)
        before = ca.flash_attention.sm90_launches
        out, lse = ca.flash_attention(q, k, v, m, seed, **kw)
        ref, ref_lse = ca.flash_attention_reference(q, k, v, m, seed, **kw)
        torch.cuda.synchronize()
        assert ca.flash_attention.sm90_launches == before + 1
        assert out.dtype == dtype and torch.isfinite(out.float()).all()
        slack = fc.forward_slack(q, k, v, m, seed, unit=fc.ROUNDING[dtype],
                                 **kw)
        _, share = fc.excess(out, ref, slack, ATOL[dtype], RTOL[dtype])
        assert share <= 1.0, (causal, masked, rate, share)
        assert (lse - ref_lse).abs().max().item() <= LSE_TOL


def _bwd_design(dtype, d, kernel):
    """(the wrapper, its tensor-core launch counter, the bound's rounding
    unit) of the tensor-core dq or dk/dv at ``dtype`` and ``d``."""
    design = ca.flash_design(dtype, d, kernel)
    assert design == ("sm90_f32" if dtype == torch.float32 else "sm90")
    wrapper = (ca.flash_attention_dq if kernel == "dq" else
               ca.flash_attention_dkv)
    counter = "sm90_f32_launches" if design == "sm90_f32" else "sm90_launches"
    return wrapper, counter, fc.rounding_unit(dtype, design)


@pytest.mark.parametrize("dtype,d", SM90_BWD_CASES)
@pytest.mark.parametrize("t", SM90_LENGTHS)
def test_sm90_dkv_matches_plain(cuda, dtype, d, t):
    """The tensor-core dk/dv against its plain version under its bound
    (sm90: with the rounding of P̃ and dS; sm90_f32: the float32 bound),
    every causal / key-mask / dropout variant."""
    wrapper, counter, unit = _bwd_design(dtype, d, "dkv")
    for i, (causal, masked, rate) in enumerate(SM90_VARIANTS):
        q, k, v, dout, m = _sm90_inputs(dtype, d, t, causal, masked, cuda,
                                        100 * i + 50)
        seed = torch.tensor([3 * i + 1], dtype=torch.int32, device=cuda)
        kw = dict(scale=1.0 / math.sqrt(d), causal=causal,
                  dropout_rate=rate)
        out, lse = ca.flash_attention_reference(q, k, v, m, seed, **kw)
        delta = ca.attention_delta(dout, out)
        args = (q, k, v, m, seed, dout, lse, delta)
        before = getattr(wrapper, counter)
        dk, dv = ca.flash_attention_dkv(*args, **kw)
        ref_dk, ref_dv = ca.flash_attention_dkv_reference(*args, **kw)
        torch.cuda.synchronize()
        assert getattr(wrapper, counter) == before + 1
        slacks = fc.dkv_slack(*args, unit=unit, **kw)
        for got, ref, slack in zip((dk, dv), (ref_dk, ref_dv), slacks):
            assert got.dtype == dtype and torch.isfinite(got.float()).all()
            _, share = fc.excess(got, ref, slack, BWD_ATOL, BWD_RTOL[dtype])
            assert share <= 1.0, (causal, masked, rate, share)


@pytest.mark.parametrize("dtype,d", SM90_BWD_CASES)
@pytest.mark.parametrize("t", SM90_LENGTHS)
def test_sm90_dq_matches_plain(cuda, dtype, d, t):
    """The tensor-core dq against its plain version under its bound (sm90:
    dS rounded unscaled, ``u·scale·(|dS|·|K|)``; sm90_f32: the float32
    bound), every causal / key-mask / dropout variant."""
    wrapper, counter, unit = _bwd_design(dtype, d, "dq")
    for i, (causal, masked, rate) in enumerate(SM90_VARIANTS):
        q, k, v, dout, m = _sm90_inputs(dtype, d, t, causal, masked, cuda,
                                        100 * i + 70)
        seed = torch.tensor([5 * i - 3], dtype=torch.int32, device=cuda)
        kw = dict(scale=1.0 / math.sqrt(d), causal=causal,
                  dropout_rate=rate)
        out, lse = ca.flash_attention_reference(q, k, v, m, seed, **kw)
        delta = ca.attention_delta(dout, out)
        args = (q, k, v, m, seed, dout, lse, delta)
        before = getattr(wrapper, counter)
        dq = ca.flash_attention_dq(*args, **kw)
        ref = ca.flash_attention_dq_reference(*args, **kw)
        torch.cuda.synchronize()
        assert getattr(wrapper, counter) == before + 1
        assert dq.dtype == dtype and torch.isfinite(dq.float()).all()
        slack = fc.dq_slack(*args, unit=unit, **kw)
        _, share = fc.excess(dq, ref, slack, BWD_ATOL, BWD_RTOL[dtype])
        assert share <= 1.0, (causal, masked, rate, share)


@pytest.mark.parametrize("dtype", SM90_DTYPES)
def test_sm90_gives_the_same_bits_twice(cuda, dtype):
    q, k, v, dout, m = _sm90_inputs(dtype, 64, 130, False, "pad", cuda, 9)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda)
    kw = dict(scale=0.125, dropout_rate=0.1)
    outs = [ca.flash_attention(q, k, v, m, seed, **kw) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    out, lse = outs[0]
    delta = ca.attention_delta(dout, out)
    grads = [ca.flash_attention_dkv(q, k, v, m, seed, dout, lse, delta, **kw)
             for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    dqs = [ca.flash_attention_dq(q, k, v, m, seed, dout, lse, delta, **kw)
           for _ in range(2)]
    assert torch.equal(*dqs)


@pytest.mark.parametrize("causal", [False, True])
def test_sm90_dropout_drops_what_keep_mask_drops(cuda, causal):
    """The bfloat16 forward with V the identity on its first D columns:
    out[i, j] != 0 exactly where keep_mask keeps (i, j) and key j is
    visible — the tensor-core fragment's (row, column) is the hash's."""
    bh, t, d, rate = 6, 130, 128, 0.3
    q = _randn((bh, t, d), torch.bfloat16, cuda, 140)
    k = _randn((bh, t, d), torch.bfloat16, cuda, 141)
    v = torch.eye(t, d, device=cuda, dtype=torch.bfloat16).expand(
        bh, t, d).contiguous()
    lens = torch.tensor([130, 100, 64, 17, 128, 1], device=cuda)
    m = (torch.arange(t, device=cuda)[None] < lens[:, None]).float()
    seed = torch.tensor([-987654321], dtype=torch.int32, device=cuda)
    out, _ = ca.flash_attention(q, k, v, m, seed, causal=causal,
                                dropout_rate=rate)
    torch.cuda.synchronize()
    visible = (m[:, None, :d] > 0.5).expand(bh, t, d)
    if causal:
        visible = visible & torch.ones(t, d, dtype=torch.bool,
                                       device=cuda).tril()
    keep = ca._tile_keep(seed, bh, t, d, rate, cuda)
    assert torch.equal(out != 0, keep & visible)


F32_HEAD_DIMS = [8, 40, 64, 96, 128]


@pytest.mark.parametrize("d", F32_HEAD_DIMS)
@pytest.mark.parametrize("t", SM90_LENGTHS)
def test_f32_sm90_forward_matches_plain(cuda, d, t):
    """The float32 tensor-core forward (every product three TF32 passes)
    against its plain version at the float32 tolerance itself, every
    causal / key-mask / dropout variant, Tk past Tq by 7 (Vᵀ's keys
    padded to 8); lse to 1e-4; a fully masked row equal to the plain
    version's mean of V."""
    assert ca.flash_design(torch.float32, d, "fwd") == "sm90_f32"
    for i, (causal, masked, rate) in enumerate(SM90_VARIANTS):
        q, k, v, _, m = _sm90_inputs(torch.float32, d, t, causal, masked,
                                     cuda, 100 * i + 1)
        seed = torch.tensor([i - 55], dtype=torch.int32, device=cuda)
        kw = dict(scale=1.0 / math.sqrt(d), causal=causal,
                  dropout_rate=rate)
        before = ca.flash_attention.sm90_f32_launches
        out, lse = ca.flash_attention(q, k, v, m, seed, **kw)
        ref, ref_lse = ca.flash_attention_reference(q, k, v, m, seed, **kw)
        torch.cuda.synchronize()
        assert ca.flash_attention.sm90_f32_launches == before + 1
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        _assert_close(out, ref, torch.float32)
        assert (lse - ref_lse).abs().max().item() <= LSE_TOL


def test_f32_sm90_forward_same_bits_and_faults(cuda):
    """Two runs give the same bits; the faulted plain variants — one TF32
    pass (testing/split_f32.py), the last key tile dropped, a rescale
    skipped, the keep mask shifted a column — all break the float32
    bound the kernel meets."""
    from deeplearning4j_tpu_torch.testing import split_f32 as sf

    q, k, v, _, m = _sm90_inputs(torch.float32, 64, 130, False, "pad",
                                 cuda, 19)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda)
    kw = dict(scale=0.125, dropout_rate=0.1)
    a = ca.flash_attention(q, k, v, m, seed, **kw)
    b = ca.flash_attention(q, k, v, m, seed, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ref, _ = ca.flash_attention_reference(q, k, v, m, seed, **kw)
    _assert_close(a[0], ref, torch.float32)
    bad = {"single_pass_tf32": sf.flash_forward_split(
        q, k, v, m, seed, passes="single", **kw)[0]}
    for fault in fc.FAULTS:
        bad[fault] = fc.forward_variant(q, k, v, m, seed, fault=fault,
                                        **kw)[0]
    for fault, out in bad.items():
        assert (out - ref).abs().max().item() > ATOL[torch.float32], fault


def test_f32_sm90_backward_same_bits_and_faults(cuda):
    """The float32 tensor-core dq and dk/dv give the same bits twice; the
    faulted plain variants — one TF32 pass (testing/split_f32.py), the
    keep mask shifted a column, the last 32-wide tile dropped — all break
    the float32 bound they meet."""
    from deeplearning4j_tpu_torch.testing import split_f32 as sf

    q, k, v, dout, m = _sm90_inputs(torch.float32, 64, 130, False, "pad",
                                    cuda, 29)
    seed = torch.tensor([6], dtype=torch.int32, device=cuda)
    kw = dict(scale=0.125, dropout_rate=0.1)
    out, lse = ca.flash_attention_reference(q, k, v, m, seed, **kw)
    args = (q, k, v, m, seed, dout, lse, ca.attention_delta(dout, out))
    got = [(ca.flash_attention_dq(*args, **kw),
            *ca.flash_attention_dkv(*args, **kw)) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*got))
    ref = (ca.flash_attention_dq_reference(*args, **kw),
           *ca.flash_attention_dkv_reference(*args, **kw))
    zero = torch.zeros((), device=cuda)

    def share(gs):
        return max(fc.excess(g, r, zero, BWD_ATOL, BWD_RTOL[torch.float32])[1]
                   for g, r in zip(gs, ref))

    assert share(got[0]) <= 1.0
    tile = dict(tile=sf.FLASH_BWD_TILE)
    bad = {"single_pass_tf32": (
        sf.flash_dq_split(*args, passes="single", **kw),
        *sf.flash_dkv_split(*args, passes="single", **kw))}
    for fault in ("keep_shifted", "last_tile_dropped"):
        bad[fault] = (fc.dq_variant(*args, fault=fault, **tile, **kw),
                      *fc.dkv_variant(*args, fault=fault, **tile, **kw))
    for fault, gs in bad.items():
        assert share(gs) > 1.0, fault


def test_f32_sm90_backward_left_padded_causal(cuda):
    """Causal rows whose visible keys are all masked while later keys are
    not (left padding): their masked keys' p is 1, not 0, so the float32
    dq and dk/dv must not skip those keys. Held against the split
    transcription (testing/split_f32.py), which, as every kernel, gives
    keys past the diagonal p = 0 where the plain version's -1e30 fill gives
    such a row's 1; every dO row is nonzero."""
    from deeplearning4j_tpu_torch.testing import split_f32 as sf

    t, d = 200, 64
    q, k, v, dout = (_randn((4, t, d), torch.float32, cuda, 60 + i)
                     for i in range(4))
    pads = torch.tensor([0, 40, 70, 150], device=cuda)
    m = (torch.arange(t, device=cuda)[None] >= pads[:, None]).float()
    seed = torch.tensor([8], dtype=torch.int32, device=cuda)
    kw = dict(scale=0.125, causal=True, dropout_rate=0.1)
    out, lse = ca.flash_attention_reference(q, k, v, m, seed, **kw)
    args = (q, k, v, m, seed, dout, lse, ca.attention_delta(dout, out))
    got = (ca.flash_attention_dq(*args, **kw),
           *ca.flash_attention_dkv(*args, **kw))
    ref = (sf.flash_dq_split(*args, **kw), *sf.flash_dkv_split(*args, **kw))
    zero = torch.zeros((), device=cuda)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _, share = fc.excess(g, r, zero, BWD_ATOL, BWD_RTOL[torch.float32])
        assert share <= 1.0, (name, share)


def test_flash_design_routes_by_counters(cuda):
    """bfloat16 at D 64 launches the sm90 forward, dq and dk/dv; float32
    at D 64 the sm90_f32 forward, dq and dk/dv; float32 at D 128 the
    sm90_f32 forward and the CUDA-core dq and dk/dv; float32 at D 192 and
    bfloat16 at D 192 the CUDA-core ones (tensor-core counters still)."""
    for dtype, d, sm90, f32, f32_bwd in ((torch.bfloat16, 64, 1, 0, 0),
                                         (torch.float16, 128, 1, 0, 0),
                                         (torch.float32, 64, 0, 1, 1),
                                         (torch.float32, 128, 0, 1, 0),
                                         (torch.float32, 192, 0, 0, 0),
                                         (torch.bfloat16, 192, 0, 0, 0)):
        q, k, v, dout, _ = _sm90_inputs(dtype, d, 70, True, None, cuda, 11)
        ca.reset_launch_counts()
        out, lse = ca.flash_attention(q, k, v, causal=True)
        delta = ca.attention_delta(dout, out)
        ca.flash_attention_dkv(q, k, v, None, None, dout, lse, delta,
                               scale=1.0 / math.sqrt(d), causal=True)
        ca.flash_attention_dq(q, k, v, None, None, dout, lse, delta,
                              scale=1.0 / math.sqrt(d), causal=True)
        counts = ca.launch_counts()
        assert counts == {"flash_attn_fwd": 1, "flash_attn_fwd_sm90": sm90,
                          "flash_attn_fwd_f32_sm90": f32,
                          "flash_attn_dq": 1, "flash_attn_dq_sm90": sm90,
                          "flash_attn_dq_f32_sm90": f32_bwd,
                          "flash_attn_dkv": 1, "flash_attn_dkv_sm90": sm90,
                          "flash_attn_dkv_f32_sm90": f32_bwd,
                          "paged_decode": 0}, (dtype, d, counts)


@pytest.mark.parametrize("causal,rate", [(False, 0.0), (True, 0.0),
                                         (False, 0.1)])
def test_attention_gradients_through_the_registry(cuda, causal, rate):
    """Gradients through ``exec_op("dot_product_attention")`` on CUDA
    tensors that require grad (the flash kernels, forward and backward)
    equal those of the plain path; without dropout the plain path is the
    generic op. Attention gradients used to be lost on the card: the
    kernel's output carried no grad_fn."""
    env = environment()
    old = env.helper_mode
    b, h, t, d = 2, 3, 40, 64
    qkv = [_randn((b, h, t, d), torch.float32, cuda, 60 + i)
           for i in range(3)]
    dout = _randn((b, h, t, d), torch.float32, cuda, 63)
    m = (torch.arange(t, device=cuda)[None] < torch.tensor(
        [[t], [23]], device=cuda)).int()[:, None, None, :]
    kw = dict(scaled=True, causal=causal, dropout_rate=rate,
              dropout_rng=torch.Generator(device=cuda).manual_seed(3)
              if rate else None)
    grads = {}
    try:
        for mode in ("auto", "generic"):
            env.helper_mode = mode
            xs = [x.clone().requires_grad_(True) for x in qkv]
            if rate and mode == "generic":  # same seed, plain versions
                kw["dropout_rng"] = torch.Generator(device=cuda).manual_seed(3)
                out = ca.flash_dpa(*xs, m, plain=True, **kw)
            else:
                counts = ca.launch_counts()
                out = exec_op("dot_product_attention", *xs, m, **kw)
            grads[mode] = torch.autograd.grad(out, xs, dout)
            if mode == "auto":
                after = ca.launch_counts()
                assert all(after[n] - counts[n] == 1 for n in (
                    "flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"))
    finally:
        env.helper_mode = old
    for a, g in zip(grads["auto"], grads["generic"]):
        assert (a - g).abs().max().item() <= BWD_ATOL


def test_bert_trains_through_the_kernels(cuda):
    """A small BERT step launches, per layer, one flash forward (with
    dropout), one dq and one dk/dv, and the updater once over every leaf;
    its
    losses equal a run whose attention runs the plain versions on the
    card with the same seeds."""
    from deeplearning4j_tpu_torch.models.bert import BertConfig, BertModel
    from deeplearning4j_tpu_torch.ops.registry import registry

    cfg = BertConfig.tiny(hidden=128, heads=2)
    r = np.random.default_rng(70)
    lens = np.array([32, 20, 9, 16])
    mask = (np.arange(32)[None] < lens[:, None]).astype(np.int32)
    batch = {"ids": (r.integers(5, cfg.vocab_size, (4, 32)) * mask
                     ).astype(np.int32),
             "segments": np.zeros((4, 32), np.int32), "mask": mask,
             "labels": np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]}
    desc = registry().get("dot_product_attention")
    losses = {}
    for plain in (False, True):
        model = BertModel(cfg, seed=1, device=cuda)
        if plain:
            desc.platform_impls["cuda"] = functools.partial(ca.flash_dpa,
                                                            plain=True)
        try:
            ca.reset_launch_counts()
            u0, v0 = cu.fused_updater.launches, cu.fused_updater.leaves
            losses[plain] = model.fit_classifier([batch, batch])
            counts = ca.launch_counts()
            launches = cu.fused_updater.launches - u0
            leaves = cu.fused_updater.leaves - v0
        finally:
            desc.platform_impls["cuda"] = ca.flash_dpa
        want = 0 if plain else 2 * cfg.layers
        assert (counts["flash_attn_fwd"], counts["flash_attn_dq"],
                counts["flash_attn_dkv"]) == (want,) * 3
        # every leaf, in one multi-tensor launch a step
        assert (leaves, launches) == (2 * 46, 2)
    np.testing.assert_allclose(losses[False], losses[True], rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("batch", ["mixed", "full", "one_page", "wide"])
def test_paged_matches_plain(cuda, dtype, d, page, batch):
    """Split-KV paged decode, one launch a call: mixed seq_lens (an
    inactive slot, one token, a page boundary, ragged, a full row), every
    slot at full context, one page a slot, and 32 heads — at D 256 more
    than one block's stages hold, so the heads split over blocks.
    Inactive slots are zeros."""
    s_n, h, max_pages = 5, 3, 12
    if batch == "one_page":
        max_pages = 1
    if batch == "wide":
        h = 32
    n_pages = s_n * max_pages
    kv = _randn((2, n_pages + 1, page, h, d), dtype, cuda, 5)
    q = _randn((s_n, h, d), dtype, cuda, 6)
    perm = np.random.default_rng(7).permutation(n_pages)
    pt = torch.from_numpy(perm.reshape(s_n, max_pages).astype(np.int32)).to(
        cuda)
    lens = {"mixed": [0, 1, page, 3 * page + 5, max_pages * page],
            "full": [max_pages * page] * s_n,
            "one_page": [0, 1, page - 1, page, 3],
            "wide": [0, 1, page + 1, 5 * page, max_pages * page]}[batch]
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = ca.paged_decode_attention.launches
    out = ca.paged_decode_attention(q, kv[0], kv[1], pt, sl)
    assert ca.paged_decode_attention.launches == before + 1
    ref = ca.paged_decode_attention_reference(q, kv[0], kv[1], pt, sl)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    live = sl > 0
    assert (out[~live] == 0).all()
    _assert_close(out[live], ref[live], dtype)
    plan = ca.paged_plan(s_n, h, d, page, max_pages, q.element_size(),
                         torch.cuda.get_device_properties(
                             cuda).multi_processor_count)
    if batch == "wide" and d == 256:
        assert plan.head_groups > 1
    # twice in a row: the split counters were left at zero
    assert torch.equal(out, ca.paged_decode_attention(q, kv[0], kv[1], pt,
                                                      sl))


def test_registry_routes_to_kernels_on_cuda(cuda):
    env = environment()
    old = env.helper_mode
    q = _randn((1, 2, 32, 64), torch.float32, cuda, 8)
    try:
        for mode, launched in (("generic", 0), ("auto", 1), ("kernel", 1)):
            env.helper_mode = mode
            before = ca.flash_attention.launches
            out = exec_op("dot_product_attention", q, q, q, causal=True)
            assert ca.flash_attention.launches - before == launched
            env.helper_mode = "generic"
            ref = exec_op("dot_product_attention", q, q, q, causal=True)
            assert (out - ref).abs().max().item() <= 1e-4
    finally:
        env.helper_mode = old


@pytest.mark.parametrize("hidden,heads", [(128, 4), (256, 2)])
def test_engine_greedy_matches_the_oracle_on_cuda(cuda, hidden, heads):
    """Small engines at head dims 32 and 128: greedy tokens through both
    kernels equal the full-prefill oracle's."""
    cfg = GptConfig.tiny(hidden=hidden, heads=heads)
    model = GptModel(cfg, device=cuda, params=init_gpt_params(
        cfg, seed=2, device=cuda, std=2.0 / math.sqrt(cfg.hidden)))
    prompts = [np.array([3, 5, 7, 9], np.int32),
               np.array([11, 2], np.int32),
               np.array([42, 43, 44, 45, 46, 47], np.int32)]
    ca.reset_launch_counts()
    eng = GenerativeEngine(model, max_slots=2, page_size=8,
                           max_pages_per_seq=6, max_prompt=16, device=cuda)
    results = eng.generate(prompts, max_new_tokens=6, eos_token=-1)
    counts = ca.launch_counts()
    assert counts["flash_attn_fwd"] >= cfg.layers * len(prompts)
    assert counts["paged_decode"] > 0
    env = environment()
    old = env.helper_mode
    env.helper_mode = "generic"
    try:
        for p, r in zip(prompts, results):
            np.testing.assert_array_equal(
                r.tokens, reference_generate(model.params, cfg, p, 6))
    finally:
        env.helper_mode = old


# ---------------------------------------------------------------------------
# training kernels: fused updater step, fused BN-apply/matmul/BN-stats
# ---------------------------------------------------------------------------
#
# Updater: the kernel repeats the plain version's float32 operations in the
# same order, each rounded once, with the lr/step scalars computed by the
# same torch ops on the host, so every kind agrees BIT FOR BIT in float32,
# and therefore in bfloat16/float16 too (both compute in float32 and round
# each output once) — except Nadam, whose divisions by a host scalar torch
# may carry out as a multiplication by the reciprocal: 2 ulp there.
# bn_matmul_stats: cuda_convbn.kernel_tolerance (one bf16 unit on z; the
# derived bound for statistics taken from the float32 accumulator).

UPDATER_KINDS = sorted(U.UPDATERS)


def _leaf_set(kind, n, dtype, dev, seed, offset=0):
    g = torch.Generator().manual_seed(seed)
    upd = U.UPDATERS[kind]()
    keys = sorted(upd.init_state(torch.zeros(1)))

    def draw(scale, positive=False):
        t = torch.randn(n + offset, generator=g) * scale
        return (t.abs() if positive else t).to(dev, dtype)[offset:]

    return upd, draw(1.0), draw(0.1), [draw(0.1, True) for _ in keys]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,offset", [(1, 0), (37, 0), (4099, 0),
                                      (65536, 0), (1000, 1)])
@pytest.mark.parametrize("kind", UPDATER_KINDS)
def test_fused_updater_matches_plain(cuda, kind, n, offset, dtype):
    """Ragged, aligned and unaligned (a view one element in: no 16-byte
    vectors) leaves."""
    upd, p, gr, st = _leaf_set(kind, n, dtype, cuda, n + offset, offset)
    lr = upd.lr(0) * 3.0
    before = cu.fused_updater.launches
    out = cu.fused_updater(p, gr, lr, 5, *st, kind=kind, **upd.fused_hyper())
    ref = cu.fused_updater_step.fn(p, gr, lr, 5, *st, kind=kind,
                                   **upd.fused_hyper())
    torch.cuda.synchronize()
    assert cu.fused_updater.launches == before + 1
    assert len(out) == len(ref) == 1 + len(st)
    for a, b in zip(out, ref):
        assert a.dtype == dtype and a.shape == (n,)
        if kind == "Nadam":
            np.testing.assert_array_max_ulp(a.float().cpu().numpy(),
                                            b.float().cpu().numpy(), maxulp=2)
        else:
            assert torch.equal(a, b), (a - b).abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", UPDATER_KINDS)
def test_fused_updater_multi_matches_plain(cuda, kind, dtype):
    """One multi-tensor launch over a tree of odd sizes, an offset view
    (the scalar path) and an empty leaf: every leaf equals its plain
    version; one launch, every leaf counted. Past TABLE_LEAVES leaves the
    group takes a second launch."""
    sizes = [1, 7, 8, 4097, 65539, 2048000, 0, 1000, 9]
    offsets = [0, 0, 0, 0, 1, 0, 0, 1, 0]
    leaves = [_leaf_set(kind, n, dtype, cuda, 40 + i, off)
              for i, (n, off) in enumerate(zip(sizes, offsets))]
    upd = leaves[0][0]
    lr = upd.lr(0) * 3.0
    ps, gs, ss = ([lf[1] for lf in leaves], [lf[2] for lf in leaves],
                  [tuple(lf[3]) for lf in leaves])
    l0, v0 = cu.fused_updater.launches, cu.fused_updater.leaves
    outs = cu.fused_updater_multi(ps, gs, ss, lr, 5, kind=kind,
                                  **upd.fused_hyper())
    torch.cuda.synchronize()
    assert cu.fused_updater.launches - l0 == 1
    assert cu.fused_updater.leaves - v0 == len(sizes)
    for p, g, s, out in zip(ps, gs, ss, outs):
        ref = cu.fused_updater_step.fn(p, g, lr, 5, *s, kind=kind,
                                       **upd.fused_hyper())
        assert len(out) == len(ref) == 1 + len(s)
        for a, b in zip(out, ref):
            assert a.dtype == dtype and a.shape == b.shape
            if kind == "Nadam":
                np.testing.assert_array_max_ulp(a.float().cpu().numpy(),
                                                b.float().cpu().numpy(),
                                                maxulp=2)
            else:
                assert torch.equal(a, b), (a - b).abs().max().item()
    n = cu.TABLE_LEAVES + 3
    ps = [torch.randn(17, device=cuda).to(dtype) for _ in range(n)]
    ss = [tuple(torch.rand(17, device=cuda).to(dtype) for _ in ss[0])
          for _ in range(n)]
    l0 = cu.fused_updater.launches
    outs = cu.fused_updater_multi(ps, ps, ss, lr, 5, kind=kind,
                                  **upd.fused_hyper())
    assert cu.fused_updater.launches - l0 == 2
    ref = cu.fused_updater_step.fn(ps[-1], ps[-1], lr, 5, *ss[-1], kind=kind,
                                   **upd.fused_hyper())
    if kind != "Nadam":
        assert all(torch.equal(a, b) for a, b in zip(outs[-1], ref))


def test_apply_fused_many_routes_leaf_by_leaf(cuda):
    """helper_mode decides for the whole call as for one leaf; a float64
    leaf passes the gate and raises, as apply_fused does."""
    upd = U.Adam()
    ps = [torch.randn(n, device=cuda) for n in (3, 300, 5000)]
    ss = [upd.init_state(p) for p in ps]
    env = environment()
    old = env.helper_mode
    try:
        for mode, launched in (("generic", 0), ("auto", 1), ("kernel", 1)):
            env.helper_mode = mode
            before = cu.fused_updater.launches
            new_p, new_s = upd.apply_fused_many(ps, ps, ss, upd.lr(0), 0)
            assert cu.fused_updater.launches - before == launched
            for p, s, np_, ns in zip(ps, ss, new_p, new_s):
                want_p, want_s = upd.apply_fused(p, p, s, upd.lr(0), 0)
                assert torch.equal(np_, want_p)
                assert all(torch.equal(ns[k], want_s[k]) for k in ns)
    finally:
        env.helper_mode = old
    with pytest.raises(ValueError, match="dtype"):
        upd.apply_fused_many([ps[0].double()], [ps[0].double()],
                             [upd.init_state(ps[0].double())], upd.lr(0), 0)


def test_fused_updater_routes_and_refuses(cuda):
    upd = U.Nesterovs()
    p = torch.randn(300, device=cuda)
    st = upd.init_state(p)
    env = environment()
    old = env.helper_mode
    try:
        for mode, launched in (("generic", 0), ("auto", 1), ("kernel", 1)):
            env.helper_mode = mode
            before = cu.fused_updater.launches
            upd.apply_fused(p, p, st, upd.lr(0), 0)
            assert cu.fused_updater.launches - before == launched
    finally:
        env.helper_mode = old
    with pytest.raises(ValueError, match="dtype"):
        cu.fused_updater(p.double(), p.double(), 0.1, 0, p.double(),
                         kind="Nesterovs", momentum=0.9)
    assert not cu.fused_updater_usable(p, p[:10], 0.1, 0, st["v"],
                                       kind="Nesterovs", momentum=0.9)


def _convbn_inputs(m, k, n, dev, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g).to(dev, torch.bfloat16)
    sc = (torch.rand(k, generator=g) + 0.5).to(dev)
    sh = (0.1 * torch.randn(k, generator=g)).to(dev)
    w = (torch.randn(k, n, generator=g) * k ** -0.5).to(dev, torch.bfloat16)
    ss = (0.1 * torch.randn(n, generator=g)).to(dev)
    return x, sc, sh, w, ss


def _check_convbn(out, ref, tol):
    z, mean, var = out
    zr, mr, vr = ref
    z_atol, z_rtol, m_tol, v_tol = tol
    zerr = (z.float() - zr.float()).abs()
    assert (zerr <= z_atol + z_rtol * zr.float().abs()).all(), \
        zerr.max().item()
    assert ((mean - mr).abs() <= m_tol).all()
    assert ((var - vr).abs() <= v_tol).all()


@pytest.mark.parametrize("prologue,relu", [(True, True), (True, False),
                                           (False, False), (False, True)])
@pytest.mark.parametrize("m,k,n", [(128, 64, 64), (256, 192, 128),
                                   (1024, 64, 256), (6272, 2048, 512)])
def test_bn_matmul_stats_matches_plain(cuda, m, k, n, prologue, relu):
    args = _convbn_inputs(m, k, n, cuda, m + k + n)
    kw = dict(relu=relu, fuse_prologue=prologue)
    assert cc.bn_matmul_stats_usable(*args)
    before = cc.bn_matmul_stats.launches
    out = cc.bn_matmul_stats(*args, **kw)
    ref = cc.reference_bn_matmul_stats(*args, **kw)
    torch.cuda.synchronize()
    assert cc.bn_matmul_stats.launches == before + 1
    assert out[0].dtype == torch.bfloat16 and out[0].shape == (m, n)
    _check_convbn(out, ref, cc.kernel_tolerance(*args, ref[0], **kw))


@pytest.mark.parametrize("m,k,n", [(192, 64, 64), (128, 96, 64),
                                   (128, 64, 96), (100, 64, 64)])
def test_bn_matmul_stats_gate_edges(cuda, m, k, n):
    """Shapes off the (128, 64, 64) grid: the gate refuses, auto takes the
    plain version, kernel mode raises, the wrapper itself raises."""
    args = _convbn_inputs(m, k, n, cuda, 1)
    assert not cc.bn_matmul_stats_usable(*args)
    f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    assert not cc.bn_matmul_stats_usable(*f32)  # float32 x: refused too
    env = environment()
    old = env.helper_mode
    try:
        env.helper_mode = "auto"
        before = cc.bn_matmul_stats.launches
        exec_op("fused_bn_matmul_stats", *args)
        assert cc.bn_matmul_stats.launches == before
        env.helper_mode = "kernel"
        with pytest.raises(RuntimeError, match="usable gate"):
            exec_op("fused_bn_matmul_stats", *args)
    finally:
        env.helper_mode = old
    with pytest.raises(ValueError, match="multiple"):
        cc.bn_matmul_stats(*args)


@pytest.mark.parametrize("prologue,relu", [(True, True), (False, False)])
def test_fused_matmul_bn_backward_agrees_with_the_plain_chain(cuda, prologue,
                                                              relu):
    """The hand backward (kernel forward) against autograd through the
    plain chain written out in float32 torch ops. The hand backward, as
    the JAX package's ``_fused_bwd``, rounds the folded cotangent dz to
    bf16 (2^-8 per term) before its products and column sums, whose terms
    partly cancel: each gradient is held to 2^-6 of its own largest
    magnitude (a 4× margin), plus 1e-3."""
    m, k, n = 512, 128, 64
    x, sc, sh, w, ss = _convbn_inputs(m, k, n, cuda, 9)
    g = torch.Generator().manual_seed(10)
    dz = torch.randn(m, n, generator=g).to(cuda, torch.bfloat16)
    dmean = torch.randn(n, generator=g).to(cuda)
    dvar = torch.randn(n, generator=g).to(cuda)

    def leaves():
        return [t.clone().requires_grad_(True) for t in (x, sc, sh, w)]

    a = leaves()
    before = cc.bn_matmul_stats.launches
    out = cc.fused_matmul_bn(*a, ss, prologue, relu)
    assert cc.bn_matmul_stats.launches == before + 1
    torch.autograd.backward(out, (dz, dmean, dvar))
    b = leaves()
    y = b[0].float()
    if prologue:
        y = y * b[1] + b[2]
        if relu:
            y = torch.clamp_min(y, 0.0)
    z = (y.to(torch.bfloat16).float() @ b[3].float())
    c = z - ss
    m1 = c.mean(0)
    var = torch.clamp_min((c * c).mean(0) - m1 * m1, 0.0)
    torch.autograd.backward((z, m1 + ss, var), (dz.float(), dmean, dvar))
    for name, ta, tb in zip(("x", "scale", "shift", "w"), a, b):
        if not prologue and name in ("scale", "shift"):
            continue
        ga, gb = ta.grad.float(), tb.grad.float()
        err = (ga - gb).abs().max().item()
        assert err <= 1e-3 + 2.0 ** -6 * gb.abs().max().item(), (name, err)


def test_resnet50_trains_through_both_kernels_on_cuda(cuda):
    """A small ResNet-50 in configuration A (float32) and B (fused blocks,
    mixed): A updates every leaf in one updater launch a step; B launches
    the
    convbn kernel on every gated 1×1 conv; losses stay finite."""
    x, lab = synthetic_image_batch(8, 64, 64, 3, 10, seed=3)
    y = np.eye(10, dtype=np.float32)[lab]
    for fused, dtype in ((False, "float32"), (True, "mixed")):
        net = ResNet50(num_classes=10, input_shape=(64, 64, 3),
                       fused_blocks=fused, dtype=dtype, device=cuda).init()
        u0, c0 = cu.fused_updater.launches, cc.bn_matmul_stats.launches
        v0 = cu.fused_updater.leaves
        net.fit(x, y, batch_size=8)
        net.fit(x, y, batch_size=8)
        torch.cuda.synchronize()
        assert math.isfinite(net.score())
        assert cu.fused_updater.leaves - v0 == 2 * 161
        assert cu.fused_updater.launches - u0 == 2
        if fused:  # stages 1-3 pass the gate (M = 8·16·16, 8·8·8, 8·4·4)
            assert cc.bn_matmul_stats.launches - c0 >= 2 * 2 * 13


def _convbn_all(args, kw):
    """(z, parts, mean, var) of the kernel and of the plain version."""
    z, parts = cc.bn_matmul_stats_partials(*args, **kw)
    got = (z, parts) + cc.reduce_partials(parts, args[4])
    zr, mr, vr = cc.reference_bn_matmul_stats(*args, **kw)
    return got, (zr, cc.reference_partials(zr, args[4]), mr, vr)


# every tile width (N 64 takes BN 64; 192 a BN-128 tile half past N),
# one and many K slabs, one and many row blocks, the stream shape's K 64
@pytest.mark.parametrize("prologue,relu", [(True, True), (True, False),
                                           (False, False)])
@pytest.mark.parametrize("m,k,n", [(128, 64, 64), (256, 64, 192),
                                   (384, 128, 128), (1024, 64, 256),
                                   (6272, 2048, 512), (25088, 1024, 256)])
def test_convbn_sm90_matches_plain(cuda, m, k, n, prologue, relu):
    """The tensor-core design against the plain version: z, mean and var
    within ``kernel_tolerance``, each 128-row block's partial sums within
    ``partials_tolerance``; the same bits twice."""
    from deeplearning4j_tpu_torch.testing import matmul_check as mc

    args = _convbn_inputs(m, k, n, cuda, m + k + n)
    kw = dict(relu=relu, fuse_prologue=prologue)
    assert cc.convbn_design(args[0], args[3]) == "sm90"
    before = (cc.bn_matmul_stats.launches, cc.bn_matmul_stats.sm90_launches)
    got, plain = _convbn_all(args, kw)
    again, _ = _convbn_all(args, kw)
    torch.cuda.synchronize()
    assert (cc.bn_matmul_stats.launches,
            cc.bn_matmul_stats.sm90_launches) == (before[0] + 2,
                                                  before[1] + 2)
    assert mc.convbn_share(got, plain, args, **kw) <= 1.0
    for a, b in zip(got[:2], again[:2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("prologue", [True, False])
def test_convbn_faulted_variants_exceed_the_check(cuda, prologue):
    """At a stage-3 shape (196 row blocks, where one doubled block moves
    the mean and variance by less than their tolerance) each faulted plain
    variant of ``testing/matmul_check.py`` still lies beyond the check the
    kernel passes: the partial sums see the block."""
    from deeplearning4j_tpu_torch.testing import matmul_check as mc

    args = _convbn_inputs(25088, 1024, 256, cuda, 3)
    kw = dict(relu=prologue, fuse_prologue=prologue)
    got, plain = _convbn_all(args, kw)
    assert mc.convbn_share(got, plain, args, **kw) <= 1.0
    for fault in mc.convbn_faults(prologue):
        bad = mc.bn_matmul_stats_variant(*args, **kw, fault=fault)
        assert mc.convbn_share(bad, plain, args, **kw) > 1.0, fault


@pytest.mark.parametrize("moved", ["x", "w"])
def test_convbn_wmma_takes_unaligned_operands(cuda, moved):
    """An x or w one element into its buffer (off 16-byte alignment, so TMA
    cannot read it) runs the WMMA kernel's element loads."""
    args = list(_convbn_inputs(512, 128, 128, cuda, 4))
    i = 0 if moved == "x" else 3
    t = args[i]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    args[i] = buf[1:].view(t.shape)
    args[i].copy_(t)
    assert args[i].data_ptr() % 16 != 0
    assert cc.convbn_design(args[0], args[3]) == "wmma"
    kw = dict(relu=True, fuse_prologue=True)
    before = (cc.bn_matmul_stats.launches, cc.bn_matmul_stats.sm90_launches)
    out = cc.bn_matmul_stats(*args, **kw)
    ref = cc.reference_bn_matmul_stats(*args, **kw)
    torch.cuda.synchronize()
    assert (cc.bn_matmul_stats.launches,
            cc.bn_matmul_stats.sm90_launches) == (before[0] + 1, before[1])
    _check_convbn(out, ref, cc.kernel_tolerance(*args, ref[0], **kw))


# ----------------------------------------------------------- fused matmul
# act(x @ w + b) against its plain version (float32 product, float32 bias
# and activation, one cast), held to cuda_matmul.kernel_tolerance: the
# float32 summation bound of K terms plus, in bfloat16/float16, one unit
# in the last place of the plain output.

FM_ACTS = ["none", "relu", "tanh", "gelu", "gelu_exact"]


def _fm_inputs(lead, k, n, dtype, dev, seed, bias=True):
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.standard_normal(lead + (k,), dtype=np.float32)
                         ).to(dev, dtype)
    w = torch.from_numpy((g.standard_normal((k, n)) / math.sqrt(max(k, 1))
                          ).astype(np.float32)).to(dev, dtype)
    b = (torch.from_numpy(g.standard_normal(n, dtype=np.float32)).to(dev)
         if bias else None)
    return x, w, b


def _check_fm(out, x, w, ref):
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm

    assert out.shape == ref.shape and out.dtype == ref.dtype
    atol, rtol = cm.kernel_tolerance(x, w, ref)
    err = (out.float() - ref.float()).abs()
    lim = atol + rtol * ref.float().abs()
    assert bool((err <= lim).all()), (err.max().item(),
                                      (err / lim).max().item())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,k,n", [
    ((1,), 1, 1), ((7,), 33, 65), ((130,), 200, 129), ((257,), 768, 300),
    ((2, 37), 96, 136), ((3, 128), 384, 256), ((256,), 3072, 128)])
@pytest.mark.parametrize("act", FM_ACTS)
def test_fused_matmul_matches_plain(cuda, dtype, lead, k, n, act):
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm

    x, w, b = _fm_inputs(lead, k, n, dtype, cuda, seed=k + n)
    for bias in (b, None):
        out = cm.fused_matmul(x, w, bias, activation=act)
        ref = cm.fused_matmul_bias_act_reference(x, w, bias, activation=act)
        torch.cuda.synchronize()
        _check_fm(out, x, w, ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_matmul_unaligned_operands(cuda, dtype):
    """Views that start one element into their storage take the element
    loads (no 16-byte vectors) and give the same result."""
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm

    x, w, b = _fm_inputs((65,), 129, 136, dtype, cuda, seed=3)
    xs = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    xs[1:] = x.reshape(-1)
    x_off = xs[1:].view(x.shape)
    assert x_off.data_ptr() % 16 != 0
    out = cm.fused_matmul(x_off, w, b, activation="gelu_exact")
    ref = cm.fused_matmul_bias_act_reference(x, w, b,
                                             activation="gelu_exact")
    torch.cuda.synchronize()
    _check_fm(out, x, w, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("lead,k,n", [
    ((1,), 8, 8), ((7,), 64, 192), ((5,), 16, 16), ((129,), 776, 1000),
    ((2, 65), 96, 200), ((3, 128), 8, 392), ((4095,), 3072, 768)])
@pytest.mark.parametrize("act", FM_ACTS)
def test_fused_matmul_sm90_matches_plain(cuda, dtype, lead, k, n, act):
    """The tensor-core kernel (K and N multiples of 8, aligned operands)
    at ragged M, N and K — one row, a partial K slab, N past the
    192-column tile, 2-D and 3-D x — with and without a bias."""
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm

    x, w, b = _fm_inputs(lead, k, n, dtype, cuda, seed=k + n + 1)
    for bias in (b, None):
        before = cm.fused_matmul.sm90_launches
        out = cm.fused_matmul(x, w, bias, activation=act)
        ref = cm.fused_matmul_bias_act_reference(x, w, bias, activation=act)
        torch.cuda.synchronize()
        assert cm.fused_matmul.sm90_launches == before + 1
        _check_fm(out, x, w, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fused_matmul_sm90_takes_a_bias_view_off_8_byte_alignment(cuda,
                                                                  dtype):
    """A float32 bias that is a view one element into its storage (4-byte
    aligned only) is read as it is by the sm90 kernel."""
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm

    x, w, b = _fm_inputs((70,), 64, 200, dtype, cuda, seed=12)
    buf = torch.zeros(b.numel() + 1, device=cuda)
    buf[1:] = b
    b_off = buf[1:]
    assert b_off.data_ptr() % 8 != 0
    before = cm.fused_matmul.sm90_launches
    out = cm.fused_matmul(x, w, b_off, activation="relu")
    ref = cm.fused_matmul_bias_act_reference(x, w, b, activation="relu")
    torch.cuda.synchronize()
    assert cm.fused_matmul.sm90_launches == before + 1
    _check_fm(out, x, w, ref)


@pytest.mark.parametrize("lead,k,n", [
    ((1,), 4, 1), ((7,), 32, 9), ((5,), 36, 130), ((129,), 776, 1000),
    ((2, 65), 96, 200), ((3, 128), 8, 391), ((4095,), 3072, 768)])
@pytest.mark.parametrize("act", FM_ACTS)
def test_fused_matmul_f32_sm90_matches_plain(cuda, lead, k, n, act):
    """The float32 tensor-core kernel (K % 4 == 0, x aligned; three TF32
    passes) at ragged M, N and K — one row, a partial K slab, odd N, N
    past both tile widths, 2-D and 3-D x — with and without a bias, held
    to kernel_tolerance unchanged."""
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm

    x, w, b = _fm_inputs(lead, k, n, torch.float32, cuda, seed=k + n + 3)
    for bias in (b, None):
        before = cm.fused_matmul.sm90_f32_launches
        out = cm.fused_matmul(x, w, bias, activation=act)
        ref = cm.fused_matmul_bias_act_reference(x, w, bias, activation=act)
        torch.cuda.synchronize()
        assert cm.fused_matmul.sm90_f32_launches == before + 1
        _check_fm(out, x, w, ref)


def test_fused_matmul_f32_sm90_bits_copies_and_faults(cuda):
    """Two runs give the same bits; the weight's K-major split copy (its
    kernel giving tf32_split's bits) is made once and remade after an
    in-place change (the new result agrees with
    the new weight); one TF32 pass, the last 32-deep K slab dropped and a
    slab added twice all break kernel_tolerance."""
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.testing import matmul_check as mc
    from deeplearning4j_tpu_torch.testing import split_f32 as sf

    x, w, b = _fm_inputs((300,), 776, 200, torch.float32, cuda, seed=21)
    # the split copy's kernel gives tf32_split's bits, ragged tiles too
    for shape in ((776, 200), (5, 33), (64, 1)):
        ww = _randn(shape, torch.float32, cuda, 22)
        assert torch.equal(cm.kmajor_split(ww), sf.tf32_split(ww.t()))
    copies = cm.kmajor_weight.copies
    out = cm.fused_matmul(x, w, b, activation="gelu")
    again = cm.fused_matmul(x, w, b, activation="gelu")
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert cm.kmajor_weight.copies == copies + 1
    ref = cm.fused_matmul_bias_act_reference(x, w, b, activation="gelu")
    _check_fm(out, x, w, ref)
    atol, rtol = cm.kernel_tolerance(x, w, ref)
    for fault in mc.F32_FAULTS:
        bad = mc.fused_matmul_variant(x, w, b, activation="gelu",
                                      fault=fault, slab=mc.F32_SLAB)
        assert ((bad - ref).abs() > atol + rtol * ref.abs()).any(), fault
    w.mul_(-1.0)
    out = cm.fused_matmul(x, w, b, activation="gelu")
    torch.cuda.synchronize()
    assert cm.kmajor_weight.copies == copies + 2
    _check_fm(out, x, w, cm.fused_matmul_bias_act_reference(
        x, w, b, activation="gelu"))


def test_matmul_design_routes_by_counters(cuda):
    """matmul_design picks sm90 for 16-bit operands TMA can read, wmma for
    the other 16-bit ones, sm90_f32 for float32 with K % 4 == 0 and an
    aligned x, simt for the other float32 ones; each design's counter
    moves only for it, the launch counter for every call."""
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    for dtype, k, n, shift, want in (
            (torch.bfloat16, 64, 64, False, "sm90"),
            (torch.float16, 776, 1000, False, "sm90"),
            (torch.bfloat16, 68, 64, False, "wmma"),
            (torch.bfloat16, 64, 60, False, "wmma"),
            (torch.float16, 64, 64, True, "wmma"),
            (torch.float32, 64, 64, False, "sm90_f32"),
            (torch.float32, 68, 9, False, "sm90_f32"),
            (torch.float32, 66, 64, False, "simt"),
            (torch.float32, 64, 64, True, "simt")):
        x, w, b = _fm_inputs((33,), k, n, dtype, cuda, seed=5)
        if shift:
            x = unaligned(x)
        out = torch.empty((33, n), dtype=dtype, device=cuda)
        assert cm.matmul_design(x, w, out) == want, (dtype, k, n, shift)
        before = (cm.fused_matmul.launches, cm.fused_matmul.sm90_launches,
                  cm.fused_matmul.sm90_f32_launches)
        got = cm.fused_matmul(x, w, b, activation="gelu")
        ref = cm.fused_matmul_bias_act_reference(x, w, b, activation="gelu")
        torch.cuda.synchronize()
        assert (cm.fused_matmul.launches, cm.fused_matmul.sm90_launches,
                cm.fused_matmul.sm90_f32_launches) == (
            before[0] + 1, before[1] + int(want == "sm90"),
            before[2] + int(want == "sm90_f32"))
        _check_fm(got, x, w, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", FM_ACTS)
def test_fused_matmul_gradients_through_the_registry(cuda, dtype, act):
    """The registry's fused_matmul_bias_act on CUDA tensors launches the
    kernel, and its output carries the backward: gradients equal autograd
    of the plain version."""
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm

    x, w, b = _fm_inputs((2, 64), 256, 384, dtype, cuda, seed=9)
    g = _randn((2, 64, 384), dtype, cuda, seed=10)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    before = cm.fused_matmul.launches
    out = exec_op("fused_matmul_bias_act", *leaves, activation=act)
    assert cm.fused_matmul.launches == before + 1
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    ref = cm.fused_matmul_bias_act_reference(*ref_leaves, activation=act)
    want = torch.autograd.grad(ref, ref_leaves, g)
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2.0 ** -6)}
    for a, e in zip(got, want):
        assert a.dtype == e.dtype
        torch.testing.assert_close(a.float(), e.float(), atol=tol[dtype][0],
                                   rtol=tol[dtype][1])


def test_fused_matmul_gate_and_refusals(cuda):
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm

    x, w, b = _fm_inputs((16,), 128, 128, torch.float32, cuda, seed=1)
    assert cm.fused_matmul_usable(x, w, b)
    assert not cm.fused_matmul_usable(x, w, b, transpose_b=True)
    assert not cm.fused_matmul_usable(x, w, b, activation="swish")
    # no TPU tile rule: ragged M, K and N are taken
    assert cm.fused_matmul_usable(x[:12], w, b)
    assert cm.fused_matmul_usable(x[:, :64], w[:64], b)
    assert cm.fused_matmul_usable(x, w[:, :100], b[:100])
    assert not cm.fused_matmul_usable(x, w, b[None])          # 2-D bias
    assert not cm.fused_matmul_usable(x.cpu(), w.cpu(), b.cpu())
    before = cm.fused_matmul.launches
    assert cm.fused_matmul(x[:0], w, b).shape == (0, 128)   # nothing to do
    assert cm.fused_matmul.launches == before
    # kernel-only limits raise in the wrapper, never a quiet fallback
    with pytest.raises(ValueError):
        cm.fused_matmul(x, w.to(torch.bfloat16), b)
    with pytest.raises(ValueError):
        cm.fused_matmul(x.double(), w.double(), b)
    with pytest.raises(ValueError):
        cm.fused_matmul(x, w, b, activation="swish")
    env = environment()
    env.helper_mode = "kernel"
    try:
        with pytest.raises(RuntimeError):
            exec_op("fused_matmul_bias_act", x, w.t(), b, transpose_b=True)
    finally:
        env.helper_mode = "auto"


def test_imported_bert_runs_every_epilogue_through_the_kernel(cuda):
    """A small imported BERT on the card: one
    kernel launch per epilogue fusion and one flash launch per layer,
    and the output equals the generic run's."""
    from deeplearning4j_tpu_torch.imports import import_onnx
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.testing.onnx_builder import bert_onnx_model

    batch, seq, layers = 2, 64, 2
    model = bert_onnx_model(layers=layers, batch=batch, seq=seq, d=256,
                            heads=4, ff=512, vocab=100)
    g = np.random.default_rng(2)
    lens = np.array([64, 20])
    feeds = {"ids": g.integers(0, 100, (batch, seq)).astype(np.float32),
             "mask": (np.arange(seq)[None] < lens[:, None]).astype(
                 np.float32)}
    sd = import_onnx(model, device=cuda)
    env = environment()
    env.helper_mode = "generic"
    try:
        want = sd.output(feeds, ["y"])["y"]
    finally:
        env.helper_mode = "auto"
    ca.reset_launch_counts()
    before = cm.fused_matmul.launches
    got = sd.output(feeds, ["y"])["y"]
    st = sd.last_compile_stats
    assert st.fusions == {"attention": layers, "epilogue": 6 * layers}
    assert cm.fused_matmul.launches - before == 6 * layers
    assert ca.launch_counts()["flash_attn_fwd"] == layers
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------- fused LayerNorm


LN_ACTS = ["none", "relu", "tanh", "gelu", "gelu_exact"]


def _ln_inputs(rows, d, dtype, dev, seed):
    g = np.random.default_rng(seed)
    x = torch.from_numpy((2.0 * g.standard_normal((rows, d)) + 0.5).astype(
        np.float32)).to(dev, dtype)
    gain = torch.from_numpy((1.0 + 0.1 * g.standard_normal(d)).astype(
        np.float32)).to(dev)
    bias = torch.from_numpy((0.1 * g.standard_normal(d)).astype(
        np.float32)).to(dev)
    return x, gain, bias


def _check_ln(out, ref):
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl

    assert out.shape == ref.shape and out.dtype == ref.dtype
    atol, rtol = cl.kernel_tolerance(ref.dtype)
    err = (out.float() - ref.float()).abs()
    lim = atol + rtol * ref.float().abs()
    assert bool((err <= lim).all()), (err.max().item(),
                                      (err / lim).max().item())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 7, 4096])
@pytest.mark.parametrize("d", [64, 96, 768, 1000, 4096])
@pytest.mark.parametrize("act", LN_ACTS)
def test_fused_layer_norm_matches_plain(cuda, dtype, rows, d, act):
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl

    x, g, b = _ln_inputs(rows, d, dtype, cuda, seed=rows + d)
    for bias in (b, None):
        before = cl.fused_layer_norm_kernel.launches
        out = cl.fused_layer_norm_kernel(x, g, bias, activation=act)
        ref = cl.fused_layer_norm_reference(x, g, bias, activation=act)
        torch.cuda.synchronize()
        assert cl.fused_layer_norm_kernel.launches == before + 1
        _check_ln(out, ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [97, 1501])
def test_fused_layer_norm_element_accesses(cuda, dtype, d):
    """An odd D and rows that start off a 16-byte boundary take the element
    accesses (no vectors), on the warp and the block path, in a 3-D x."""
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl

    x, g, b = _ln_inputs(2 * 33, d, dtype, cuda, seed=d)
    x = x.reshape(2, 33, d)
    out = cl.fused_layer_norm_kernel(x, g, b, activation="gelu")
    ref = cl.fused_layer_norm_reference(x, g, b, activation="gelu")
    _check_ln(out, ref)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    flat[1:] = x.reshape(-1)
    x_off = flat[1:].view(2, 33, d)
    assert x_off.data_ptr() % 16 != 0
    out = cl.fused_layer_norm_kernel(x_off, g, b, activation="gelu_exact")
    ref = cl.fused_layer_norm_reference(x, g, b, activation="gelu_exact")
    torch.cuda.synchronize()
    _check_ln(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", LN_ACTS)
def test_fused_layer_norm_gradients_through_the_registry(cuda, dtype, act):
    """The registry's fused_layer_norm on CUDA tensors launches the kernel,
    and its output carries the backward: gradients equal autograd of the
    plain version."""
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl

    x, g, b = _ln_inputs(2 * 64, 768, dtype, cuda, seed=4)
    x = x.reshape(2, 64, 768)
    dy = _randn((2, 64, 768), dtype, cuda, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (x, g, b)]
    before = cl.fused_layer_norm_kernel.launches
    out = exec_op("fused_layer_norm", *leaves, activation=act)
    assert cl.fused_layer_norm_kernel.launches == before + 1
    assert out.grad_fn is not None and out.dtype == dtype
    got = torch.autograd.grad(out, leaves, dy)
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, g, b)]
    ref = cl.fused_layer_norm_reference(*ref_leaves, activation=act)
    want = torch.autograd.grad(ref, ref_leaves, dy)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype
        torch.testing.assert_close(a.float(), e.float(), atol=1e-5,
                                   rtol=1e-5)


def test_fused_layer_norm_gate_and_refusals(cuda):
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl

    x, g, b = _ln_inputs(16, 100, torch.float32, cuda, seed=1)
    assert cl.fused_layer_norm_usable(x, g, b)
    assert cl.fused_layer_norm_usable(x, g)                 # no bias
    assert cl.fused_layer_norm_usable(x[:3], g, b)          # any rows, D
    assert cl.fused_layer_norm_usable(x.double(), g, b)     # as the JAX gate
    assert not cl.fused_layer_norm_usable(x, g, b, axis=0)
    assert not cl.fused_layer_norm_usable(x, g, b, activation="swish")
    assert not cl.fused_layer_norm_usable(x, g[None], b)    # 2-D gain
    assert not cl.fused_layer_norm_usable(x, g, b[:50])
    assert not cl.fused_layer_norm_usable(x[0], g, b)       # rank 1
    assert not cl.fused_layer_norm_usable(x.cpu(), g.cpu(), b.cpu())
    before = cl.fused_layer_norm_kernel.launches
    assert cl.fused_layer_norm_kernel(x[:0], g, b).shape == (0, 100)
    assert cl.fused_layer_norm_kernel.launches == before
    # kernel-only limits raise in the wrapper, never a quiet fallback
    with pytest.raises(ValueError):
        cl.fused_layer_norm_kernel(x.double(), g, b)
    with pytest.raises(ValueError):
        cl.fused_layer_norm_kernel(x, g, b, activation="swish")
    with pytest.raises(ValueError):
        cl.fused_layer_norm_kernel(x, g[:50], b)
    env = environment()
    env.helper_mode = "kernel"
    try:
        with pytest.raises(RuntimeError):
            exec_op("fused_layer_norm", x, g, b, axis=0)
    finally:
        env.helper_mode = "auto"


def test_fused_layer_norm_build_and_launch_failures_raise(cuda, tmp_path,
                                                          monkeypatch):
    """A source that does not compile raises with the compiler's output,
    and a launch the driver refuses raises with its cudaError_t; neither
    runs the plain version nor counts a launch."""
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl

    x, g, b = _ln_inputs(8, 64, torch.float32, cuda, seed=2)
    before = cl.fused_layer_norm_kernel.launches
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "fused_layer_norm.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "SOURCES", ("fused_layer_norm",))
    monkeypatch.setattr(_build, "_fns", {})
    with pytest.raises(RuntimeError, match="build failed"):
        cl.fused_layer_norm_kernel(x, g, b)
    monkeypatch.setattr(_build, "kernel_fn",
                        lambda *a, **k: (lambda *args: 9))
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        cl.fused_layer_norm_kernel(x, g, b)
    assert cl.fused_layer_norm_kernel.launches == before


def test_samediff_fit_launches_the_layernorm_kernel_each_step(cuda):
    """A small imported BERT with the token head, fine-tuned through
    ``sd.fit`` on the card: each step launches the fused LayerNorm once,
    the flash forward, dq and dk/dv once a layer, the fused matmul once an
    epilogue and the updater once a leaf; the losses equal the generic
    run's (1e-5 relative)."""
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.imports import import_onnx
    from deeplearning4j_tpu_torch.nn.updater import Adam
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.testing import onnx_builder as ob

    batch, seq, layers, d = 2, 64, 2, 256
    model = ob.bert_onnx_model(layers=layers, batch=batch, seq=seq, d=d,
                               heads=4, ff=512, vocab=100)
    feeds = ob.bert_onnx_feeds(batch, seq, 100)
    data = ob.TokenBatch(feeds, ob.token_labels(batch, seq))
    env = environment()

    def fit(mode):
        env.helper_mode = mode
        try:
            sd = import_onnx(model, device=cuda)
            _, loss = ob.add_token_head(sd, f"l{layers - 1}_out",
                                        ob.token_head_arrays(d), batch, seq)
            sd.set_training_config(TrainingConfig(
                updater=Adam(learning_rate=1e-3),
                data_set_feature_mapping=["ids", "mask"],
                data_set_label_mapping=["labels"], loss_variables=[loss]))
            return [sd.fit([data])[0] for _ in range(2)], sd
        finally:
            env.helper_mode = "auto"

    want, _ = fit("generic")
    ca.reset_launch_counts()
    cl.fused_layer_norm_kernel.launches = 0
    cm.fused_matmul.launches = 0
    cu.fused_updater.launches = cu.fused_updater.leaves = 0
    got, sd = fit("auto")
    n_leaves = len(sd.training_state()["params"])
    assert sd.last_compile_stats.fusions == {
        "attention": layers, "epilogue": 6 * layers + 2, "layernorm": 1}
    assert cl.fused_layer_norm_kernel.launches == 2
    assert cm.fused_matmul.launches == 2 * (6 * layers + 2)
    assert cu.fused_updater.leaves == 2 * n_leaves == 2 * 41
    assert cu.fused_updater.launches == 2
    counts = ca.launch_counts()
    for name in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
        assert counts[name] == 2 * layers, (name, counts)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] < got[0]


# ------------------------------------------------- int8 serving matmul


def _int8_inputs(lead, k, n, dtype, dev, seed):
    from deeplearning4j_tpu_torch.ops import quantized as Q

    g = np.random.default_rng(seed)
    x = torch.from_numpy((2.0 * g.standard_normal(lead + (k,))).astype(
        np.float32)).to(dev, dtype)
    w = torch.from_numpy((0.05 * g.standard_normal((k, n))).astype(
        np.float32)).to(dev)
    wq, ws = Q.quantize_int8.fn(w, axis=0)
    return x, wq, ws


def _check_int8(x, wq, ws):
    """The row quantization, the GEMM and the two together equal their
    plain versions bit for bit."""
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
    from deeplearning4j_tpu_torch.ops import quantized as Q

    x2 = x.reshape(-1, x.shape[-1])
    xq, xs = cq.row_quantize(x2)
    rq, rs = Q._row_quantize(x2)
    y = cq.int8_matmul(xq, xs, wq, ws, x.dtype)
    whole = cq.matmul_int8(x, wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(xq, rq) and torch.equal(xs, rs)
    assert torch.equal(y, cq.int8_matmul_reference(xq, xs, wq, ws, x.dtype))
    assert whole.shape == x.shape[:-1] + (wq.shape[1],)
    assert whole.dtype == x.dtype
    assert torch.equal(whole, cq.matmul_int8_reference(x, wq, ws))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 17, 4095])
@pytest.mark.parametrize("n", [2, 9, 130])
@pytest.mark.parametrize("k", [7, 768, 3072])
def test_matmul_int8_matches_plain_bit_for_bit(cuda, dtype, m, n, k):
    x, wq, ws = _int8_inputs((m,), k, n, dtype, cuda, seed=m + n + k)
    _check_int8(x, wq, ws)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,k,n", [((3, 17), 768, 130), ((2, 64), 3072, 768),
                                      ((4, 9), 7, 2)])
@pytest.mark.parametrize("scale_2d", [False, True], ids=["n", "1n"])
def test_matmul_int8_3d_and_scale_layouts(cuda, dtype, lead, k, n, scale_2d):
    x, wq, ws = _int8_inputs(lead, k, n, dtype, cuda, seed=k + n)
    _check_int8(x, wq, ws if scale_2d else ws.reshape(n))


@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_int8_unaligned_operands(cuda, dtype):
    """Operands at odd offsets into their buffers: the element paths."""
    x, wq, ws = _int8_inputs((66,), 769, 33, dtype, cuda, seed=3)
    xo = torch.empty(66 * 769 + 1, dtype=dtype, device=cuda)[1:].view(66, 769)
    xo.copy_(x)
    wo = torch.empty(769 * 33 + 3, dtype=torch.int8, device=cuda)[3:].view(
        769, 33)
    wo.copy_(wq)
    _check_int8(xo, wo, ws)


# the sm90 GEMM: ragged M, N past and short of both tile widths (N 2, 9:
# element stores), K of one 16-byte row and a partial 128-deep slab
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 130, 4095])
@pytest.mark.parametrize("n", [2, 9, 200, 768])
@pytest.mark.parametrize("k", [16, 784, 3072])
def test_matmul_int8_sm90_matches_plain_bit_for_bit(cuda, dtype, m, n, k):
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq

    x, wq, ws = _int8_inputs((m,), k, n, dtype, cuda, seed=m + n + k + 1)
    xq, xs = cq.row_quantize(x)
    assert cq.int8_design(xq) == "sm90"
    before = cq.int8_matmul.sm90_launches
    y = cq.int8_matmul(xq, xs, wq, ws, dtype)
    again = cq.int8_matmul(xq, xs, wq, ws, dtype)
    torch.cuda.synchronize()
    assert cq.int8_matmul.sm90_launches == before + 2
    assert torch.equal(y, cq.int8_matmul_reference(xq, xs, wq, ws, dtype))
    assert torch.equal(y, again)


@pytest.mark.parametrize("n", [200, 768])
def test_int8_sm90_accumulator_map(cuda, n):
    """An integer product whose every entry is known, acc[r, c] =
    r + 4096·c (exact in float32), with unit scales: each s32 register of
    m64nNk32 lands at the (row, column) acc_row / acc_col give it, in both
    tile widths (M 4096: N 200 takes BN 128, N 768 BN 192)."""
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq

    m, k = 4096, 4176
    r = torch.arange(m)
    c = torch.arange(n)
    q = torch.zeros((m, k), dtype=torch.int64)
    w = torch.zeros((k, n), dtype=torch.int64)
    q[:, 0], q[:, 1] = r % 64, r // 64       # r = r0 + 64 r1
    w[0], w[1] = 1, 64
    q[:, 2:66] = 64                          # 64 · 64 · (c % 64)
    w[2:66] = (c % 64).reshape(1, n)
    q[:, 66:4162] = 64                       # 4096 · 64 · (c // 64)
    w[66:4162] = (c // 64).reshape(1, n)
    q, w = q.to(cuda, torch.int8), w.to(cuda, torch.int8)
    from deeplearning4j_tpu_torch.ops.cuda_matmul import sm_count

    assert cq.int8_tile_n(m, n, sm_count(0)) == (192 if n == 768 else 128)
    ones_m = torch.ones(m, device=cuda)
    ones_n = torch.ones(n, device=cuda)
    assert cq.int8_design(q) == "sm90"
    want = (r.reshape(m, 1) + 4096 * c.reshape(1, n)).to(cuda, torch.float32)
    y = cq.int8_matmul(q, ones_m, w, ones_n, torch.float32)
    assert torch.equal(y, want)
    y = cq.int8_matmul(q, ones_m, -w, ones_n, torch.float32)  # signed s8
    assert torch.equal(y, -want)


def test_int8_faulted_variants_break_bit_exactness(cuda):
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
    from deeplearning4j_tpu_torch.testing import matmul_check as mc

    x, wq, ws = _int8_inputs((4096,), 768, 768, torch.float32, cuda, seed=2)
    xq, xs = cq.row_quantize(x)
    y = cq.int8_matmul(xq, xs, wq, ws, torch.float32)
    assert torch.equal(y, cq.int8_matmul_reference(xq, xs, wq, ws,
                                                   torch.float32))
    for fault in mc.INT8_FAULTS:
        bad = mc.int8_matmul_variant(xq, xs, wq, ws, torch.float32,
                                     fault=fault)
        assert not torch.equal(bad, y), fault


def test_int8_design_routes_by_counters(cuda):
    """sm90 where TMA reads q (K % 16, aligned), wmma for an odd K or an
    offset q; the sm90 counter moves only for sm90. The K-major weight is
    copied once, reused, and remade after an in-place change of w_q."""
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq

    for k, shift, want in ((768, False, "sm90"), (7, False, "wmma"),
                           (776, True, "wmma")):
        x, wq, ws = _int8_inputs((33,), k, 40, torch.bfloat16, cuda, seed=k)
        xq, xs = cq.row_quantize(x)
        if shift:
            buf = torch.empty(xq.numel() + 1, dtype=torch.int8, device=cuda)
            xq = buf[1:].view(xq.shape).copy_(xq)
        assert cq.int8_design(xq) == want, (k, shift)
        before = (cq.int8_matmul.launches, cq.int8_matmul.sm90_launches)
        y = cq.int8_matmul(xq, xs, wq, ws, torch.bfloat16)
        torch.cuda.synchronize()
        assert (cq.int8_matmul.launches, cq.int8_matmul.sm90_launches) == (
            before[0] + 1, before[1] + int(want == "sm90"))
        assert torch.equal(y, cq.int8_matmul_reference(xq, xs, wq, ws,
                                                       torch.bfloat16))
    x, wq, ws = _int8_inputs((64,), 256, 96, torch.float32, cuda, seed=9)
    xq, xs = cq.row_quantize(x)
    copies = cq.kmajor_weight.copies
    cq.int8_matmul(xq, xs, wq, ws, torch.float32)
    cq.int8_matmul(xq, xs, wq, ws, torch.float32)
    assert cq.kmajor_weight.copies == copies + 1
    wq.neg_()  # in place: the kept copy is stale
    y = cq.int8_matmul(xq, xs, wq, ws, torch.float32)
    torch.cuda.synchronize()
    assert cq.kmajor_weight.copies == copies + 2
    assert torch.equal(y, cq.int8_matmul_reference(xq, xs, wq, ws,
                                                   torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_int8_gradients_through_the_registry(cuda, dtype):
    """The straight-through backward on the card: the registry's kernel
    forward launches both kernels once, and dx and the scale's (zero)
    gradient equal the generic run's."""
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq

    x, wq, ws = _int8_inputs((4, 33), 256, 96, dtype, cuda, seed=5)
    g = _randn((4, 33, 96), dtype, cuda, 6)
    env = environment()
    grads = {}
    for mode in ("generic", "auto"):
        env.helper_mode = mode
        try:
            xr = x.clone().requires_grad_(True)
            wr = ws.clone().requires_grad_(True)
            cq.reset_launch_counts()
            y = exec_op("matmul_int8", xr, wq, wr)
            launched = cq.launch_counts()
            grads[mode] = (y,) + torch.autograd.grad(y, (xr, wr), g)
        finally:
            env.helper_mode = "auto"
        want = 0 if mode == "generic" else 1
        assert launched == {"matmul_int8": want, "row_quantize": want}
    for a, b in zip(grads["auto"], grads["generic"]):
        assert torch.equal(a, b)
    assert not grads["auto"][2].any()


def test_matmul_int8_gate_and_refusals(cuda):
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq

    x, wq, ws = _int8_inputs((16,), 128, 64, torch.float32, cuda, seed=1)
    assert cq.matmul_int8_usable(x, wq, ws)
    assert cq.matmul_int8_usable(x[:5, :100], wq[:100], ws)  # no tile rule
    assert not cq.matmul_int8_usable(x.double(), wq, ws)
    assert not cq.matmul_int8_usable(x[:, :64], wq, ws)
    assert not cq.matmul_int8_usable(x, wq.float(), ws)
    assert not cq.matmul_int8_usable(x, wq, ws[:, :10])
    assert not cq.matmul_int8_usable(x.cpu(), wq.cpu(), ws.cpu())
    before = cq.launch_counts()
    assert cq.matmul_int8(x[:0], wq, ws).shape == (0, 64)  # nothing to do
    assert cq.launch_counts() == before
    # called directly, what the kernel does not take raises
    with pytest.raises(ValueError):
        cq.row_quantize(x.double())
    xq, xs = cq.row_quantize(x)
    with pytest.raises(ValueError):
        cq.int8_matmul(xq[:, :64], xs, wq, ws, torch.float32)
    with pytest.raises(ValueError):
        cq.int8_matmul(xq, xs, wq, ws, torch.float64)
    env = environment()
    env.helper_mode = "kernel"
    try:
        with pytest.raises(RuntimeError):
            exec_op("matmul_int8", x.double(), wq, ws)
    finally:
        env.helper_mode = "auto"


def test_int8_bert_runs_every_matmul_through_the_kernel(cuda):
    """A small int8 encoder recorded through SameDiff on the card: each
    forward launches the GEMM and the row quantization once a dense
    weight and flash once a layer; the output is held against the generic
    run within 3× a generic run from an embedding table moved by one unit
    in the last place."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
    from deeplearning4j_tpu_torch.testing import onnx_builder as ob
    from deeplearning4j_tpu_torch.testing.int8_bert import bert_int8_encoder

    batch, seq, layers = 2, 64, 2
    arrays = ob.bert_onnx_weights(layers=layers, seq=seq, d=256, ff=512,
                                  vocab=100)
    feeds = ob.bert_onnx_feeds(batch, seq, 100)
    sign = np.sign(np.random.default_rng(4).standard_normal(
        arrays["emb"].shape)).astype(np.float32)
    nudged = dict(arrays, emb=np.nextafter(arrays["emb"],
                                           sign * np.inf).astype(np.float32))
    env = environment()

    def run(mode, weights):
        env.helper_mode = mode
        try:
            sd = SameDiff(device=cuda)
            bert_int8_encoder(sd, weights, batch=batch, seq=seq, heads=4)
            return sd.output(feeds, ["y", "hidden"])
        finally:
            env.helper_mode = "auto"

    want, yard = run("generic", arrays), run("generic", nudged)
    ca.reset_launch_counts()
    cq.reset_launch_counts()
    got = run("auto", arrays)
    assert cq.launch_counts() == {"matmul_int8": 6 * layers + 1,
                                  "row_quantize": 6 * layers + 1}
    assert ca.launch_counts()["flash_attn_fwd"] == layers
    for name in ("y", "hidden"):
        assert np.all(np.isfinite(got[name]))
        limit = 3.0 * np.abs(yard[name] - want[name]).max()
        assert np.abs(got[name] - want[name]).max() <= limit, name


def test_attention_head_dim_past_the_kernels_runs_the_plain_op(cuda):
    """D = 320: the gate refuses it (the kernels are built up to 256), so
    ``dot_product_attention`` returns the plain result, counts a generic
    dispatch and launches nothing — it does not raise."""
    from deeplearning4j_tpu_torch import observe

    q, k, v = (_randn((2, 3, 40, 320), torch.float32, cuda, s)
               for s in (1, 2, 3))
    mask = torch.ones((2, 1, 1, 40), dtype=torch.bool, device=cuda)
    mask[1, ..., 25:] = False
    observe.reset()
    ca.reset_launch_counts()
    got = exec_op("dot_product_attention", q, k, v, mask)
    assert ca.launch_counts()["flash_attn_fwd"] == 0
    m = observe.metrics()
    assert m.counter("dl4j_tpu_helper_dispatch_total",
                     op="dot_product_attention", impl="generic",
                     reason="not_usable").value == 1
    from deeplearning4j_tpu_torch.ops.nn_ops import dot_product_attention

    assert torch.equal(got, dot_product_attention.fn(q, k, v, mask))


# ---------------------------------------------------------------------------
# lstm_layer: cuDNN's LSTM as the registry helper (a library call)
# ---------------------------------------------------------------------------

LSTM_LENGTHS = [12, 9, 5, 1, 12]


def _lstm_inputs(dev, dtype=torch.float32, state=False, t=12, i=7, h=16):
    n = len(LSTM_LENGTHS)
    args = [_randn((n, t, i), dtype, dev, 70),
            0.3 * _randn((i, 4 * h), dtype, dev, 71),
            0.3 * _randn((h, 4 * h), dtype, dev, 72),
            0.1 * _randn((4 * h,), dtype, dev, 73)]
    args += ([_randn((n, h), dtype, dev, 74), _randn((n, h), dtype, dev, 75)]
             if state else [None, None])
    return args


def _right_mask(dev, t=12):
    lens = torch.tensor(LSTM_LENGTHS, device=dev)
    return (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()


def _lstm_tally(op="lstm_layer"):
    from deeplearning4j_tpu_torch import observe

    return {dict(c.labels)["impl"] + "/" + dict(c.labels)["reason"]:
            int(c.value) for c in observe.metrics().instruments()
            if c.name == "dl4j_tpu_helper_dispatch_total"
            and dict(c.labels)["op"] == op and c.value}


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "reverse"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "right"])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "carried"])
def test_lstm_layer_cudnn_matches_generic(cuda, reverse, masked, state):
    """The helper against the generic on the card, float32 (TF32 off):
    outputs at every position 1e-5, the last h and c 1e-5, and the
    gradients of x, W, RW, b (and the carried state) 1e-4 — the same
    products summed in cuDNN's order. Padded positions hold the last h in
    the forward direction and the initial h in the reverse one."""
    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.ops.cudnn_lstm import lstm_layer

    args = _lstm_inputs(cuda, state=state)
    mask = _right_mask(cuda) if masked else None
    kw = dict(gate_activation="sigmoid", activation="tanh", reverse=reverse)
    w = [_randn(s, torch.float32, cuda, 76 + k)
         for k, s in enumerate([(5, 12, 16), (5, 16), (5, 16)])]
    outs, grads = {}, {}
    for name in ("helper", "generic"):
        leaves = [a.clone().requires_grad_(True) if a is not None else None
                  for a in args]
        observe.reset()
        fn = (functools.partial(exec_op, "lstm_layer") if name == "helper"
              else lstm_layer.fn)
        ys = fn(*leaves, mask, **kw)
        if name == "helper":
            assert _lstm_tally() == {"cudnn/usable": 1}
        sum((y * wk).sum() for y, wk in zip(ys, w)).backward()
        outs[name] = [y.detach() for y in ys]
        grads[name] = [a.grad for a in leaves if a is not None]
    for a, b in zip(outs["helper"], outs["generic"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(grads["helper"], grads["generic"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    if masked:
        y, h_last = outs["helper"][0], outs["helper"][1]
        h0 = args[4] if state else torch.zeros_like(h_last)
        for row, n in enumerate(LSTM_LENGTHS):
            fill = h0[row] if reverse else h_last[row]
            assert torch.equal(y[row, n:], fill.expand(12 - n, -1))


def test_lstm_layer_cudnn_float16(cuda):
    """float16, right-padded, both directions: the helper within 1e-2 of
    the generic (outputs in (-1, 1); ten float16 units at 1 over 12
    steps)."""
    from deeplearning4j_tpu_torch.ops.cudnn_lstm import lstm_layer

    args = _lstm_inputs(cuda, dtype=torch.float16)
    mask = _right_mask(cuda)
    for reverse in (False, True):
        kw = dict(gate_activation="sigmoid", activation="tanh",
                  reverse=reverse)
        got = exec_op("lstm_layer", *args, mask, **kw)
        want = lstm_layer.fn(*args, mask, **kw)
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                       atol=1e-2)


@pytest.mark.parametrize("case", ["interior_mask", "hardsigmoid",
                                  "identity_cell", "bfloat16"])
def test_lstm_layer_gate_refuses_what_cudnn_computes_otherwise(cuda, case):
    """An interior mask, hardsigmoid gates, a non-tanh cell activation and
    bfloat16 run the generic (tallied ``impl=generic``, the generic's
    exact result); ``helper_mode="kernel"`` raises instead."""
    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.ops.cudnn_lstm import lstm_layer

    dtype = torch.bfloat16 if case == "bfloat16" else torch.float32
    args = _lstm_inputs(cuda, dtype=dtype)
    mask = _right_mask(cuda)
    if case == "interior_mask":
        mask[0, 3] = 0.0
    kw = dict(gate_activation="hardsigmoid" if case == "hardsigmoid"
              else "sigmoid",
              activation="identity" if case == "identity_cell" else "tanh")
    observe.reset()
    got = exec_op("lstm_layer", *args, mask, **kw)
    assert _lstm_tally() == {"generic/not_usable": 1}
    for a, b in zip(got, lstm_layer.fn(*args, mask, **kw)):
        assert torch.equal(a, b)
    env = environment()
    env.helper_mode = "kernel"
    try:
        with pytest.raises(RuntimeError, match="usable gate refuses"):
            exec_op("lstm_layer", *args, mask, **kw)
    finally:
        env.helper_mode = "auto"


def test_bilstm_tagger_dispatches_cudnn_per_direction(cuda):
    """A small BiLSTM tagger through ``fit`` and ``output`` on the card:
    two cuDNN dispatches a forward (one a direction), none generic, and
    its output within 1e-5 of ``helper_mode="generic"`` at every position
    after a step."""
    from deeplearning4j_tpu_torch import nn as tnn
    from deeplearning4j_tpu_torch import observe

    conf = (tnn.builder().seed(1).updater(tnn.Adam(learning_rate=5e-3))
            .list()
            .layer(tnn.Bidirectional.wrap(tnn.LSTM(n_out=16,
                                                   activation="tanh")))
            .layer(tnn.RnnOutputLayer(n_out=5, activation="softmax"))
            .set_input_type(tnn.InputType.recurrent(7)).build())
    net = tnn.MultiLayerNetwork(conf, device=cuda).init()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 12, 7), dtype=np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (5, 12))]
    m = _right_mask(cuda).cpu().numpy()
    observe.reset()
    net.fit(x, y, batch_size=5)
    got = net.output(x, m)
    assert _lstm_tally() == {"cudnn/usable": 4}   # fit's forward, output
    env = environment()
    env.helper_mode = "generic"
    try:
        want = net.output(x, m)
    finally:
        env.helper_mode = "auto"
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
