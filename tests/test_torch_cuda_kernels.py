"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a GPU (the
decision is taken inside the ``cuda`` fixture, never at import). Run them
on the card with::

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

``chip_smoke.py`` holds each kernel against its plain version at the
serving shapes; these cover the edges: ragged lengths, one-row queries,
non-causal and rectangular attention, head dims of every instantiation
(padded and exact), other page sizes, empty (inactive) decode slots, and
the three dtypes.

Tolerances, elementwise ``|kernel - plain| <= ATOL + RTOL * |plain|``:
float32 1e-4 absolute (same math, another summation order; ~1e-6 seen);
bfloat16 and float16 one unit in the last place of the plain output
(RTOL 2^-7 and 2^-10, ATOL 1e-5): both sides compute in float32 and round
once, so they differ by at most one rounding step. The float32 lse:
1e-4 absolute.
"""

import math

import numpy as np
import pytest

import torch

from deeplearning4j_tpu_torch.environment import environment
from deeplearning4j_tpu_torch.models.gpt import (
    GptConfig, GptModel, init_gpt_params, reference_generate)
from deeplearning4j_tpu_torch.ops import cuda_attention as ca
from deeplearning4j_tpu_torch.ops import exec_op
from deeplearning4j_tpu_torch.serving import GenerativeEngine

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-5, torch.float16: 1e-5}
LSE_TOL = 1e-4
# one head dim per instantiation at its full width and one padded below it
HEAD_DIMS = [8, 32, 48, 64, 96, 128, 200, 256]


def _assert_close(out, ref, dtype):
    ref = ref.float()
    err = (out.float() - ref).abs()
    lim = ATOL[dtype] + RTOL[dtype] * ref.abs()
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
    _assert_close(out, ref, dtype)
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("page", [8, 16])
def test_paged_matches_plain(cuda, dtype, d, page):
    s_n, h, max_pages = 5, 3, 12
    n_pages = s_n * max_pages
    kv = _randn((2, n_pages + 1, page, h, d), dtype, cuda, 5)
    q = _randn((s_n, h, d), dtype, cuda, 6)
    perm = np.random.default_rng(7).permutation(n_pages)
    pt = torch.from_numpy(perm.reshape(s_n, max_pages).astype(np.int32)).to(
        cuda)
    # an inactive slot (0), one token, a page boundary, ragged, full row
    lens = [0, 1, page, 3 * page + 5, max_pages * page]
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = ca.paged_decode_attention(q, kv[0], kv[1], pt, sl)
    ref = ca.paged_decode_attention_reference(q, kv[0], kv[1], pt, sl)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    live = sl > 0
    _assert_close(out[live], ref[live], dtype)


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
