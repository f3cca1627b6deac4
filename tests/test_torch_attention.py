"""Attention parity of the PyTorch port against the JAX package (CPU).

The port's plain flash and paged-decode versions — what the CUDA kernels
are held against on the card — run on the same numpy inputs as the JAX
package's generic op and its Pallas kernels in interpret mode: the
forward with and without dropout, and the backward against ``jax.vjp``
of the JAX ``flash_attention`` custom VJP. The dropout keep mask equals
the TPU kernels' bit for bit. The wrappers on CPU tensors compute the
plain versions; the registry's dispatch and usable gates are checked
without a card.

Tolerances (float32 throughout): 1e-5 absolute/relative — the same
arithmetic in another summation order, on O(1) values. The keep mask:
exact.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import nn_ops as jax_nn_ops
from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu_torch.environment import environment
from deeplearning4j_tpu_torch.ops import cuda_attention as ca
from deeplearning4j_tpu_torch.ops import exec_op, registry
from deeplearning4j_tpu_torch.testing import paged_check as pc

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(bh=6, t_q=40, t_k=40, d=16, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(bh, t_q, d).astype(np.float32),
            r.randn(bh, t_k, d).astype(np.float32),
            r.randn(bh, t_k, d).astype(np.float32))


def _key_mask(bh, t_k, seed=1):
    """End-padded key masks; key 0 always valid (no fully-masked row)."""
    lens = np.random.RandomState(seed).randint(1, t_k + 1, size=bh)
    lens[0] = t_k
    return (np.arange(t_k)[None, :] < lens[:, None]).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def helper_mode():
    env = environment()
    old = env.helper_mode
    yield env
    env.helper_mode = old


class TestFlashPlainParity:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("masked", [False, True])
    def test_vs_jax_generic(self, causal, masked):
        q, k, v = _qkv()
        m = _key_mask(6, 40) if masked else None
        want = jax_nn_ops.dot_product_attention.fn(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if m is None else jnp.asarray(m[:, None, :] > 0.5),
            scaled=True, causal=causal)
        got, _ = ca.flash_attention_reference(
            _t(q), _t(k), _t(v), None if m is None else _t(m),
            causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_vs_pallas_interpret(self, causal):
        """Out AND lse against the Pallas forward, ragged T=40 over 16-row
        blocks (multi-tile, padded edge, causal tile skip)."""
        q, k, v = _qkv()
        m = _key_mask(6, 40)
        scale = 1.0 / np.sqrt(16)
        out, lse = jpa._flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
            jnp.zeros((1, 1), jnp.int32), scale=scale, causal=causal,
            block_q=16, block_k=16, interpret=True, dropout_rate=0.0)
        public = jpa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
            None, scale, causal, 16, 16, True, 0.0)
        got, got_lse = ca.flash_attention_reference(
            _t(q), _t(k), _t(v), _t(m), scale=scale, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(public), **TOL)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0],
                                   **TOL)

    def test_wrapper_on_cpu_is_the_plain_version(self):
        q, k, v = _qkv(seed=3)
        m = _key_mask(6, 40, seed=4)
        before = ca.flash_attention.launches
        out, lse = ca.flash_attention(_t(q), _t(k), _t(v), _t(m),
                                      causal=True)
        ref_out, ref_lse = ca.flash_attention_reference(
            _t(q), _t(k), _t(v), _t(m), causal=True)
        assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
        assert ca.flash_attention.launches == before  # nothing launched

    def test_causal_requires_equal_lengths(self):
        q, k, v = _qkv(t_q=8, t_k=12)
        with pytest.raises(ValueError, match="t_q == t_kv"):
            ca.flash_attention(_t(q), _t(k), _t(v), causal=True)


class TestDropoutAndBackward:
    """In-kernel attention dropout and the backward (kernels 1, 3, 4)."""

    @pytest.mark.parametrize("rate", [0.1, 0.3])
    @pytest.mark.parametrize("seed", [-2 ** 31, -7, 0, 123456789,
                                      2 ** 31 - 1])
    def test_keep_mask_is_bit_exact(self, seed, rate):
        """Rows and columns up to 511 (the int32 products wrap), batch·head
        indices up to 383, negative and large seeds."""
        rows = torch.arange(512)[:, None]
        cols = torch.arange(512)[None, :]
        for bh in (0, 1, 97, 383):
            want = np.asarray(jpa._keep_mask(
                jnp.int32(seed), jnp.int32(bh), 0, 0, block_q=512,
                block_k=512, rate=rate))
            got = ca.keep_mask(torch.tensor(seed, dtype=torch.int32), bh,
                               rows, cols, rate).numpy()
            np.testing.assert_array_equal(got, want)
            assert 0.5 < want.mean() < 1.0  # both values occur

    def test_keep_mask_takes_absolute_coordinates(self):
        """A tile at (q0, k0) of the JAX mask is the port's mask at those
        rows and columns (what lets every kernel regenerate it)."""
        want = np.asarray(jpa._keep_mask(jnp.int32(5), jnp.int32(7), 48, 16,
                                         block_q=16, block_k=32, rate=0.25))
        got = ca.keep_mask(5, 7, torch.arange(48, 64)[:, None],
                           torch.arange(16, 48)[None, :], 0.25).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("rate", [0.1, 0.3])
    def test_dropout_forward_vs_pallas_interpret(self, causal, rate):
        """Out and lse against the Pallas forward with in-kernel dropout,
        BH 6, ragged T = 40 over 16-row blocks, key mask."""
        q, k, v = _qkv()
        m = _key_mask(6, 40)
        scale = 1.0 / np.sqrt(16)
        seed = jnp.array([[-1234567]], jnp.int32)
        out, lse = jpa._flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
            seed, scale=scale, causal=causal, block_q=16, block_k=16,
            interpret=True, dropout_rate=rate)
        public = jpa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
            seed, scale, causal, 16, 16, True, rate)
        got, got_lse = ca.flash_attention_reference(
            _t(q), _t(k), _t(v), _t(m), torch.tensor([-1234567]),
            scale=scale, causal=causal, dropout_rate=rate)
        np.testing.assert_allclose(got.numpy(), np.asarray(out)[:, :40],
                                   **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(public), **TOL)
        np.testing.assert_allclose(got_lse.numpy(),
                                   np.asarray(lse)[:, :40, 0], **TOL)
        # dropout really dropped: the rate-0 output differs
        plain, _ = ca.flash_attention_reference(
            _t(q), _t(k), _t(v), _t(m), scale=scale, causal=causal)
        assert not np.allclose(got.numpy(), plain.numpy(), atol=1e-3)

    @pytest.mark.parametrize("rate", [0.0, 0.25])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("masked", [False, True])
    def test_backward_vs_jax_vjp(self, rate, causal, masked):
        """dq, dk, dv of the plain backward against ``jax.vjp`` of the JAX
        ``flash_attention`` (its Pallas dq and dk/dv kernels, interpret
        mode), from the port's own forward out and lse."""
        q, k, v = _qkv(seed=11)
        dout = np.random.RandomState(12).randn(6, 40, 16).astype(np.float32)
        m = _key_mask(6, 40, seed=13) if masked else None
        scale = 1.0 / np.sqrt(16)
        seed = 424242
        jm = None if m is None else jnp.asarray(m)

        def f(q_, k_, v_):
            return jpa.flash_attention(q_, k_, v_, jm,
                                       jnp.array([[seed]], jnp.int32), scale,
                                       causal, 16, 16, True, rate)

        _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(dout))
        tm = None if m is None else _t(m)
        out, lse = ca.flash_attention_reference(
            _t(q), _t(k), _t(v), tm, seed, scale=scale, causal=causal,
            dropout_rate=rate)
        got = ca.flash_attention_backward_reference(
            _t(q), _t(k), _t(v), tm, seed, out, lse, _t(dout), scale=scale,
            causal=causal, dropout_rate=rate)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=name)

    @pytest.mark.parametrize("rate", [0.0, 0.25])
    @pytest.mark.parametrize("causal", [False, True])
    def test_autograd_function_vs_autograd_of_plain_forward(self, rate,
                                                             causal):
        """``FlashAttentionFn`` on CPU tensors (its backward = the plain
        dq and dk/dv) against torch autograd through the plain forward."""
        q, k, v = (_t(a) for a in _qkv(seed=21))
        m = _t(_key_mask(6, 40, seed=22))
        dout = _t(np.random.RandomState(23).randn(6, 40, 16).astype(
            np.float32))
        grads = []
        for fn in (ca.flash_attention, ca.flash_attention_reference):
            qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out, lse = fn(*qs, m, 77, causal=causal, dropout_rate=rate)
            if fn is ca.flash_attention:  # lse is not differentiated
                assert not lse.requires_grad
            grads.append(torch.autograd.grad(out, qs, dout))
        for name, g, w in zip(("dq", "dk", "dv"), *grads):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL,
                                       err_msg=name)

    def test_flash_attention_output_carries_a_grad_fn(self):
        q, k, v = (_t(a).requires_grad_(True) for a in _qkv(seed=31))
        out, _ = ca.flash_attention(q, k, v)
        assert out.grad_fn is not None
        before = (ca.flash_attention.launches, ca.flash_attention_dq.launches,
                  ca.flash_attention_dkv.launches)
        out.sum().backward()
        assert q.grad is not None and k.grad is not None and v.grad is not None
        assert (ca.flash_attention.launches, ca.flash_attention_dq.launches,
                ca.flash_attention_dkv.launches) == before  # CPU: plain

    def test_dropout_needs_a_seed_and_an_rng(self):
        q, k, v = (_t(a) for a in _qkv(bh=2, t_q=8, t_k=8))
        with pytest.raises(ValueError, match="needs a seed"):
            ca.flash_attention(q, k, v, dropout_rate=0.1)
        with pytest.raises(ValueError, match="requires dropout_rng"):
            ca.flash_dpa(q[None], k[None], v[None], dropout_rate=0.1)

    def test_flash_dpa_draws_its_seed_from_the_generator(self):
        """Two generators seeded alike give the same dropped output; the
        folded batch·head index is batch-major, as the JAX ``flash_dpa``."""
        r = np.random.RandomState(41)
        q, k, v = (_t(r.randn(2, 3, 24, 16).astype(np.float32))
                   for _ in range(3))
        mask = _t(_key_mask(2, 24, seed=42)[:, None, None, :])
        outs = [ca.flash_dpa(q, k, v, mask, dropout_rate=0.2,
                             dropout_rng=torch.Generator().manual_seed(5))
                for _ in range(2)]
        assert torch.equal(outs[0], outs[1])
        seed = ca.rng_to_seed(torch.Generator().manual_seed(5))
        assert seed.dtype == torch.int32 and seed.shape == (1,)
        m = mask.reshape(2, 24).float().repeat_interleave(3, dim=0)
        want, _ = ca.flash_attention_reference(
            q.reshape(6, 24, 16), k.reshape(6, 24, 16), v.reshape(6, 24, 16),
            m, seed, dropout_rate=0.2)
        np.testing.assert_allclose(outs[0].reshape(6, 24, 16).numpy(),
                                   want.numpy(), **TOL)


class TestGenericOpParity:
    @pytest.mark.parametrize("t_q,t_k", [(24, 24), (8, 24)])
    def test_dot_product_attention_4d(self, t_q, t_k):
        """The port's generic op (mask fill -1e9, END-aligned causal) vs
        the JAX generic, (B, H, T, D) with a (B, 1, 1, Tk) key mask."""
        r = np.random.RandomState(5)
        q = r.randn(2, 3, t_q, 16).astype(np.float32)
        k = r.randn(2, 3, t_k, 16).astype(np.float32)
        v = r.randn(2, 3, t_k, 16).astype(np.float32)
        m = _key_mask(2, t_k, seed=6)[:, None, None, :] > 0.5
        want = jax_nn_ops.dot_product_attention.fn(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
            scaled=True, causal=True)
        got = exec_op("dot_product_attention", _t(q), _t(k), _t(v), _t(m),
                      scaled=True, causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("d", [96, 40])
    def test_bf16_divides_by_sqrt_d_rounded_to_bf16(self, d):
        """bfloat16 scores are divided by √D rounded to bfloat16 (9.8125
        for D 96, 6.3125 for D 40), as the reference's
        ``jnp.sqrt(jnp.asarray(D, scores.dtype))``: within one bfloat16
        unit at the largest |y| (the float √D missed by up to 0.516 at
        |y| ~9, where a unit is 0.0625)."""
        g = np.random.default_rng(0)
        q, k, v = (3.0 * g.standard_normal((2, 4, 64, d), dtype=np.float32)
                   for _ in range(3))
        want = jax_nn_ops.dot_product_attention.fn(
            *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
            scaled=True, causal=True)
        got = exec_op("dot_product_attention",
                      *(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                      scaled=True, causal=True)
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        unit = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= unit, (err, unit)

    def test_int_key_mask_as_bert_passes_it(self):
        """BERT hands the op its (B, 1, 1, T) int32 iterator mask: the
        port reads nonzero as attend (``.bool()``) and fills -1e9, as
        ``jnp.where`` on the int mask does."""
        r = np.random.RandomState(7)
        q, k, v = (r.randn(2, 3, 24, 16).astype(np.float32)
                   for _ in range(3))
        m = _key_mask(2, 24, seed=8).astype(np.int32)[:, None, None, :]
        want = jax_nn_ops.dot_product_attention.fn(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
            scaled=True)
        got = exec_op("dot_product_attention", _t(q), _t(k), _t(v), _t(m),
                      scaled=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        with pytest.raises(ValueError, match="requires dropout_rng"):
            exec_op("dot_product_attention", _t(q), _t(k), _t(v),
                    dropout_rate=0.1)


def _paged_inputs(seed=3):
    r = np.random.RandomState(seed)
    s_n, h, d, page, n_pages, max_pages = 4, 4, 16, 8, 12, 4
    q = r.randn(s_n, h, d).astype(np.float32)
    kp = r.randn(n_pages, page, h, d).astype(np.float32)
    vp = r.randn(n_pages, page, h, d).astype(np.float32)
    pt = np.stack([r.choice(n_pages, max_pages, replace=False)
                   for _ in range(s_n)]).astype(np.int32)
    # 1, a page boundary + 1, a partial page, the full row
    sl = np.array([1, 9, 25, 32], np.int32)
    return q, kp, vp, pt, sl


class TestPagedPlainParity:
    def test_vs_jax_generic_and_pallas_interpret(self):
        q, kp, vp, pt, sl = _paged_inputs()
        args = [jnp.asarray(a) for a in (q, kp, vp, pt, sl)]
        want_xla = np.asarray(jpa.paged_decode_attention_xla(*args))
        want_pl = np.asarray(jpa._paged_decode_call(*args, interpret=True))
        got = ca.paged_decode_attention_reference(
            *[_t(a) for a in (q, kp, vp, pt, sl)]).numpy()
        np.testing.assert_allclose(got, want_xla, **TOL)
        np.testing.assert_allclose(got, want_pl, **TOL)

    def test_registry_op_on_cpu(self, helper_mode):
        q, kp, vp, pt, sl = _paged_inputs(seed=8)
        ts = [_t(a) for a in (q, kp, vp, pt, sl)]
        before = ca.paged_decode_attention.launches
        got = exec_op("paged_decode_attention", *ts, scale=0.25)
        want = jpa.paged_decode_attention_xla(
            *[jnp.asarray(a) for a in (q, kp, vp, pt, sl)], scale=0.25)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert ca.paged_decode_attention.launches == before


def _split_inputs(page, d, dtype, seed, s_n=6, h=2, max_pages=4):
    """Seq_lens 0, 1, page - 1, page, page + 1 and a full row; a shuffled
    page table."""
    r = np.random.RandomState(seed)
    n_pages = s_n * max_pages
    q = r.randn(s_n, h, d).astype(np.float32)
    kp = r.randn(n_pages + 1, page, h, d).astype(np.float32)
    vp = r.randn(n_pages + 1, page, h, d).astype(np.float32)
    pt = r.permutation(n_pages).reshape(s_n, max_pages).astype(np.int32)
    sl = np.array([0, 1, page - 1, page, page + 1, max_pages * page],
                  np.int32)
    if dtype == torch.bfloat16:  # the bfloat16 values, in both packages
        q, kp, vp = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
            jnp.float32)) for a in (q, kp, vp))
    return q, kp, vp, pt, sl


# paged decode's split-KV plan, transcribed (testing/paged_check.py): the
# same float32 arithmetic as the reference in another order, 1e-5; in
# bfloat16 both round the float32 result once, so one unit in the last
# place (2^-7 relative) apart at most. The bfloat16 Pallas kernel also
# rounds P to bfloat16 before P·V (its `_mm_nn`): against it the bound adds
# 2^-7·(|P|·|V|) and one more unit of its own output's rounding
_SPLIT_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
              torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}


class TestPagedSplitKV:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", [32, 64, 128])
    @pytest.mark.parametrize("page", [8, 16, 32])
    def test_split_plan_vs_reference_and_pallas_interpret(self, page, d,
                                                          dtype):
        q, kp, vp, pt, sl = _split_inputs(page, d, dtype, page + d)
        tq, tk, tv = (_t(a).to(dtype) for a in (q, kp, vp))
        tpt, tsl = _t(pt), _t(sl)
        es = tq.element_size()
        live = sl > 0
        ref = ca.paged_decode_attention_reference(tq, tk, tv, tpt, tsl)
        # |P|·|V|: the reference's own weights over |V|
        abs_pv = ca.paged_decode_attention_reference(
            tq.float(), tk.float(), tv.float().abs(), tpt, tsl)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        want_pl = np.asarray(jpa._paged_decode_call(
            *[jnp.asarray(a, jdt) for a in (q, kp, vp)], jnp.asarray(pt),
            jnp.asarray(sl), interpret=True).astype(jnp.float32))
        # the card's plan (one page a split at this size) and coarser ones
        plans = [ca.paged_plan(6, 2, d, page, 4, es, 132)] + [
            dataclasses.replace(ca.paged_plan(6, 2, d, page, 4, es, 132),
                                pages_per_split=pps, splits=-(-4 // pps))
            for pps in (2, 3)]
        assert plans[0].pages_per_split == 1
        for plan in plans:
            got = pc.paged_decode_split(tq, tk, tv, tpt, tsl, plan=plan)
            assert got.dtype == dtype
            assert (got[~torch.from_numpy(live)] == 0).all()
            np.testing.assert_allclose(got.float()[live], ref.float()[live],
                                       **_SPLIT_TOL[dtype])
            if dtype == torch.float32:
                np.testing.assert_allclose(got.float()[live], want_pl[live],
                                           **_SPLIT_TOL[dtype])
            else:  # the Pallas kernel also rounds P to bfloat16 before P·V
                err = (got.float() - torch.from_numpy(want_pl)).abs()[live]
                lim = (1e-5 + 2.0 ** -6 * ref.float().abs()
                       + 2.0 ** -7 * abs_pv)[live]
                assert (err <= lim).all(), (err / lim).max().item()

    @pytest.mark.parametrize("fault", pc.FAULTS)
    def test_faulted_transcriptions_break_the_check(self, fault):
        q, kp, vp, pt, sl = _split_inputs(16, 64, torch.float32, 5)
        args = [_t(a) for a in (q, kp, vp, pt, sl)]
        plan = ca.paged_plan(6, 2, 64, 16, 4, 4, 132)
        ref = ca.paged_decode_attention_reference(*args)
        bad = pc.paged_decode_split(*args, plan=plan, fault=fault)
        live = sl > 0
        err = (bad - ref).abs()[live]
        lim = 1e-5 + 1e-5 * ref.abs()[live]
        assert (err / lim).max().item() > 100.0
        # only the multi-split slots move
        one_split = torch.from_numpy(sl <= 16)
        assert torch.equal(bad[one_split], pc.paged_decode_split(
            *args, plan=plan)[one_split])

    def test_splits_and_tiles_cover_every_position_once(self):
        for n in (0, 1, 15, 16, 17, 100, 1024):
            for page, pps, tile in ((16, 1, 16), (16, 2, 8), (8, 3, 8),
                                    (24, 2, 12)):
                seen = np.zeros(max(n, 1), np.int64)
                splits = pc.split_bounds(n, page, pps)
                assert len(splits) == max(1, -(-n // (page * pps)))
                for lo, hi in splits:
                    assert lo % page == 0  # splits start on pages
                    for groups in pc.tile_bounds(lo, hi, tile):
                        assert all(b - a <= 8 for a, b in groups)
                        for a, b in groups:
                            assert a // page == (b - 1) // page
                            seen[a:b] += 1
                assert (seen[:n] == 1).all()

    def test_reduce_scatter_leaves_lane_l_position_l_over_4(self):
        """csrc/paged_decode.cu's reduce_scatter8, shuffles transcribed:
        lane l ends with the warp's sum for position l // 4, as max8,
        sum8 and the P·V broadcast (from lane 4 i) read it."""
        part = np.random.RandomState(3).randn(32, 8)  # [lane, position]

        def shfl_xor(v, mask):
            return np.array([v[lane ^ mask] for lane in range(32)])

        lane = np.arange(32)
        b4, b3, b2 = (lane & 16) > 0, (lane & 8) > 0, (lane & 4) > 0
        r4 = [np.where(b4, part[:, k + 4], part[:, k]) + shfl_xor(
            np.where(b4, part[:, k], part[:, k + 4]), 16) for k in range(4)]
        r2 = [np.where(b3, r4[k + 2], r4[k]) + shfl_xor(
            np.where(b3, r4[k], r4[k + 2]), 8) for k in range(2)]
        r = np.where(b2, r2[1], r2[0]) + shfl_xor(np.where(b2, r2[0], r2[1]),
                                                  4)
        r = r + shfl_xor(r, 2)
        r = r + shfl_xor(r, 1)
        np.testing.assert_allclose(r, part.sum(axis=0)[lane // 4],
                                   rtol=1e-12)

    def test_plan_at_the_serving_shapes(self):
        # GPT-2 small: 12 heads × 64, page 16, 8 slots × 64 pages, 132 SMs
        f32 = ca.paged_plan(8, 12, 64, 16, 64, 4, 132)
        bf16 = ca.paged_plan(8, 12, 64, 16, 64, 2, 132)
        assert (f32.tile, f32.heads_per_block, f32.head_groups) == (8, 12, 1)
        assert (bf16.tile, bf16.heads_per_block) == (16, 12)  # whole pages
        for p in (f32, bf16):
            assert (p.pages_per_split, p.splits, p.stages) == (2, 32, 2)
        # H·D past one block's stages: the heads split over blocks
        big = ca.paged_plan(4, 32, 256, 16, 8, 4, 132)
        assert big.head_groups * big.heads_per_block >= 32
        assert big.heads_per_block < 32 and big.tile == 8
        for p in (f32, bf16, big):
            es = 4 if p is not bf16 else 2
            d = 256 if p is big else 64
            stage = 2 * p.tile * p.heads_per_block * d * es
            assert stage <= ca.PAGED_STAGE_BYTES
            assert p.stages * stage <= ca.PAGED_RING_BYTES
            assert 16 % p.tile == 0


class TestDispatch:
    def test_auto_on_cpu_takes_the_generic_impl(self, helper_mode):
        q, k, v = (_t(a) for a in _qkv(bh=2, t_q=8, t_k=8))
        desc = registry().get("dot_product_attention")
        helper_mode.helper_mode = "auto"
        assert desc.resolve(q, k, v, causal=True) is desc.fn
        helper_mode.helper_mode = "generic"
        assert desc.resolve(q, k, v, causal=True) is desc.fn

    @pytest.mark.parametrize("op", ["dot_product_attention",
                                    "paged_decode_attention"])
    def test_forced_kernel_on_cpu_raises(self, helper_mode, op):
        helper_mode.helper_mode = "kernel"
        q = torch.zeros(2, 8, 16)
        with pytest.raises(RuntimeError, match="no kernel is registered"):
            registry().get(op).resolve(q, q, q)

    def test_usable_gates(self, monkeypatch):
        """The gates' shape logic, with the device check stubbed (these
        tensors live on the CPU)."""
        monkeypatch.setattr(ca, "_on_cuda", lambda *ts: True)
        q4 = torch.zeros(1, 12, 32, 64)
        m4 = torch.ones(1, 1, 1, 32)
        assert ca.flash_usable(q4, q4, q4, m4, causal=True)
        # dropout runs in the kernels, as it does in the JAX gate's kernel
        assert ca.flash_usable(q4, q4, q4, m4, causal=True,
                               dropout_rate=0.1)
        short = torch.zeros(1, 12, 8, 64)
        assert not ca.flash_usable(short, q4, q4, m4, causal=True)
        assert ca.flash_usable(short, q4, q4, m4, causal=False)
        assert not ca.flash_usable(q4, q4, q4, torch.ones(1, 12, 32, 32))
        # every head dim the JAX gate takes (a multiple of 8) passes up to
        # the kernels' MAX_HEAD_DIM, D=128 included; the rest is refused
        for d in (8, 48, 128, 256):
            qd = torch.zeros(1, 12, 32, d)
            assert ca.flash_usable(qd, qd, qd), d
        odd = torch.zeros(1, 12, 32, 44)
        assert not ca.flash_usable(odd, odd, odd)
        # past MAX_HEAD_DIM the JAX kernel computes and these are not
        # built: the gate refuses, so the op runs its plain version
        for d in (264, 320, 512):
            qd = torch.zeros(1, 12, 32, d)
            assert not ca.flash_usable(qd, qd, qd), d
        # the kernel's other limit (dtype) is the wrapper's to refuse,
        # loudly: the gate does not hand it to the plain op
        assert ca.flash_usable(q4.double(), q4.double(), q4.double())
        q, kp = torch.zeros(8, 12, 64), torch.zeros(9, 16, 12, 64)
        pt, sl = (torch.zeros(8, 4, dtype=torch.int32),
                  torch.zeros(8, dtype=torch.int32))
        assert ca.paged_usable(q, kp, kp, pt, sl)
        assert ca.paged_usable(q, kp, kp, pt.long(), sl)
        assert not ca.paged_usable(q[None], kp, kp, pt, sl)
        for d in (8, 96, 128, 256):
            qd, kd = torch.zeros(8, 12, d), torch.zeros(9, 16, 12, d)
            assert ca.paged_usable(qd, kd, kd, pt, sl), d
        q44, k44 = torch.zeros(8, 12, 44), torch.zeros(9, 16, 12, 44)
        assert not ca.paged_usable(q44, k44, k44, pt, sl)
        q320, k320 = torch.zeros(8, 12, 320), torch.zeros(9, 16, 12, 320)
        assert not ca.paged_usable(q320, k320, k320, pt, sl)
        k12 = torch.zeros(9, 12, 12, 64)  # page size 12: not a multiple of 8
        assert not ca.paged_usable(q, k12, k12, pt, sl)

    def test_gates_decide_as_the_jax_gates(self, monkeypatch):
        """Over a grid of ranks, masks, causal flags, head dims and page
        sizes, each gate (device check stubbed) says what the JAX gate says
        with its TPU-measured thresholds taken out (``flash_min_t`` 0,
        ``min_pages`` at its default 1), with and without dropout."""
        from deeplearning4j_tpu.ops.registry import registry as jax_registry

        monkeypatch.setattr(ca, "_on_cuda", lambda *ts: True)
        monkeypatch.setattr(jpa, "flash_min_t", lambda: 0)
        jax_flash = jax_registry().get(
            "dot_product_attention").platform_usable["tpu"]
        jax_paged = jax_registry().get(
            "paged_decode_attention").platform_usable["tpu"]
        z = np.zeros
        masks = {"none": lambda b, h, t: None,
                 "key": lambda b, h, t: z((b, 1, 1, t), np.float32),
                 "full": lambda b, h, t: z((b, h, t, t), np.float32)}
        n = 0
        for d in (8, 44, 64, 128, 256):
            for t_q in (16, 32):
                for causal, rate in ((False, 0.0), (True, 0.0),
                                     (False, 0.1), (True, 0.1)):
                    for mname, mk in masks.items():
                        q = z((1, 2, t_q, d), np.float32)
                        kv = z((1, 2, 32, d), np.float32)
                        m = mk(1, 2, 32)
                        if mname == "full":
                            m = z((1, 2, t_q, 32), np.float32)
                        want = bool(jax_flash(q, kv, kv, m, causal=causal,
                                              dropout_rate=rate))
                        got = ca.flash_usable(
                            _t(q), _t(kv), _t(kv),
                            None if m is None else _t(m), causal=causal,
                            dropout_rate=rate)
                        assert got == want, (d, t_q, causal, rate, mname)
                        n += want
        for d in (8, 44, 64, 128):
            for page in (8, 12, 16):
                for q_rank in (2, 3):
                    q = z((8, 12, d)[3 - q_rank:], np.float32)
                    kp = z((9, page, 12, d), np.float32)
                    pt, sl = z((8, 4), np.int32), z((8,), np.int32)
                    want = bool(jax_paged(q, kp, kp, pt, sl))
                    got = ca.paged_usable(_t(q), _t(kp), _t(kp), _t(pt),
                                          _t(sl))
                    assert got == want, (d, page, q_rank)
                    n += want
        assert n > 0  # the grid has cases both gates take

    def test_gates_refuse_cpu_tensors(self):
        q4 = torch.zeros(1, 12, 32, 64)
        assert not ca.flash_usable(q4, q4, q4)

    def test_head_dim_past_the_kernels_runs_the_plain_op(self, monkeypatch):
        """D = 320 (a multiple of 8 past MAX_HEAD_DIM): the JAX package
        computes it, so the port's gates refuse it instead of handing the
        kernel wrappers a head dim they raise on; the op's plain version
        (run here, on the CPU) equals the JAX generic."""
        monkeypatch.setattr(ca, "_on_cuda", lambda *ts: True)
        d = 320
        assert d % 8 == 0 and d > ca.MAX_HEAD_DIM
        q, k, v = _qkv(bh=4, t_q=12, t_k=12, d=d, seed=5)
        q4, k4, v4 = (a.reshape(2, 2, 12, d) for a in (q, k, v))
        mask = np.ones((2, 1, 1, 12), np.float32)
        mask[1, ..., 7:] = 0.0
        assert not registry().get("dot_product_attention").platform_usable[
            "cuda"](_t(q4), _t(k4), _t(v4), _t(mask))
        qd, kd = torch.zeros(8, 12, d), torch.zeros(9, 16, 12, d)
        pt, sl = (torch.zeros(8, 4, dtype=torch.int32),
                  torch.zeros(8, dtype=torch.int32))
        assert not registry().get("paged_decode_attention").platform_usable[
            "cuda"](qd, kd, kd, pt, sl)
        got = exec_op("dot_product_attention", _t(q4), _t(k4), _t(v4),
                      _t(mask) > 0.5)
        want = jax_nn_ops.dot_product_attention.fn(
            jnp.asarray(q4), jnp.asarray(k4), jnp.asarray(v4),
            jnp.asarray(mask) > 0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
