"""GPT parity of the PyTorch port against the JAX package (CPU).

One numpy-made parameter tree at ``GptConfig.tiny()`` feeds both packages
(JAX arrays on one side, :func:`params_from_numpy` on the other). The
weights are drawn at std 2/sqrt(hidden) with random biases and LayerNorm
affines, so greedy generation does not collapse onto the last prompt token
and the token checks mean something.

Tolerances (float32): logits and K/V 1e-4 absolute/relative — two layers
of matmuls and LayerNorms summed in another order, on values of O(1-10).
Greedy tokens must match exactly: with these weights the top-2 logit gaps
are orders of magnitude wider than that error.
"""

import json
import zipfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.serving import GenerativeEngine as JaxEngine
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.serving import GenerativeEngine
from deeplearning4j_tpu_torch.testing.gpt_serving import drain

TOL = dict(rtol=1e-4, atol=1e-4)
CFG_J = jgpt.GptConfig.tiny()
CFG_T = tgpt.GptConfig.tiny()
PROMPTS = [np.array([3, 5, 7, 9], np.int32),
           np.array([11, 2], np.int32),
           np.array([42, 43, 44, 45, 46, 47], np.int32),
           np.array([8, 8, 8], np.int32),
           np.array([17, 23, 31], np.int32)]


def _numpy_params(cfg, seed=0):
    """The JAX pytree's structure, filled from numpy."""
    r = np.random.RandomState(seed)
    std = 2.0 / np.sqrt(cfg.hidden)

    def fill(path, shape):
        name = path[-1]
        if name == "ln_gamma":
            return (1.0 + 0.1 * r.randn(*shape)).astype(np.float32)
        if name.startswith("b") or name == "ln_beta":
            return (0.1 * r.randn(*shape)).astype(np.float32)
        return (std * r.randn(*shape)).astype(np.float32)

    shapes = tgpt.param_shapes(cfg)
    made = {p: fill(p, s) for p, s in tgpt._leaf_paths(shapes)}
    return tgpt._rebuild(shapes, made)


NP_PARAMS = _numpy_params(CFG_T)
JAX_PARAMS = jax.tree.map(jnp.asarray, NP_PARAMS)
PORT_PARAMS = tgpt.params_from_numpy(NP_PARAMS, device="cpu")


def _port_model():
    return tgpt.GptModel(CFG_T, params=PORT_PARAMS, device="cpu")


def test_config_round_trip_matches_jax():
    assert tgpt.GptConfig.base().to_json() == jgpt.GptConfig.base().to_json()
    assert (tgpt.GptConfig.from_json(CFG_J.to_json()) == CFG_T)


def test_prefill_logits_and_kv():
    r = np.random.RandomState(1)
    ids = r.randint(0, CFG_T.vocab_size, (2, 20)).astype(np.int32)
    mask = np.ones((2, 20), np.int32)
    mask[1, 13:] = 0  # end padding
    want_l, want_kv = jgpt.gpt_prefill(JAX_PARAMS, jnp.asarray(ids), CFG_J,
                                       mask=jnp.asarray(mask))
    with torch.no_grad():
        got_l, got_kv = tgpt.gpt_prefill(PORT_PARAMS, torch.from_numpy(ids),
                                         CFG_T, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    np.testing.assert_allclose(got_kv.numpy(), np.asarray(want_kv), **TOL)


def test_decode_step_logits_and_cache():
    r = np.random.RandomState(2)
    h, dh = CFG_T.heads, CFG_T.hidden // CFG_T.heads
    s_n, page, n_pages, max_pages = 3, 8, 10, 3
    kv = r.randn(CFG_T.layers, 2, n_pages + 1, page, h, dh).astype(np.float32)
    pt = np.stack([r.choice(n_pages, max_pages, replace=False)
                   for _ in range(s_n)]).astype(np.int32)
    seq_lens = np.array([5, 16, 0], np.int32)      # slot 2 inactive
    tokens = np.array([7, 200, 0], np.int32)
    active = seq_lens > 0
    write_page = np.where(active, pt[np.arange(s_n), seq_lens // page],
                          n_pages).astype(np.int32)
    write_off = (seq_lens % page).astype(np.int32)
    incl = (seq_lens + active).astype(np.int32)
    args = (tokens, seq_lens, pt, incl, write_page, write_off)
    want_kv, want_l = jgpt.gpt_decode_step(
        JAX_PARAMS, jnp.asarray(kv), *[jnp.asarray(a) for a in args], CFG_J)
    got_kv = torch.from_numpy(kv.copy())
    with torch.no_grad():
        out_kv, got_l = tgpt.gpt_decode_step(
            PORT_PARAMS, got_kv, *[torch.from_numpy(a) for a in args], CFG_T)
    assert out_kv is got_kv  # updated in place
    live = [0, 1]  # the inactive slot attends over nothing: unspecified
    np.testing.assert_allclose(got_l.numpy()[live],
                               np.asarray(want_l)[live], **TOL)
    np.testing.assert_allclose(got_kv.numpy(), np.asarray(want_kv), **TOL)


def test_greedy_matches_jax_reference_generate():
    # one prompt: the JAX oracle runs eagerly, ~1 s per generated token
    want = jgpt.reference_generate(JAX_PARAMS, CFG_J, PROMPTS[2], 5)
    got = tgpt.reference_generate(PORT_PARAMS, CFG_T, PROMPTS[2], 5)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 1  # the check is not degenerate


@pytest.mark.parametrize("budgets", [None, [3, 8, 2, 6, 4]])
def test_engine_greedy_matches_jax_engine_midflight(budgets):
    """5 requests through 2 slots: ``generate`` with one budget (slots
    turn over as pairs finish), and per-request budgets through
    ``submit`` (slots turn over one at a time while the other decodes).
    Every token agrees with the JAX engine's."""
    kw = dict(max_slots=2, page_size=8, max_pages_per_seq=6, max_prompt=16,
              seed=3)
    jeng = JaxEngine(jgpt.GptModel(CFG_J, params=JAX_PARAMS), **kw)
    eng = GenerativeEngine(_port_model(), device="cpu", **kw)
    if budgets is None:
        wants = jeng.generate(PROMPTS, max_new_tokens=6, eos_token=-1)
        gots = eng.generate(PROMPTS, max_new_tokens=6, eos_token=-1)
    else:
        results = []
        for e in (jeng, eng):
            futs = [e.submit(p, max_new_tokens=b, eos_token=-1)
                    for p, b in zip(PROMPTS, budgets)]
            drain(e)
            results.append([f.result(timeout=0) for f in futs])
        wants, gots = results
    for want, got in zip(wants, gots):
        assert got.finish_reason == want.finish_reason == "length"
        np.testing.assert_array_equal(got.tokens, want.tokens)
    eng.check_invariants()
    assert eng.cache.free_pages == eng.cache.num_pages


def test_restore_jax_zip(tmp_path):
    """A zip written by the JAX save_gpt restores into the port with the
    same logits; and the port's zip restores into JAX."""
    path = str(tmp_path / "gpt.zip")
    jmodel = jgpt.GptModel(CFG_J, params=JAX_PARAMS)
    jgpt.save_gpt(jmodel, path)
    with zipfile.ZipFile(path) as z:
        assert json.loads(z.read("meta.json"))["dtype"] == "float32"
    model = tgpt.restore_gpt(path, device="cpu")
    assert model.cfg == CFG_T
    ids = np.array([[1, 2, 3, 4, 250]], np.int32)
    want = jmodel.logits(ids)
    np.testing.assert_allclose(model.logits(ids), want, **TOL)
    back = str(tmp_path / "port.zip")
    tgpt.save_gpt(model, back)
    np.testing.assert_allclose(jgpt.restore_gpt(back).logits(ids), want,
                               **TOL)


def test_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    """The default device is CUDA: without a GPU the entry points raise
    instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tgpt.GptModel(CFG_T)
    path = str(tmp_path / "gpt.zip")
    tgpt.save_gpt(_port_model(), path)
    with pytest.raises(RuntimeError, match="is_available"):
        tgpt.restore_gpt(path)
    with pytest.raises(RuntimeError, match="is_available"):
        GenerativeEngine(_port_model())



def test_bfloat16_logits_come_back_bfloat16():
    """``GptModel`` with bfloat16 parameters returns ``ml_dtypes.bfloat16``
    numpy logits, as the JAX package's ``logits`` does: the port's own
    bfloat16 logits bit for bit (the host copy is exact). Two layers of
    bfloat16 rounding in another order put them more than one bfloat16
    unit (2^-7 of the largest JAX logit) from the JAX logits: 2.95 units
    measured, where the JAX bfloat16 logits are 3.73 units from its own
    float32 logits of the same weights. They are held to 3.5 units."""
    jm = jgpt.GptModel(CFG_J, params=jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), NP_PARAMS))
    tm = tgpt.GptModel(CFG_T, params=tgpt.params_from_numpy(
        NP_PARAMS, device="cpu", dtype=torch.bfloat16), device="cpu")
    ids = np.stack([PROMPTS[0], PROMPTS[0][::-1]])
    want = np.asarray(jm.logits(ids))
    got = tm.logits(ids)
    assert str(want.dtype) == str(got.dtype) == "bfloat16"
    assert got.shape == want.shape
    own, _ = tgpt.gpt_prefill(tm.params, torch.as_tensor(ids), CFG_T)
    np.testing.assert_array_equal(got.view(np.int16),
                                  own.view(torch.int16).numpy())
    want32 = want.astype(np.float32)
    unit = 2.0 ** -7 * np.abs(want32).max()
    assert np.abs(got.astype(np.float32) - want32).max() <= 3.5 * unit
