"""Compiled execution (``ops/capture.py``): CUDA-graph capture units.

On the CPU (no card) the units run eagerly, and the tests hold what the
captured path rests on without one: the eager run per call, the
process-wide ``disable_capture()``, the static-buffer loads (an unchanged
tensor is not copied again; an in-place change or another tensor is), the
derived-buffer refresh of ``cuda_matmul.kmajor_weight`` (a changed weight
is remade into the same buffer; a faulted variant that skips the refresh
leaves a stale copy, which the check catches), the launch counters the
replays account for, the paged-decode counters kept at their address, the
capture's dispatch tally, the host-copy-free ops a capture runs, and the
serving engine with captures disabled.

The tests marked ``cuda`` run on the card and skip here (the decision is
taken in the ``cuda`` fixture, never at import)::

    python -m pytest -m cuda tests/test_torch_capture.py

They hold captured against eager bit for bit — a decode step's logits and
tokens, an imported BERT's ``sd.output`` — with replays adding their
launches to the counters, a weight changed in place after a capture seen by
the next replay (and a faulted variant that skips the refresh caught), two
replays of a sampled step drawing different tokens, and the serving ledger
across admissions.
"""

import threading

import numpy as np
import pytest

import torch

from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.autodiff.samediff import GRAPH_OPS
from deeplearning4j_tpu_torch.models.gpt import (
    GptConfig, GptModel, init_gpt_params)
from deeplearning4j_tpu_torch.ops import capture
from deeplearning4j_tpu_torch.ops import cuda_attention as ca
from deeplearning4j_tpu_torch.ops import cuda_convbn as cc
from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl
from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
from deeplearning4j_tpu_torch.ops import cuda_updater as cu
from deeplearning4j_tpu_torch.ops.capture import (
    CapturedUnit, _Derived, _Static, capture_enabled, disable_capture)
from deeplearning4j_tpu_torch.ops.registry import exec_op
from deeplearning4j_tpu_torch.serving import GenerativeEngine

PROMPTS = [np.array([3, 5, 7, 9], np.int32),
           np.array([11, 2], np.int32),
           np.array([42, 43, 44, 45, 46, 47], np.int32),
           np.array([8, 8, 8], np.int32),
           np.array([17, 23, 31], np.int32)]


# ------------------------------------------------------------------- CPU


def test_cpu_unit_runs_eagerly_every_call():
    calls = []

    def fn(x, y):
        calls.append(1)
        return x + y, x * y

    unit = CapturedUnit(fn, device="cpu")
    assert not unit.captured()
    x, y = torch.arange(4.0), torch.full((4,), 2.0)
    for _ in range(3):
        s, p = unit(x, y)
        torch.testing.assert_close(s, x + y)
        torch.testing.assert_close(p, x * y)
    assert len(calls) == 3 and unit.captures == 0


def test_disable_capture_is_process_wide_and_nests():
    assert capture_enabled()
    seen = []
    with disable_capture():
        with disable_capture():
            assert not capture_enabled()
        assert not capture_enabled()
        t = threading.Thread(target=lambda: seen.append(capture_enabled()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen == [False]  # the engine's worker thread sees it too
    assert capture_enabled()


@pytest.mark.parametrize("case", ["same", "inplace", "other", "buffer",
                                  "buffer_changed", "inference"])
def test_static_load_copies_only_what_changed(case):
    buf = torch.zeros(3)
    st = _Static(buf)
    src = torch.tensor([1.0, 2.0, 3.0])
    assert st.load(src) and torch.equal(buf, src)
    if case == "same":  # the tensor loaded last time, unchanged: no copy
        assert not st.load(src)
    elif case == "inplace":
        src.mul_(2)
        assert st.load(src) and torch.equal(buf, src)
    elif case == "other":
        other = torch.tensor([7.0, 8.0, 9.0])
        assert st.load(other) and torch.equal(buf, other)
    elif case == "buffer":  # the buffer itself is never copied onto itself
        assert not st.load(buf)
    elif case == "buffer_changed":  # someone wrote the buffer: reload
        buf.zero_()
        assert st.load(src) and torch.equal(buf, src)
    else:  # an inference tensor keeps no version: always copied
        with torch.inference_mode():
            inf = torch.tensor([4.0, 5.0, 6.0])
        assert st.load(inf) and st.load(inf)
        assert torch.equal(buf, inf)


def _recorded_kmajor(w):
    """``kmajor_weight(w)`` as a capture's warm-up calls it: returns the
    copy and the derived buffer the capture registered."""
    capture._RECORDING.derived = derived = {}
    try:
        wt = cm.kmajor_weight(w)
    finally:
        capture._RECORDING.derived = None
    (d,) = derived.values()
    return wt, d


@pytest.mark.parametrize("refresh", [True, False],
                         ids=["refresh", "faulted_no_refresh"])
def test_kmajor_copy_remade_in_the_same_buffer(refresh):
    """A K-major copy a captured graph reads is remade in place after an
    in-place change of its weight; a faulted variant that skips the
    refresh keeps the stale copy, which this check catches."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (6, 5)).astype(np.float32))
    wt, d = _recorded_kmajor(w)
    assert d.buffer is wt and d.source is w
    torch.testing.assert_close(wt, w.t())
    ptr, copies = wt.data_ptr(), cm.kmajor_weight.copies
    assert not d.refresh()  # nothing changed: no copy
    w.mul_(3.0)  # sd.fit-style in-place change
    if refresh:
        assert d.refresh()
    fresh = torch.equal(wt, w.t())
    assert fresh is refresh
    if not refresh:
        return
    assert wt.data_ptr() == ptr  # the graph's address
    assert cm.kmajor_weight.copies == copies + 1
    assert not d.refresh()
    # an eager call after the refresh shares the remade copy
    assert cm.kmajor_weight(w) is wt
    assert cm.kmajor_weight.copies == copies + 1


def test_kmajor_not_noted_outside_a_capture():
    w = torch.ones(4, 3)
    assert getattr(capture._RECORDING, "derived", None) is None
    cm.kmajor_weight(w)  # no capture underway: nothing to register


def test_derived_refresh_follows_source_version():
    src, buf = torch.ones(4), torch.zeros(4)
    made = []
    d = _Derived(src, buf, lambda s, b: (made.append(1), b.copy_(s * 2)))
    assert not d.refresh()
    src.add_(1)
    assert d.refresh() and torch.equal(buf, torch.full((4,), 4.0))
    assert not d.refresh() and made == [1]


def test_counter_cells_cover_every_launch_counter():
    cells = set(capture._counter_cells())
    for w, attr in ca.KERNELS.values():
        assert (w, attr) in cells
    for w in cq.KERNELS.values():
        assert (w, "launches") in cells
    for cell in [(cm.fused_matmul, "launches"),
                 (cm.fused_matmul, "sm90_launches"),
                 (cm.fused_matmul, "sm90_f32_launches"),
                 (cm.kmajor_weight, "copies"),
                 (cq.int8_matmul, "sm90_launches"),
                 (cl.fused_layer_norm_kernel, "launches"),
                 (cc.bn_matmul_stats, "launches"),
                 (cc.bn_matmul_stats, "sm90_launches"),
                 (cu.fused_updater, "launches"),
                 (cu.fused_updater, "leaves")]:
        assert cell in cells
    assert len(cells) == len(capture._counter_cells())  # no duplicates


def test_dispatch_inside_a_capture_is_tallied_not_counted():
    observe.reset()
    q = torch.zeros(1, 4, 8)
    kw = dict(scale=1.0)
    tally = {}
    capture._RECORDING.dispatch = tally
    try:
        exec_op("paged_decode_attention", q, torch.zeros(2, 8, 4, 8),
                torch.zeros(2, 8, 4, 8), torch.zeros(1, 1, dtype=torch.int32),
                torch.ones(1, dtype=torch.int32), **kw)
    finally:
        capture._RECORDING.dispatch = None
    assert tally == {("paged_decode_attention", "generic", "no_helper"): 1}
    m = observe.metrics()
    assert m.family_total("dl4j_tpu_helper_dispatch_total") == 0
    exec_op("paged_decode_attention", q, torch.zeros(2, 8, 4, 8),
            torch.zeros(2, 8, 4, 8), torch.zeros(1, 1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), **kw)
    assert m.family_total("dl4j_tpu_helper_dispatch_total") == 1


def test_paged_counters_keep_an_outgrown_buffer():
    dev = torch.device("cpu")
    ca._PAGED_COUNTERS.pop(dev, None)
    first = ca._paged_counters(dev, 10)
    assert first.numel() == 1024 and ca._paged_counters(dev, 1024) is first
    n_kept = len(ca._PAGED_OUTGROWN)
    bigger = ca._paged_counters(dev, 5000)
    assert bigger.numel() == 5000 and bigger is not first
    assert ca._PAGED_OUTGROWN[-1] is first  # never freed: graphs address it
    assert len(ca._PAGED_OUTGROWN) == n_kept + 1
    ca._PAGED_COUNTERS.pop(dev, None)
    ca._PAGED_OUTGROWN.remove(first)


def test_captured_ops_make_no_host_copies():
    """The graph ops that once built a device tensor from host data —
    ``size`` and a negative-step ``strided_slice`` — give numpy's
    results."""
    a = torch.arange(24.0).reshape(4, 6)
    size = GRAPH_OPS["size"](a)
    assert size.dtype == torch.int32 and size.ndim == 0 and int(size) == 24
    for begin, end, strides in [([3, 5], [0, 0], [-1, -2]),
                                ([0, 5], [4, -7], [1, -1]),
                                ([2, 0], [2, 6], [-1, 1])]:
        got = GRAPH_OPS["strided_slice"](a, begin=begin, end=end,
                                         strides=strides)
        want = a.numpy()[tuple(slice(b, e, s)
                               for b, e, s in zip(begin, end, strides))]
        np.testing.assert_array_equal(got.numpy(), want)


def test_engine_with_captures_disabled_serves_the_same_tokens():
    cfg = GptConfig.tiny()
    model = GptModel(cfg, device="cpu", params=init_gpt_params(
        cfg, seed=2, device="cpu", std=2.0 / np.sqrt(cfg.hidden)))
    kw = dict(max_slots=2, page_size=8, max_pages_per_seq=6, max_prompt=16,
              device="cpu")
    a = GenerativeEngine(model, **kw).generate(PROMPTS, max_new_tokens=5,
                                               eos_token=-1)
    with disable_capture():
        b = GenerativeEngine(model, **kw).generate(
            PROMPTS, max_new_tokens=5, eos_token=-1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)


def test_engine_stages_host_state_in_one_buffer():
    """The decode step's inputs cross in one copy: the page table,
    lengths, fed tokens, active flags, top-k, temperatures and top-p of
    every slot sit in one int32 buffer at their views."""
    cfg = GptConfig.tiny()
    model = GptModel(cfg, device="cpu", params=init_gpt_params(
        cfg, seed=2, device="cpu"))
    eng = GenerativeEngine(model, max_slots=3, page_size=8,
                           max_pages_per_seq=4, max_prompt=16, device="cpu")
    d = eng._dec
    base = eng._dec_dev.data_ptr()
    assert d["page_table"].shape == (3, 4)
    assert all(v.untyped_storage().data_ptr() == base for v in d.values())
    assert d["temp"].dtype == d["top_p"].dtype == torch.float32
    assert eng._dec_dev.numel() == 3 * 4 + 6 * 3
    a = eng._adm
    assert a["ids"].shape == (1, 16) and a["pt_row"].shape == (4,)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA-graph capture has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _gpt(dev, **kw):
    cfg = GptConfig.tiny(**kw)
    return GptModel(cfg, device=dev, params=init_gpt_params(
        cfg, seed=2, device=dev, std=2.0 / np.sqrt(cfg.hidden)))


_ENGINE = dict(max_slots=2, page_size=8, max_pages_per_seq=6, max_prompt=16)


@pytest.mark.cuda
def test_decode_captured_bit_equal_eager_and_counted(cuda):
    model = _gpt(cuda)
    eng = GenerativeEngine(model, device=cuda, **_ENGINE)
    for p in PROMPTS[:2]:
        eng.submit(p, max_new_tokens=8, eos_token=-1)
    eng.step()  # admits both and captures the decode step
    assert eng._decode_fn.captures == 1
    ca.reset_launch_counts()
    toks_c, logits_c = (t.clone() for t in eng._decode_fn())
    assert ca.launch_counts()["paged_decode"] == model.cfg.layers
    with disable_capture():
        toks_e, logits_e = eng._decode_fn()
    assert ca.launch_counts()["paged_decode"] == 2 * model.cfg.layers
    assert torch.equal(logits_c, logits_e)
    assert torch.equal(toks_c, toks_e)
    assert eng._decode_fn.captures == 1


@pytest.mark.cuda
def test_serving_captured_matches_eager_and_the_ledger(cuda):
    model = _gpt(cuda)
    observe.reset()
    ca.reset_launch_counts()
    eng = GenerativeEngine(model, device=cuda, **_ENGINE)
    got = eng.generate(PROMPTS, max_new_tokens=6, eos_token=-1)
    steps = observe.metrics().histogram(
        "dl4j_tpu_serving_decode_step_seconds").count
    assert ca.launch_counts()["paged_decode"] == model.cfg.layers * steps
    assert ca.launch_counts()["flash_attn_fwd"] == (model.cfg.layers
                                                    * len(PROMPTS))
    by_key = {}
    for ev in observe.ledger().events():
        by_key.setdefault(ev.key, []).append(ev.cause)
    assert by_key == {k: ["first_compile"]
                      for k in ("prefill", "write_prompt", "decode")}
    assert (eng._prefill_fn.captures, eng._write_fn.captures,
            eng._decode_fn.captures) == (1, 1, 1)
    with disable_capture():
        want = GenerativeEngine(model, device=cuda, **_ENGINE).generate(
            PROMPTS, max_new_tokens=6, eos_token=-1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


@pytest.mark.cuda
def test_sampled_replays_draw_new_tokens(cuda):
    model = _gpt(cuda)
    eng = GenerativeEngine(model, device=cuda, seed=5, **_ENGINE)
    eng.submit(PROMPTS[0], max_new_tokens=8, temperature=1.5)
    eng.step()
    d = eng._dec
    d["active"].fill_(1)
    d["temp"].fill_(2.0)
    draws = [eng._decode_fn()[0].clone() for _ in range(6)]
    assert len({tuple(t.tolist()) for t in draws}) > 1
    d["temp"].fill_(0.0)  # greedy slots: the same token every replay
    greedy = [eng._decode_fn()[0].clone() for _ in range(3)]
    assert all(torch.equal(greedy[0], g) for g in greedy)


def _small_bert(dev, layers=2):
    from deeplearning4j_tpu_torch.imports import import_onnx
    from deeplearning4j_tpu_torch.testing.onnx_builder import (
        bert_onnx_feeds, bert_onnx_model)

    sd = import_onnx(bert_onnx_model(layers=layers, batch=2, seq=64, d=256,
                                     heads=4, ff=512, vocab=100), device=dev)
    return sd, bert_onnx_feeds(2, 64, 100)


@pytest.mark.cuda
def test_sd_output_captured_bit_equal_eager_and_counted(cuda):
    layers = 2
    sd, feeds = _small_bert(cuda, layers)
    observe.reset()
    first = sd.output(feeds, ["y"])["y"]  # warm-up + capture
    st = sd.last_compile_stats
    assert st.trace_seconds is not None and st.compile_seconds is not None
    ca.reset_launch_counts()
    mm0 = cm.fused_matmul.launches
    got = sd.output(feeds, ["y"])["y"]  # a replay
    assert cm.fused_matmul.launches - mm0 == 6 * layers
    assert ca.launch_counts()["flash_attn_fwd"] == layers
    disp = observe.metrics().counter(
        "dl4j_tpu_helper_dispatch_total", op="fused_matmul_bias_act",
        impl="cuda", reason="usable").value
    assert disp == 2 * 6 * layers  # the warm-up and one replay
    with disable_capture():
        want = sd.output(feeds, ["y"])["y"]
    assert np.array_equal(got, want) and np.array_equal(first, want)
    causes = [e.cause for e in observe.ledger().events()]
    assert causes == ["first_compile"]


@pytest.mark.cuda
@pytest.mark.parametrize("refresh", [True, False],
                         ids=["refresh", "faulted_no_refresh"])
def test_weight_changed_in_place_is_seen_by_the_next_replay(cuda, refresh,
                                                            monkeypatch):
    """A weight changed in place after the capture moves the captured
    graph's static copy of it and its K-major split copy: the next replay
    equals the eager run on the new weight. A faulted variant that skips
    the derived-buffer refresh must fail that check."""
    sd, feeds = _small_bert(cuda)
    sd.output(feeds, ["y"])
    before = sd.output(feeds, ["y"])["y"]
    if not refresh:
        monkeypatch.setattr(_Derived, "refresh", lambda self: False)
    with torch.no_grad():
        sd._arrays["l0_w1"].mul_(1.5)
    got = sd.output(feeds, ["y"])["y"]
    with disable_capture():
        want = sd.output(feeds, ["y"])["y"]
    assert not np.array_equal(want, before)
    assert np.array_equal(got, want) is refresh


@pytest.mark.cuda
def test_new_batch_captures_again_and_a_rename_drops_the_graphs(cuda):
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff

    r = np.random.default_rng(0)
    sd = SameDiff(device=cuda)
    x = sd.placeholder("x", (None, 64))
    w = sd.var("w", (0.1 * r.standard_normal((64, 32))).astype(np.float32))
    sd.math.tanh(x @ w).rename("out")
    observe.reset()
    feeds = [{"x": r.standard_normal((n, 64)).astype(np.float32)}
             for n in (8, 3)]
    for f in feeds:
        sd.output(f, ["out"])
    fn = sd._jit_cache[("compiled", ("out",), True, sd._effective_passes())]
    assert fn.unit.captures == 2 and fn.unit.pool_bytes > 0
    replayed = sd.output(feeds[0], ["out"])["out"]
    with disable_capture():
        want = sd.output(feeds[0], ["out"])["out"]
    assert np.array_equal(replayed, want) and fn.unit.captures == 2
    sd._rename("w", "w_renamed")
    assert not fn.unit._graphs and fn.unit.pool_bytes == 0
    sd.output(feeds[0], ["out"])
    assert [e.cause for e in observe.ledger().events()] == [
        "first_compile", "new_shape", "graph_mutation"]
