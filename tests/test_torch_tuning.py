"""Measured dispatch of the port (``ops/tuning.py``) and
``observe.summary()`` against the JAX package (CPU).

* the table: serde, deep merge, schema refusal, a corrupt measured table
  falling back to the checked-in ones with one warning a path, the
  bucket entry over the op-level one, ``tuned_block``'s divisibility
  fallback (the JAX ``tests/test_tuning.py`` classes ``TestTableSerde``
  and ``TestBuckets``); bucket labels equal to the JAX package's; a table
  either package wrote loads in the other;
* the checked-in tables: ``default.json`` holds no TPU figure (every
  crossover 0, no blocks), the card's table names the card and its power
  limit and covers every tuned op;
* each of the seven gates reads its key: with a crossover set in a
  sandboxed table the gate returns ``CROSSOVER`` below it and passes at
  it, and the registry counts the two decisions (``crossover`` /
  ``usable``; ``forced_kernel`` under ``helper_mode="kernel"``). The
  gates accept CUDA tensors only: the tests make the gates and the
  registry see the CPU tensors as the card's (``cuda_view``) and only
  resolve, never call the kernels; the convbn kernel reads its
  ``block_n`` through ``convbn_block_n``;
* ``autotune(smoke=True, device="cpu")`` runs every tuner's code path and
  writes a table that is live in the same process;
* ``dispatch_summary()`` and ``summary()`` give the JAX package's
  sections and values after the same metric events.
"""

import importlib
import json
import logging
import os

import pytest
import torch

import deeplearning4j_tpu.ops  # noqa: F401 - registers the JAX catalog
from deeplearning4j_tpu import observe as jobserve
from deeplearning4j_tpu.ops import tuning as jtuning
from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.environment import environment
from deeplearning4j_tpu_torch.ops import cuda_attention as ca
from deeplearning4j_tpu_torch.ops import cuda_convbn as cc
from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl
from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
from deeplearning4j_tpu_torch.ops import cuda_updater as cu
from deeplearning4j_tpu_torch.ops import tuning
from deeplearning4j_tpu_torch.ops.registry import registry

registry_mod = importlib.import_module("deeplearning4j_tpu_torch.ops.registry")
TABLE_DIR = os.path.join(os.path.dirname(tuning.__file__), "tuning_tables")
CARD_TABLE = os.path.join(TABLE_DIR, "nvidia_h100_80gb_hbm3.json")


@pytest.fixture
def tuning_sandbox(tmp_path, monkeypatch):
    """The measured-table directory is a per-test one; memoized tables are
    dropped before and after, so no table leaks into another test."""
    monkeypatch.setenv(tuning.ENV_DIR, str(tmp_path))
    tuning.reset_tables()
    yield tmp_path
    monkeypatch.undo()
    tuning.reset_tables()


@pytest.fixture
def cuda_view(monkeypatch):
    """The gates and the registry take these CPU tensors for the card's."""
    for mod in (ca, cm, cl, cq, cu, cc):
        monkeypatch.setattr(mod, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(registry_mod, "tensor_platform",
                        lambda *a, **k: "cuda")


def _write_table(tmp_path, entries, kind="cpu"):
    t = tuning.TuningTable(device_kind=kind, entries=entries)
    t.save(os.path.join(str(tmp_path), f"{kind}.json"))
    tuning.reset_tables()
    return t


def _dispatch_delta(fn):
    before = observe.dispatch_summary()
    out = fn()
    after = observe.dispatch_summary()
    return out, {k: after.get(k, 0) - before.get(k, 0)
                 for k in after if after.get(k, 0) != before.get(k, 0)}


# ------------------------------------------------------------- the table


class TestTableSerde:
    def test_round_trip(self, tmp_path):
        t = tuning.TuningTable(device_kind="cpu",
                               measured_on={"nvidia_smi": "card, 700.00 W"})
        t.set("dot_product_attention", "flash_min_t", 256)
        t.set_block("matmul_int8", "m256_k512_n512", "block_m", 128)
        path = t.save(str(tmp_path / "cpu.json"))
        assert not os.path.exists(path + ".tmp")  # written, then renamed
        back = tuning.TuningTable.load(path)
        assert back.device_kind == "cpu" and back.source == path
        assert back.get("dot_product_attention", "flash_min_t") == 256
        assert back.get_block("matmul_int8", "m256_k512_n512",
                              "block_m") == 128
        assert back.measured_on == t.measured_on
        assert back.to_dict() == t.to_dict()

    def test_merge_deep(self):
        a = tuning.TuningTable("cpu", {
            "op": {"thresh": 1, "blocks": {"t64": {"block_q": 8}}}})
        b = tuning.TuningTable("cpu", {
            "op": {"thresh": 2, "blocks": {"t64": {"block_k": 16},
                                           "t128": {"block_q": 32}}}})
        a.merge(b)
        assert a.get("op", "thresh") == 2  # other wins
        assert a.get_block("op", "t64", "block_q") == 8   # preserved
        assert a.get_block("op", "t64", "block_k") == 16  # merged in
        assert a.get_block("op", "t128", "block_q") == 32

    def test_rejects_wrong_schema(self, tmp_path):
        p = tmp_path / "bad.json"
        p.write_text(json.dumps({"schema": "nope", "entries": {}}))
        with pytest.raises(ValueError):
            tuning.TuningTable.load(str(p))

    def test_corrupt_cache_falls_back_and_warns_once(self, tuning_sandbox,
                                                     caplog):
        bad = tuning_sandbox / "cpu.json"
        for text in ("{not json", json.dumps({"schema": "v0",
                                              "entries": {}}),
                     json.dumps({"schema": tuning.SCHEMA,
                                 "entries": {"x": 3}})):
            bad.write_text(text)
            tuning.reset_tables()
            with caplog.at_level(logging.WARNING, logger=tuning.__name__):
                caplog.clear()
                for _ in range(2):
                    tuning._ACTIVE.clear()  # re-read the files, keep warned
                    assert tuning.active_table("cpu").get(
                        "dot_product_attention", "flash_min_t") == 0
            warned = [r for r in caplog.records
                      if "corrupt tuning table" in r.getMessage()]
            assert len(warned) == 1

    def test_malformed_blocks_falls_back_not_crashes(self, tuning_sandbox):
        for entries in ({"fused_layer_norm": {"blocks": None}},
                        {"op": {"blocks": {"t64": 512}}}):
            (tuning_sandbox / "cpu.json").write_text(json.dumps({
                "schema": tuning.SCHEMA, "device_kind": "cpu",
                "entries": entries}))
            tuning.reset_tables()
            assert tuning.tuned("fused_layer_norm", "min_rows") == 0

    def test_cache_overlays_default(self, tuning_sandbox):
        _write_table(tuning_sandbox,
                     {"dot_product_attention": {"flash_min_t": 99}})
        assert tuning.tuned("dot_product_attention", "flash_min_t") == 99
        assert tuning.tuned("fused_updater_step", "min_size") == 0

    def test_bucket_beats_op_level(self, tuning_sandbox):
        _write_table(tuning_sandbox, {"op": {
            "block_q": 1, "blocks": {"t64": {"block_q": 7}}}})
        assert tuning.tuned("op", "block_q", bucket="t64") == 7
        assert tuning.tuned("op", "block_q", bucket="t128") == 1
        assert tuning.tuned("op", "missing", 5, bucket="t64") == 5


class TestBuckets:
    def test_pow2(self):
        assert [tuning.pow2_bucket(n) for n in (1, 2, 3, 63, 64, 65)] == \
            [1, 2, 4, 64, 64, 128]

    def test_labels_equal_the_jax_packages(self):
        for n in (0, 1, 2, 3, 7, 8, 9, 100, 4096, 4097, 25088):
            assert tuning.pow2_bucket(n) == jtuning.pow2_bucket(n)
            assert tuning.bucket_t(n) == jtuning.bucket_t(n)
            assert tuning.bucket_rows(n) == jtuning.bucket_rows(n)
        for m, k, n in ((100, 512, 513), (4096, 768, 3072), (1, 1, 1),
                        (6272, 2048, 512)):
            assert tuning.bucket_mkn(m, k, n) == jtuning.bucket_mkn(m, k, n)
        assert tuning.bucket_mkn(100, 512, 513) == "m128_k512_n1024"
        assert tuning.normalize_device_kind("NVIDIA H100 80GB HBM3") == \
            jtuning.normalize_device_kind("NVIDIA H100 80GB HBM3") == \
            "nvidia_h100_80gb_hbm3"

    def test_tuned_block_divisibility_fallback(self, tuning_sandbox):
        _write_table(tuning_sandbox, {"op": {
            "blocks": {"t64": {"block_q": 48}}}})
        assert tuning.tuned_block("op", "block_q", 64, "t64",
                                  lambda s: 32) == 32
        assert tuning.tuned_block("op", "block_q", 96, "t64",
                                  lambda s: 32) == 48


def test_a_table_either_package_wrote_loads_in_the_other(tmp_path):
    jt = jtuning.TuningTable(device_kind="tpu_v5_lite")
    jt.set("dot_product_attention", "flash_min_t", 4096)
    jt.set_block("fused_layer_norm", "r1024", "block_rows", 256)
    path = jt.save(str(tmp_path / "j.json"))
    back = tuning.TuningTable.load(path)
    assert back.device_kind == "tpu_v5_lite" and back.entries == jt.entries
    jdefault = os.path.join(os.path.dirname(jtuning.__file__),
                            "tuning_tables", "default.json")
    assert tuning.TuningTable.load(jdefault).entries == \
        jtuning.TuningTable.load(jdefault).entries
    card = jtuning.TuningTable.load(CARD_TABLE)
    assert card.entries == tuning.TuningTable.load(CARD_TABLE).entries


def test_checked_in_tables():
    default = tuning.TuningTable.load(os.path.join(TABLE_DIR,
                                                   "default.json"))
    jdefault = jtuning.TuningTable.load(os.path.join(
        os.path.dirname(jtuning.__file__), "tuning_tables", "default.json"))
    # no TPU figure: every crossover 0 (every call a gate passes takes the
    # kernel), no block sizes
    assert {op: e for op, e in default.entries.items()} == {
        op: {k: 0 for k in e if k != "blocks"}
        for op, e in jdefault.entries.items() if set(e) - {"blocks"}}
    card = tuning.TuningTable.load(CARD_TABLE)
    assert card.device_kind == "nvidia_h100_80gb_hbm3"
    assert card.measured_on["device_name"] == "NVIDIA H100 80GB HBM3"
    assert card.measured_on["nvidia_smi"].startswith(
        "NVIDIA H100 80GB HBM3, ") and card.measured_on[
            "nvidia_smi"].endswith(" W")
    assert card.measured_on["smoke"] is False
    assert sorted(card.entries) == sorted(n for n, _ in tuning._TUNERS)
    assert tuning.default_table_paths("nvidia_h100_80gb_hbm3")[-1] == \
        CARD_TABLE
    assert tuning.default_table_paths("cpu") == [
        os.path.join(TABLE_DIR, "default.json")]


# ------------------------------------------------------------- the gates


def _zeros(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def _check_gate(desc, below_args, at_args, kw=None):
    kw = kw or {}
    gate = desc.platform_usable["cuda"]
    assert gate(*below_args, **kw) is tuning.CROSSOVER
    assert gate(*at_args, **kw) is True
    lo, d1 = _dispatch_delta(lambda: desc.resolve(*below_args, **kw))
    hi, d2 = _dispatch_delta(lambda: desc.resolve(*at_args, **kw))
    assert lo is desc.fn and hi is desc.platform_impls["cuda"]
    assert d1 == {f"{desc.name}/generic/crossover": 1}
    assert d2 == {f"{desc.name}/cuda/usable": 1}
    env = environment()
    env.helper_mode = "kernel"
    try:
        forced, d3 = _dispatch_delta(lambda: desc.resolve(*below_args, **kw))
    finally:
        env.helper_mode = "auto"
    assert forced is desc.platform_impls["cuda"]
    assert d3 == {f"{desc.name}/cuda/forced_kernel": 1}


def test_flash_reads_flash_min_t(tuning_sandbox, cuda_view):
    _write_table(tuning_sandbox, {"dot_product_attention": {
        "flash_min_t": 64}})
    desc = registry().get("dot_product_attention")
    lo, hi = _zeros(2, 32, 16), _zeros(2, 64, 16)
    _check_gate(desc, (lo, lo, lo), (hi, hi, hi))
    # 4-D keys count on axis 2; dropout passes below the crossover
    lo4 = _zeros(1, 2, 32, 16)
    assert ca.flash_usable(lo4, lo4, lo4) is tuning.CROSSOVER
    assert ca.flash_usable(lo, lo, lo, dropout_rate=0.1) is True
    # a gate refusal stays a refusal, not a crossover
    assert ca.flash_usable(_zeros(2, 32, 12), lo, lo) is False


def test_fused_matmul_reads_pallas_min_m(tuning_sandbox, cuda_view):
    _write_table(tuning_sandbox, {"fused_matmul_bias_act": {
        "pallas_min_m": 64}})
    desc = registry().get("fused_matmul_bias_act")
    w = _zeros(128, 32)
    _check_gate(desc, (_zeros(32, 128), w), (_zeros(64, 128), w))
    assert cm.fused_matmul_usable(_zeros(2, 16, 128), w) is \
        tuning.CROSSOVER
    assert cm.fused_matmul_usable(_zeros(2, 32, 128), w) is True


def test_layer_norm_reads_min_rows(tuning_sandbox, cuda_view):
    _write_table(tuning_sandbox, {"fused_layer_norm": {"min_rows": 32}})
    desc = registry().get("fused_layer_norm")
    g = torch.ones(128)
    _check_gate(desc, (_zeros(16, 128), g), (_zeros(2, 16, 128), g))


def test_updater_reads_min_size(tuning_sandbox, cuda_view):
    _write_table(tuning_sandbox, {"fused_updater_step": {"min_size": 1024}})
    desc = registry().get("fused_updater_step")
    lr, step = torch.tensor(1e-2), torch.tensor(0.0)

    def args(n):
        z = _zeros(n)
        return (z, z, lr, step, z)  # Nesterovs: one state leaf (v)

    _check_gate(desc, args(512), args(1024), {"kind": "Nesterovs"})


def test_int8_reads_pallas_min_m(tuning_sandbox, cuda_view):
    _write_table(tuning_sandbox, {"matmul_int8": {"pallas_min_m": 64}})
    desc = registry().get("matmul_int8")
    wq, ws = _zeros(128, 128, dtype=torch.int8), torch.ones(128)
    _check_gate(desc, (_zeros(32, 128), wq, ws), (_zeros(64, 128), wq, ws))


def test_paged_decode_reads_min_pages(tuning_sandbox, cuda_view):
    _write_table(tuning_sandbox, {"paged_decode_attention": {
        "min_pages": 4}})
    desc = registry().get("paged_decode_attention")
    q, kp = _zeros(2, 2, 8), _zeros(8, 8, 2, 8)
    sl = _zeros(2, dtype=torch.int32)

    def pt(pages):
        return _zeros(2, pages, dtype=torch.int32)

    _check_gate(desc, (q, kp, kp, pt(2), sl), (q, kp, kp, pt(4), sl))


def test_convbn_reads_block_n(tuning_sandbox):
    m, k, n = 25088, 1024, 256
    bucket = tuning.bucket_mkn(m, k, n)
    picked = cc.convbn_tile_n(m, n, 132)
    assert cc.convbn_block_n(m, k, n, 132) == picked  # no entry
    other = 64 if picked == 128 else 128
    _write_table(tuning_sandbox, {"fused_bn_matmul_stats": {
        "blocks": {bucket: {"block_n": other}}}})
    assert cc.convbn_block_n(m, k, n, 132) == other
    assert cc.convbn_block_n(m, k, 192, 132) == cc.convbn_tile_n(m, 192, 132)
    _write_table(tuning_sandbox, {"fused_bn_matmul_stats": {
        "blocks": {bucket: {"block_n": 512}}}})  # does not divide N
    assert cc.convbn_block_n(m, k, n, 132) == picked


def test_default_table_sends_every_eligible_call_to_the_kernel(
        tuning_sandbox, cuda_view):
    one = _zeros(1, 8)
    assert ca.flash_usable(_zeros(1, 1, 8), _zeros(1, 1, 8),
                           _zeros(1, 1, 8)) is True
    assert cm.fused_matmul_usable(one, _zeros(8, 8)) is True
    assert cl.fused_layer_norm_usable(one, torch.ones(8)) is True
    assert cq.matmul_int8_usable(one, _zeros(8, 8, dtype=torch.int8),
                                 torch.ones(8)) is True
    z = _zeros(1)
    assert cu.fused_updater_usable(z, z, 0.1, 0.0, z,
                                   kind="Nesterovs") is True
    assert ca.paged_usable(_zeros(1, 1, 8), _zeros(1, 8, 1, 8),
                           _zeros(1, 8, 1, 8),
                           _zeros(1, 1, dtype=torch.int32),
                           _zeros(1, dtype=torch.int32)) is True


def test_cpu_tensors_never_read_the_table(tuning_sandbox):
    _write_table(tuning_sandbox, {"fused_matmul_bias_act": {
        "pallas_min_m": 64}})
    desc = registry().get("fused_matmul_bias_act")
    assert desc.platform_usable["cuda"](_zeros(8, 8), _zeros(8, 8)) is False
    _, delta = _dispatch_delta(lambda: desc.resolve(_zeros(8, 8),
                                                    _zeros(8, 8)))
    assert delta == {"fused_matmul_bias_act/generic/no_helper": 1}


# ------------------------------------------------------------- autotune


def test_autotune_smoke_on_the_cpu_saves_a_live_table(tuning_sandbox):
    table, report = tuning.autotune(smoke=True, device="cpu")
    assert report.ops == [n for n, _ in tuning._TUNERS]
    assert report.measurements == sum(
        k.endswith("_ms") and k != "spread_ms"
        for t in report.timings.values() for v in t.values() for k in v)
    for t in report.timings.values():
        for v in t.values():
            assert v["readings"] == tuning.READINGS and v["spread_ms"] >= 0
    assert sorted(table.entries) == sorted(report.ops)
    for op, key in (("dot_product_attention", "flash_min_t"),
                    ("fused_matmul_bias_act", "pallas_min_m"),
                    ("fused_layer_norm", "min_rows"),
                    ("fused_updater_step", "min_size"),
                    ("matmul_int8", "pallas_min_m"),
                    ("paged_decode_attention", "min_pages")):
        assert isinstance(table.get(op, key), int)
        assert tuning.tuned(op, key) == table.get(op, key)  # live
    assert table.entries["fused_bn_matmul_stats"]["blocks"] == {
        "m128_k64_n128": {"block_n": table.get_block(
            "fused_bn_matmul_stats", "m128_k64_n128", "block_n")}}
    assert report.table_path == tuning.cache_path("cpu")
    assert tuning.TuningTable.load(report.table_path).measured_on == {
        "device_name": "cpu", "smoke": True}
    # a subset re-tune keeps the other ops' entries
    tuning.autotune(ops=["fused_layer_norm"], smoke=True, device="cpu")
    assert sorted(tuning.TuningTable.load(report.table_path).entries) == \
        sorted(report.ops)
    runs = observe.metrics().counter("dl4j_tpu_tuning_runs_total",
                                     op="fused_layer_norm").value
    assert runs >= 2


def test_crossover_is_the_first_win():
    assert tuning._crossover((16, 64, 256), {16: 2.0, 64: 1.0, 256: 3.0},
                             {16: 1.0, 64: 2.0, 256: 2.0}) == 64
    assert tuning._crossover((16, 64), {16: 2.0, 64: 2.0},
                             {16: 1.0, 64: 1.0}) == 128
    assert tuning._crossover((16, 64), {16: 2.0, 64: 2.0},
                             {16: 1.0, 64: 1.0}) == jtuning._crossover(
        (16, 64), {16: 2.0, 64: 2.0}, {16: 1.0, 64: 1.0})


def test_a_generic_win_inside_the_spread_keeps_the_kernel():
    """The generic takes a rung only by more than that rung's spread."""
    kernel, generic = {16: 1.05, 64: 1.5, 256: 1.0}, {16: 1.0, 64: 1.0,
                                                      256: 2.0}
    assert tuning._crossover((16, 64, 256), kernel, generic) == 256
    assert tuning._crossover((16, 64, 256), kernel, generic,
                             {16: 0.1, 64: 0.1, 256: 0.1}) == 16
    assert tuning._crossover((16, 64, 256), kernel, generic,
                             {16: 0.01, 64: 0.6, 256: 0.1}) == 64
    assert tuning._crossover((16, 64), {16: 2.0, 64: 2.0},
                             {16: 1.0, 64: 1.0}, {16: 0.5, 64: 0.5}) == 128


@pytest.mark.parametrize("argv,saved", [
    ([], True), (["--smoke"], False), (["--out", "t.json"], False)],
    ids=["cache", "smoke", "out"])
def test_tune_cli_leaves_no_cache_overlay_for_smoke_or_out(
        tuning_sandbox, monkeypatch, argv, saved):
    """``--smoke`` and ``--out`` write no file into the cache directory,
    which would overlay the checked-in table for every later run."""
    from deeplearning4j_tpu_torch import tune

    seen = {}

    def fake(ops=None, smoke=False, save=True):
        seen["save"] = save
        return (tuning.TuningTable(device_kind="cpu"),
                tuning.TuneReport(device_kind="cpu"))

    monkeypatch.setattr(tuning, "autotune", fake)
    monkeypatch.chdir(tuning_sandbox)
    assert tune.main(argv) == 0
    assert seen["save"] is saved


# ------------------------------------------------------------- summary


def _same_events(m, ledger):
    m.counter("dl4j_tpu_helper_dispatch_total", op="fused_layer_norm",
              impl="generic", reason="crossover").inc(2)
    m.counter("dl4j_tpu_train_steps_total", model="a").inc(3)
    m.counter("dl4j_tpu_train_examples_total", model="a").inc(96)
    for v in (0.010, 0.012, 0.020):
        m.histogram("dl4j_tpu_train_step_seconds", model="a").observe(v)
    m.counter("dl4j_tpu_serving_generated_tokens_total").inc(40)
    m.counter("dl4j_tpu_serving_admitted_total").inc(4)
    m.counter("dl4j_tpu_serving_evicted_total", reason="eos").inc(4)
    for name in ("decode_step", "ttft", "intertoken"):
        m.histogram(f"dl4j_tpu_serving_{name}_seconds").observe(0.004)
    m.counter("dl4j_tpu_spec_proposed_tokens_total").inc(8)
    m.counter("dl4j_tpu_spec_accepted_tokens_total").inc(5)
    m.counter("dl4j_tpu_spec_rejected_tokens_total").inc(3)
    m.histogram("dl4j_tpu_spec_accept_ratio").observe(0.625)
    m.counter("dl4j_tpu_prefix_lookups_total").inc(4)
    m.counter("dl4j_tpu_prefix_hits_total").inc(3)
    m.counter("dl4j_tpu_slo_admitted_total", **{"class": "chat"}).inc(2)
    m.counter("dl4j_tpu_slo_shed_total", **{"class": "batch"},
              reason="bucket").inc()
    m.counter("dl4j_tpu_ckpt_async_saves_total").inc()
    m.histogram("dl4j_tpu_ckpt_write_seconds").observe(0.3)
    m.counter("dl4j_tpu_faults_injected_total", point="x").inc()
    m.counter("dl4j_tpu_serving_engine_restarts_total").inc()
    ledger.record(graph="samediff", key="exec", signature="sig",
                  cause="first_compile", callsite="here")


def test_summary_has_the_jax_sections_and_values():
    observe.reset()
    jobserve.reset()
    try:
        for mod in (observe, jobserve):
            _same_events(mod.metrics(), mod.ledger())
        got, want = observe.summary(), jobserve.summary()
        assert sorted(got) == sorted(want) == sorted(
            ["recompiles", "dispatch", "train", "generate", "spec",
             "prefix", "slo", "training", "robustness"])
        assert got == want
        assert observe.dispatch_summary() == jobserve.dispatch_summary() == {
            "fused_layer_norm/generic/crossover": 2}
    finally:
        observe.reset()
        jobserve.reset()
    assert observe.summary() == {}
