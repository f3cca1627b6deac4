"""The port's export cache (``autodiff/export.py``) on the CPU, case for
case against ``tests/test_export.py``, and held to the JAX package on the
same numpy inputs.

* The cache: a round trip, atomic writes, a miss, corrupt and
  undeserializable entries (warn once), the torch-version, device-kind,
  operator-schema and digest pins, and ``from_env`` inert without the
  variable.
* The restore ledger: ``cache_hit`` on a restore, a polymorphic program's
  fresh signature a ``cache_hit``, a populating install's first dispatch a
  ``first_compile``.
* MultiLayerNetwork: the populating and the warm leg bit for bit equal to
  the plain step; ragged batches inside the exported batch range; a batch
  below it takes the recorded fallback; the supervisor's warm ``resume``;
  a network that draws (dropout) refused; a warm-booted step from the JAX
  package's parameters against one JAX ``fit`` step.
* SameDiff: the populating and the warm leg bit for bit equal to the plain
  exec at two batch sizes; another structure misses; a graph saved by the
  JAX package, loaded by the port, exported and restored, against the JAX
  ``sd.output``; the tiny imported ONNX BERT; ``as_export_text``;
  ``GraphPlan.fingerprint``.
* The kernels' ``torch.library`` operators: ``torch.library.opcheck`` for
  each; a program calling them exported, saved, loaded and run; the
  BN/matmul/BN-stats, LayerNorm and int8 kernels traced through their
  operators' fakes (fake CUDA tensors).

Tolerances against the JAX package, with their reasons (float32; the two
frameworks sum in other orders): SameDiff outputs 1e-6 relative + 1e-7
absolute (``test_torch_samediff_serde.py``'s); the one-step MLN parameters
1e-5 absolute (one Adam step of lr 0.02 moves each element by about lr;
the roundings of the gradient move it by ~1e-7 of that), the score 1e-5
relative. The port against itself: bit for bit.
"""

import base64
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch import nn, observe
from deeplearning4j_tpu_torch.autodiff import export as aot
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.ops import cuda_attention as ca
from deeplearning4j_tpu_torch.ops import cuda_convbn as cc
from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl
from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
from deeplearning4j_tpu_torch.ops import library

JAX_SD_TOL = dict(rtol=1e-6, atol=1e-7)
JAX_STEP_ATOL = 1e-5
JAX_SCORE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(aot.ENV_DIR, raising=False)
    observe.reset()
    aot.reset_export_cache()
    yield
    observe.reset()
    aot.reset_export_cache()


def _conf(pkg, seed=7, hidden=8, dropout=0.0):
    kw = dict(dropout=dropout) if dropout else {}
    return (pkg.builder().seed(seed).updater(pkg.Adam(learning_rate=0.02))
            .weight_init("xavier").list()
            .layer(pkg.DenseLayer(n_out=hidden, activation="tanh", **kw))
            .layer(pkg.OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(2)).build())


def build_mln(seed=7, hidden=8, dropout=0.0, params=None):
    return nn.MultiLayerNetwork(_conf(nn, seed, hidden, dropout),
                                device="cpu").init(params)


def xy(n=32, seed=0):
    r = np.random.RandomState(seed)
    x = r.rand(n, 2).astype(np.float32)
    y = np.zeros((n, 2), np.float32)
    y[np.arange(n), r.randint(0, 2, n)] = 1.0
    return x, y


def _build_sd(pkg_sd, seed=0, width=3):
    r = np.random.RandomState(seed)
    sd = pkg_sd()
    x = sd.placeholder("x", shape=(None, 4))
    w = sd.var("w", r.randn(4, width).astype(np.float32))
    b = sd.var("b", np.zeros(width, np.float32))
    out = sd.nn.softmax(sd.math.tanh(sd.nn.linear(x, w, b)))
    return sd, out.name


def build_sd(seed=0, width=3):
    return _build_sd(lambda: SameDiff.create(device="cpu"), seed, width)


def params_equal(a, b):
    la = [t for p in a for t in torch.utils._pytree.tree_leaves(p)]
    lb = [t for p in b for t in torch.utils._pytree.tree_leaves(p)]
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def ledger_window(start):
    return observe.ledger().events()[start:]


def _tiny_exported():
    return aot.export_fn(lambda x: x * 2.0 + 1.0, (torch.zeros(4),))


# ---------------------------------------------------------------------------
# ExportCache: the store/load discipline
# ---------------------------------------------------------------------------


def _doc_edit(path, **fields):
    doc = json.load(open(path))
    doc.update(fields)
    json.dump(doc, open(path, "w"))


class TestExportCache:
    def test_store_load_roundtrip_and_atomicity(self, tmp_path):
        cache = aot.ExportCache(str(tmp_path))
        path = cache.store("fp0", "k0", _tiny_exported(), meta={"graph": "t"})
        assert os.path.exists(path)
        leftovers = [f for _, _, fs in os.walk(tmp_path) for f in fs
                     if f.endswith(".tmp")]
        assert leftovers == []
        restored, meta = cache.load_entry("fp0", "k0")
        assert meta == {"graph": "t"}
        x = torch.arange(4, dtype=torch.float32)
        assert torch.equal(restored.module()(x), x * 2.0 + 1.0)

    def test_miss_on_unknown_key(self, tmp_path):
        cache = aot.ExportCache(str(tmp_path))
        assert cache.load("fp0", "nothing") is None
        assert observe.metrics().counter(
            "dl4j_tpu_aot_cache_misses").value == 1

    def test_corrupt_entry_warns_once_then_fresh_trace(self, tmp_path,
                                                       caplog):
        cache = aot.ExportCache(str(tmp_path))
        path = cache.store("fp0", "k0", _tiny_exported())
        with open(path, "w") as f:
            f.write("{this is not json")
        with caplog.at_level(logging.WARNING):
            assert cache.load("fp0", "k0") is None
        assert any("corrupt" in r.message for r in caplog.records)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert cache.load("fp0", "k0") is None
        assert [r for r in caplog.records if "corrupt" in r.message] == []

    def test_undeserializable_payload_degrades_to_miss(self, tmp_path,
                                                       caplog):
        cache = aot.ExportCache(str(tmp_path))
        path = cache.store("fp0", "k0", _tiny_exported())
        _doc_edit(path, payload=base64.b64encode(b"garbage").decode())
        with caplog.at_level(logging.WARNING):
            assert cache.load("fp0", "k0") is None
        assert any("undeserializable" in r.message for r in caplog.records)

    @pytest.mark.parametrize("field, value", [
        ("torch_version", "0.0.0-stale"), ("device_kind", "NVIDIA X9000"),
        ("ops_schema", "0" * 64)])
    def test_stale_toolchain_invalidates(self, tmp_path, caplog, field,
                                         value):
        cache = aot.ExportCache(str(tmp_path))
        path = cache.store("fp0", "k0", _tiny_exported())
        _doc_edit(path, **{field: value})
        with caplog.at_level(logging.WARNING):
            assert cache.load("fp0", "k0") is None
        assert any("stale" in r.message for r in caplog.records)
        assert list(cache.entries()) == []

    def test_digest_pins_toolchain(self, tmp_path):
        cache = aot.ExportCache(str(tmp_path))
        d = cache.digest("fp0", "k0")
        assert d != cache.digest("fp1", "k0")
        assert d != cache.digest("fp0", "k1")
        assert cache.ops_schema == library.schema_digest()
        cache.ops_schema = "another operator set"
        assert cache.digest("fp0", "k0") != d
        assert cache.device_kind == "cpu"  # no card on this host

    def test_from_env_is_inert_without_optin(self, monkeypatch, tmp_path):
        assert aot.ExportCache.from_env() is None
        monkeypatch.setenv(aot.ENV_DIR, str(tmp_path))
        cache = aot.ExportCache.from_env()
        assert cache is not None and cache.root == str(tmp_path)


# ---------------------------------------------------------------------------
# restore_callable's ledger semantics
# ---------------------------------------------------------------------------


class TestRestoreLedger:
    def test_hit_restore_records_cache_hit(self):
        start = len(observe.ledger().events())
        fn = aot.restore_callable(_tiny_exported(), graph="t", key="k0",
                                  hit=True)
        assert [(e.graph, e.key, e.cause) for e in ledger_window(start)] \
            == [("t", "k0", "cache_hit")]
        assert fn._aot_restored
        summ = observe.ledger().summary()
        assert summ["by_cause"].get("cache_hit", 0) == 1
        assert any("export.py" in cs for cs in summ["by_callsite"])

    def test_polymorphic_new_signature_is_cache_hit_not_new_shape(self):
        fn = aot.restore_callable(_tiny_exported(), graph="t", key="k0",
                                  hit=True, polymorphic=True)
        start = len(observe.ledger().events())
        for sig in ("x=f32[8]", "x=f32[3]"):
            observe.note_jit_signature(fn, graph="t", key="k0",
                                       signature=sig)
        assert [e.cause for e in ledger_window(start)] == ["cache_hit"] * 2

    def test_miss_install_leaves_first_compile_to_dispatch(self):
        fn = aot.restore_callable(_tiny_exported(), graph="t", key="k0",
                                  hit=False)
        start = len(observe.ledger().events())
        observe.note_jit_signature(fn, graph="t", key="k0",
                                   signature="x=f32[4]")
        assert [e.cause for e in ledger_window(start)] == ["first_compile"]


# ---------------------------------------------------------------------------
# MultiLayerNetwork train step
# ---------------------------------------------------------------------------


class TestMLNRoundTrip:
    def test_populate_and_warm_boot_are_bit_exact(self, tmp_path):
        x, y = xy(n=32)
        oracle = build_mln()
        oracle.fit(x, y, epochs=2, batch_size=16)
        cache = aot.ExportCache(str(tmp_path))
        net = build_mln()
        path = aot.export_train_step(net, x[:16], y[:16], cache=cache)
        assert path is not None and os.path.exists(path)
        net.fit(x, y, epochs=2, batch_size=16)
        assert params_equal(net.params, oracle.params)
        assert params_equal(net.opt_state, oracle.opt_state)
        warm = build_mln()
        start = len(observe.ledger().events())
        assert aot.warm_boot_net(warm, cache=cache) == 1
        warm.fit(x, y, epochs=2, batch_size=16)
        assert params_equal(warm.params, oracle.params)
        assert warm.iteration_count == oracle.iteration_count == 4
        evs = [e for e in ledger_window(start) if e.graph == "mln"]
        assert evs and all(e.cause == "cache_hit" for e in evs), \
            [(e.key, e.cause) for e in evs]

    def test_symbolic_batch_serves_ragged_batches(self, tmp_path):
        x, y = xy(n=12)
        cache = aot.ExportCache(str(tmp_path))
        aot.export_train_step(build_mln(), x[:5], y[:5], cache=cache)
        warm = build_mln()
        assert aot.warm_boot_net(warm, cache=cache) == 1
        step = warm._jit_cache["train_step"]
        assert step.meta["batch_range"][0] <= 2
        start = len(observe.ledger().events())
        warm.fit(x, y, epochs=1, batch_size=5)  # batches of 5, 5, 2
        evs = [e for e in ledger_window(start) if e.graph == "mln"]
        assert evs and all(e.cause == "cache_hit" for e in evs)
        assert not step.plain
        oracle = build_mln()
        oracle.fit(x, y, epochs=1, batch_size=5)
        assert params_equal(warm.params, oracle.params)

    def test_batch_outside_the_export_takes_the_plain_step(self, tmp_path):
        x, y = xy(n=9)
        cache = aot.ExportCache(str(tmp_path))
        aot.export_train_step(build_mln(), x[:4], y[:4], cache=cache)
        warm = build_mln()
        aot.warm_boot_net(warm, cache=cache)
        step = warm._jit_cache["train_step"]
        lo = step.meta["batch_range"][0]
        assert lo == 2  # torch.export specializes sizes 0 and 1
        start = len(observe.ledger().events())
        warm.fit(x, y, epochs=1, batch_size=4)  # 4, 4, then 1: below it
        assert step.plain and not step._aot_restored
        evs = [e for e in ledger_window(start) if e.graph == "mln"]
        # the plain step's own unit traces for the first time
        assert [e.cause for e in evs] == ["cache_hit", "first_compile"]
        oracle = build_mln()
        oracle.fit(x, y, epochs=1, batch_size=4)
        assert params_equal(warm.params, oracle.params)

    def test_fingerprint_separates_configs(self):
        assert aot.net_fingerprint(build_mln(hidden=8)) != \
            aot.net_fingerprint(build_mln(hidden=16))
        assert aot.net_fingerprint(build_mln()) == \
            aot.net_fingerprint(build_mln())

    def test_fingerprint_pins_the_helper_mode(self):
        from deeplearning4j_tpu_torch.environment import environment

        env = environment()
        auto = aot.net_fingerprint(build_mln())
        env.helper_mode = "generic"
        try:
            assert aot.net_fingerprint(build_mln()) != auto
        finally:
            env.helper_mode = "auto"

    def test_supervisor_resume_warm_boots(self, tmp_path, monkeypatch):
        from deeplearning4j_tpu_torch.parallel import (
            TrainingCheckpointer, TrainingSupervisor)

        x, y = xy(n=32)
        monkeypatch.setenv(aot.ENV_DIR, str(tmp_path / "aot"))
        net = build_mln()
        aot.export_train_step(net, x[:16], y[:16])
        net.fit(x, y, epochs=1, batch_size=16)
        ckpt = TrainingCheckpointer(str(tmp_path / "ckpt"))
        ckpt.save(int(net.iteration_count), net)
        ckpt.wait_until_finished()
        net2 = build_mln()
        sup = TrainingSupervisor(net2, TrainingCheckpointer(
            str(tmp_path / "ckpt")), save_every=100)
        start = len(observe.ledger().events())
        assert sup.resume() == 2
        assert "train_step" in net2._jit_cache
        net2.fit(x, y, epochs=1, batch_size=16)
        net.fit(x, y, epochs=1, batch_size=16)
        assert params_equal(net2.params, net.params)
        evs = [e for e in ledger_window(start) if e.graph == "mln"]
        assert evs and all(e.cause == "cache_hit" for e in evs)

    def test_resume_is_inert_without_the_variable(self, tmp_path):
        from deeplearning4j_tpu_torch.parallel import (
            TrainingCheckpointer, TrainingSupervisor)

        net = build_mln()
        sup = TrainingSupervisor(net, TrainingCheckpointer(str(tmp_path)))
        assert sup.resume() is None
        assert net._jit_cache == {}

    def test_a_step_that_draws_is_refused(self, tmp_path):
        x, y = xy(n=8)
        with pytest.raises(NotImplementedError, match="dropout"):
            aot.export_train_step(build_mln(dropout=0.5), x, y,
                                  cache=aot.ExportCache(str(tmp_path)))

    def test_warm_step_from_jax_parameters_matches_one_jax_fit_step(
            self, tmp_path):
        jnet = jnn.MultiLayerNetwork(_conf(jnn)).init()
        start = jax.tree.map(np.array, jnet.params)
        x, y = xy(n=16, seed=3)
        cache = aot.ExportCache(str(tmp_path))
        aot.export_train_step(build_mln(params=start), x, y, cache=cache)
        warm = build_mln(params=start)
        assert aot.warm_boot_net(warm, cache=cache) == 1
        jnet.fit(x, y, batch_size=16)
        warm.fit(x, y, batch_size=16)
        assert not warm._jit_cache["train_step"].plain
        np.testing.assert_allclose(warm.score(), jnet.score(),
                                   rtol=JAX_SCORE_RTOL)
        want = jax.tree.leaves(jax.tree.map(np.array, jnet.params))
        got = [t.numpy() for p in warm.params
               for t in torch.utils._pytree.tree_leaves(p)]
        assert len(want) == len(got)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=0, atol=JAX_STEP_ATOL)


# ---------------------------------------------------------------------------
# SameDiff whole-graph exec
# ---------------------------------------------------------------------------


class TestSameDiffRoundTrip:
    def test_populate_and_warm_boot_are_bit_exact(self, tmp_path):
        r = np.random.RandomState(1)
        x8 = r.randn(8, 4).astype(np.float32)
        x3 = r.randn(3, 4).astype(np.float32)
        sd0, out0 = build_sd()
        oracle8 = sd0.output({"x": x8}, out0)[out0]
        oracle3 = sd0.output({"x": x3}, out0)[out0]
        cache = aot.ExportCache(str(tmp_path))
        sd1, out1 = build_sd()
        assert aot.export_exec(sd1, {"x": x8}, out1, cache=cache)
        np.testing.assert_array_equal(sd1.output({"x": x8}, out1)[out1],
                                      oracle8)
        sd2, out2 = build_sd()
        assert aot.warm_boot_samediff(sd2, out2, cache=cache)
        start = len(observe.ledger().events())
        np.testing.assert_array_equal(sd2.output({"x": x8}, out2)[out2],
                                      oracle8)
        np.testing.assert_array_equal(sd2.output({"x": x3}, out2)[out2],
                                      oracle3)
        evs = [e for e in ledger_window(start) if e.graph == "samediff"]
        assert evs and all(e.cause == "cache_hit" for e in evs), \
            [(e.key, e.cause, e.signature) for e in evs]

    def test_batch_outside_the_export_takes_the_plain_exec(self, tmp_path):
        r = np.random.RandomState(2)
        x1 = r.randn(1, 4).astype(np.float32)
        sd0, out0 = build_sd()
        oracle = sd0.output({"x": x1}, out0)[out0]
        cache = aot.ExportCache(str(tmp_path))
        aot.export_exec(build_sd()[0], {"x": np.zeros((6, 4), np.float32)},
                        out0, cache=cache)
        sd2, out2 = build_sd()
        assert aot.warm_boot_samediff(sd2, out2, cache=cache)
        start = len(observe.ledger().events())
        np.testing.assert_array_equal(sd2.output({"x": x1}, out2)[out2],
                                      oracle)
        evs = [e.cause for e in ledger_window(start)
               if e.graph == "samediff"]
        assert evs == ["new_shape"]  # the restore's aot[exec], then plain

    def test_warm_boot_misses_on_different_graph(self, tmp_path):
        cache = aot.ExportCache(str(tmp_path))
        sd1, out1 = build_sd()
        aot.export_exec(sd1, {"x": np.zeros((2, 4), np.float32)}, out1,
                        cache=cache)
        sd2, out2 = build_sd(width=5)
        assert not aot.warm_boot_samediff(sd2, out2, cache=cache)

    def test_jax_saved_graph_exported_by_the_port_matches_jax(self,
                                                              tmp_path):
        jsd, jout = _build_sd(JSameDiff, seed=4)
        path = str(tmp_path / "graph.zip")
        jsd.save(path)
        r = np.random.RandomState(5)
        feeds = {"x": r.randn(7, 4).astype(np.float32)}
        want = np.asarray(jsd.output(feeds, jout)[jout])
        cache = aot.ExportCache(str(tmp_path / "aot"))
        sd1 = SameDiff.load(path, device="cpu")
        aot.export_exec(sd1, feeds, jout, cache=cache)
        sd2 = SameDiff.load(path, device="cpu")
        assert aot.warm_boot_samediff(sd2, jout, cache=cache)
        got = sd2.output(feeds, jout)[jout]
        np.testing.assert_allclose(got, want, **JAX_SD_TOL)
        np.testing.assert_array_equal(got, sd1.output(feeds, jout)[jout])

    def test_imported_tiny_bert_round_trip(self, tmp_path):
        from deeplearning4j_tpu_torch.imports import import_onnx
        from deeplearning4j_tpu_torch.testing import onnx_builder as tb

        cfg = dict(layers=2, batch=2, seq=16, d=32, heads=4, ff=64,
                   vocab=50)
        model = tb.bert_onnx_model(**cfg)
        feeds = tb.bert_onnx_feeds(2, 16, 50, min_len=4)
        plain = import_onnx(model, device="cpu").output(feeds, ["y"])["y"]
        cache = aot.ExportCache(str(tmp_path))
        sd1 = import_onnx(model, device="cpu")
        aot.export_exec(sd1, feeds, ["y"], cache=cache)
        sd2 = import_onnx(model, device="cpu")
        assert aot.warm_boot_samediff(sd2, ["y"], cache=cache)
        np.testing.assert_array_equal(sd2.output(feeds, ["y"])["y"], plain)
        np.testing.assert_array_equal(sd1.output(feeds, ["y"])["y"], plain)

    def test_as_export_text_is_the_program_not_stablehlo(self):
        sd, out = build_sd()
        text = sd.as_export_text({"x": np.zeros((3, 4), np.float32)}, out)
        assert "torch.ops.aten" in text and "ExportedProgram" in text
        assert "stablehlo" not in text.lower()

    def test_graph_plan_fingerprint(self):
        def plan(seed=0, act="tanh"):
            r = np.random.RandomState(seed)
            sd = SameDiff.create(device="cpu")
            x = sd.placeholder("x", shape=(None, 4))
            w = sd.var("w", r.randn(4, 3).astype(np.float32))
            out = sd.nn.softmax(getattr(sd.math, act)(x @ w))
            return sd._graph_plan((out.name,)).fingerprint()

        fa = plan()
        assert len(fa) == 64 and fa == plan()
        # variable values are arguments, not part of a plan; its ops are
        assert fa == plan(seed=9)
        assert fa != plan(act="exp")
        # a variable's shape is not part of the plan: samediff_fingerprint
        # adds the variables' specs
        sd3, out3 = build_sd(width=3)
        sd5, out5 = build_sd(width=5)
        assert aot.samediff_fingerprint(sd3, (out3,)) != \
            aot.samediff_fingerprint(sd5, (out5,))


# ---------------------------------------------------------------------------
# the kernels as torch.library operators
# ---------------------------------------------------------------------------


def _op_cases():
    r = np.random.RandomState(11)

    def t(*shape, grad=False, dtype=np.float32):
        return torch.from_numpy(r.randn(*shape).astype(dtype)
                                ).requires_grad_(grad)

    qkv = [t(4, 16, 8, grad=True) for _ in range(3)]
    lse = torch.randn(4, 16)
    seed = torch.tensor([7], dtype=torch.int32)
    mask = torch.from_numpy((r.rand(4, 16) > 0.2).astype(np.float32))
    from deeplearning4j_tpu_torch.nn.updater import Adam

    upd = Adam(learning_rate=0.01)
    coef = upd.coefficients(torch.tensor(0.01), 3)
    hyper = json.dumps(dict(sorted(upd.fused_hyper().items())))
    leaves = [t(7), t(3, 2)]
    upd_args = (leaves, [t(7), t(3, 2)], [t(7).abs(), t(7).abs(),
                                          t(3, 2).abs(), t(3, 2).abs()],
                coef, torch.tensor(0.01), torch.tensor(3), "Adam", hyper)
    return {
        "flash_fwd": (*qkv, None, None, 0.35, False, 0.0),
        "flash_fwd_dropout": (*qkv, mask, seed, 0.35, True, 0.25),
        # the backward operators run under the forward's autograd formula
        # and have none of their own
        "flash_dq": (*[a.detach() for a in qkv], mask, seed, t(4, 16, 8),
                     lse, t(4, 16), 0.35, False, 0.25),
        "flash_dkv": (*[a.detach() for a in qkv], None, None, t(4, 16, 8),
                      lse, t(4, 16), 0.35, True, 0.0),
        "paged_decode": (t(2, 2, 8), t(5, 8, 2, 8), t(5, 8, 2, 8),
                         torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
                         torch.tensor([9, 3], dtype=torch.int32), 0.3),
        "fused_matmul": (t(5, 8, grad=True), t(8, 6, grad=True),
                         t(6, grad=True), "gelu", False, False),
        "fused_updater": upd_args,
        "fused_updater_": upd_args,
        "bn_matmul_stats": (t(256, 64).bfloat16(), t(64), t(64),
                            t(64, 64).bfloat16(), t(64), True, True, 0),
        "bn_matmul_stats_no_prologue": (t(128, 64).bfloat16(), t(64), t(64),
                                        t(64, 128).bfloat16(), t(128), False,
                                        False, 64),
        "fused_layer_norm": (t(6, 16, grad=True), t(16, grad=True),
                             t(16, grad=True), 1e-5, "gelu"),
        "fused_layer_norm_no_bias": (t(2, 3, 16, grad=True), t(16, grad=True),
                                     None, 1e-6, "none"),
        "matmul_int8_row_quantize": (t(7, 32),),
        "matmul_int8": (torch.from_numpy(r.randint(-127, 128, (7, 32)).astype(
            np.int8)), t(7, 1).abs(), torch.from_numpy(
                r.randint(-127, 128, (32, 5)).astype(np.int8)), t(5).abs(),
            torch.bfloat16),
    }


UPD = __import__("deeplearning4j_tpu_torch.nn.updater",
                 fromlist=["Nesterovs"]).Nesterovs(learning_rate=0.1,
                                                   momentum=0.9)
UPD_HYPER = json.dumps(dict(sorted(UPD.fused_hyper().items())))


class TestOperators:
    @pytest.mark.parametrize("case", list(_op_cases()))
    def test_opcheck(self, case):
        args = _op_cases()[case]
        name = case
        for suffix in ("_dropout", "_no_prologue", "_no_bias"):
            name = name.replace(suffix, "")
        op = getattr(library.ops(), name).default
        torch.library.opcheck(op, args)

    def test_every_operator_is_registered_with_its_schema(self):
        ns = library.ops()
        for name in library.OPS:
            assert getattr(ns, name).default._schema.name == \
                library.qualname(name)
        assert len(library.schema_digest()) == 64

    def test_a_program_of_the_operators_round_trips(self, tmp_path):
        """flash attention, paged decode, the fused
        matmul and the in-place updater in one exported program, saved,
        loaded and run at another batch: equal to the same calls run
        eagerly."""
        r = np.random.RandomState(3)

        def fn(q, k, v, w, p, s):
            out, _ = ca.flash_attention(q, k, v, causal=True)
            h = cm.fused_matmul(out.reshape(-1, 8), w, None,
                                activation="relu")
            pages = h.reshape(-1, 4, 2, 8)[:2]
            dec = ca.paged_decode_attention(
                q[:2, 0].reshape(1, 2, 8), pages, pages,
                torch.zeros((1, 2), dtype=torch.int32),
                torch.full((1,), 5, dtype=torch.int32))
            # the in-place updater operator as fused_updater_multi calls
            # it on the card (on the CPU that wrapper updates leaf by leaf)
            library.ops().fused_updater_(
                [p], [dec.sum() * torch.ones_like(p)], [s],
                UPD.coefficients(torch.tensor(0.1), 1), torch.tensor(0.1),
                torch.tensor(1), "Nesterovs", UPD_HYPER)
            return h.sum(), dec

        def args(b):
            return ([torch.from_numpy(r.randn(b, 8, 8).astype(np.float32))
                     for _ in range(3)]
                    + [torch.from_numpy(r.randn(8, 8).astype(np.float32)),
                       torch.zeros(3), torch.zeros(3)])

        from torch.export import Dim
        ds = ({0: Dim.AUTO},) * 3 + (None, None, None)
        exported = aot.export_fn(fn, args(4), ds)
        names = {str(n.target) for n in exported.graph.nodes}
        assert {"dl4j_tpu_torch.flash_fwd.default",
                "dl4j_tpu_torch.fused_matmul.default",
                "dl4j_tpu_torch.paged_decode.default",
                "dl4j_tpu_torch.fused_updater_.default"} <= names
        cache = aot.ExportCache(str(tmp_path))
        cache.store("ops", "k", exported)
        restored = cache.load("ops", "k").module()
        a = args(6)
        b = [x.clone() for x in a]
        got, want = restored(*a), fn(*b)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.equal(a[4], b[4]) and a[4].abs().sum() > 0

    def test_a_fused_layer_norm_graph_exports_through_its_operator(
            self, tmp_path, monkeypatch):
        """A SameDiff graph whose optimizer fuses layer_norm → gelu into a
        ``fused_layer_norm`` node, with the gate taking these CPU tensors
        for the card's (the operator's CPU implementation is the plain
        version): the exported program calls
        ``dl4j_tpu_torch::fused_layer_norm``, and the warm-booted program
        gives the direct run's output bit for bit."""
        import importlib

        registry_mod = importlib.import_module(
            "deeplearning4j_tpu_torch.ops.registry")
        monkeypatch.setattr(cl, "_on_cuda", lambda *ts: True)
        monkeypatch.setattr(registry_mod, "tensor_platform",
                            lambda *a, **k: "cuda")

        def build():
            r = np.random.RandomState(6)
            sd = SameDiff(device="cpu")
            x = sd.placeholder("x", (None, 16, 32))
            g = sd.var("g", (1 + 0.1 * r.randn(32)).astype(np.float32))
            b = sd.var("b", (0.1 * r.randn(32)).astype(np.float32))
            sd.nn.gelu(sd.nn.layer_norm(x, g, b)).rename("y")
            return sd

        feeds = {"x": np.random.RandomState(7).randn(4, 16, 32).astype(
            np.float32)}
        sd0 = build()
        direct = sd0.output(feeds, ["y"])["y"]
        assert sd0.last_compile_stats.fusions.get("layernorm") == 1
        assert "dl4j_tpu_torch.fused_layer_norm" in sd0.as_export_text(
            feeds, ["y"])
        cache = aot.ExportCache(str(tmp_path))
        assert aot.export_exec(build(), feeds, ["y"], cache=cache)
        sd2 = build()
        assert aot.warm_boot_samediff(sd2, ["y"], cache=cache)
        np.testing.assert_array_equal(sd2.output(feeds, ["y"])["y"], direct)

    @pytest.mark.parametrize("kernel, call, shapes", [
        ("bn_matmul_stats", lambda f: cc.bn_matmul_stats_partials(
            f(256, 64), f(64), f(64), f(64, 32), f(32)),
         [(256, 32), (2, 2, 32)]),
        ("fused_layer_norm", lambda f: (cl.fused_layer_norm_kernel(
            f(16, 64), f(64)),), [(16, 64)]),
        ("matmul_int8_row_quantize", lambda f: cq.row_quantize(f(16, 64)),
         [(16, 64), (16, 1)]),
    ])
    def test_a_ctypes_kernel_refuses_tracing_by_name(self, kernel, call,
                                                     shapes):
        """The BN/matmul/BN-stats, LayerNorm and row-quantization kernels
        trace: fake CUDA tensors go through the operator's fake and come
        back fake, of the kernel's shapes, with no launch counted."""
        mode = FakeTensorMode()

        def fake_cuda(*shape):
            return FakeTensor(mode, torch.empty(shape, device="meta"),
                              torch.device("cuda", 0))

        counters = (cc.bn_matmul_stats.launches,
                    cl.fused_layer_norm_kernel.launches,
                    cq.row_quantize.launches)
        with mode:
            outs = call(fake_cuda)
        assert [tuple(o.shape) for o in outs] == shapes
        assert all(isinstance(o, FakeTensor) and o.device.type == "cuda"
                   for o in outs)
        assert (cc.bn_matmul_stats.launches,
                cl.fused_layer_norm_kernel.launches,
                cq.row_quantize.launches) == counters
