"""The port's recompile ledger against the JAX package's (CPU).

The same call sequences go through ``observe`` of both packages and must
leave the same records:

* ``signature_of``: identical strings for the same numpy arrays (float32,
  float64, int32, int64, bool, ``ml_dtypes.bfloat16``, Python scalars,
  ``None`` entries skipped), and a torch tensor gives the string of the
  numpy array of its shape and dtype;
* ``note_jit_signature`` / ``RecompileLedger``: the same ``(graph, key,
  signature, cause)`` events, the same summary counts, the same
  ``dl4j_tpu_recompiles_total`` counters, the same refusal of an unknown
  cause;
* the serving engines: 5 greedy prompts over 2 slots from one numpy
  parameter tree give the same tokens and the same per-key serving ledger
  (one ``first_compile`` each for prefill, write_prompt and decode, no
  ``new_shape``; the JAX check is ``tests/test_serving.py``'s
  ``TestDecodeJitStability``);
* ``SameDiff.output``: one graph through output, the same shape again, a
  new batch, a rename, a constant rebind and a variable reshaped gives the
  same cause sequence in both packages, with outputs within
  ``tests/test_torch_samediff.py``'s tolerance (1e-5).

On the CPU nothing is captured: the port's units run eagerly and report
their first run per signature, as ``jax.jit`` compiles on the CPU.
"""

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu import observe as jobs
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.serving import GenerativeEngine as JaxEngine
from deeplearning4j_tpu_torch import observe as tobs
from deeplearning4j_tpu_torch.autodiff import optimize as topt
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff as TSameDiff
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.serving import GenerativeEngine

TOL = dict(rtol=1e-5, atol=1e-5)

ARRAYS = {
    "f32": np.zeros((32, 128), np.float32),
    "f64": np.ones((3,), np.float64),
    "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
    "i64": np.arange(4, dtype=np.int64),
    "b": np.array([True, False]),
    "bf16": np.zeros((2, 4), ml_dtypes.bfloat16),
    "scalar_arr": np.float32(1.5),
}


@pytest.fixture
def fresh():
    jobs.reset()
    tobs.reset()
    yield
    jobs.reset()
    tobs.reset()


def _events(obs):
    return [(e.graph, e.key, e.signature, e.cause)
            for e in obs.ledger().events()]


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_signature_of_matches_jax_per_dtype(name):
    a = ARRAYS[name]
    assert tobs.signature_of(a) == jobs.signature_of(a)
    assert tobs.signature_of(x=a) == jobs.signature_of(x=a)


def test_signature_of_mixed_positional_named_and_none():
    args = (ARRAYS["f32"], None, ARRAYS["i32"])
    named = dict(ids=ARRAYS["i32"], mask=None, w=ARRAYS["bf16"], lr=0.1,
                 n=3)
    want = jobs.signature_of(*args, **named)
    assert tobs.signature_of(*args, **named) == want
    assert "mask" not in want and "|1:" not in want


@pytest.mark.parametrize("name", ["f32", "f64", "i32", "i64", "b", "bf16"])
def test_signature_of_torch_tensor_is_the_numpy_string(name):
    a = ARRAYS[name]
    if a.dtype == ml_dtypes.bfloat16:
        t = torch.zeros(a.shape, dtype=torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    assert tobs.signature_of(x=t) == jobs.signature_of(x=a)


def test_bfloat16_signature_names_the_dtype():
    assert tobs.signature_of(x=ARRAYS["bf16"]) == "x:bfloat16[2,4]"
    assert tobs.signature_of(ARRAYS["f32"]) == "0:float32[32,128]"


class _Unit:
    """A cached unit that takes attributes (the seen-signature set)."""


def _drive(obs):
    """One call sequence: two units, new shapes, repeats, a rebuilt unit
    with an invalidation cause, a unit refusing attributes."""
    a, b = _Unit(), _Unit()
    sig = obs.signature_of
    causes = []
    for fn, key, arr, kw in [
            (a, "exec", ARRAYS["f32"], {}),
            (a, "exec", ARRAYS["f32"], {}),             # cache hit
            (a, "exec", ARRAYS["i32"], {}),             # new shape
            (b, "grad", ARRAYS["bf16"], {}),
            (b, "grad", ARRAYS["bf16"], {}),
            (_Unit(), "exec", ARRAYS["f32"],
             {"cause_if_new_fn": "graph_mutation"}),    # rebuilt
            (_Unit(), "exec", ARRAYS["f32"],
             {"cause_if_new_fn": "constant_rebind"}),
            (_Unit(), "train", ARRAYS["f64"],
             {"cause_if_new_fn": "variable_rebind"}),
            (object(), "exec", ARRAYS["f32"], {})]:     # no attributes
        causes.append(obs.note_jit_signature(
            fn, graph="g", key=key, signature=sig(x=arr), **kw))
    return causes


def test_note_jit_signature_event_lists_match_jax(fresh):
    want = _drive(jobs)
    got = _drive(tobs)
    assert got == want
    assert _events(tobs) == _events(jobs)
    assert len(tobs.ledger()) == len(jobs.ledger()) == 6
    jsum, tsum = jobs.ledger().summary(), tobs.ledger().summary()
    assert tsum["total"] == jsum["total"]
    assert tsum["by_cause"] == jsum["by_cause"]
    for name in ("dl4j_tpu_recompiles_total",):
        assert (tobs.metrics().counter(name).value
                == jobs.metrics().counter(name).value == 6)
    for cause in jsum["by_cause"]:
        assert (tobs.metrics().counter("dl4j_tpu_recompile_cause_total",
                                       cause=cause).value
                == jsum["by_cause"][cause])


def test_record_refuses_unknown_cause_and_carries_stats(fresh):
    for obs in (jobs, tobs):
        with pytest.raises(ValueError, match="unknown recompile cause"):
            obs.ledger().record(graph="g", key="k", signature="", cause="x")
    st = topt.OptimizeStats(nodes_before=9, nodes_after=4)
    st.trace_seconds, st.compile_seconds = 0.5, 1.25
    ev = tobs.ledger().record(graph="g", key="exec", signature="s",
                              cause="first_compile", stats=st)
    d = ev.to_dict()
    assert (d["trace_seconds"], d["compile_seconds"]) == (0.5, 1.25)
    assert (d["nodes_before"], d["nodes_after"]) == (9, 4)
    assert d["callsite"].startswith("tests/test_torch_ledger.py:")
    assert tobs.ledger().summary()["compile_seconds_sum"] == 1.25
    assert set(d) == set(jobs.ledger().record(
        graph="g", key="exec", signature="s", cause="first_compile",
        stats=st).to_dict())


def test_reset_starts_a_fresh_ledger(fresh):
    tobs.note_jit_signature(_Unit(), graph="g", key="k", signature="s")
    assert len(tobs.ledger()) == 1
    tobs.reset()
    assert len(tobs.ledger()) == 0


# ---------------------------------------------------------------- serving

CFG_J = jgpt.GptConfig.tiny()
CFG_T = tgpt.GptConfig.tiny()
PROMPTS = [np.array([3, 5, 7, 9], np.int32),
           np.array([11, 2], np.int32),
           np.array([42, 43, 44, 45, 46, 47], np.int32),
           np.array([8, 8, 8], np.int32),
           np.array([17, 23, 31], np.int32)]


def _numpy_params(cfg, seed=0):
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


def _serving_by_key(obs):
    by_key = {}
    for ev in obs.ledger().events():
        if ev.graph == "serving":
            by_key.setdefault(ev.key, []).append((ev.signature, ev.cause))
    return by_key


def test_engines_serve_the_same_tokens_and_serving_ledger(fresh):
    params = _numpy_params(CFG_T)
    kw = dict(max_slots=2, page_size=8, max_pages_per_seq=6, max_prompt=16,
              seed=3)
    jeng = JaxEngine(jgpt.GptModel(CFG_J, params=jax.tree.map(
        jnp.asarray, params)), **kw)
    eng = GenerativeEngine(tgpt.GptModel(
        CFG_T, params=tgpt.params_from_numpy(params, device="cpu"),
        device="cpu"), device="cpu", **kw)
    wants = jeng.generate(PROMPTS, max_new_tokens=4, eos_token=-1)
    gots = eng.generate(PROMPTS, max_new_tokens=4, eos_token=-1)
    for w, g in zip(wants, gots):
        np.testing.assert_array_equal(g.tokens, w.tokens)
    assert len({t for g in gots for t in g.tokens.tolist()}) > 1
    want, got = _serving_by_key(jobs), _serving_by_key(tobs)
    assert got == want
    assert {k: [c for _, c in v] for k, v in got.items()} == {
        "prefill": ["first_compile"], "write_prompt": ["first_compile"],
        "decode": ["first_compile"]}


# --------------------------------------------------------------- samediff


def _graph(pkg):
    """x @ w + b → tanh → (· * scale) with a constant, a variable and a
    placeholder whose batch varies."""
    r = np.random.RandomState(0)
    sd = JSameDiff() if pkg == "jax" else TSameDiff(device="cpu")
    x = sd.placeholder("x", (None, 8))
    w = sd.var("w", (r.randn(8, 6) * 0.3).astype(np.float32))
    b = sd.var("b", (r.randn(6) * 0.1).astype(np.float32))
    scale = sd.constant("scale", np.float32(1.5))
    (sd.math.tanh(x @ w + b) * scale).rename("out")
    return sd


def _samediff_sequence(pkg):
    """output, the same shape again, a new batch, a rename, a constant
    rebind, a variable reshaped: the outputs of each call."""
    sd = _graph(pkg)
    r = np.random.RandomState(1)
    x4 = r.randn(4, 8).astype(np.float32)
    x7 = r.randn(7, 8).astype(np.float32)
    outs = [sd.output({"x": x4}, "out")["out"],
            sd.output({"x": x4 + 1.0}, "out")["out"],
            sd.output({"x": x7}, "out")["out"]]
    sd._rename("w", "w_renamed")
    outs.append(sd.output({"x": x7}, "out")["out"])
    sd.set_arr("scale", np.float32(-2.0))
    outs.append(sd.output({"x": x7}, "out")["out"])
    sd.set_arr("b", (r.randn(1, 6) * 0.1).astype(np.float32))
    outs.append(sd.output({"x": x4}, "out")["out"])
    return outs


def test_samediff_cause_sequence_matches_jax(fresh):
    want_out = _samediff_sequence("jax")
    got_out = _samediff_sequence("torch")
    for g, w in zip(got_out, want_out):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    want = [e for e in _events(jobs) if e[0] == "samediff"]
    got = [e for e in _events(tobs) if e[0] == "samediff"]
    assert got == want
    assert [c for *_, c in got] == [
        "first_compile", "new_shape", "graph_mutation", "constant_rebind",
        "variable_rebind"]


def test_samediff_compile_stats_on_the_cpu(fresh):
    """The first output's eager run is its trace; nothing is captured on
    the CPU, so compile_seconds stays None — in the stats, their dict, the
    event and the spans."""
    sd = _graph("torch")
    sd.output({"x": np.ones((2, 8), np.float32)}, "out")
    st = sd.last_compile_stats
    assert st.trace_seconds is not None and st.trace_seconds >= 0
    assert st.compile_seconds is None
    d = st.to_dict()
    assert {"trace_seconds", "compile_seconds", "fusions",
            "optimize_seconds"} <= set(d)
    names = [e["name"] for e in tobs.tracer().to_dict()["traceEvents"]]
    assert "jit_trace" in names and "xla_compile" not in names
    assert tobs.metrics().histogram("dl4j_tpu_trace_seconds").count == 1
    (ev,) = tobs.ledger().events()
    assert ev.stats is st and ev.to_dict()["compile_seconds"] is None
