"""Compiled training of the PyTorch port against the JAX package (CPU).

The training steps of both networks, BERT and SameDiff are training units
(``nn/compiled.py``): CUDA-graph captures on the card, the same functions
run eagerly here. What the CPU can hold:

* ``fit_scanned`` of a small ``MultiLayerNetwork`` and of a two-input,
  two-output ``ComputationGraph`` in both modes (``steps`` given: one
  batch repeated; ``steps`` None: a leading per-step axis), under Adam
  with an ``ExponentialSchedule``, l2 and weight decay, against the JAX
  ``fit_scanned`` (parameters drawn by the JAX package and carried across,
  inputs drawn with numpy): losses and parameters within 1e-5 relative +
  1e-6 absolute, the updater state within 1e-5 relative + 1e-5 of each
  state kind's largest magnitude (at most 1e-6) absolute — float32 on two
  compilers that sum in other orders, over 4 steps;
  ``BertModel.fit_mlm_scanned`` of a tiny BERT at dropout 0 against the
  JAX method within the same bounds, and its ``step``; listeners after
  the chunk with the JAX iteration numbers; masks refused;
* the learning rate, every schedule and every kind's coefficient buffer
  computed from an int32 step tensor, bit for bit against the host floats
  of the earlier calling convention, at steps 0, 1, 7 and 1000;
* the in-place plain updater bit for bit against the out-of-place one,
  and each trainer's donated step (the card's in-place path, forced here)
  bit for bit against its rebinding step;
* no host read in any step function: each unit run under a
  ``TorchDispatchMode`` that fails on ``aten::_local_scalar_dense`` with
  ``Tensor.cpu`` / ``tolist`` / ``numpy`` / ``item`` refused; the masked
  LSTM step is routed to eager by its rule and counted;
* the small-table gather ``nn_ops.table_rows`` (BERT's token types,
  SameDiff's ``gather``): the rows themselves, the ``index_add_``
  gradient, taken as the one-hot GEMM up to ``ONE_HOT_ROWS`` rows.
"""

import contextlib

import numpy as np
import pytest

import jax
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu.nn import updater as jupd
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.models import graph_state_from_numpy
from deeplearning4j_tpu_torch.models._tree import leaf_paths
from deeplearning4j_tpu_torch.nn import compiled
from deeplearning4j_tpu_torch.nn import graph as tgraph
from deeplearning4j_tpu_torch.nn import updater as tupd
from deeplearning4j_tpu_torch.ops import cuda_updater as cu

TOL = dict(rtol=1e-5, atol=1e-6)
SCHED = dict(value=1e-2, gamma=0.9)
STEPS = 4


def _host(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _np(t):
    return t.detach().float().cpu().numpy()


def _assert_close(jtree, ttree, what, *, state=False):
    """Every leaf of the port's tree within TOL of the JAX tree's. An
    updater ``state`` tree (a state dict at each parameter leaf) is held
    to its own scale: each state kind (Adam's ``m``, ``v``) within 1e-5
    relative plus 1e-5 of that kind's largest magnitude across the tree,
    at most TOL's 1e-6 absolute — ``v`` after a few steps is ~1e-6, which
    a fixed 1e-6 would not hold at all."""
    jl = jax.tree_util.tree_leaves_with_path(_host(jtree))
    tl = jax.tree.leaves(jax.tree.map(_np, ttree))
    assert len(jl) == len(tl), what
    scale = {}
    if state:
        for path, j in jl:
            kind = str(path[-1])
            scale[kind] = max(scale.get(kind, 0.0),
                              float(np.abs(j).max()) if j.size else 0.0)
    for (path, j), t in zip(jl, tl):
        atol = (min(TOL["atol"], 1e-5 * scale[str(path[-1])]) if state
                else TOL["atol"])
        np.testing.assert_allclose(t, j, rtol=TOL["rtol"], atol=atol,
                                   err_msg=f"{what} {path}")


def _updater(pkg):
    mod = jupd if pkg is jnn else tupd
    return mod.Adam(learning_rate=mod.ExponentialSchedule(**SCHED))


def _mln_conf(pkg):
    return (pkg.builder().seed(3).updater(_updater(pkg)).l2(1e-3)
            .weight_decay(1e-2).weight_init("xavier").list()
            .layer(pkg.DenseLayer(n_out=16, activation="tanh"))
            .layer(pkg.DenseLayer(n_out=12, activation="relu"))
            .layer(pkg.OutputLayer(n_out=4, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(8)).build())


def _mln_pair():
    jnet = jnn.MultiLayerNetwork(_mln_conf(jnn)).init()
    tnet = tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init(params=_host(jnet.params))
    return jnet, tnet


def _data(shape_x, classes, seed, lead=()):
    r = np.random.RandomState(seed)
    x = r.randn(*lead, *shape_x).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[r.randint(0, classes,
                                                    lead + shape_x[:1])]
    return x, y


@pytest.mark.parametrize("per_step", [True, False], ids=["rows", "steps"])
def test_mln_fit_scanned_matches_jax(per_step):
    jnet, tnet = _mln_pair()
    if per_step:
        x, y = _data((10, 8), 4, 1, lead=(STEPS,))
        kw = {}
    else:
        x, y = _data((10, 8), 4, 1)
        kw = dict(steps=STEPS)
    lj = jnet.fit_scanned(x, y, **kw)
    observe.reset()
    lt = tnet.fit_scanned(x, y, **kw)
    np.testing.assert_allclose(lt, lj, **TOL)
    _assert_close(jnet.params, tnet.params, "params")
    _assert_close(jnet.opt_state, tnet.opt_state, "updater state",
                  state=True)
    assert tnet.iteration_count == jnet.iteration_count == STEPS
    assert [(e.graph, e.key, e.cause) for e in observe.ledger().events()] \
        == [("mln", "fit_scanned", "first_compile")]
    # a second chunk continues the schedule from the device iteration
    np.testing.assert_allclose(tnet.fit_scanned(x, y, **kw),
                               jnet.fit_scanned(x, y, **kw), **TOL)
    _assert_close(jnet.params, tnet.params, "params after two chunks")


def test_fit_scanned_equals_as_many_fit_steps():
    """Step k of the scan is ``fit`` on batch k, bit for bit."""
    _, a = _mln_pair()
    _, b = _mln_pair()
    x, y = _data((10, 8), 4, 2, lead=(STEPS,))
    scanned = a.fit_scanned(x, y)
    stepped = []
    for k in range(STEPS):
        b.fit(x[k], y[k], batch_size=10)
        stepped.append(b.score())
    np.testing.assert_array_equal(scanned, np.asarray(stepped, np.float32))
    for (_, p), (_, q) in zip(leaf_paths(a.params), leaf_paths(b.params)):
        assert torch.equal(p, q)


def test_fit_scanned_listeners_after_the_chunk():
    """Listeners fire after the chunk, once a step, iteration-major, with
    the JAX package's iteration numbers and each step's loss."""

    from deeplearning4j_tpu.nn.listeners import TrainingListener as JL
    from deeplearning4j_tpu_torch.nn.listeners import TrainingListener as TL

    def log(base, tag, out):
        class Log(base):
            def iteration_done(self, model, iteration, epoch, score):
                out.append((tag, iteration, epoch, float(score)))
        return Log()

    jnet, tnet = _mln_pair()
    x, y = _data((10, 8), 4, 3)
    seen = {"jax": [], "port": []}
    jnet.set_listeners(log(JL, "a", seen["jax"]), log(JL, "b", seen["jax"]))
    tnet.set_listeners(log(TL, "a", seen["port"]),
                       log(TL, "b", seen["port"]))
    jnet.fit(x, y, batch_size=10)
    tnet.fit(x, y, batch_size=10)
    del seen["jax"][:], seen["port"][:]
    lj = jnet.fit_scanned(x, y, steps=3)
    lt = tnet.fit_scanned(x, y, steps=3)
    assert [e[:3] for e in seen["port"]] == [e[:3] for e in seen["jax"]] \
        == [(t, i, 1) for i in (2, 3, 4) for t in "ab"]
    assert [e[3] for e in seen["port"]] == [float(v) for v in lt for _ in
                                            "ab"]
    np.testing.assert_allclose([e[3] for e in seen["port"]],
                               [e[3] for e in seen["jax"]], **TOL)
    assert len(lj) == len(lt) == 3


def test_fit_scanned_refuses_masks():
    _, tnet = _mln_pair()
    x, y = _data((10, 8), 4, 4)
    with pytest.raises(ValueError, match="no masks"):
        tnet.fit_scanned(x, y, steps=2,
                         features_mask=np.ones((10, 1), np.float32))
    assert tnet.iteration_count == 0


def _graph_json():
    b = (jgraph.graph_builder().seed(5).updater(_updater(jnn)).l2(1e-3)
         .weight_decay(1e-2).weight_init("xavier").add_inputs("a", "b")
         .set_input_types(a=jnn.InputType.feed_forward(6),
                          b=jnn.InputType.feed_forward(5)))
    b.add_layer("da", jnn.DenseLayer(n_out=8, activation="tanh"), "a")
    b.add_layer("db", jnn.DenseLayer(n_out=8, activation="relu"), "b")
    b.add_vertex("m", jgraph.MergeVertex(), "da", "db")
    b.add_layer("h", jnn.DenseLayer(n_out=10, activation="tanh"), "m")
    b.add_layer("o1", jnn.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"), "h")
    b.add_layer("o2", jnn.OutputLayer(n_out=2, activation="identity",
                                      loss="mse"), "h")
    b.set_outputs("o1", "o2")
    return b.build().to_json()


def _graph_pair():
    text = _graph_json()
    jnet = jgraph.ComputationGraph(
        jgraph.ComputationGraphConfiguration.from_json(text)).init()
    tnet = tgraph.ComputationGraph(
        tgraph.ComputationGraphConfiguration.from_json(text), device="cpu")
    tnet.params, tnet.net_state, tnet.opt_state = graph_state_from_numpy(
        _host(jnet.params), _host(jnet.net_state), _host(jnet.opt_state),
        device="cpu")
    return jnet, tnet


def _graph_data(seed, lead=()):
    r = np.random.RandomState(seed)
    n = 7
    feats = {"a": r.randn(*lead, n, 6).astype(np.float32),
             "b": r.randn(*lead, n, 5).astype(np.float32)}
    labels = {"o1": np.eye(3, dtype=np.float32)[r.randint(0, 3, lead + (n,))],
              "o2": r.randn(*lead, n, 2).astype(np.float32)}
    return feats, labels


@pytest.mark.parametrize("per_step", [True, False], ids=["rows", "steps"])
def test_graph_fit_scanned_two_inputs_two_outputs_matches_jax(per_step):
    jnet, tnet = _graph_pair()
    feats, labels = _graph_data(6, lead=(STEPS,) if per_step else ())
    kw = {} if per_step else dict(steps=STEPS)
    lj = jnet.fit_scanned(feats, labels, **kw)
    lt = tnet.fit_scanned(feats, labels, **kw)
    np.testing.assert_allclose(lt, lj, **TOL)
    _assert_close(jnet.params, tnet.params, "params")
    _assert_close(jnet.opt_state, tnet.opt_state, "updater state",
                  state=True)
    assert tnet.iteration_count == jnet.iteration_count == STEPS


def _bert_pair():
    cfg = dict(vocab_size=64, hidden=32, layers=2, heads=2, intermediate=64,
               max_position=32, dropout=0.0)
    jm = jbert.BertModel(jbert.BertConfig.tiny(**cfg), seed=0)
    tm = tbert.BertModel(tbert.BertConfig.tiny(**cfg), seed=0, device="cpu")
    tm.params = tbert.bert_params_from_numpy(_host(jm.params), "cpu")
    tm.opt_state = tbert.bert_opt_state_from_numpy(_host(jm.opt_state),
                                                   "cpu")
    return jm, tm


def _mlm_batch(seed=0, n=3, t=16, vocab=64):
    r = np.random.RandomState(seed)
    mask = np.ones((n, t), np.int32)
    mask[1, 11:] = 0
    return {"ids": r.randint(0, vocab, (n, t)).astype(np.int32),
            "segments": np.zeros((n, t), np.int32), "mask": mask,
            "mlm_labels": r.randint(0, vocab, (n, t)).astype(np.int32),
            "mlm_mask": (r.rand(n, t) < 0.3).astype(np.float32)}


def test_bert_fit_mlm_scanned_matches_jax():
    jm, tm = _bert_pair()
    b = _mlm_batch()
    lj = jm.fit_mlm_scanned(b, 3)
    lt = tm.fit_mlm_scanned(b, 3)
    np.testing.assert_allclose(lt, lj, **TOL)
    _assert_close(jm.params, tm.params, "params")
    _assert_close(jm.opt_state, tm.opt_state, "adam", state=True)
    assert tm.step == jm.step == 3
    tm.fit_mlm_scanned(b, 2)
    assert tm.step == 5


# --- the updater's scalars on the device ------------------------------------

SCHEDULES = [
    tupd.Schedule(value=3e-3),
    tupd.StepSchedule(value=0.1, decay_rate=0.5, step=3.0),
    tupd.ExponentialSchedule(value=0.05, gamma=0.97),
    tupd.InverseSchedule(value=0.1, gamma=0.2, power=1.5),
    tupd.PolySchedule(value=0.1, power=2.0, max_iter=500),
    tupd.SigmoidSchedule(value=0.1, gamma=0.05, step_size=5),
    tupd.CycleSchedule(initial_lr=1e-3, max_lr=1e-1, cycle_length=20,
                       annealing_length=4, annealing_decay=0.2),
    tupd.MapSchedule(value=0.1, values=((1, 0.05), (7, 0.01))),
]
AT = (0, 1, 7, 1000)


def _f32(v):
    return float(np.float32(v))


def _host_coefficients(u, step: int):
    """The kernel's coefficients as host floats, the earlier calling
    convention: ``float()`` of the updater math at a Python int step,
    the reciprocals by numpy."""
    lr = u.lr(step)
    f = float(lr)

    def recip(x):
        return float(np.float32(1.0) / np.float32(float(x)))

    kind = type(u).__name__
    if kind == "Sgd":
        c = [f]
    elif kind in ("NoOp", "Frozen"):
        c = []
    elif kind == "Nesterovs":
        c = [u.momentum, f, 1 + u.momentum]
    elif kind == "AdaGrad":
        c = [f, u.epsilon]
    elif kind == "RmsProp":
        c = [u.rms_decay, 1 - u.rms_decay, f, u.epsilon]
    elif kind == "AdaDelta":
        c = [u.rho, 1 - u.rho, u.epsilon]
    elif kind in ("Adam", "AmsGrad"):
        c = [u.beta1, 1 - u.beta1, u.beta2, 1 - u.beta2,
             float(u._alpha(lr, step)), u.epsilon]
    elif kind == "AdaMax":
        c = [u.beta1, 1 - u.beta1, u.beta2, float(u._scale(lr, step)),
             u.epsilon]
    else:  # Nadam
        bc1, bc2 = u._corrections(step)
        c = [u.beta1, 1 - u.beta1, u.beta2, 1 - u.beta2, f, recip(bc1),
             recip(bc2), u.epsilon]
    return np.asarray([_f32(v) for v in c] + [0.0] * (8 - len(c)),
                      np.float32)


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: type(s).__name__)
def test_schedules_from_a_step_tensor_equal_the_host_floats(sched):
    for step in AT:
        t = sched(torch.tensor(step, dtype=torch.int32))
        assert t.dtype == torch.float32 and t.ndim == 0
        assert t.numpy().tobytes() == np.float32(float(sched(step))).tobytes()


@pytest.mark.parametrize("kind", sorted(tupd.UPDATERS))
def test_coefficients_from_a_step_tensor_equal_the_host_floats(kind):
    for sched in (2e-3, tupd.ExponentialSchedule(value=0.05, gamma=0.97),
                  tupd.CycleSchedule(initial_lr=1e-3, max_lr=1e-1,
                                     cycle_length=20, annealing_length=4)):
        cls = tupd.UPDATERS[kind]
        u = cls(learning_rate=sched) if kind != "AdaDelta" else cls()
        for step in AT:
            it = torch.tensor(step, dtype=torch.int32)
            lr = u.lr(it)
            assert lr.numpy().tobytes() == np.float32(
                float(u.lr(step))).tobytes()
            buf = u.coefficients(lr, it)
            assert buf.shape == (8,) and buf.dtype == torch.float32
            np.testing.assert_array_equal(buf.numpy(),
                                          _host_coefficients(u, step))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(tupd.UPDATERS))
def test_inplace_plain_updater_equals_out_of_place(kind, dtype):
    r = np.random.RandomState(len(kind))
    u = tupd.UPDATERS[kind]()
    sizes = (1, 7, 37)

    def tree():
        ps = [torch.from_numpy(r.randn(n).astype(np.float32)).to(dtype)
              for n in sizes]
        ss = [{k: torch.from_numpy(np.abs(r.randn(n)).astype(
            np.float32)).to(dtype) * 0.1 for k in sorted(u.init_state(p))}
              for n, p in zip(sizes, ps)]
        return ps, ss

    ps, ss = tree()
    gs = [torch.from_numpy(r.randn(n).astype(np.float32)).to(dtype)
          for n in sizes]
    step = torch.tensor(3, dtype=torch.int32)
    lr = u.lr(step) * 2.0
    want_p, want_s = u.apply_fused_many(ps, gs, ss, lr, step)
    ptrs = [p.data_ptr() for p in ps]
    got_p, got_s = u.apply_fused_many(ps, gs, ss, lr, step, inplace=True)
    assert [p.data_ptr() for p in got_p] == ptrs
    assert all(a is b for a, b in zip(got_p, ps))
    for a, b in zip(got_p, want_p):
        assert torch.equal(a, b)
    for a, b, s in zip(got_s, want_s, ss):
        assert a is s and sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k])
    # the kernel's wrapper on the CPU: the plain version, written in place
    p2, s2 = tree()
    out = cu.fused_updater_multi(
        p2, gs, [tuple(s[k] for k in sorted(s)) for s in s2], lr, step,
        kind=kind, inplace=True)
    for (np_, *ns), p, s in zip(out, p2, s2):
        assert np_ is p and all(x is s[k] for x, k in zip(ns, sorted(s)))


# --- the donated (in-place) step equals the rebinding step -------------------


@pytest.fixture
def donate(monkeypatch):
    """Force the card's in-place step on the CPU."""
    def force():
        for mod in (compiled, tnn.multilayer, tgraph, tbert):
            monkeypatch.setattr(mod, "donates", lambda device: True)
    return force


def _state_of(net):
    return [_np(t) for t in compiled.tensors_of(net.params, net.opt_state,
                                                net.net_state)]


def test_donated_mln_step_equals_the_rebinding_step(donate):
    """l2, weight decay (of the weight before the step), batch-norm state
    and the device iteration through the in-place path."""
    conf = (tnn.builder().seed(2).updater(_updater(tnn)).l2(1e-3)
            .weight_decay(1e-2).list()
            .layer(tnn.DenseLayer(n_out=12, activation="relu"))
            .layer(tnn.BatchNormalization())
            .layer(tnn.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(tnn.InputType.feed_forward(5)).build())
    x, y = _data((9, 5), 3, 8, lead=(3,))
    rebinding = tnn.MultiLayerNetwork(conf, device="cpu").init()
    losses_a = [rebinding.fit_scanned(x, y)]
    donate()
    donated = tnn.MultiLayerNetwork(conf, device="cpu").init()
    leaves = compiled.tensors_of(donated.params, donated.opt_state,
                                 donated.net_state)
    losses_b = [donated.fit_scanned(x, y)]
    for k in range(3):
        rebinding.fit(x[k], y[k], batch_size=9)
        donated.fit(x[k], y[k], batch_size=9)
    np.testing.assert_array_equal(losses_a, losses_b)
    assert float(rebinding.score()) == float(donated.score())
    for a, b in zip(_state_of(rebinding), _state_of(donated)):
        np.testing.assert_array_equal(a, b)
    after = compiled.tensors_of(donated.params, donated.opt_state,
                                donated.net_state)
    assert all(a is b for a, b in zip(after, leaves))
    assert int(donated._steps.iteration.tensor) == donated.iteration_count


def test_donated_graph_and_bert_steps_equal_the_rebinding_steps(donate):
    feats, labels = _graph_data(9, lead=(3,))
    _, ga = _graph_pair()
    la = ga.fit_scanned(feats, labels)
    _, tm_a = _bert_pair()
    b = _mlm_batch(1)
    ba = tm_a.fit_mlm_scanned(b, 2)
    donate()
    _, gb = _graph_pair()
    lb = gb.fit_scanned(feats, labels)
    _, tm_b = _bert_pair()
    bb = tm_b.fit_mlm_scanned(b, 2)
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(ba, bb)
    for x, y in zip(_state_of(ga), _state_of(gb)):
        np.testing.assert_array_equal(x, y)
    for (_, x), (_, y) in zip(leaf_paths(tm_a.params),
                              leaf_paths(tm_b.params)):
        assert torch.equal(x, y)


def test_every_unit_key_is_hashable(monkeypatch):
    """On the card a unit keys its graphs by a signature holding the
    step's ``key`` and ``layout``; here every step still hands the unit a
    key, which must hash (a list in it fails only on the card)."""
    from deeplearning4j_tpu_torch.ops.capture import CapturedUnit

    keys = []
    real = CapturedUnit.__call__

    def call(self, *args, key=(), **kw):
        keys.append(hash(key))
        return real(self, *args, key=key, **kw)

    monkeypatch.setattr(CapturedUnit, "__call__", call)
    _, mln = _mln_pair()
    x, y = _data((10, 8), 4, 6, lead=(2,))
    mln.fit(x[0], y[0], batch_size=10)
    mln.fit_scanned(x, y)
    mln.fit_scanned(x[0], y[0], steps=2)
    _, graph = _graph_pair()
    feats, labels = _graph_data(8, lead=(2,))
    graph.fit_multi({k: v[0] for k, v in feats.items()},
                    {k: v[0] for k, v in labels.items()})
    graph.fit_scanned(feats, labels)
    graph.fit_scanned({k: v[0] for k, v in feats.items()},
                      {k: v[0] for k, v in labels.items()}, steps=2)
    _, bert = _bert_pair()
    bert.fit_mlm([_mlm_batch(3)])
    bert.fit_mlm_scanned(_mlm_batch(3), 2)
    assert len(keys) == 1 + 4 + 1 + 4 + 1 + 2


# --- the small-table gather ------------------------------------------------


@pytest.mark.parametrize("rows", [2, 512, 513])
def test_table_rows_gradient_is_the_one_hot_gemm(rows):
    """``nn_ops.table_rows``: the rows themselves, and the gradient of
    ``index_add_`` within float32 summation error; a table of at most
    ``ONE_HOT_ROWS`` rows takes it as the one-hot GEMM (its backward is
    ``_TableRows``'), with no host read, a larger one through
    ``F.embedding``."""
    from deeplearning4j_tpu_torch.ops import nn_ops

    r = np.random.RandomState(rows)
    table = torch.from_numpy(r.randn(rows, 16).astype(np.float32))
    ids = torch.from_numpy(r.randint(0, min(rows, 3), (8, 40)))
    grad = torch.from_numpy(r.randn(8, 40, 16).astype(np.float32))
    t = table.clone().requires_grad_(True)
    out = nn_ops.table_rows(t, ids)
    assert torch.equal(out, table[ids])
    small = rows <= nn_ops.ONE_HOT_ROWS
    assert (type(out.grad_fn).__name__ == "_TableRowsBackward") == small
    with _NoHostRead():
        out.backward(grad)
    want = torch.zeros_like(table).index_add_(0, ids.reshape(-1),
                                              grad.reshape(-1, 16))
    np.testing.assert_allclose(t.grad.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)
    with torch.no_grad():
        assert nn_ops.table_rows(t, ids).grad_fn is None


# --- no host read inside a step ----------------------------------------------


class _NoHostRead(TorchDispatchMode):
    """Fails on ``aten::_local_scalar_dense`` (``item``, ``float()``,
    ``int()``, ``bool()`` of a tensor): a device-to-host read on the
    card, which a captured graph cannot hold."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("host read inside a step: "
                                 "aten::_local_scalar_dense")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_read(monkeypatch):
    """Inside the block every unit body of ``compiled.TrainUnits.run``
    runs under :class:`_NoHostRead` with ``Tensor.cpu``, ``tolist``,
    ``numpy`` and ``item`` refused."""
    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"host read inside a step: Tensor.{name}")
        return f

    real_run = compiled.TrainUnits.run
    bodies = []

    def run(self, key, body, args, **kw):
        def guarded(*a):
            with monkeypatch.context() as m:
                for name in ("cpu", "tolist", "numpy", "item"):
                    m.setattr(torch.Tensor, name, refuse(name))
                with _NoHostRead():
                    out = body(*a)
            bodies.append(key)
            return out
        return real_run(self, key, guarded, args, **kw)

    monkeypatch.setattr(compiled.TrainUnits, "run", run)
    yield bodies
    monkeypatch.setattr(compiled.TrainUnits, "run", real_run)


def test_mln_units_make_no_host_read(monkeypatch):
    _, tnet = _mln_pair()
    x, y = _data((10, 8), 4, 5, lead=(2,))
    with no_host_read(monkeypatch) as bodies:
        tnet.fit(x[0], y[0], batch_size=10)
        tnet.fit_scanned(x, y)
        tnet.fit_scanned(x[0], y[0], steps=2)
    assert bodies == ["train", "fit_scanned", "fit_scanned", "fit_scanned",
                      "fit_scanned"]


def test_tbptt_units_make_no_host_read(monkeypatch):
    from deeplearning4j_tpu_torch.testing import sequential as S

    ds = S.char_batch(2, 12, 7)
    mln = tnn.MultiLayerNetwork(S.char_conf(7, 8, 5), device="cpu").init()
    graph = tgraph.ComputationGraph(S.char_graph_conf(7, 8, 5),
                                    device="cpu").init()
    with no_host_read(monkeypatch) as bodies:
        mln.fit(ds, batch_size=2)
        graph.fit(ds, batch_size=2)
    assert bodies == ["train_tbptt"] * 6


def test_graph_units_make_no_host_read(monkeypatch):
    _, tnet = _graph_pair()
    feats, labels = _graph_data(7, lead=(2,))
    with no_host_read(monkeypatch) as bodies:
        tnet.fit_multi({k: v[0] for k, v in feats.items()},
                       {k: v[0] for k, v in labels.items()})
        tnet.fit_scanned(feats, labels)
    assert bodies == ["train", "fit_scanned", "fit_scanned"]


def test_bert_units_make_no_host_read(monkeypatch):
    _, tm = _bert_pair()
    tm.cfg = tbert.BertConfig.tiny(vocab_size=64, hidden=32, layers=2,
                                   heads=2, intermediate=64, max_position=32,
                                   dropout=0.1)
    b = _mlm_batch(2)
    cls = dict(b, labels=np.eye(2, dtype=np.float32)[[0, 1, 1]])
    with no_host_read(monkeypatch) as bodies:
        tm.fit_classifier([cls])
        tm.fit_mlm([b])
        tm.fit_mlm_scanned(b, 2)
    assert bodies == ["cls", "mlm", "mlm", "mlm"]


def test_samediff_units_make_no_host_read(monkeypatch):
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig

    r = np.random.RandomState(0)
    sd = SameDiff(device="cpu")
    x = sd.placeholder("x", (4, 6))
    lab = sd.placeholder("y", (4, 3))
    w = sd.var("w", (r.randn(6, 3) * 0.1).astype(np.float32))
    bias = sd.var("b", np.zeros(3, np.float32))
    logits = sd.nn.gelu(x @ w + bias)
    sd.loss.softmax_cross_entropy(logits, lab).rename("loss")
    sd.set_training_config(TrainingConfig(
        updater=_updater(tnn), l2=1e-3, weight_decay=1e-2,
        data_set_feature_mapping=["x"], data_set_label_mapping=["y"],
        loss_variables=["loss"]))
    feats = r.randn(4, 6).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[[0, 2, 1, 0]]
    from deeplearning4j_tpu_torch.datasets import DataSet

    with no_host_read(monkeypatch) as bodies:
        sd.fit(DataSet(feats, labels), epochs=2)
        sd.calculate_gradients({"x": feats, "y": labels}, "loss")
    assert bodies == ["train", "train", "grad"]


def test_masked_lstm_step_is_routed_and_counted(monkeypatch):
    """A features mask fed to a network with an LSTM: routed to eager by
    the rule (the body may read the host), recorded once in the ledger,
    counted every step; an unmasked step of the same network is a
    unit."""
    from deeplearning4j_tpu_torch.testing import sequential as S

    net = tnn.MultiLayerNetwork(S.tagger_conf(6, 5, 4), device="cpu").init()
    batches, _ = S.tagger_batches(3, 10, 4, 6, 4, 2)
    observe.reset()
    for ds in batches:
        net.fit(ds, batch_size=3)
    routed = observe.ledger().routed_events()
    assert [(e.graph, e.key, e.reason) for e in routed] == [
        ("mln", "train", compiled.MASKED_LSTM)]
    skipped = observe.metrics().counter(
        "dl4j_tpu_capture_skipped_total", unit="train",
        reason=compiled.MASKED_LSTM)
    assert skipped.value == 2
    with no_host_read(monkeypatch) as bodies:
        ds = batches[0]
        net.fit(ds.features, ds.labels, batch_size=3)
    assert bodies == ["train"] and skipped.value == 2
    assert compiled.mask_routing(net.layers, (None,)) is None
