"""Updater parity of the PyTorch port against the JAX package (CPU).

For each of the 11 updater kinds, one ragged float32 leaf (37 elements,
drawn with numpy) goes through 3 steps with a learning-rate schedule, in
the port's generic ``fused_updater_step`` and in the JAX package's generic
op (``fused_updater_step.fn``) and its Pallas kernel in interpret mode
(``fused_updater_helper(..., interpret=True)``, as
``tests/test_fused_updater.py`` runs it).

Tolerance against JAX: 1e-5 relative + 1e-6 absolute, the JAX package's
own kernel-vs-generic bound — float32 on two compilers that may fuse
multiply-adds differently, over 3 steps.

The CUDA kernel itself runs only on the card; here its arithmetic is held
by an op-for-op transcription of ``csrc/fused_updater.cu``'s ``update_one``
into float32 torch ops (each rounds once, as __fmul_rn & co. do; torch's
own sqrt, since the CPU's vectorized sqrt is not always correctly
rounded), fed with :meth:`Updater.coefficients`: it must equal the plain
version bit for bit, except Nadam (the kernel multiplies by the reciprocal
of each bias correction, as torch's CUDA division by a host scalar does;
the CPU divides): 2 ulp.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import updater as jupd
from deeplearning4j_tpu.ops.pallas_updater import (
    fused_updater_helper, fused_updater_step as jax_step)
from deeplearning4j_tpu_torch.environment import environment
from deeplearning4j_tpu_torch.nn import updater as tupd
from deeplearning4j_tpu_torch.ops import cuda_updater as cu
from deeplearning4j_tpu_torch.ops import registry

KINDS = sorted(tupd.UPDATERS)
TOL = dict(rtol=1e-5, atol=1e-6)
N = 37  # ragged: not a multiple of 4, 8 or 128
SCHED = dict(value=2e-2, gamma=0.8)


def _state0(kind, r):
    """A non-trivial state point (zeros hide asymmetric-state bugs)."""
    keys = sorted(tupd.UPDATERS[kind]().init_state(torch.zeros(1)))
    return {k: (np.abs(r.randn(N)) * 0.1).astype(np.float32) for k in keys}


def _hyper(kind):
    """Non-default hyperparameters, so each one reaches the math."""
    return {"Nesterovs": dict(momentum=0.8), "AdaGrad": dict(epsilon=1e-5),
            "RmsProp": dict(rms_decay=0.9, epsilon=1e-6),
            "AdaDelta": dict(rho=0.9, epsilon=1e-5),
            "Adam": dict(beta1=0.85, beta2=0.99, epsilon=1e-6),
            "AdaMax": dict(beta1=0.85, beta2=0.99, epsilon=1e-6),
            "Nadam": dict(beta1=0.85, beta2=0.99, epsilon=1e-6),
            "AmsGrad": dict(beta1=0.85, beta2=0.99, epsilon=1e-6)
            }.get(kind, {})


@pytest.mark.parametrize("kind", KINDS)
def test_three_scheduled_steps_match_jax(kind):
    r = np.random.RandomState(KINDS.index(kind))
    p = r.randn(N).astype(np.float32)
    st = _state0(kind, r)
    keys = sorted(st)
    hyper = _hyper(kind)
    ju = jupd.UPDATERS[kind](
        learning_rate=jupd.ExponentialSchedule(**SCHED), **hyper)
    tu = tupd.UPDATERS[kind](
        learning_rate=tupd.ExponentialSchedule(**SCHED), **hyper)
    jp, jpl, tp = jnp.asarray(p), jnp.asarray(p), torch.from_numpy(p)
    js = [jnp.asarray(st[k]) for k in keys]
    jsl = list(js)
    ts = [torch.from_numpy(st[k]) for k in keys]
    for step in range(3):
        g = (r.randn(N) * 0.1).astype(np.float32)
        jlr, tlr = ju.lr(step), tu.lr(step)
        np.testing.assert_allclose(float(tlr), float(jlr), rtol=1e-6)
        out_j = jax_step.fn(jp, jnp.asarray(g), jlr, jnp.float32(step), *js,
                            kind=kind, **ju.fused_hyper())
        out_pl = fused_updater_helper(jpl, jnp.asarray(g), jlr,
                                      jnp.float32(step), *jsl, kind=kind,
                                      block_rows=8, interpret=True,
                                      **ju.fused_hyper())
        out_t = cu.fused_updater_step.fn(tp, torch.from_numpy(g), tlr, step,
                                         *ts, kind=kind, **tu.fused_hyper())
        for a, b, c in zip(out_t, out_j, out_pl):
            assert a.dtype == torch.float32 and a.shape == (N,)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
            np.testing.assert_allclose(a.numpy(), np.asarray(c), **TOL)
        jp, js = out_j[0], list(out_j[1:])
        jpl, jsl = out_pl[0], list(out_pl[1:])
        tp, ts = out_t[0], list(out_t[1:])


# --- the kernel's arithmetic, transcribed op for op ----------------

def _kernel_math(kind, c, p, g, s):
    """``update_one`` of csrc/fused_updater.cu, one float32 op per
    intrinsic; c as float32 scalars (ctypes.c_float rounding)."""
    c = [torch.tensor(v, dtype=torch.float32) for v in c]
    p, g = torch.from_numpy(p), torch.from_numpy(g)
    s = [torch.from_numpy(x) for x in s]
    sqrt = torch.sqrt
    if kind == "Sgd":
        u = c[0] * g
    elif kind == "NoOp":
        u = g
    elif kind == "Frozen":
        u = torch.zeros_like(g)
    elif kind == "Nesterovs":
        vp = c[0] * s[0]
        v = vp - c[1] * g
        u = vp - c[2] * v
        s[0] = v
    elif kind == "AdaGrad":
        h = s[0] + g * g
        u = (c[0] * g) / (sqrt(h) + c[1])
        s[0] = h
    elif kind == "RmsProp":
        g2 = c[0] * s[0] + (c[1] * g) * g
        u = (g * c[2]) / sqrt(g2 + c[3])
        s[0] = g2
    elif kind == "AdaDelta":
        msg = c[0] * s[1] + (c[1] * g) * g
        dx = (sqrt(s[0] + c[2]) / sqrt(msg + c[2])) * g
        s[0] = c[0] * s[0] + (c[1] * dx) * dx
        s[1] = msg
        u = dx
    elif kind in ("Adam", "AmsGrad"):
        m = c[0] * s[0] + c[1] * g
        v = c[2] * s[1] + (c[3] * g) * g
        den = v
        if kind == "AmsGrad":
            den = torch.maximum(s[2], v)
            s[2] = den
        u = (c[4] * m) / (sqrt(den) + c[5])
        s[0], s[1] = m, v
    elif kind == "AdaMax":
        m = c[0] * s[0] + c[1] * g
        uu = torch.maximum(c[2] * s[1], torch.abs(g))
        u = (c[3] * m) / (uu + c[4])
        s[0], s[1] = m, uu
    elif kind == "Nadam":
        m = c[0] * s[0] + c[1] * g
        v = c[2] * s[1] + (c[3] * g) * g
        inner = c[0] * (m * c[5]) + (c[1] * g) * c[5]
        u = (c[4] * inner) / (sqrt(v * c[6]) + c[7])
        s[0], s[1] = m, v
    return [(p - u).numpy()] + [x.numpy() for x in s]


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_arithmetic_matches_the_plain_version(kind):
    r = np.random.RandomState(100 + KINDS.index(kind))
    tu = tupd.UPDATERS[kind](**_hyper(kind))
    p = r.randn(N).astype(np.float32)
    g = (r.randn(N) * 0.1).astype(np.float32)
    st = _state0(kind, r)
    keys = sorted(st)
    lr, step = tu.lr(0) * 3.0, 4
    want = cu.fused_updater_step.fn(
        torch.from_numpy(p), torch.from_numpy(g), lr, step,
        *(torch.from_numpy(st[k]) for k in keys), kind=kind,
        **tu.fused_hyper())
    got = _kernel_math(kind, tu.coefficients(lr, step), p, g,
                       [st[k] for k in keys])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if kind == "Nadam":
            np.testing.assert_array_max_ulp(a, b.numpy(), maxulp=2)
        else:
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_reads_its_coefficient_buffer_and_writes_in_place(kind):
    """The kernel's calling convention: its coefficients come from the
    (8,) float32 buffer ``Updater.coefficients`` makes from the trainer's
    int32 step tensor (the kernel loads it once a block), and it writes
    the new parameter and state over the old ones (dst == src). The
    transcription, fed that buffer, and writing into the leaf's own
    arrays, equals the plain version at the same step tensor — bit for
    bit, Nadam within the 2 ulp of its reciprocals."""
    r = np.random.RandomState(300 + KINDS.index(kind))
    tu = tupd.UPDATERS[kind](
        learning_rate=tupd.ExponentialSchedule(**SCHED), **_hyper(kind))
    step = torch.tensor(5, dtype=torch.int32)
    lr = tu.lr(step)
    buf = tu.coefficients(lr, step)
    assert buf.shape == (8,) and buf.dtype == torch.float32
    p = r.randn(N).astype(np.float32)
    g = (r.randn(N) * 0.1).astype(np.float32)
    st = _state0(kind, r)
    keys = sorted(st)
    want = cu.fused_updater_step.fn(
        torch.from_numpy(p.copy()), torch.from_numpy(g), lr, step,
        *(torch.from_numpy(st[k].copy()) for k in keys), kind=kind,
        **tu.fused_hyper())
    dst = [p] + [st[k] for k in keys]
    new = _kernel_math(kind, list(buf.numpy()), p, g, dst[1:])
    for d, v in zip(dst, new):
        d[...] = v  # in place: the sources are the destinations
    assert dst[0] is p and all(d is st[k] for d, k in zip(dst[1:], keys))
    for a, b in zip(dst, want):
        if kind == "Nadam":
            np.testing.assert_array_max_ulp(a, b.numpy(), maxulp=2)
        else:
            np.testing.assert_array_equal(a, b.numpy())


def test_plain_version_rounds_low_precision_leaves_once():
    """A bfloat16 leaf is computed in float32 and each output rounded once
    to bfloat16 — what the kernel stores."""
    r = np.random.RandomState(7)
    p, g, v = (torch.from_numpy(r.randn(N).astype(np.float32)) for _ in "pgv")
    lr = torch.tensor(0.05)
    out16 = cu.fused_updater_step.fn(p.bfloat16(), g.bfloat16(), lr, 0,
                                     v.bfloat16(), kind="Nesterovs")
    out32 = cu.fused_updater_step.fn(p.bfloat16().float(), g.bfloat16().float(),
                                     lr, 0, v.bfloat16().float(),
                                     kind="Nesterovs")
    for a, b in zip(out16, out32):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.bfloat16())


@pytest.mark.parametrize("name", sorted(jupd._SCHEDULES))
def test_schedules_match_jax(name):
    kw = {"MapSchedule": dict(value=0.1, values=((2, 0.05), (5, 0.01)))}
    if name == "MapSchedule":
        js = jupd.MapSchedule(**kw[name])
        ts = tupd.MapSchedule(**kw[name])
    else:
        js = jupd._SCHEDULES[name]()
        ts = tupd._SCHEDULES[name]()
    for it in (0, 1, 3, 7, 600, 1234):
        np.testing.assert_allclose(float(ts(it)), float(js(it)), rtol=1e-6,
                                   atol=1e-9)


def test_updater_json_reads_the_jax_dict():
    ju = jupd.Adam(learning_rate=jupd.StepSchedule(value=0.1, decay_rate=0.5,
                                                   step=10.0), beta1=0.8)
    tu = tupd.Updater.from_dict(ju.to_dict())
    assert isinstance(tu, tupd.Adam) and tu.beta1 == 0.8
    assert isinstance(tu.learning_rate, tupd.StepSchedule)
    assert tu.to_dict() == ju.to_dict()
    assert float(tu.lr(25)) == pytest.approx(float(ju.lr(25)))


def test_apply_fused_on_cpu_runs_the_plain_version():
    """On CPU tensors the registry takes the generic impl; the kernel's
    counter does not move, and the gate refuses."""
    upd = tupd.Nesterovs(learning_rate=0.1)
    p, g = torch.randn(10), torch.randn(10)
    st = upd.init_state(p)
    before = cu.fused_updater.launches
    new_p, new_s = upd.apply_fused(p, g, st, upd.lr(0), 0)
    u, want_s = upd.apply(g, st, upd.lr(0), 0)
    assert torch.equal(new_p, p - u) and torch.equal(new_s["v"], want_s["v"])
    assert cu.fused_updater.launches == before
    assert not cu.fused_updater_usable(p, g, upd.lr(0), 0, st["v"],
                                       kind="Nesterovs", momentum=0.9)
    out = cu.fused_updater(p, g, upd.lr(0), 0, st["v"], kind="Nesterovs",
                           momentum=0.9)
    assert torch.equal(out[0], new_p)


def test_forced_kernel_on_cpu_raises():
    env = environment()
    old = env.helper_mode
    env.helper_mode = "kernel"
    try:
        with pytest.raises(RuntimeError, match="kernel"):
            registry().get("fused_updater_step")(
                torch.zeros(3), torch.zeros(3), 0.1, 0, kind="Sgd")
    finally:
        env.helper_mode = old


def test_wrong_state_count_is_refused():
    with pytest.raises(ValueError, match="state"):
        cu.fused_updater_step.fn(torch.zeros(3), torch.zeros(3), 0.1, 0,
                                 kind="Adam")


# --- the multi-tensor launch: plan and indexing, transcribed --------------
#
# csrc/fused_updater.cu's fused_updater_kernel in numpy: block b finds its
# leaf by binary search over the launch's chunk starts, updates the
# vectors [e0 / VEC, min(e0 / VEC + 256 * 4, n_vec)) of its chunk (thread
# t's i-th vector is v0 + i * 256 + t) and, one element a thread a
# stride, the chunk's elements past n_vec * VEC.

_THREADS, _ILP = 256, 4


def _block_elements(numels, n_vecs, starts, b, elem_size):
    """(leaf, element indices) that block ``b`` of a launch updates."""
    vec = 16 // elem_size
    chunk = cu.chunk_elements(elem_size)
    lo, hi = 0, len(numels) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if starts[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    n, n_vec = numels[lo], n_vecs[lo]
    e0 = (b - starts[lo]) * chunk
    v0 = e0 // vec
    v_end = min(v0 + _THREADS * _ILP, n_vec)
    v = (v0 + np.arange(_ILP)[:, None] * _THREADS
         + np.arange(_THREADS)[None, :]).ravel()
    v = v[v < v_end]
    vec_elems = (v[:, None] * vec + np.arange(vec)[None, :]).ravel()
    s_end = min(e0 + chunk, n)
    first = max(e0, n_vec * vec)
    per_thread = max(0, -(-(s_end - first) // _THREADS))
    e = (first + np.arange(_THREADS)[:, None]
         + _THREADS * np.arange(per_thread)[None, :]).ravel()
    return lo, np.concatenate([vec_elems, e[e < s_end]])


def _coverage(numels, ptr_offsets, elem_size):
    """Per leaf, how many times the planned launches update each element;
    and the launches' leaf counts."""
    counts = [np.zeros(n, np.int64) for n in numels]
    # leaf i's buffers at 4096-byte-aligned bases moved by ptr_offsets[i]
    n_vecs = [cu.vector_count(n, elem_size, [4096 * 7 + off] * 5)
              for n, off in zip(numels, ptr_offsets)]
    plan = cu.plan_launches(numels, elem_size)
    for idx, starts in plan:
        assert len(idx) <= cu.TABLE_LEAVES
        assert starts[0] == 0 and starts == sorted(starts)
        sub_n = [numels[i] for i in idx]
        sub_v = [n_vecs[i] for i in idx]
        for b in range(starts[-1]):
            leaf, elems = _block_elements(sub_n, sub_v, starts, b,
                                          elem_size)
            np.add.at(counts[idx[leaf]], elems, 1)
    return counts, [len(idx) for idx, _ in plan], n_vecs


@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("numels,offsets", [
    ([1, 7, 8, 4097, 2048000], [0] * 5),
    ([4097, 2048000, 9], [4, 2, 0]),                 # offset views
    ([0, 3, 16384, 16385, 8191, 0, 1000], [0, 0, 0, 0, 0, 0, 8]),
])
def test_multi_tensor_plan_covers_every_element_once(numels, offsets,
                                                     elem_size):
    counts, per_launch, n_vecs = _coverage(numels, offsets, elem_size)
    for n, c, off, nv in zip(numels, counts, offsets, n_vecs):
        assert (c == 1).all(), (n, off, np.unique(c))
        # an offset leaf takes the scalar path whole; an aligned one its
        # vectors and the ragged tail
        assert nv == (0 if off % 16 else n // (16 // elem_size))
    assert per_launch == [sum(n > 0 for n in numels)]


def test_multi_tensor_plan_splits_a_group_larger_than_one_table():
    numels = [((i * 7919) % 5000) + 1 for i in range(cu.TABLE_LEAVES + 45)]
    for elem_size, offset in ((4, 0), (2, 4)):
        counts, per_launch, _ = _coverage(numels, [offset] * len(numels),
                                          elem_size)
        assert all((c == 1).all() for c in counts)
        assert per_launch == [cu.TABLE_LEAVES, 45]


def test_flat_outputs_start_every_leaf_on_16_bytes():
    shapes = [(3,), (7, 5), (1,), (2, 2, 2), (4097,)]
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        outs = cu._flat_outputs(shapes, dtype, torch.device("cpu"), 3)
        one = cu._flat_outputs(shapes[1:2], dtype, torch.device("cpu"), 2)
        assert [v[0].shape for v in one] == [(7, 5)] * 2
        assert len(outs) == 3
        for views in outs:
            base = views[0].data_ptr()
            for v, s in zip(views, shapes):
                assert v.shape == s and v.dtype == dtype
                assert (v.data_ptr() - base) % 16 == 0
            assert len({v.untyped_storage().data_ptr() for v in views}) == 1


def _tree(kind, dtype, seed, sizes=(1, 7, 8, 37, 300)):
    r = np.random.RandomState(seed)
    keys = sorted(tupd.UPDATERS[kind]().init_state(torch.zeros(1)))
    ps = [torch.from_numpy(r.randn(n).astype(np.float32)).to(dtype)
          for n in sizes]
    gs = [torch.from_numpy((r.randn(n) * 0.1).astype(np.float32)).to(dtype)
          for n in sizes]
    ss = [{k: torch.from_numpy((np.abs(r.randn(n)) * 0.1).astype(
        np.float32)).to(dtype) for k in keys} for n in sizes]
    return ps, gs, ss


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_apply_fused_many_equals_apply_fused_per_leaf(kind, dtype):
    tu = tupd.UPDATERS[kind](**_hyper(kind))
    ps, gs, ss = _tree(kind, dtype, 200 + KINDS.index(kind))
    lr = tu.lr(0) * 3.0
    launches = cu.fused_updater.launches
    new_p, new_s = tu.apply_fused_many(ps, gs, ss, lr, 4)
    assert cu.fused_updater.launches == launches  # CPU: the plain version
    for p, g, s, np_, ns in zip(ps, gs, ss, new_p, new_s):
        want_p, want_s = tu.apply_fused(p, g, s, lr, 4)
        assert np_.dtype == dtype and torch.equal(np_, want_p)
        assert sorted(ns) == sorted(want_s)
        for k in ns:
            assert torch.equal(ns[k], want_s[k])


@pytest.mark.parametrize("kind", KINDS)
def test_apply_fused_many_three_scheduled_steps_match_jax(kind):
    """A small tree through apply_fused_many, three steps of an
    exponential schedule, against the JAX generic op and the Pallas kernel
    in interpret mode leaf by leaf."""
    hyper = _hyper(kind)
    tu = tupd.UPDATERS[kind](
        learning_rate=tupd.ExponentialSchedule(**SCHED), **hyper)
    ju = jupd.UPDATERS[kind](
        learning_rate=jupd.ExponentialSchedule(**SCHED), **hyper)
    ps, _, ss = _tree(kind, torch.float32, 300 + KINDS.index(kind),
                      sizes=(5, 37, 130))
    keys = sorted(ss[0])
    jp = [jnp.asarray(p.numpy()) for p in ps]
    js = [[jnp.asarray(s[k].numpy()) for k in keys] for s in ss]
    jpl, jsl = list(jp), [list(s) for s in js]
    r = np.random.RandomState(KINDS.index(kind))
    for step in range(3):
        gs = [(r.randn(p.numel()) * 0.1).astype(np.float32) for p in ps]
        ps, ss = tu.apply_fused_many(ps, [torch.from_numpy(g) for g in gs],
                                     ss, tu.lr(step), step)
        jlr = ju.lr(step)
        for i, g in enumerate(gs):
            out_j = jax_step.fn(jp[i], jnp.asarray(g), jlr, jnp.float32(step),
                                *js[i], kind=kind, **ju.fused_hyper())
            out_pl = fused_updater_helper(
                jpl[i], jnp.asarray(g), jlr, jnp.float32(step), *jsl[i],
                kind=kind, block_rows=8, interpret=True, **ju.fused_hyper())
            jp[i], js[i] = out_j[0], list(out_j[1:])
            jpl[i], jsl[i] = out_pl[0], list(out_pl[1:])
            got = [ps[i]] + [ss[i][k] for k in keys]
            for a, b, c in zip(got, out_j, out_pl):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
                np.testing.assert_allclose(a.numpy(), np.asarray(c), **TOL)


def test_apply_fused_many_keeps_a_subclass_override():
    """A user subclass overriding apply keeps its per-leaf path."""

    class Halved(tupd.Sgd):
        def apply(self, grad, state, lr, step):
            return 0.5 * lr * grad, state

    upd = Halved(learning_rate=0.2)
    ps, gs, ss = _tree("Sgd", torch.float32, 9)
    new_p, new_s = upd.apply_fused_many(ps, gs, ss, upd.lr(0), 0)
    for p, g, np_ in zip(ps, gs, new_p):
        assert torch.equal(np_, p - 0.5 * upd.lr(0) * g)
    assert new_s == ss
