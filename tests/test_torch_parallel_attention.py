"""The port's sequence and pipeline parallelism against the JAX package's:
ring attention and Ulysses (``parallel/ring_attention.py``,
``parallel/ulysses.py``) and the GPipe pipeline and its trainer
(``parallel/pipeline.py``), over gloo groups of 2 and 4 ranks
(``testing/dist_group.py``) against the JAX functions on a mesh of as
many of this process's virtual CPU devices.

Tolerances: attention forward rtol 1e-4 / atol 1e-5, gradients 1e-3 /
1e-4 (JAX ``tests/test_ring_attention.py:31,56``); the pipeline 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.parallel.pipeline import (
    PipelineParallelTrainer as JTrainer, pipeline_forward as j_pipeline,
    stack_stage_params as j_stack)
from deeplearning4j_tpu.parallel.ring_attention import (
    ring_attention as j_ring)
from deeplearning4j_tpu.parallel.ulysses import ulysses_attention as j_uly
from deeplearning4j_tpu_torch.testing.dist_group import run_group

CASES = "deeplearning4j_tpu_torch.testing.parallel_cases"
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
PIPE = dict(rtol=1e-5, atol=1e-5)
T, D = 32, 8


def _qkvc(which, seed):
    r = np.random.RandomState(seed)
    shape = (4, T, D) if which == "ring" else (2, 4, T, D)
    return [r.randn(*shape).astype(np.float32) for _ in range(4)]


def _self_inputs(seed):
    r = np.random.RandomState(seed)
    return [r.randn(2, T, D).astype(np.float32)] + [
        (r.randn(D, D) * 0.3).astype(np.float32) for _ in range(4)]


def _stage_params(n, d, seed):
    r = np.random.RandomState(seed)
    return [{"W": r.randn(d, d).astype(np.float32) * 0.5,
             "b": r.randn(d).astype(np.float32) * 0.1} for _ in range(n)]


def _pipe_inputs(world):
    stacked = jax.tree.map(np.asarray, j_stack(
        [jax.tree.map(jnp.asarray, p) for p in _stage_params(world, 6, 2)]))
    x = np.random.RandomState(3).randn(12, 6).astype(np.float32)
    return stacked, x


def _trainer_inputs(world):
    r = np.random.RandomState(5)
    stacked = jax.tree.map(np.asarray, j_stack(
        [jax.tree.map(jnp.asarray, p) for p in _stage_params(world, 8, 4)]))
    head = {"Wo": r.randn(8, 1).astype(np.float32) * 0.3}
    x = r.randn(16, 8).astype(np.float32)
    y = r.randn(16, 1).astype(np.float32)
    return stacked, head, x, y


def _conf_mesh(world):
    return {"data": 2, "pipe": world // 2} if world == 4 else {"pipe": 2}


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                tuple(axes))


def _head_xent(hp, feats, y):
    logp = jax.nn.log_softmax(feats @ hp["W"])
    return -jnp.mean(jnp.sum(y * logp, axis=-1))


def _confs_inputs(world):
    mesh = _jax_mesh(_conf_mesh(world))
    r = np.random.RandomState(7)
    head = {"W": (r.randn(8, 3) * 0.3).astype(np.float32)}
    jtr = JTrainer.from_confs([jnn.DenseLayer(n_out=8, activation="tanh")],
                              _head_xent, 8, mesh, num_microbatches=4,
                              updater=jnn.Adam(learning_rate=0.01),
                              head_params=jax.tree.map(jnp.asarray, head))
    x = r.randn(16, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, 16)]
    return jtr, head, x, y


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"ranks{w}")
def group(request, tmp_path_factory):
    world = request.param
    cases = []
    for which in ("ring", "ulysses"):
        for causal in (False, True):
            q, k, v, c = _qkvc(which, world + causal)
            cases.append((f"{which}_{causal}", f"{CASES}:attention_case",
                          dict(q=q, k=k, v=v, c=c, causal=causal,
                               world=world, which=which)))
    cases.append(("ring_self", f"{CASES}:ring_self_case",
                  dict(zip(("x", "wq", "wk", "wv", "wo"),
                           _self_inputs(world)), world=world)))
    stacked, x = _pipe_inputs(world)
    cases.append(("pipe", f"{CASES}:pipeline_case", dict(
        stacked=stacked, x=x, microbatches=[2, 3, 6],
        axes={"pipe": world})))
    stacked, head, tx, ty = _trainer_inputs(world)
    cases.append(("trainer", f"{CASES}:pipeline_trainer_case", dict(
        stacked=stacked, head=head, x=tx, y=ty, steps=3,
        axes={"pipe": world}, updater="sgd")))
    jtr, head, cx, cy = _confs_inputs(world)
    cases.append(("confs", f"{CASES}:pipeline_trainer_case", dict(
        stacked=jax.tree.map(np.asarray, jtr.stacked_params), head=head,
        x=cx, y=cy, steps=3, axes=_conf_mesh(world), updater="adam",
        confs=True)))
    out = run_group(str(tmp_path_factory.mktemp(f"attn{world}")), world,
                    cases, threads=max(1, torch.get_num_threads() // world))
    return world, out


def _dense(q, k, v, causal):
    s = np.einsum("...qd,...kd->...qk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("...qk,...kd->...qd", p, v.astype(np.float64))


def _jax_attention(which, world, q, k, v, c, causal):
    mesh = _jax_mesh({"seq": world})
    fn = j_ring if which == "ring" else j_uly

    def loss(q, k, v):
        out = fn(q, k, v, mesh=mesh, axis="seq", causal=causal)
        return jnp.sum(out * c), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _gathered(out, name, key, axis):
    return np.concatenate([res[name][key] for res in out], axis=axis)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("which", ["ring", "ulysses"])
def test_sequence_parallel_attention_matches_jax_and_dense(group, which,
                                                           causal):
    world, out = group
    q, k, v, c = _qkvc(which, world + causal)
    name = f"{which}_{causal}"
    axis = 1 if which == "ring" else 2
    got = _gathered(out, name, "out", axis)
    want, grads = _jax_attention(which, world, q, k, v, c, causal)
    np.testing.assert_allclose(got, want, **FWD)
    np.testing.assert_allclose(got, _dense(q, k, v, causal), **FWD)
    for key, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_gathered(out, name, key, axis), g,
                                   **GRAD, err_msg=key)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_equals_ring(group, causal):
    """The two strategies on the same heads: Ulysses (B, H, T, D) against
    ring over (B·H, T, D)."""
    world, out = group
    q, k, v, c = _qkvc("ulysses", world + causal)
    uly = _gathered(out, f"ulysses_{causal}", "out", 2)
    b, h = q.shape[:2]
    ring, _ = _jax_attention("ring", world, *(
        a.reshape(b * h, T, D) for a in (q, k, v, c)), causal)
    np.testing.assert_allclose(uly.reshape(b * h, T, D), ring, **FWD)


def test_ulysses_refuses_indivisible_heads(group):
    world, out = group
    for res in out:
        assert res["ulysses_False"]["error"] == (
            f"ulysses needs num_heads (1) divisible by the 'seq' axis size "
            f"({world}) — use ring_attention for head-indivisible meshes")


def test_ring_self_attention_matches_jax(group):
    from deeplearning4j_tpu.parallel.ring_attention import (
        RingSelfAttention as JRingSelf)

    world, out = group
    x, wq, wk, wv, wo = _self_inputs(world)
    want = JRingSelf(_jax_mesh({"seq": world}), num_heads=2, causal=True)(
        *(jnp.asarray(a) for a in (x, wq, wk, wv, wo)))
    np.testing.assert_allclose(_gathered(out, "ring_self", "out", 1),
                               np.asarray(want), **FWD)


def _tanh_stage(p, x):
    return jnp.tanh(x @ p["W"] + p["b"])


def test_pipeline_forward_matches_jax_and_microbatch_count(group):
    world, out = group
    stacked, x = _pipe_inputs(world)
    mesh = _jax_mesh({"pipe": world})
    want = x
    for s in range(world):
        want = np.tanh(want @ stacked["W"][s] + stacked["b"][s])
    for m in (2, 3, 6):
        jgot = np.asarray(j_pipeline(_tanh_stage, mesh, num_microbatches=m)(
            jax.tree.map(jnp.asarray, stacked), jnp.asarray(x)))
        for res in out:  # every rank returns the whole output
            np.testing.assert_allclose(res["pipe"][m], jgot, **PIPE)
            np.testing.assert_allclose(res["pipe"][m], want, **PIPE)
    for res in out:
        np.testing.assert_allclose(res["pipe"][2], res["pipe"][6],
                                   rtol=1e-6, atol=1e-6)


def test_pipeline_trainer_matches_jax(group):
    world, out = group
    stacked, head, x, y = _trainer_inputs(world)

    def head_fn(hp, feats, yy):
        return jnp.mean((feats @ hp["Wo"] - yy) ** 2)

    jtr = JTrainer(_tanh_stage, head_fn, _jax_mesh({"pipe": world}),
                   num_microbatches=4, updater=jnn.Sgd(learning_rate=0.05))
    jtr.init_params(jax.tree.map(jnp.asarray, stacked),
                    jax.tree.map(jnp.asarray, head))
    losses = jtr.fit(jnp.asarray(x), jnp.asarray(y), steps=3)
    assert losses[-1] < losses[0]
    _assert_trainer(out, "trainer", jtr, losses)


def test_config_built_dp_pp_trainer_matches_jax(group):
    """A stage built from DenseLayer(tanh) configurations under Adam, on a
    data × pipe mesh for 4 ranks."""
    world, out = group
    jtr, head, x, y = _confs_inputs(world)
    losses = jtr.fit(jnp.asarray(x), jnp.asarray(y), steps=3)
    _assert_trainer(out, "confs", jtr, losses)


def _assert_trainer(out, name, jtr, losses):
    want_stage = jax.tree.map(np.asarray, jtr.stacked_params)
    want_head = jax.tree.map(np.asarray, jtr.head_params)
    for res in out:
        got = res[name]
        np.testing.assert_allclose(got["losses"], losses, **PIPE)
        s = got["stage_index"]
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(got["stage"]),
                jax.tree_util.tree_leaves_with_path(want_stage)):
            np.testing.assert_allclose(g[0], w[s], **PIPE, err_msg=str(path))
        for k in want_head:
            np.testing.assert_allclose(got["head"][k], want_head[k], **PIPE)
