"""Reinforcement learning of the PyTorch port against the JAX package (CPU).

``DuelingQLayer`` (output, gradients of a fixed projection, one Adam
step, JSON and zips both ways), and the learners on the same MDPs from
the same carried parameters: ``QLearningDiscrete`` (double DQN on and
off, plain and dueling heads), ``ActorCritic``, ``A3CDiscrete`` and
``AsyncNStepQLearningDiscrete`` take the same actions and rewards as the
JAX learners (both draw from the same numpy generators) and end with the
same parameters within a float32 tolerance. The target network is a
copy the in-place updater cannot reach. The helpers (policies, replay,
``HistoryProcessor``, ``GymMDP``, Catch) and the JAX package's learning
tests, mirrored from ``tests/test_nlp_rl.py`` on the carried
parameters.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu import rl as jrl
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.rl.async_rl import (
    AsyncNStepQLearningDiscrete as JNStep)
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch import rl as trl
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.testing import rl_envs as E

OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
STEP = dict(rtol=1e-5, atol=1e-6)
# parameters after a run of tens to hundreds of Adam steps: float32
# rounding differences between XLA and PyTorch, moved through Adam's
# normalization (a tiny gradient's sign decides a full-size step)
RUN = dict(rtol=2e-3, atol=2e-4)


def _host(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _np(tree):
    return jax.tree.map(lambda t: t.detach().cpu().numpy(), tree)


def _assert_trees(want, got, tol, what):
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree.leaves(got)
    assert len(wl) == len(gl), what
    for (path, w), g in zip(wl, gl):
        np.testing.assert_allclose(g, w, err_msg=f"{what} {path}", **tol)


def _pair(conf_fn):
    """The JAX network from ``conf_fn(jnn)`` and the port's from its JSON,
    the JAX parameters carried across."""
    jconf = conf_fn(jnn)
    jnet = jnn.MultiLayerNetwork(jconf).init()
    tconf = tnn.MultiLayerConfiguration.from_json(jconf.to_json())
    tnet = tnn.MultiLayerNetwork(tconf, device="cpu").init(
        params=_host(jnet.params))
    return jnet, tnet


def q_conf(pkg, obs=5, n_actions=2, seed=0, hidden=32, dueling=False):
    b = (pkg.builder().seed(seed).updater(pkg.Adam(learning_rate=5e-3))
         .list().layer(pkg.DenseLayer(n_out=hidden, activation="relu")))
    b = b.layer(pkg.DuelingQLayer(n_actions=n_actions, activation="identity")
                if dueling else
                pkg.OutputLayer(n_out=n_actions, activation="identity",
                                loss="mse"))
    return b.set_input_type(pkg.InputType.feed_forward(obs)).build()


def ac_conf(pkg, n_out, activation, seed, hidden=32, act="relu"):
    b = (pkg.builder().seed(seed).updater(pkg.Adam(learning_rate=5e-3))
         .list().layer(pkg.DenseLayer(n_out=hidden, activation=act)))
    b = b.layer(pkg.OutputLayer(
        n_out=n_out, activation=activation,
        loss="mcxent" if activation == "softmax" else "mse"))
    return b.set_input_type(pkg.InputType.feed_forward(5)).build()


class Recording(E.ChainMDP):
    """The chain, recording every action it is given."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def step(self, action):
        self.log.append(int(action))
        return super().step(action)


# ---------------------------------------------------------------------------
# DuelingQLayer
# ---------------------------------------------------------------------------


def dueling_conf(pkg, dropout=0.0):
    return (pkg.builder().seed(3).updater(pkg.Adam(learning_rate=1e-2))
            .list()
            .layer(pkg.DenseLayer(n_out=6, activation="tanh"))
            .layer(pkg.DuelingQLayer(n_actions=3, activation="identity",
                                     dropout=dropout))
            .layer(pkg.LossLayer(loss="mse", activation="identity"))
            .set_input_type(pkg.InputType.feed_forward(4)).build())


def test_dueling_layer_output_gradients_and_adam_step_match_jax():
    jnet, tnet = _pair(dueling_conf)
    rng = np.random.RandomState(0)
    x = rng.randn(5, 4).astype(np.float32)
    y = rng.randn(5, 3).astype(np.float32)
    want = np.asarray(jnet.output(x))
    np.testing.assert_allclose(tnet.output(x), want, **OUT)
    # Q − (V + A − mean A) is 0: the aggregation, recomputed by hand
    p = _np(tnet.params)
    h = np.tanh(x @ p[0]["W"] + p[0]["b"])
    v = h @ p[1]["Wv"] + p[1]["bv"]
    a = h @ p[1]["Wa"] + p[1]["ba"]
    np.testing.assert_allclose(tnet.output(x), v + a - a.mean(-1, keepdims=True),
                               **OUT)
    c = rng.randn(*want.shape).astype(np.float32)

    def jproj(params):
        out, _ = jnet._forward(params, jnet.net_state, jnp.asarray(x), None,
                               train=True, rng=jax.random.key(0))
        return jnp.sum(out * c)

    jg = jax.grad(jproj)(jnet.params)
    params = jax.tree.map(lambda t: t.detach().requires_grad_(True),
                          tnet.params)
    out, _ = tnet._forward(params, tnet.net_state, torch.from_numpy(x), None,
                           train=True, rng=None)
    tg = torch.autograd.grad((out * torch.from_numpy(c)).sum(),
                             jax.tree.leaves(params))
    _assert_trees(_host(jg), [g.numpy() for g in tg], GRAD, "gradient")
    jnet.fit(JDataSet(x, y), batch_size=5)
    tnet.fit(DataSet(x, y), batch_size=5)
    np.testing.assert_allclose(tnet.score(), float(jnet.score()), rtol=1e-5)
    _assert_trees(_host(jnet.params), _np(tnet.params), STEP, "adam step")
    _assert_trees(_host(jnet.opt_state), _np(tnet.opt_state), STEP,
                  "adam state")


def test_dueling_layer_drops_its_input_in_training_only():
    """Input dropout as every layer applies it (``_maybe_dropout``): the
    inference forward keeps every unit; a training forward with rate
    0.5 zeroes some of the head's inputs."""
    _, tnet = _pair(lambda pkg: dueling_conf(pkg, dropout=0.5))
    x = torch.ones(64, 4)
    q_eval = tnet._forward(tnet.params, tnet.net_state, x, None,
                           train=False, rng=None)[0]
    q_train = tnet._forward(tnet.params, tnet.net_state, x, None,
                            train=True, rng=tnet._gen)[0]
    assert torch.allclose(q_eval, q_eval[:1].expand_as(q_eval))
    assert not torch.allclose(q_train, q_eval)


def test_dueling_json_and_zip_both_ways(tmp_path):
    js, ts = dueling_conf(jnn).to_json(), dueling_conf(tnn).to_json()
    assert json.loads(js) == json.loads(ts)
    assert json.loads(tnn.MultiLayerConfiguration.from_json(js).to_json()) \
        == json.loads(js)
    assert json.loads(jnn.MultiLayerConfiguration.from_json(ts).to_json()) \
        == json.loads(ts)
    jnet, tnet = _pair(dueling_conf)
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jnn.save_model(jnet, jpath)
    got = tnn.restore_model(jpath, device="cpu")
    np.testing.assert_allclose(got.output(x), np.asarray(jnet.output(x)),
                               **OUT)
    tnn.save_model(tnet, tpath)
    back = jnn.restore_model(tpath)
    np.testing.assert_allclose(np.asarray(back.output(x)), tnet.output(x),
                               **OUT)


def test_dueling_q_net_builds_the_jax_configuration():
    jnet = jrl.dqn.dueling_q_net(4, 3, hidden=8, seed=1)
    tnet = trl.dueling_q_net(4, 3, hidden=8, seed=1, device="cpu")
    assert json.loads(tnet.conf.to_json()) == json.loads(jnet.conf.to_json())
    assert tnet.device.type == "cpu"
    assert {k: tuple(v.shape) for k, v in tnet.params[1].items()} == {
        "Wv": (8, 1), "bv": (1,), "Wa": (8, 3), "ba": (3,)}


# ---------------------------------------------------------------------------
# the learners against the JAX learners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("double,dueling", [(True, False), (False, False),
                                            (True, True)])
def test_qlearning_discrete_matches_jax(double, dueling):
    """A few ChainMDP episodes (eps annealed over 150 steps, so the
    greedy Q argmax decides most late actions): the same actions,
    episode returns, iteration count, and parameters and Adam state
    within RUN."""
    jnet, tnet = _pair(lambda pkg: q_conf(pkg, seed=7, dueling=dueling))
    cfg = dict(gamma=0.95, batch_size=16, target_update_freq=25,
               start_size=16, eps_anneal_steps=150, double_dqn=double,
               seed=7)
    jlog, tlog = [], []
    j = jrl.QLearningDiscrete(Recording(jlog), jnet,
                              jrl.QLearningConfiguration(**cfg))
    t = trl.QLearningDiscrete(Recording(tlog), tnet,
                              trl.QLearningConfiguration(**cfg))
    jr = j.train(episodes=10, max_steps=30)
    tr = t.train(episodes=10, max_steps=30)
    assert tlog == jlog and len(jlog) > 100
    assert tr == jr
    assert tnet.iteration_count == jnet.iteration_count > 80
    _assert_trees(_host(jnet.params), _np(tnet.params), RUN, "params")
    _assert_trees(_host(j.target_params), _np(t.target_params), RUN,
                  "target")
    assert t.play(max_steps=30) == j.play(max_steps=30)


def test_td_step_on_a_fixed_minibatch_matches_jax():
    """One TD step from carried parameters and a carried, different
    target: the loss, the parameters and the Adam state (STEP)."""
    jnet, tnet = _pair(lambda pkg: q_conf(pkg, seed=2))
    rng = np.random.RandomState(3)
    target = jax.tree.map(lambda a: a + 0.1 * rng.randn(*a.shape).astype(
        np.float32), _host(jnet.params))
    batch = (rng.rand(16, 5).astype(np.float32),
             rng.randint(2, size=16).astype(np.int32),
             rng.randn(16).astype(np.float32),
             rng.rand(16, 5).astype(np.float32),
             (rng.rand(16) < 0.3).astype(np.float32))
    for double in (True, False):
        cfg = dict(double_dqn=double, gamma=0.9)
        jnet, tnet = _pair(lambda pkg: q_conf(pkg, seed=2))
        j = jrl.QLearningDiscrete(E.ChainMDP(), jnet,
                                  jrl.QLearningConfiguration(**cfg))
        t = trl.QLearningDiscrete(E.ChainMDP(), tnet,
                                  trl.QLearningConfiguration(**cfg))
        j.target_params = jax.tree.map(jnp.asarray, target)
        t.target_params = tnn.MultiLayerNetwork(
            tnet.conf, device="cpu").init(params=target).params
        jnet.params, jnet.opt_state, jloss = j._td_step(
            jnet.params, j.target_params, jnet.opt_state,
            jnp.asarray(0, jnp.int32), *map(jnp.asarray, batch))
        tloss = t.td_step(*batch)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        _assert_trees(_host(jnet.params), _np(tnet.params), STEP, "params")
        _assert_trees(_host(jnet.opt_state), _np(tnet.opt_state), STEP,
                      "adam")


def test_target_network_is_a_copy_the_updater_cannot_reach():
    """The updater writes the online parameters in place: after a sync
    and one TD step the target still holds the synced values (an alias
    would have moved with the online network), and the next sync copies
    the new values into the target's own tensors."""
    _, tnet = _pair(lambda pkg: q_conf(pkg, seed=4))
    t = trl.QLearningDiscrete(E.ChainMDP(), tnet)
    t.sync_target()
    synced = _np(t.target_params)
    ids = [id(x) for x in jax.tree.leaves(t.target_params)]
    rng = np.random.RandomState(0)
    t.td_step(rng.rand(8, 5).astype(np.float32),
              rng.randint(2, size=8).astype(np.int32),
              rng.randn(8).astype(np.float32),
              rng.rand(8, 5).astype(np.float32), np.zeros(8, np.float32))
    _assert_trees(synced, _np(t.target_params), dict(rtol=0, atol=0),
                  "target after a step")
    moved = max(float((a - torch.from_numpy(b)).abs().max()) for a, b in zip(
        jax.tree.leaves(tnet.params), jax.tree.leaves(synced)))
    assert moved > 0
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(
        jax.tree.leaves(tnet.params), jax.tree.leaves(t.target_params)))
    t.sync_target()
    assert [id(x) for x in jax.tree.leaves(t.target_params)] == ids
    _assert_trees(_np(tnet.params), _np(t.target_params),
                  dict(rtol=0, atol=0), "target after the sync")
    # the n-step learner's target alike
    _, qnet = _pair(lambda pkg: q_conf(pkg, seed=4))
    n = trl.AsyncNStepQLearningDiscrete(E.ChainMDP, qnet, n_envs=2,
                                        n_steps=3, target_update_freq=1000)
    before = _np(n.target_params)
    n.train(batches=2)
    _assert_trees(before, _np(n.target_params), dict(rtol=0, atol=0),
                  "n-step target")
    assert not np.allclose(_np(qnet.params)[0]["W"], before[0]["W"])


def test_actor_critic_matches_jax():
    jp, tp = _pair(lambda pkg: ac_conf(pkg, 2, "softmax", 3))
    jv, tv = _pair(lambda pkg: ac_conf(pkg, 1, "identity", 4))
    jlog, tlog = [], []
    j = jrl.ActorCritic(Recording(jlog), jp, jv, gamma=0.95, n_steps=16,
                        seed=5)
    t = trl.ActorCritic(Recording(tlog), tp, tv, gamma=0.95, n_steps=16,
                        seed=5)
    j.train_steps(320, max_episode_steps=30)
    t.train_steps(320, max_episode_steps=30)
    assert tlog == jlog and len(jlog) == 320
    assert t.episode_rewards == j.episode_rewards
    assert tp.iteration_count == jp.iteration_count == 20
    _assert_trees(_host(jp.params), _np(tp.params), RUN, "policy")
    _assert_trees(_host(jv.params), _np(tv.params), RUN, "value")


def _a3c_conf(pkg, n_out, activation):
    return ac_conf(pkg, n_out, activation, 5, act="tanh")


def test_a3c_matches_jax():
    """8 rollouts of 4 chains × 8 steps: actions, rewards, losses and
    parameters."""
    jp, tp = _pair(lambda pkg: _a3c_conf(pkg, 2, "softmax"))
    jv, tv = _pair(lambda pkg: _a3c_conf(pkg, 1, "identity"))
    jlog, tlog = [], []
    j = jrl.A3CDiscrete(lambda: Recording(jlog), jp, jv, n_envs=4,
                        n_steps=8, gamma=0.95, seed=7)
    t = trl.A3CDiscrete(lambda: Recording(tlog), tp, tv, n_envs=4,
                        n_steps=8, gamma=0.95, seed=7)
    jl = j.train(batches=8)
    tl = t.train(batches=8)
    assert tlog == jlog and len(jlog) == 8 * 4 * 8
    assert t.episode_rewards == j.episode_rewards
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-5)
    _assert_trees(_host(jp.params), _np(tp.params), RUN, "policy")
    _assert_trees(_host(jv.params), _np(tv.params), RUN, "value")


def test_a3c_update_on_a_fixed_rollout_matches_jax():
    """One update at step 3 from carried parameters on a fixed rollout:
    the loss, both networks' parameters and Adam state (STEP)."""
    jp, tp = _pair(lambda pkg: _a3c_conf(pkg, 2, "softmax"))
    jv, tv = _pair(lambda pkg: _a3c_conf(pkg, 1, "identity"))
    j = jrl.A3CDiscrete(E.ChainMDP, jp, jv, n_envs=2, n_steps=2, seed=1)
    t = trl.A3CDiscrete(E.ChainMDP, tp, tv, n_envs=2, n_steps=2, seed=1)
    rng = np.random.RandomState(2)
    obs = rng.rand(24, 5).astype(np.float32)
    acts = rng.randint(2, size=24).astype(np.int32)
    rets = rng.randn(24).astype(np.float32)
    (jp.params, jp.opt_state, jv.params, jv.opt_state, jloss) = j._step(
        jp.params, jv.params, jp.opt_state, jv.opt_state,
        jnp.asarray(3, jnp.int32), jnp.asarray(obs), jnp.asarray(acts),
        jnp.asarray(rets))
    tloss = t.update(3, obs, acts, rets)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for jn, tn, what in ((jp, tp, "policy"), (jv, tv, "value")):
        _assert_trees(_host(jn.params), _np(tn.params), STEP, what)
        _assert_trees(_host(jn.opt_state), _np(tn.opt_state), STEP,
                      what + " adam")


def test_async_nstep_q_matches_jax():
    jnet, tnet = _pair(lambda pkg: q_conf(pkg, seed=11))
    jlog, tlog = [], []
    kw = dict(n_envs=4, n_steps=5, gamma=0.95, target_update_freq=5,
              eps_anneal_batches=10, seed=11)
    j = JNStep(lambda: Recording(jlog), jnet, **kw)
    t = trl.AsyncNStepQLearningDiscrete(lambda: Recording(tlog), tnet, **kw)
    jl = j.train(batches=15)
    tl = t.train(batches=15)
    assert tlog == jlog and len(jlog) == 15 * 4 * 5
    assert t.episode_rewards == j.episode_rewards
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-6)
    _assert_trees(_host(jnet.params), _np(tnet.params), RUN, "params")
    _assert_trees(_host(j.target_params), _np(t.target_params), RUN,
                  "target")
    assert t.play(E.ChainMDP(), 30) == j.play(E.ChainMDP(), 30)


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


def test_policies_and_replay_draw_as_the_jax_ones():
    q = np.array([0.1, 0.5, 0.2], np.float32)
    je, te = jrl.EpsGreedy(1.0, 0.1, 50, seed=3), trl.EpsGreedy(
        1.0, 0.1, 50, seed=3)
    assert [te.next_action(q) for _ in range(80)] == [
        je.next_action(q) for _ in range(80)]
    assert te.epsilon() == pytest.approx(0.1)
    jb, tb = jrl.BoltzmannPolicy(0.5, seed=2), trl.BoltzmannPolicy(0.5,
                                                                  seed=2)
    assert [tb.next_action(q) for _ in range(50)] == [
        jb.next_action(q) for _ in range(50)]
    assert trl.GreedyPolicy().next_action(q) == 1
    jr, tr = jrl.ExpReplay(5, 3, seed=0), trl.ExpReplay(5, 3, seed=0)
    for i in range(10):
        tr_ = (np.full(2, i, np.float32), i % 2, float(i),
               np.zeros(2, np.float32), i == 9)
        jr.store(tr_)
        tr.store(tr_)
    assert len(tr) == 5
    for a, b in zip(tr.sample(), jr.sample()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_history_processor_matches_jax():
    jh, th = jrl.HistoryProcessor(3, 2), trl.HistoryProcessor(3, 2)
    for i in range(7):
        f = np.full((2, 2), i, np.float32)
        assert th.record(f) == jh.record(f)
        np.testing.assert_array_equal(th.get_history(), jh.get_history())
    th.reset()
    with pytest.raises(ValueError):
        th.get_history()
    th.record(np.ones((2,)))
    np.testing.assert_array_equal(th.get_history()[0], 0)


def test_gym_mdp_adapter():
    class FakeGym:
        class Space:
            n = 3
            shape = (4,)
        action_space = Space()
        observation_space = Space()

        def reset(self):
            return np.zeros(4), {}

        def step(self, a):
            return np.ones(4) * a, 1.0, a == 2, False, {}

    class ClassicGym(FakeGym):
        def reset(self):
            return np.zeros((2, 2))

        def step(self, a):
            return np.ones((2, 2)), 0.5, True, {}

    mdp = trl.GymMDP(FakeGym())
    assert mdp.obs_size == 4 and mdp.num_actions == 3
    assert mdp.reset().shape == (4,)
    obs, r, done = mdp.step(2)
    assert r == 1.0 and done and obs[0] == 2.0 and obs.dtype == np.float32
    classic = trl.GymMDP(ClassicGym(), obs_size=4, num_actions=2)
    assert classic.reset().shape == (4,)
    got, want = classic.step(1), jrl.GymMDP(ClassicGym()).step(1)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == (0.5, True)
    assert classic.obs_size == 4 and classic.num_actions == 2


def test_catch_is_bsuites_and_renders_84_by_84_by_4():
    game = E.Catch(seed=3)
    board = game.reset()
    assert board.shape == (10, 5) and board.sum() == 2
    col = int(np.argmax(board[0]))
    rewards = []
    for _ in range(9):
        board, r, done = game.step(1)  # stay: the paddle keeps column 2
        rewards.append(r)
    assert done and rewards[:8] == [0.0] * 8
    assert rewards[8] == (1.0 if col == 2 else -1.0)
    mdp = E.CatchPixels(seed=3)
    obs = mdp.reset()
    assert obs.shape == (84, 84, 4) and obs.dtype == np.float32
    assert obs[..., :3].sum() == 0  # zero-padded history
    np.testing.assert_array_equal(obs[..., 3], E.upscale(
        E.Catch(seed=3).reset(), 84, 84))
    obs, _, _ = mdp.step(0)
    np.testing.assert_array_equal(obs[..., 2], E.upscale(
        E.Catch(seed=3).reset(), 84, 84))
    assert mdp.obs_size == 84 * 84 * 4 and mdp.num_actions == 3


def test_the_nature_trunk_on_catch_has_the_stated_size():
    net = tnn.MultiLayerNetwork(E.conv_q_conf(tnn), device="cpu").init()
    assert net.num_params() == 1686180
    obs = E.CatchPixels().reset()
    q = net.output(obs[None])
    assert q.shape == (1, 3) and np.isfinite(q).all()
    pol = tnn.MultiLayerNetwork(E.atari_2013_conf(tnn, "policy"),
                                device="cpu").init()
    np.testing.assert_allclose(pol.output(obs[None]).sum(), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# the JAX package's learning tests, on the port (parameters carried)
# ---------------------------------------------------------------------------


def test_dqn_learns_chain():
    _, tnet = _pair(lambda pkg: q_conf(pkg, seed=7))
    dqn = trl.QLearningDiscrete(E.ChainMDP(), tnet, trl.QLearningConfiguration(
        gamma=0.95, batch_size=32, target_update_freq=50, start_size=32,
        eps_anneal_steps=300, seed=7))
    dqn.train(episodes=60, max_steps=30)
    assert dqn.play(max_steps=30) == pytest.approx(1.0)


def test_dueling_dqn_learns_chain():
    _, tnet = _pair(lambda pkg: q_conf(pkg, seed=7, dueling=True))
    dqn = trl.QLearningDiscrete(E.ChainMDP(), tnet, trl.QLearningConfiguration(
        gamma=0.95, batch_size=32, target_update_freq=50, start_size=32,
        eps_anneal_steps=300, seed=7))
    dqn.train(episodes=60, max_steps=30)
    assert dqn.play(max_steps=30) == pytest.approx(1.0)


def test_ac_learns_chain():
    _, tp = _pair(lambda pkg: ac_conf(pkg, 2, "softmax", 3))
    _, tv = _pair(lambda pkg: ac_conf(pkg, 1, "identity", 4))
    mdp = E.ChainMDP()
    ac = trl.ActorCritic(mdp, tp, tv, gamma=0.95, n_steps=16, seed=5)
    ac.train_steps(3000, max_episode_steps=30)
    assert tp.output(mdp.reset()[None])[0][1] > 0.8


def test_a3c_learns_chain():
    _, tp = _pair(lambda pkg: _a3c_conf(pkg, 2, "softmax"))
    _, tv = _pair(lambda pkg: _a3c_conf(pkg, 1, "identity"))
    a3c = trl.A3CDiscrete(E.ChainMDP, tp, tv, n_envs=4, n_steps=8,
                          gamma=0.95, seed=7)
    a3c.train(batches=120)
    recent = a3c.episode_rewards[-20:]
    assert len(recent) >= 5 and np.mean(recent) > 0.8


def test_async_nstep_q_learns_chain():
    _, tnet = _pair(lambda pkg: q_conf(pkg, seed=11))
    alg = trl.AsyncNStepQLearningDiscrete(
        E.ChainMDP, tnet, n_envs=8, n_steps=5, gamma=0.95,
        target_update_freq=20, eps_anneal_batches=80, seed=11)
    losses = alg.train(batches=150)
    assert np.isfinite(losses[-1])
    assert alg.play(E.ChainMDP(), max_steps=30) == pytest.approx(1.0)
