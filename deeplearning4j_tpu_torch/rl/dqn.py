"""Reinforcement learning, the RL4J role: DQN and synchronous actor-critic.

Counterpart of ``deeplearning4j_tpu/rl/dqn.py``:

* :class:`MDP`, the policies (:class:`EpsGreedy`, :class:`BoltzmannPolicy`,
  :class:`GreedyPolicy`) and :class:`ExpReplay` are host numpy, copied:
  they draw from ``np.random.RandomState`` / ``random.Random`` exactly as
  the JAX package does, so both take the same actions and minibatches
  from a seed.
* :class:`QLearningDiscrete` (QLearningDiscrete.java: replay, target
  network, ε-greedy, double DQN, reward clipping) and
  :class:`ActorCritic` (the batched synchronous advantage actor-critic)
  train ``MultiLayerNetwork`` s through their own steps: the network's
  ``_forward`` under autograd, then :func:`apply_layer_updates` in place
  (one ``fused_updater`` launch per updater group on the card), at the
  network's int32 device iteration.
* :func:`dueling_q_net`: a dense trunk under a ``DuelingQLayer`` head.

What differs from the JAX package: its parameters are immutable arrays,
so ``target_params = jax.tree.map(jnp.asarray, net.params)`` is a safe
alias. Here the updater writes the parameters in place, so the target
network is a separate copy, refreshed with ``copy_`` at each sync.
Each environment step reads the online network's Q-values back to the
host (``q_values``): the action depends on them.
"""

from __future__ import annotations

import dataclasses
import random
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.models._tree import leaf_paths, map_tree
from deeplearning4j_tpu_torch.nn import dtype as DT
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, apply_layer_updates, autograd_leaves, grad_tree)


class MDP:
    """rl4j-api MDP interface."""

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool]:
        """returns (observation, reward, done)."""
        raise NotImplementedError

    @property
    def num_actions(self) -> int:
        raise NotImplementedError

    @property
    def obs_size(self) -> int:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Policies (rl4j policy/*)
# ---------------------------------------------------------------------------


class EpsGreedy:
    """EpsGreedy.java: anneal ε from eps_start to eps_min over anneal_steps."""

    def __init__(self, eps_start: float = 1.0, eps_min: float = 0.05,
                 anneal_steps: int = 1000, seed: int = 0):
        self.eps_start = eps_start
        self.eps_min = eps_min
        self.anneal = anneal_steps
        self.rng = np.random.RandomState(seed)
        self.step_count = 0

    def epsilon(self) -> float:
        f = min(1.0, self.step_count / max(1, self.anneal))
        return self.eps_start + f * (self.eps_min - self.eps_start)

    def next_action(self, q_values: np.ndarray) -> int:
        self.step_count += 1
        if self.rng.rand() < self.epsilon():
            return int(self.rng.randint(len(q_values)))
        return int(np.argmax(q_values))


class BoltzmannPolicy:
    """BoltzmannQPolicy.java: sample ∝ softmax(Q/T)."""

    def __init__(self, temperature: float = 1.0, seed: int = 0):
        self.temperature = temperature
        self.rng = np.random.RandomState(seed)

    def next_action(self, q_values: np.ndarray) -> int:
        z = q_values / max(self.temperature, 1e-6)
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self.rng.choice(len(q_values), p=p))


class GreedyPolicy:
    def next_action(self, q_values: np.ndarray) -> int:
        return int(np.argmax(q_values))


# ---------------------------------------------------------------------------
# Replay buffer (learning/sync/ExpReplay.java)
# ---------------------------------------------------------------------------


class ExpReplay:
    def __init__(self, max_size: int = 10000, batch_size: int = 32,
                 seed: int = 0):
        self.buf: Deque = deque(maxlen=max_size)
        self.batch_size = batch_size
        self.rng = random.Random(seed)

    def store(self, transition) -> None:
        self.buf.append(transition)

    def sample(self):
        batch = self.rng.sample(list(self.buf),
                                min(self.batch_size, len(self.buf)))
        s, a, r, s2, d = zip(*batch)
        return (np.stack(s).astype(np.float32), np.asarray(a, np.int32),
                np.asarray(r, np.float32), np.stack(s2).astype(np.float32),
                np.asarray(d, np.float32))

    def __len__(self):
        return len(self.buf)


# ---------------------------------------------------------------------------
# The shared step pieces
# ---------------------------------------------------------------------------


def copy_params(params):
    """A separate copy of a network's parameter trees (a target
    network): the updater writes the online tensors in place."""
    return map_tree(lambda t: t.detach().clone(), params)


def sync_params(target, params) -> None:
    """``params``' values copied into ``target``'s own tensors."""
    with torch.no_grad():
        for (_, t), (_, p) in zip(leaf_paths(target), leaf_paths(params)):
            t.copy_(p)


def forward(net: MultiLayerNetwork, params, x) -> torch.Tensor:
    """The inference forward (``train=False``) of ``net`` at ``params``
    on the device tensor ``x``; differentiable in ``params``."""
    with DT.precision_scope(net.conf.dtype):
        return net._forward(params, net.net_state, x, None, train=False,
                            rng=None)[0]


def update(net: MultiLayerNetwork, grads, step: torch.Tensor) -> None:
    """The network's update tail in place: L1/L2, gradient normalization,
    the updater (one multi-tensor launch per updater group on the card)
    and weight decay (``apply_layer_updates``)."""
    with torch.no_grad():
        apply_layer_updates(net.conf, zip(net.params, grads, net.opt_state,
                                          net.updaters, net.conf.layers),
                            step, inplace=True)


def feed(net: MultiLayerNetwork, a) -> torch.Tensor:
    """A host array on the network's device, in the dtype the JAX package
    computes in."""
    return net._feed(np.asarray(a))


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[i, idx[i]]`` (``jnp.take_along_axis(x, idx[:, None], 1)[:, 0]``)."""
    return x.gather(1, idx.long()[:, None])[:, 0]


def actor_critic_step(pnet: MultiLayerNetwork, vnet: MultiLayerNetwork,
                      step: torch.Tensor, s, a, ret,
                      entropy_coef: float) -> torch.Tensor:
    """One advantage actor-critic update of both networks from a rollout
    (JAX ``dqn.py:266`` / ``async_rl.py:133``): the value network's MSE to
    the returns, the policy's −(log π(a|s)·A + c·H(π)) with the advantage
    A = ret − V(s) from the value network before its update. Returns the
    summed loss, a 0-d device tensor."""
    with torch.enable_grad():
        v_leaves = autograd_leaves(vnet.params)
        v = forward(vnet, v_leaves, s)[:, 0]
        v_loss = torch.mean((ret - v) ** 2)
        v_grads = grad_tree(v_loss, v_leaves)
        adv = (ret - v).detach()
        p_leaves = autograd_leaves(pnet.params)
        probs = forward(pnet, p_leaves, s)
        logp = torch.log(probs + 1e-8)
        chosen = take(logp, a)
        entropy = -torch.sum(probs * logp, dim=1)
        p_loss = -torch.mean(chosen * adv + entropy_coef * entropy)
        p_grads = grad_tree(p_loss, p_leaves)
    update(pnet, p_grads, step)
    update(vnet, v_grads, step)
    return (p_loss + v_loss).detach()


def n_step_returns(rews: np.ndarray, dones: np.ndarray, boot: np.ndarray,
                   gamma: float) -> np.ndarray:
    """Discounted returns over a (n_steps, n_envs) rollout, bootstrapped
    from ``boot`` and cut where an episode ended."""
    rets = np.zeros_like(rews)
    running = boot
    for t in reversed(range(rews.shape[0])):
        running = rews[t] + gamma * running * (~dones[t])
        rets[t] = running
    return rets


# ---------------------------------------------------------------------------
# DQN (QLearningDiscrete)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QLearningConfiguration:
    """QLearning.QLConfiguration analog."""

    gamma: float = 0.99
    batch_size: int = 32
    target_update_freq: int = 100
    start_size: int = 64
    max_replay: int = 10000
    double_dqn: bool = True
    reward_clip: Optional[float] = None
    eps_start: float = 1.0
    eps_min: float = 0.05
    eps_anneal_steps: int = 1000
    seed: int = 0


class QLearningDiscrete:
    """QLearningDiscrete.java: DQN trainer over an MDP, on the network's
    device."""

    def __init__(self, mdp: MDP, net: MultiLayerNetwork,
                 config: QLearningConfiguration = QLearningConfiguration()):
        self.mdp = mdp
        self.net = net
        self.cfg = config
        self.policy = EpsGreedy(config.eps_start, config.eps_min,
                                config.eps_anneal_steps, config.seed)
        self.replay = ExpReplay(config.max_replay, config.batch_size,
                                config.seed)
        self.target_params = copy_params(net.params)
        self.total_steps = 0
        self.episode_rewards: List[float] = []
        self.losses: List[torch.Tensor] = []  # one 0-d device tensor a step

    def td_step(self, s, a, r, s2, d) -> torch.Tensor:
        """One TD update on a minibatch (JAX ``dqn.py:160-193``): the MSE
        of Q(s, a) to r + γ(1 − d)·Q_target(s2, a*), a* = argmax of the
        online Q(s2) under double DQN, else the target's max. Returns the
        loss, a 0-d device tensor."""
        net, cfg = self.net, self.cfg
        s, a, r, s2, d = (feed(net, v) for v in (s, a, r, s2, d))
        step = net._steps.iteration.at(net.iteration_count)
        with torch.no_grad():
            q_next_target = forward(net, self.target_params, s2)
            if cfg.double_dqn:
                a_star = torch.argmax(forward(net, net.params, s2), dim=1)
                q_next = take(q_next_target, a_star)
            else:
                q_next = torch.max(q_next_target, dim=1).values
            target = r + cfg.gamma * (1.0 - d) * q_next
        with torch.enable_grad():
            leaves = autograd_leaves(net.params)
            q_sa = take(forward(net, leaves, s), a)
            loss = torch.mean((q_sa - target) ** 2)
            grads = grad_tree(loss, leaves)
        update(net, grads, step)
        step.add_(1)
        net._steps.iteration.advanced()
        net.iteration_count += 1
        return loss.detach()

    def sync_target(self) -> None:
        sync_params(self.target_params, self.net.params)

    def q_values(self, obs: np.ndarray) -> np.ndarray:
        return self.net.output(obs[None].astype(np.float32))[0]

    def train_episode(self, max_steps: int = 200) -> float:
        obs = self.mdp.reset()
        total = 0.0
        for _ in range(max_steps):
            action = self.policy.next_action(self.q_values(obs))
            obs2, reward, done = self.mdp.step(action)
            total += reward
            r = reward
            if self.cfg.reward_clip:
                r = float(np.clip(r, -self.cfg.reward_clip,
                                  self.cfg.reward_clip))
            self.replay.store((obs, action, r, obs2, float(done)))
            obs = obs2
            self.total_steps += 1
            if len(self.replay) >= self.cfg.start_size:
                self.losses.append(self.td_step(*self.replay.sample()))
            if self.total_steps % self.cfg.target_update_freq == 0:
                self.sync_target()
            if done:
                break
        self.episode_rewards.append(total)
        return total

    def train(self, episodes: int, max_steps: int = 200) -> List[float]:
        return [self.train_episode(max_steps) for _ in range(episodes)]

    def play(self, max_steps: int = 200) -> float:
        """Greedy rollout (Policy.play)."""
        policy = GreedyPolicy()
        obs = self.mdp.reset()
        total = 0.0
        for _ in range(max_steps):
            obs, r, done = self.mdp.step(
                policy.next_action(self.q_values(obs)))
            total += r
            if done:
                break
        return total


# ---------------------------------------------------------------------------
# Advantage actor-critic (the A3C-equivalent, synchronous)
# ---------------------------------------------------------------------------


class ActorCritic:
    """Batched synchronous advantage actor-critic (A3CDiscrete's
    objective, one update a rollout of ``n_steps``)."""

    def __init__(self, mdp: MDP, policy_net: MultiLayerNetwork,
                 value_net: MultiLayerNetwork, gamma: float = 0.99,
                 n_steps: int = 16, entropy_coef: float = 0.01,
                 seed: int = 0):
        self.mdp = mdp
        self.policy_net = policy_net
        self.value_net = value_net
        self.gamma = gamma
        self.n_steps = n_steps
        self.entropy_coef = entropy_coef
        self.rng = np.random.RandomState(seed)
        self.episode_rewards: List[float] = []
        self._obs = None
        self._ep_reward = 0.0

    def _action(self, obs) -> int:
        probs = self.policy_net.output(obs[None].astype(np.float32))[0]
        probs = np.clip(probs, 1e-8, 1.0)
        probs = probs / probs.sum()
        return int(self.rng.choice(len(probs), p=probs))

    def train_steps(self, total_steps: int,
                    max_episode_steps: int = 200) -> None:
        if self._obs is None:
            self._obs = self.mdp.reset()
        steps_done = 0
        ep_steps = 0
        pnet = self.policy_net
        while steps_done < total_steps:
            states, actions, rewards, cuts = [], [], [], []
            for _ in range(self.n_steps):
                a = self._action(self._obs)
                obs2, r, done = self.mdp.step(a)
                states.append(self._obs)
                actions.append(a)
                rewards.append(r)
                self._ep_reward += r
                self._obs = obs2
                steps_done += 1
                ep_steps += 1
                truncated = ep_steps >= max_episode_steps
                # a truncation reset must also cut the return recurrence,
                # or the new episode's rewards leak into the old one's
                cuts.append(done or truncated)
                if done or truncated:
                    self.episode_rewards.append(self._ep_reward)
                    self._ep_reward = 0.0
                    ep_steps = 0
                    self._obs = self.mdp.reset()
            # n-step returns (bootstrap with V(s_T) unless the chain was cut)
            v_last = float(self.value_net.output(
                self._obs[None].astype(np.float32))[0, 0])
            ret = v_last if not cuts[-1] else 0.0
            returns = []
            for r, c in zip(reversed(rewards), reversed(cuts)):
                ret = r + self.gamma * ret * (1.0 - float(c))
                returns.append(ret)
            returns.reverse()
            step = pnet._steps.iteration.at(pnet.iteration_count)
            actor_critic_step(
                pnet, self.value_net, step,
                feed(pnet, np.stack(states).astype(np.float32)),
                feed(pnet, np.asarray(actions, np.int32)),
                feed(pnet, np.asarray(returns, np.float32)),
                self.entropy_coef)
            step.add_(1)
            pnet._steps.iteration.advanced()
            pnet.iteration_count += 1


def dueling_q_net(obs_size: int, n_actions: int, hidden: int = 64,
                  seed: int = 0, learning_rate: float = 5e-3, *,
                  device=None) -> MultiLayerNetwork:
    """Dueling-DQN network (JAX ``dqn.py:354``): a relu dense trunk under
    a ``DuelingQLayer`` head (Q = V + A − mean A), Adam; a drop-in for the
    plain Q-network of :class:`QLearningDiscrete`."""
    from deeplearning4j_tpu_torch import nn

    return MultiLayerNetwork(
        nn.builder().seed(seed).updater(nn.Adam(learning_rate=learning_rate))
        .list()
        .layer(nn.DenseLayer(n_out=hidden, activation="relu"))
        .layer(nn.DuelingQLayer(n_actions=n_actions, activation="identity"))
        .set_input_type(nn.InputType.feed_forward(obs_size)).build(),
        device=device).init()
