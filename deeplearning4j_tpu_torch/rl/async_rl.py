"""A3C-equivalent parallel-environment training and the MDP adapters.

Counterpart of ``deeplearning4j_tpu/rl/async_rl.py``:

* :class:`GymMDP` (rl4j-gym's GymEnv: any gym-style environment as an
  MDP, duck-typed: gym itself is not imported) and
  :class:`HistoryProcessor` (frame skip and stack) are host numpy,
  copied.
* :class:`A3CDiscrete` and :class:`AsyncNStepQLearningDiscrete`: RL4J's
  hogwild worker threads become ``n_envs`` synchronous environments whose
  observations are stacked into one batch; one batched policy (or Q)
  forward per environment step and one update per rollout of
  ``n_steps``, as in the JAX package. Actions are drawn on the host from
  ``np.random.RandomState(seed)`` in the JAX package's order, so each
  environment step reads the forward's result back to the host.

The n-step learner's target network is a separate copy of the online
parameters (the updater writes those in place), refreshed with
``copy_`` every ``target_update_freq`` rollouts.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.compiled import DeviceIteration
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, autograd_leaves, grad_tree)
from deeplearning4j_tpu_torch.rl.dqn import (
    MDP, actor_critic_step, copy_params, feed, forward, n_step_returns,
    sync_params, take, update)


class GymMDP(MDP):
    """GymEnv analog: wraps any gym-style env (reset() → obs | (obs,
    info); step(a) → (obs, reward, done[, truncated], info)) into the
    rl4j MDP interface."""

    def __init__(self, env: Any, obs_size: Optional[int] = None,
                 num_actions: Optional[int] = None):
        self.env = env
        self._obs_size = obs_size
        self._num_actions = num_actions

    def reset(self) -> np.ndarray:
        out = self.env.reset()
        obs = out[0] if isinstance(out, tuple) else out
        return np.asarray(obs, np.float32).ravel()

    def step(self, action: int) -> Tuple[np.ndarray, float, bool]:
        out = self.env.step(int(action))
        if len(out) == 5:  # gymnasium: obs, reward, terminated, truncated
            obs, reward, term, trunc, _ = out
            done = bool(term or trunc)
        else:  # classic gym: obs, reward, done, info
            obs, reward, done = out[0], out[1], bool(out[2])
        return np.asarray(obs, np.float32).ravel(), float(reward), done

    @property
    def num_actions(self) -> int:
        if self._num_actions is not None:
            return self._num_actions
        return int(self.env.action_space.n)

    @property
    def obs_size(self) -> int:
        if self._obs_size is not None:
            return self._obs_size
        return int(np.prod(self.env.observation_space.shape))


class HistoryProcessor:
    """HistoryProcessor.java analog: skip frames and stack the last
    ``history_length`` kept frames into one observation. ``record`` every
    raw frame; ``get_history`` returns the (history_length, *frame_shape)
    stack, zero-padded until warm."""

    def __init__(self, history_length: int = 4, skip_frames: int = 4):
        self.history_length = history_length
        self.skip_frames = max(1, skip_frames)
        self._frames: List[np.ndarray] = []
        self._count = 0

    def reset(self) -> None:
        self._frames = []
        self._count = 0

    def record(self, frame: np.ndarray) -> bool:
        """Returns True when the frame was kept (every skip_frames-th)."""
        keep = self._count % self.skip_frames == 0
        self._count += 1
        if keep:
            self._frames.append(np.asarray(frame, np.float32))
            if len(self._frames) > self.history_length:
                self._frames.pop(0)
        return keep

    def get_history(self) -> np.ndarray:
        if not self._frames:
            raise ValueError("record() at least one frame first")
        shape = self._frames[0].shape
        pad = self.history_length - len(self._frames)
        frames = [np.zeros(shape, np.float32)] * pad + self._frames
        return np.stack(frames)


def _step_envs(envs, acts, ep_rewards, obs, episode_rewards):
    """Every environment one step: (rewards, dones); an ended episode's
    return is recorded and its environment reset."""
    rews, dones = [], []
    for k, env in enumerate(envs):
        nxt, r, d = env.step(acts[k])
        ep_rewards[k] += r
        if d:
            episode_rewards.append(ep_rewards[k])
            ep_rewards[k] = 0.0
            nxt = env.reset()
        obs[k] = nxt
        rews.append(r)
        dones.append(d)
    return rews, dones


def _flat(x: np.ndarray) -> np.ndarray:
    return x.reshape((-1,) + x.shape[2:])


class A3CDiscrete:
    """A3CDiscrete analog: ``n_envs`` parallel MDPs, one batched advantage
    actor-critic update a rollout (:func:`.dqn.actor_critic_step`: one
    ``fused_updater`` launch per network on the card)."""

    def __init__(self, mdp_factory: Callable[[], MDP],
                 policy_net: MultiLayerNetwork,
                 value_net: MultiLayerNetwork, n_envs: int = 8,
                 n_steps: int = 8, gamma: float = 0.99,
                 entropy_coef: float = 0.01, seed: int = 0):
        self.envs = [mdp_factory() for _ in range(n_envs)]
        self.policy_net = policy_net
        self.value_net = value_net
        self.n_envs = n_envs
        self.n_steps = n_steps
        self.gamma = gamma
        self.entropy_coef = entropy_coef
        self.rng = np.random.RandomState(seed)
        self._obs = [e.reset() for e in self.envs]
        self._ep_rewards = np.zeros(n_envs)
        self.episode_rewards: List[float] = []
        self._iteration = DeviceIteration(policy_net.device)

    def _policy(self, batch: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            probs = forward(self.policy_net, self.policy_net.params,
                            feed(self.policy_net, batch))
        return probs.float().cpu().numpy()

    def _rollout(self):
        """Step all envs ``n_steps`` with one batched policy forward a
        step."""
        obs_buf, act_buf, rew_buf, done_buf = [], [], [], []
        for _ in range(self.n_steps):
            batch = np.stack(self._obs)
            probs = self._policy(batch)
            acts = [int(self.rng.choice(len(p), p=p / p.sum()))
                    for p in probs]
            obs_buf.append(batch)
            act_buf.append(acts)
            rews, dones = _step_envs(self.envs, acts, self._ep_rewards,
                                     self._obs, self.episode_rewards)
            rew_buf.append(rews)
            done_buf.append(dones)
        return (np.asarray(obs_buf, np.float32),
                np.asarray(act_buf, np.int32),
                np.asarray(rew_buf, np.float32), np.asarray(done_buf))

    def update(self, step: int, obs, acts, rets) -> torch.Tensor:
        """One batched update from a flattened rollout at iteration
        ``step``; returns the summed loss, a 0-d device tensor."""
        pnet = self.policy_net
        it = self._iteration.at(step)
        loss = actor_critic_step(pnet, self.value_net, it, feed(pnet, obs),
                                 feed(pnet, acts), feed(pnet, rets),
                                 self.entropy_coef)
        it.add_(1)
        self._iteration.advanced()
        return loss

    def train_batch(self, step: int) -> float:
        """One rollout and one batched update; returns the summed loss."""
        obs, acts, rews, dones = self._rollout()
        vnet = self.value_net
        with torch.no_grad():
            boot = forward(vnet, vnet.params, feed(
                vnet, np.stack(self._obs)))[:, 0].float().cpu().numpy()
        rets = n_step_returns(rews, dones, boot, self.gamma)
        return float(self.update(step, _flat(obs), _flat(acts),
                                 _flat(rets)))

    def train(self, batches: int = 100) -> List[float]:
        return [self.train_batch(i) for i in range(batches)]


class AsyncNStepQLearningDiscrete:
    """AsyncNStepQLearningDiscrete analog (RL4J async/nstep/discrete):
    ``n_envs`` parallel MDPs, ε-greedy behavior from the online Q-network,
    n-step targets bootstrapped from a periodically synced target
    network, one batched MSE update a rollout."""

    def __init__(self, mdp_factory: Callable[[], MDP],
                 q_net: MultiLayerNetwork, n_envs: int = 8,
                 n_steps: int = 5, gamma: float = 0.99,
                 target_update_freq: int = 40,
                 eps_start: float = 1.0, eps_min: float = 0.1,
                 eps_anneal_batches: int = 200, seed: int = 0):
        self.envs = [mdp_factory() for _ in range(n_envs)]
        self.net = q_net
        self.n_envs = n_envs
        self.n_steps = n_steps
        self.gamma = gamma
        self.target_update_freq = target_update_freq
        self.eps_start, self.eps_min = eps_start, eps_min
        self.eps_anneal = eps_anneal_batches
        self.rng = np.random.RandomState(seed)
        self._obs = [e.reset() for e in self.envs]
        self._ep_rewards = np.zeros(n_envs)
        self.episode_rewards: List[float] = []
        self.target_params = copy_params(q_net.params)
        self._iteration = DeviceIteration(q_net.device)
        self._batches = 0

    def _eps(self) -> float:
        f = min(1.0, self._batches / max(1, self.eps_anneal))
        return self.eps_start + (self.eps_min - self.eps_start) * f

    def _q(self, params, batch: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            q = forward(self.net, params, feed(self.net, batch))
        return q.float().cpu().numpy()

    def update(self, obs, acts, rets) -> torch.Tensor:
        """One MSE update of Q(s, a) to the n-step returns; returns the
        loss, a 0-d device tensor."""
        net = self.net
        s, a, ret = (feed(net, v) for v in (obs, acts, rets))
        step = self._iteration.at(self._batches)
        with torch.enable_grad():
            leaves = autograd_leaves(net.params)
            q_sa = take(forward(net, leaves, s), a)
            loss = torch.mean((q_sa - ret) ** 2)
            grads = grad_tree(loss, leaves)
        update(net, grads, step)
        step.add_(1)
        self._iteration.advanced()
        return loss.detach()

    def train_batch(self) -> float:
        eps = self._eps()
        obs_buf, act_buf, rew_buf, done_buf = [], [], [], []
        for _ in range(self.n_steps):
            batch = np.stack(self._obs)
            q = self._q(self.net.params, batch)
            acts = [int(self.rng.randint(q.shape[1]))
                    if self.rng.rand() < eps else int(np.argmax(q[k]))
                    for k in range(self.n_envs)]
            obs_buf.append(batch)
            act_buf.append(acts)
            rews, dones = _step_envs(self.envs, acts, self._ep_rewards,
                                     self._obs, self.episode_rewards)
            rew_buf.append(rews)
            done_buf.append(dones)
        obs = np.asarray(obs_buf, np.float32)
        acts = np.asarray(act_buf, np.int32)
        rews = np.asarray(rew_buf, np.float32)
        dones = np.asarray(done_buf)
        # n-step returns bootstrapped from the target network's max-Q
        boot = self._q(self.target_params, np.stack(self._obs)).max(axis=1)
        rets = n_step_returns(rews, dones, boot, self.gamma)
        loss = self.update(_flat(obs), _flat(acts), _flat(rets))
        self._batches += 1
        if self._batches % self.target_update_freq == 0:
            sync_params(self.target_params, self.net.params)
        return float(loss)

    def train(self, batches: int = 100) -> List[float]:
        return [self.train_batch() for _ in range(batches)]

    def play(self, mdp: MDP, max_steps: int = 200) -> float:
        obs = mdp.reset()
        total = 0.0
        for _ in range(max_steps):
            q = self._q(self.net.params, obs[None])[0]
            obs, r, done = mdp.step(int(np.argmax(q)))
            total += r
            if done:
                break
        return total
