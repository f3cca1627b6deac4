"""Reinforcement learning of the port, the RL4J role: DQN, the synchronous
and batched actor-critics, n-step Q-learning and the MDP adapters
(counterpart of ``deeplearning4j_tpu/rl``)."""

from deeplearning4j_tpu_torch.rl.dqn import (
    MDP, ActorCritic, BoltzmannPolicy, EpsGreedy, ExpReplay, GreedyPolicy,
    QLearningConfiguration, QLearningDiscrete, dueling_q_net,
)
from deeplearning4j_tpu_torch.rl.async_rl import (
    A3CDiscrete, AsyncNStepQLearningDiscrete, GymMDP, HistoryProcessor,
)

__all__ = ["MDP", "ActorCritic", "BoltzmannPolicy", "EpsGreedy", "ExpReplay",
           "GreedyPolicy", "QLearningConfiguration", "QLearningDiscrete",
           "dueling_q_net", "A3CDiscrete", "AsyncNStepQLearningDiscrete",
           "GymMDP", "HistoryProcessor"]
