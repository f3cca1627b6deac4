"""Environments and network configurations for the reinforcement-learning
tests and chip_smoke's ``rl_dqn`` / ``rl_a3c`` phases (host numpy; no
``gym``, no Atari ROM).

* :class:`Catch`: bsuite's Catch (Osband et al., 2020,
  ``bsuite/environments/catch.py``): a ball falls from a random column of
  the top row of a 10 × 5 board, the paddle on the bottom row moves left,
  stays or moves right (3 actions), and the last of 9 steps pays +1 if
  the paddle is under the ball, else −1.
* :class:`CatchPixels`: Catch as an MDP over frames upscaled to 84 × 84
  by nearest neighbour, the last 4 stacked by a :class:`HistoryProcessor`
  (``skip_frames`` 1) and returned NHWC ``(84, 84, 4)``:
  ``get_history`` stacks channels first, the networks read NHWC.
* :class:`ChainMDP`: the 5-state chain of the JAX package's RL tests.
* :func:`conv_q_conf`, :func:`atari_2013_conf`: the Nature-DQN trunk
  (Mnih et al., 2015) under a ``DuelingQLayer`` head, and the 2013 Atari
  trunk (Mnih et al., 2013) under a softmax policy or a linear value
  head, built through either package's ``nn`` (their builders share one
  API), so one configuration crosses to both.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.rl.async_rl import HistoryProcessor
from deeplearning4j_tpu_torch.rl.dqn import MDP

# (n_out, kernel, stride) of each convolution
NATURE_CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
ATARI_2013_CONVS = ((16, 8, 4), (32, 4, 2))


class Catch:
    """bsuite Catch: ``reset`` → the board, ``step(a)`` → (board, reward,
    done); actions 0 left, 1 stay, 2 right."""

    def __init__(self, rows: int = 10, columns: int = 5, seed: int = 1):
        self.rows, self.columns = rows, columns
        self._rng = np.random.RandomState(seed)
        self._paddle_y = rows - 1

    def _board(self) -> np.ndarray:
        board = np.zeros((self.rows, self.columns), np.float32)
        board[self._ball_y, self._ball_x] = 1.0
        board[self._paddle_y, self._paddle_x] = 1.0
        return board

    def reset(self) -> np.ndarray:
        self._ball_x = int(self._rng.randint(self.columns))
        self._ball_y = 0
        self._paddle_x = self.columns // 2
        return self._board()

    def step(self, action: int) -> Tuple[np.ndarray, float, bool]:
        dx = int(action) - 1
        self._paddle_x = int(np.clip(self._paddle_x + dx, 0,
                                     self.columns - 1))
        self._ball_y += 1
        if self._ball_y == self._paddle_y:
            reward = 1.0 if self._paddle_x == self._ball_x else -1.0
            return self._board(), reward, True
        return self._board(), 0.0, False


def upscale(board: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-neighbour upscaling of a (rows, columns) board."""
    rows = np.arange(height) * board.shape[0] // height
    cols = np.arange(width) * board.shape[1] // width
    return board[rows][:, cols]


class CatchPixels(MDP):
    """Catch over ``history`` stacked ``size`` × ``size`` frames, NHWC."""

    def __init__(self, size: int = 84, history: int = 4, seed: int = 1):
        self.game = Catch(seed=seed)
        self.size = size
        self.history = HistoryProcessor(history_length=history,
                                        skip_frames=1)

    def _obs(self, board) -> np.ndarray:
        self.history.record(upscale(board, self.size, self.size))
        return np.ascontiguousarray(
            self.history.get_history().transpose(1, 2, 0))

    def reset(self) -> np.ndarray:
        self.history.reset()
        return self._obs(self.game.reset())

    def step(self, action: int) -> Tuple[np.ndarray, float, bool]:
        board, reward, done = self.game.step(action)
        return self._obs(board), reward, done

    @property
    def num_actions(self) -> int:
        return 3

    @property
    def obs_size(self) -> int:
        return self.size * self.size * self.history.history_length


class ChainMDP(MDP):
    """5-state chain: action 1 moves right (+1 at the end), action 0
    resets with a 0.01 distractor reward."""

    def __init__(self, length: int = 5):
        self.length = length
        self.pos = 0

    def reset(self):
        self.pos = 0
        return self._obs()

    def _obs(self):
        o = np.zeros(self.length, np.float32)
        o[self.pos] = 1.0
        return o

    def step(self, action):
        if action == 1:
            self.pos += 1
            if self.pos >= self.length - 1:
                return self._obs(), 1.0, True
            return self._obs(), 0.0, False
        self.pos = 0
        return self._obs(), 0.01, False

    @property
    def num_actions(self):
        return 2

    @property
    def obs_size(self):
        return self.length


def _trunk(pkg, b, convs: Sequence[Tuple[int, int, int]], dense: int):
    for n_out, k, s in convs:
        b = b.layer(pkg.ConvolutionLayer(n_out=n_out, kernel=(k, k),
                                         stride=(s, s), activation="relu"))
    return b.layer(pkg.DenseLayer(n_out=dense, activation="relu"))


def conv_q_conf(pkg, n_actions: int = 3, shape=(84, 84, 4),
                convs=NATURE_CONVS, dense: int = 512,
                learning_rate: float = 6.25e-5, seed: int = 0):
    """A convolutional Q-network under a ``DuelingQLayer`` head (Adam);
    the defaults are the Nature-DQN trunk on Catch's 84 × 84 × 4 stack."""
    b = (pkg.builder().seed(seed)
         .updater(pkg.Adam(learning_rate=learning_rate)).list())
    b = _trunk(pkg, b, convs, dense)
    b = b.layer(pkg.DuelingQLayer(n_actions=n_actions,
                                  activation="identity"))
    return b.set_input_type(pkg.InputType.convolutional(*shape)).build()


def atari_2013_conf(pkg, head: str, n_actions: int = 3, shape=(84, 84, 4),
                    convs=ATARI_2013_CONVS, dense: int = 256,
                    learning_rate: float = 1e-4, seed: int = 0):
    """The 2013 Atari trunk under a softmax policy head (``head="policy"``)
    or a linear value head (``"value"``), Adam."""
    b = (pkg.builder().seed(seed)
         .updater(pkg.Adam(learning_rate=learning_rate)).list())
    b = _trunk(pkg, b, convs, dense)
    b = b.layer(pkg.OutputLayer(n_out=n_actions, activation="softmax",
                                loss="mcxent") if head == "policy" else
                pkg.OutputLayer(n_out=1, activation="identity", loss="mse"))
    return b.set_input_type(pkg.InputType.convolutional(*shape)).build()
