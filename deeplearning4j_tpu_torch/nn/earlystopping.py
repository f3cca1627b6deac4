"""Early stopping (deeplearning4j-core's earlystopping).

Counterpart of ``deeplearning4j_tpu/nn/earlystopping.py``:
EarlyStoppingConfiguration.java, trainer/EarlyStoppingTrainer.java, the
termination conditions (MaxEpochsTerminationCondition,
ScoreImprovementEpochTerminationCondition,
MaxScoreIterationTerminationCondition, MaxTimeIterationTerminationCondition),
saver/{InMemoryModelSaver, LocalFileModelSaver} and EarlyStoppingResult,
for a MultiLayerNetwork or a ComputationGraph.

:class:`InMemoryModelSaver` copies the network's parameters and layer
state (tensors cloned on their device), not the network: on the card a
network holds CUDA-graph captures, generators and pinned buffers, which a
deep copy must not duplicate. Restoring copies the saved values back into
the live tensors where the trees match, so a captured training step keeps
its buffers.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float,
                  history: List[float]) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score, history):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after ``max_epochs_without_improvement`` epochs without an
    improvement of at least ``min_improvement``."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement

    def terminate(self, epoch, score, history):
        if len(history) <= self.patience:
            return False
        best_before = min(history[:-self.patience])
        recent_best = min(history[-self.patience:])
        return recent_best >= best_before - self.min_improvement


class IterationTerminationCondition:
    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort when the score passes a bound or is not finite (a
    divergence guard)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, score):
        return score > self.max_score or not np.isfinite(score)


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def terminate(self, score):
        # a monotonic clock: the budget is a duration
        if self._start is None:
            self._start = time.perf_counter()
            return False
        return time.perf_counter() - self._start > self.max_seconds


def _snapshot(tree):
    """A parameter or layer-state tree with every tensor cloned."""
    from deeplearning4j_tpu_torch.models import _tree

    return _tree.map_tree(lambda t: t.detach().clone(), tree)


def _restore(live, saved):
    """``saved`` as the network's tree: its values copied into the live
    tensors where every leaf's shape and dtype match (the buffers a
    captured training step reads stay the same), else ``saved`` itself."""
    from deeplearning4j_tpu_torch.models import _tree

    lp, sp = list(_tree.leaf_paths(live)), list(_tree.leaf_paths(saved))
    same = len(lp) == len(sp) and all(
        a == b and isinstance(x, torch.Tensor) and x.shape == y.shape
        and x.dtype == y.dtype and x.device == y.device
        for (a, x), (b, y) in zip(lp, sp))
    if not same:
        return saved
    with torch.no_grad():
        for (_, x), (_, y) in zip(lp, sp):
            x.copy_(y)
    return live


class InMemoryModelSaver:
    """saver/InMemoryModelSaver.java: the best (and latest) parameters and
    layer state, kept in memory."""

    def __init__(self):
        self.best = None
        self.latest = None

    def save_best(self, net):
        self.best = {"params": _snapshot(net.params),
                     "net_state": _snapshot(net.net_state)}

    def save_latest(self, net):
        self.latest = {"params": _snapshot(net.params),
                       "net_state": _snapshot(net.net_state)}

    def restore_best(self, net):
        if self.best is not None:
            net.params = _restore(net.params, self.best["params"])
            net.net_state = _restore(net.net_state, self.best["net_state"])
        return net


class LocalFileModelSaver:
    """saver/LocalFileModelSaver.java: ``bestModel.zip`` and
    ``latestModel.zip`` in ``directory``."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def save_best(self, net):
        from deeplearning4j_tpu_torch.nn.serde import save_model

        save_model(net, os.path.join(self.dir, "bestModel.zip"))

    def save_latest(self, net):
        from deeplearning4j_tpu_torch.nn.serde import save_model

        save_model(net, os.path.join(self.dir, "latestModel.zip"))

    def restore_best(self, net):
        from deeplearning4j_tpu_torch.nn.serde import restore_model

        return restore_model(os.path.join(self.dir, "bestModel.zip"),
                             device=net.device)


class EarlyStoppingConfiguration:
    """EarlyStoppingConfiguration.Builder (keyword arguments instead of a
    builder)."""

    def __init__(self,
                 epoch_termination_conditions: Optional[
                     List[EpochTerminationCondition]] = None,
                 iteration_termination_conditions: Optional[
                     List[IterationTerminationCondition]] = None,
                 score_calculator: Optional[Callable[[Any], float]] = None,
                 model_saver=None,
                 evaluate_every_n_epochs: int = 1,
                 save_last_model: bool = False):
        self.epoch_conditions = epoch_termination_conditions or []
        self.iteration_conditions = iteration_termination_conditions or []
        self.score_calculator = score_calculator
        self.saver = (model_saver if model_saver is not None
                      else InMemoryModelSaver())
        self.every_n = max(1, evaluate_every_n_epochs)
        self.save_last_model = save_last_model


class EarlyStoppingResult:
    """EarlyStoppingResult.java: the reason, the best epoch and score, the
    score history and the best model."""

    def __init__(self, termination_reason: str, termination_details: str,
                 best_epoch: int, best_score: float, total_epochs: int,
                 score_history: Dict[int, float], best_model):
        self.termination_reason = termination_reason
        self.termination_details = termination_details
        self.best_epoch = best_epoch
        self.best_score = best_score
        self.total_epochs = total_epochs
        self.score_history = score_history
        self.best_model = best_model


class EarlyStoppingTrainer:
    """trainer/EarlyStoppingTrainer.java for a MultiLayerNetwork or a
    ComputationGraph: one epoch of ``fit`` at a time, the iteration
    conditions on the training score, the held-out score every
    ``evaluate_every_n_epochs`` epochs (the mean of ``net.score(ds)`` over
    the test iterator, or the configuration's ``score_calculator``), the
    best model saved, the epoch conditions, and the best model restored
    at the end."""

    def __init__(self, config: EarlyStoppingConfiguration, net,
                 train_iterator, test_iterator=None):
        self.cfg = config
        self.net = net
        self.train_iter = train_iterator
        self.test_iter = test_iterator

    def _score(self) -> float:
        if self.cfg.score_calculator is not None:
            return float(self.cfg.score_calculator(self.net))
        if self.test_iter is not None:
            return float(np.mean([self.net.score(ds)
                                  for ds in self.test_iter]))
        return self.net.score()

    def fit(self) -> EarlyStoppingResult:
        best_score = float("inf")
        best_epoch = -1
        history: Dict[int, float] = {}
        epoch_scores: List[float] = []
        epoch = 0
        reason, details = "EpochTerminationCondition", "exhausted"
        while True:
            self.net.fit(self.train_iter, epochs=1)
            train_score = self.net.score()
            stop_iter = False
            for c in self.cfg.iteration_conditions:
                if c.terminate(train_score):
                    reason = "IterationTerminationCondition"
                    details = f"{type(c).__name__} at epoch {epoch}"
                    stop_iter = True
                    break
            if stop_iter:
                break
            if epoch % self.cfg.every_n == 0:
                score = self._score()
                history[epoch] = score
                epoch_scores.append(score)
                if score < best_score:
                    best_score = score
                    best_epoch = epoch
                    self.cfg.saver.save_best(self.net)
                if self.cfg.save_last_model:
                    self.cfg.saver.save_latest(self.net)
            # the epoch conditions run every epoch and see the most recent
            # held-out score
            last = epoch_scores[-1] if epoch_scores else float("inf")
            stop_epoch = False
            for c in self.cfg.epoch_conditions:
                if c.terminate(epoch, last, epoch_scores):
                    reason = "EpochTerminationCondition"
                    details = f"{type(c).__name__} at epoch {epoch}"
                    stop_epoch = True
                    break
            if stop_epoch:
                break
            epoch += 1
        best_model = self.cfg.saver.restore_best(self.net)
        return EarlyStoppingResult(reason, details, best_epoch, best_score,
                                   epoch + 1, history, best_model)
