"""SameDiff listeners: History and HistoryListener.

Counterpart of ``deeplearning4j_tpu/autodiff/listeners.py`` (nd4j
autodiff/listeners/**: records/History.java + HistoryListener). ``fit``
calls ``iteration_done(model, iteration, epoch, loss)`` after every step
and ``fit_done(model)`` after the last. ``UIListener`` waits for the UI
server's port (ROADMAP.md, Queue 1 item 9).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


class History:
    """records/History.java analog: training-run record."""

    def __init__(self):
        self.loss_curve: List[float] = []        # per-iteration losses
        self.epoch_losses: List[float] = []      # per-epoch means
        self.evaluations: Dict[str, List[Any]] = {}
        self.training_time_millis: float = 0.0

    def final_train_loss(self) -> float:
        return self.loss_curve[-1] if self.loss_curve else float("nan")

    def average_loss(self, epoch: int) -> float:
        return self.epoch_losses[epoch]

    def num_epochs(self) -> int:
        return len(self.epoch_losses)


class HistoryListener:
    """HistoryListener analog: accumulates a History across fit() calls.
    Reading each step's loss (``float(score)``) waits for the device once
    a step; attach it only where that per-step record is wanted.

    Usage:
        hl = HistoryListener()
        sd.set_listeners(hl)
        sd.fit(data, epochs=3)
        hl.history.loss_curve / .epoch_losses
    """

    def __init__(self):
        self.history = History()
        self._epoch_losses: List[float] = []
        self._current_epoch: Optional[int] = None
        # monotonic clock: this anchor exists only to be subtracted
        self._t0 = time.perf_counter()

    def iteration_done(self, model, iteration, epoch, score) -> None:
        s = float(score)
        if self._current_epoch is None:
            self._current_epoch = epoch
        if epoch != self._current_epoch:
            self._flush_epoch()
            self._current_epoch = epoch
        self.history.loss_curve.append(s)
        self._epoch_losses.append(s)
        self.history.training_time_millis = \
            (time.perf_counter() - self._t0) * 1000.0

    def _flush_epoch(self) -> None:
        if self._epoch_losses:
            self.history.epoch_losses.append(
                sum(self._epoch_losses) / len(self._epoch_losses))
            self._epoch_losses = []

    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        self._flush_epoch()

    def finalize(self) -> History:
        """Flush any open epoch and return the History."""
        self._flush_epoch()
        return self.history

