"""Training listeners (org/deeplearning4j/optimize/listeners).

Counterpart of ``deeplearning4j_tpu/nn/listeners.py``: the
``TrainingListener`` hooks (``iteration_done``, ``on_epoch_start``,
``on_epoch_end``, ``fit_done``, ``on_preemption``), ``notify_fit_done``,
``notify_preemption``, and ``ScoreIterationListener``, ``PerformanceListener``,
``TimeIterationListener``, ``CollectScoresIterationListener``,
``EvaluativeListener`` and ``CheckpointListener``.

``fit`` hands each listener the step's loss as the 0-d device tensor the
step returned, so a step adds no host synchronization unless a listener
reads the score: ``CollectScoresIterationListener`` converts it with
``float``, ``ScoreIterationListener`` when it logs, ``PerformanceListener``
only with ``report_score``. ``PerformanceListener``'s rates are host time
between calls, which on an asynchronous device is the rate the host
enqueues steps (the reference's reading on an async backend too).

The fit loops poll ``faults.preemption_requested()`` once a batch; on a
graceful-preemption request they call :func:`notify_preemption` (the
checkpoint listener's final synchronous snapshot) and return.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class TrainingListener:
    """TrainingListener.java: every hook optional. ``fit`` calls
    ``fit_done`` once when its loop completes, and ``on_preemption`` when
    a graceful-preemption request (SIGTERM) makes it return early."""

    def iteration_done(self, model, iteration: int, epoch: int,
                       score) -> None:
        pass

    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass

    def fit_done(self, model) -> None:
        pass

    def on_preemption(self, model) -> None:
        pass


def notify_fit_done(model, listeners) -> None:
    """``fit_done`` across listeners; one that raises is logged, not
    propagated (a listener written without the hook is skipped)."""
    for lst in listeners:
        fn = getattr(lst, "fit_done", None)
        if fn is not None:
            try:
                fn(model)
            except Exception:
                logger.warning("fit_done listener %r raised", lst,
                               exc_info=True)


def notify_iteration(model, iteration: int, loss) -> None:
    """``iteration_done`` across ``model.listeners`` at ``iteration`` (the
    scanned loops' epilogue, once a step after the chunk)."""
    for lst in model.listeners:
        lst.iteration_done(model, iteration, model.epoch_count, loss)


def notify_preemption(model, listeners) -> None:
    """The graceful-preemption exit: count and log it, then fire
    ``on_preemption`` across listeners (the checkpoint listener's final
    synchronous snapshot). One that raises is logged: the grace period is
    finite. All logging of the request happens here, at the polling site
    (``faults.request_preemption`` runs inside a signal handler)."""
    from deeplearning4j_tpu_torch import observe

    observe.metrics().counter("dl4j_tpu_train_preemptions_total").inc()
    observe.log_event(
        "train_preempt", phase="snapshot",
        iteration=int(getattr(model, "iteration_count",
                              getattr(model, "_step", 0))))
    logger.warning("preemption requested: taking a final snapshot and "
                   "leaving the fit loop")
    for lst in listeners:
        fn = getattr(lst, "on_preemption", None)
        if fn is not None:
            try:
                fn(model)
            except Exception:
                logger.warning("on_preemption listener %r raised", lst,
                               exc_info=True)


class ScoreIterationListener(TrainingListener):
    """ScoreIterationListener.java: log the score every N iterations."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.print_iterations == 0:
            logger.info("Score at iteration %d is %s", iteration,
                        float(score))


class PerformanceListener(TrainingListener):
    """PerformanceListener.java: batches/s, samples/s and ms an iteration
    over every ``frequency`` iterations (the first call starts the
    clock)."""

    def __init__(self, frequency: int = 10, report_score: bool = False):
        self.frequency = max(1, frequency)
        self.report_score = report_score
        self._last_time = None
        self._last_iter = 0
        self.history: List[Dict[str, float]] = []

    def iteration_done(self, model, iteration, epoch, score):
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time, self._last_iter = now, iteration
            return
        if iteration - self._last_iter >= self.frequency:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            batch = getattr(model, "last_batch_size", 0)
            rec = {
                "iteration": iteration,
                "batches_per_sec": iters / dt,
                "samples_per_sec": iters * batch / dt,
                "iter_ms": 1000.0 * dt / iters,
            }
            self.history.append(rec)
            from deeplearning4j_tpu_torch import observe

            m = observe.metrics()
            m.gauge("dl4j_tpu_examples_per_sec").set(rec["samples_per_sec"])
            m.gauge("dl4j_tpu_batches_per_sec").set(rec["batches_per_sec"])
            msg = (f"iteration {iteration}: {rec['batches_per_sec']:.1f} "
                   f"batches/sec, {rec['samples_per_sec']:.1f} samples/sec, "
                   f"{rec['iter_ms']:.2f} ms/iter")
            if self.report_score:
                msg += f", score {float(score)}"
            logger.info(msg)
            self._last_time, self._last_iter = now, iteration


class TimeIterationListener(TrainingListener):
    """TimeIterationListener.java: estimated time remaining."""

    def __init__(self, total_iterations: int, frequency: int = 50):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self._start = None

    def iteration_done(self, model, iteration, epoch, score):
        if self._start is None:
            self._start = time.perf_counter()
            return
        if iteration and iteration % self.frequency == 0:
            elapsed = time.perf_counter() - self._start
            remaining = elapsed / iteration * max(self.total - iteration, 0)
            logger.info("iteration %d/%d — est. remaining %.0fs", iteration,
                        self.total, remaining)


class CollectScoresIterationListener(TrainingListener):
    """CollectScoresIterationListener.java: (iteration, score) pairs."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))


class EvaluativeListener(TrainingListener):
    """EvaluativeListener.java: ``model.evaluate`` every N iterations, or
    at each epoch's end."""

    def __init__(self, iterator, frequency: int = 1, unit: str = "epoch"):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.unit = unit
        self.evaluations: List[Any] = []

    def _evaluate(self, model):
        e = model.evaluate(self.iterator)
        self.evaluations.append(e)
        logger.info("EvaluativeListener accuracy: %.4f", e.accuracy())

    def iteration_done(self, model, iteration, epoch, score):
        if (self.unit == "iteration" and iteration
                and iteration % self.frequency == 0):
            self._evaluate(model)

    def on_epoch_end(self, model):
        if self.unit == "epoch":
            self._evaluate(model)


class CheckpointListener(TrainingListener):
    """CheckpointListener.java: a model zip every N iterations or epochs
    (``save_model``, which writes either network), the last
    ``keep_last`` kept."""

    def __init__(self, directory: str,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_n_epochs: Optional[int] = None,
                 keep_last: Optional[int] = None):
        self.dir = directory
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.keep_last = keep_last
        self.saved: List[str] = []
        os.makedirs(directory, exist_ok=True)

    def _save(self, model, tag: str):
        from deeplearning4j_tpu_torch.nn.serde import save_model

        path = os.path.join(self.dir, f"checkpoint_{tag}.zip")
        save_model(model, path)
        self.saved.append(path)
        if self.keep_last and len(self.saved) > self.keep_last:
            old = self.saved.pop(0)
            if os.path.exists(old):
                os.remove(old)
        logger.info("checkpoint saved: %s", path)

    def iteration_done(self, model, iteration, epoch, score):
        if self.every_iter and iteration and iteration % self.every_iter == 0:
            self._save(model, f"iter_{iteration}")

    def on_epoch_end(self, model):
        if self.every_epoch:
            ep = getattr(model, "epoch_count", 0)
            if ep % self.every_epoch == 0:
                self._save(model, f"epoch_{ep}")
