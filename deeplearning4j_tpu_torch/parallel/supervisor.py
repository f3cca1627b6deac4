"""TrainingSupervisor: a fit that survives being killed.

Counterpart of ``deeplearning4j_tpu/parallel/supervisor.py``, the
training twin of the serving engine's supervisor:

* every crash (the injected ``preemption`` fault, any exception between
  steps) restores the newest intact checkpoint (parameters, updater
  state, the dropout generator's state, iteration, epoch, data cursor)
  and resumes, within ``max_restarts`` and after a capped exponential
  backoff, so the replayed steps see exactly the batches and random
  draws the uninterrupted run saw: the trajectory is bit for bit the
  same;
* the network object survives an in-process restart and the restored
  tensors keep their shapes and dtypes;
* a SIGTERM (with ``install_sigterm=True``, on the main thread) sets
  the graceful-preemption flag: the fit loop takes one final synchronous
  snapshot and returns, ``fit`` returns ``"preempted"``, and the next
  launch resumes from that step.

Usage::

    net = MultiLayerNetwork(conf).init()
    ckpt = TrainingCheckpointer(directory)
    sup = TrainingSupervisor(net, ckpt, save_every=10, install_sigterm=True)
    sup.fit(features, labels, epochs=3, batch_size=32)   # resumable

With ``$DL4J_TPU_COMPILE_CACHE`` set, ``resume`` also warm-boots the
network's exported train step (``autodiff/export.py``
``maybe_warm_boot_net``): the resumed fit's first batch runs the restored
program, recorded as ``cache_hit``, instead of tracing the step again.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Any, Optional

from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.parallel.checkpoint import (
    CheckpointTrainingListener,
    TrainingCheckpointer,
)

logger = logging.getLogger(__name__)


class TrainingSupervisor:
    """Supervise a fit loop: periodic checkpoints (asynchronous by
    default), bounded restore-and-resume on crashes, graceful SIGTERM
    snapshots. ``max_restarts`` caps recoveries (past it the exception
    propagates); restarts back off from ``restart_backoff_s``, doubling,
    capped at 2 s; every resume is counted
    (``dl4j_tpu_ckpt_resumes_total``) and logged (``train_resume``).
    ``fit`` returns ``"completed"`` or ``"preempted"``."""

    def __init__(self, net, checkpointer: TrainingCheckpointer, *,
                 save_every: int = 1, max_restarts: int = 5,
                 restart_backoff_s: float = 0.05,
                 install_sigterm: bool = False,
                 asynchronous: bool = True):
        self.net = net
        self.ckpt = checkpointer
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.install_sigterm = install_sigterm
        self.restarts = 0
        self.listener = CheckpointTrainingListener(
            checkpointer, every_n_iterations=save_every,
            asynchronous=asynchronous)
        self._prev_handler: Any = None

    # ----------------------------------------------------------- sigterm
    def _install_handler(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            logger.warning("SIGTERM handler not installed: fit is not on "
                           "the main thread")
            return

        def _on_sigterm(signum, frame):
            faults.request_preemption()

        self._prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)

    def _uninstall_handler(self) -> None:
        if self._prev_handler is not None:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._prev_handler = None

    # --------------------------------------------------------------- fit
    def _attach(self) -> None:
        listeners = getattr(self.net, "listeners", None)
        if listeners is None:  # SameDiff keeps them in _listeners
            listeners = getattr(self.net, "_listeners", None)
            if listeners is None:
                listeners = []
                self.net._listeners = listeners
        if self.listener not in listeners:
            listeners.append(self.listener)

    def resume(self) -> Optional[int]:
        """Restore the newest intact checkpoint into the net, after
        draining the async queue. Returns the step restored, or None."""
        self.ckpt.wait_until_finished(timeout=60.0)
        restored = self.ckpt.restore(self.net)
        # the compiled state too: a train step exported by an earlier
        # process (export_train_step) restores into the net's _jit_cache
        from deeplearning4j_tpu_torch.autodiff import export as _aot_export

        _aot_export.maybe_warm_boot_net(self.net)
        if restored is not None:
            epoch = int(getattr(self.net, "epoch_count", 0))
            cursor = int(getattr(self.net, "batch_in_epoch", 0))
            observe.metrics().counter("dl4j_tpu_ckpt_resumes_total").inc()
            observe.log_event("train_resume", step=restored,
                              restarts=self.restarts, epoch=epoch,
                              cursor=cursor)
            logger.warning("training resumed from checkpoint step %d "
                           "(epoch %d, cursor %d)", restored, epoch, cursor)
        return restored

    def _realign_iterator(self, data) -> None:
        """A shuffling ListDataSetIterator draws each epoch's order from
        its own epoch counter: set it to the net's epoch, so the replayed
        rest sees the uninterrupted run's order."""
        if hasattr(data, "_epoch"):
            data._epoch = int(getattr(self.net, "epoch_count", 0))

    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 32, resume: bool = True,
            **fit_kwargs) -> str:
        """Run, or resume, a supervised fit to ``epochs`` epochs in all:
        a net restored at ``epoch_count == 2`` with ``epochs=5`` trains 3
        more. Arrays or a DataSet become one ListDataSetIterator, so every
        restart replays the same batches."""
        from deeplearning4j_tpu_torch.datasets.dataset import (
            DataSet, ListDataSetIterator)

        if labels is not None:
            data = ListDataSetIterator(DataSet(data, labels),
                                       batch_size=batch_size)
        elif isinstance(data, DataSet):
            data = ListDataSetIterator(data, batch_size=batch_size)

        self._attach()
        if self.install_sigterm:
            self._install_handler()

        def preempted() -> str:
            # a supervisor that installed the handler owns the flag: clear
            # it so a later fit in this process can train (a request made
            # by someone else stays set for them to clear)
            if self.install_sigterm:
                faults.clear_preemption()
            return "preempted"

        try:
            if resume and self.ckpt.latest_step() is not None:
                self.resume()
            while True:
                if faults.preemption_requested():
                    return preempted()
                remaining = epochs - int(getattr(self.net, "epoch_count", 0))
                if remaining <= 0:
                    return "completed"
                self._realign_iterator(data)
                epoch_before = int(getattr(self.net, "epoch_count", 0))
                try:
                    self.net.fit(data, epochs=remaining, **fit_kwargs)
                except Exception as e:
                    self.restarts += 1
                    if self.restarts > self.max_restarts:
                        logger.error(
                            "training crashed %d times (cap %d); giving up: "
                            "%r", self.restarts, self.max_restarts, e)
                        raise
                    backoff = min(
                        self.restart_backoff_s * (2 ** (self.restarts - 1)),
                        2.0)
                    logger.warning(
                        "training crashed (%r): restart %d/%d after %.3fs",
                        e, self.restarts, self.max_restarts, backoff)
                    time.sleep(backoff)
                    self.resume()
                    continue
                if faults.preemption_requested():
                    return preempted()  # the loop snapshotted and returned
                if int(getattr(self.net, "epoch_count",
                               epoch_before)) == epoch_before:
                    # no progress and no exception (no data?): stop here
                    # rather than loop forever
                    return "completed"
        finally:
            self._uninstall_handler()
            self.ckpt.wait_until_finished(timeout=60.0)
