"""Checkpointing of the full training state for exact resume.

Counterpart of ``deeplearning4j_tpu/parallel/checkpoint.py``, its ``.npz``
path. A checkpoint holds what exact resume needs: parameters, updater
state, layer state, iteration, epoch, the data cursor and the dropout
stream's generator state; a fit killed at any step and resumed from it
replays the uninterrupted run bit for bit.

* **The file.** ``<dir>/step_<N>.npz``, one array a leaf, keyed by the
  leaf's path in the JAX package's ``jax.tree_util.keystr`` form
  (``['params'][0]['W']``, ``['opt_state']['out']['b']['m']``), plus the
  ``latest.json`` marker. So a directory either package's
  ``TrainingCheckpointer(use_orbax=False)`` wrote restores into the
  other's same-configured network: a loader reads the keys its own
  network has and ignores the rest. The JAX package's ``['rng_key']`` (a
  ``jax.random`` key) and the port's ``['torch_rng_state']`` (its
  ``torch.Generator`` state) are each read only by their own package; a
  network that finds no generator state of its kind keeps its own.
  bfloat16 leaves are written as float32 (exactly) and read back into the
  leaf's dtype.
* **Durability.** Each save writes a temporary file, fsyncs it and
  publishes it with ``os.replace``; the marker records a sha256 of each
  file. ``restore`` verifies it and falls back, newest first, past a
  torn or unloadable file (``dl4j_tpu_checkpoint_corrupt_total``,
  ``dl4j_tpu_checkpoint_fallback_total``, a ``checkpoint_fallback``
  event). ``keep_last`` retention never evicts the newest intact
  checkpoint and never counts queued writes.
* **Asynchronous saves.** ``save_async`` copies every tensor to the host
  at the step boundary (non-blocking device-to-host copies, then one
  synchronization) and hands the arrays to one background writer
  thread, which does the durable write. A full queue drops the oldest
  pending snapshot (``drop_oldest``) or blocks the trainer (``block``);
  a failed background write raises :class:`CheckpointWriteError` on the
  next save; ``wait_until_finished`` drains the queue and sweeps the
  ``.tmp`` files a dead writer left behind.

The fault points ``worker_death`` (inside the durable write, before the
publishing rename) and ``checkpoint_torn_write`` (truncates the file
just published) prove the failure paths. The JAX package's orbax path is
not ported: orbax is a JAX library, and ``use_orbax=True`` raises.
"""

from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import shutil
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.nn.compiled import commit

logger = logging.getLogger(__name__)

#: overflow policies of the bounded async writer queue
OVERFLOW_POLICIES = ("drop_oldest", "block")

#: the port's generator state in a checkpoint (the JAX package's is
#: ``rng_key``)
RNG_STATE_KEY = "torch_rng_state"

# leaves a checkpoint may lack: the target keeps its own value
_OPTIONAL_KEYS = ("['rng_key']", "['data_cursor']", f"['{RNG_STATE_KEY}']")


class CheckpointWriteError(RuntimeError):
    """Raised on the next save when a background write failed: an async
    failure must not stay silent until restore time."""

    def __init__(self, failures: List[Tuple[int, BaseException]]):
        steps = [s for s, _ in failures]
        super().__init__(
            f"async checkpoint write failed for step(s) {steps}: "
            f"{failures[-1][1]!r}")
        self.failures = failures


# ---------------------------------------------------------------------------
# trees: the JAX package's key paths, host snapshots
# ---------------------------------------------------------------------------


def keystr_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) for every leaf, in ``jax.tree_util``'s order and
    ``keystr`` form: dict keys sorted and written ``[repr(key)]``, list
    and tuple positions ``[i]``; None and empty containers hold no
    leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += keystr_leaves(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += keystr_leaves(v, f"{prefix}[{i}]")
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def _map_leaves(fn, tree, prefix: str = ""):
    """The tree with ``fn(key path, leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def host_snapshot(state):
    """Every leaf of ``state`` as a host numpy array of its own: device
    tensors are copied without blocking, then one synchronization waits
    for all of them, so a writer thread never touches a device buffer.
    The copies are queued on the current stream, the one the training
    steps replay on, and the synchronization returns only when they are
    done: the next step's in-place writes come after them.
    bfloat16 becomes float32 (numpy has no bfloat16; the values are
    exact)."""
    moved = []

    def to_host(_, leaf):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.device.type == "cpu":
                return t.clone()
            moved.append(t.device)
            return t.to("cpu", non_blocking=True)
        return np.array(leaf)

    host = _map_leaves(to_host, state)
    for dev in set(moved):
        torch.cuda.synchronize(dev)

    def to_numpy(_, leaf):
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()
            return leaf.numpy()
        return leaf

    return _map_leaves(to_numpy, host)


def _as_leaf(arr: np.ndarray, like):
    """A loaded array as the target leaf's kind: a tensor of its dtype on
    its device, or a numpy array."""
    if not isinstance(like, torch.Tensor):
        return np.asarray(arr)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


# ---------------------------------------------------------------------------
# the background writer
# ---------------------------------------------------------------------------


class _AsyncWriter:
    """Bounded background writer: the training thread enqueues host
    snapshots, this thread makes them durable. One writer a
    checkpointer, so writes stay ordered and the marker consistent."""

    def __init__(self, ckpt: "TrainingCheckpointer", max_queue: int,
                 overflow: str):
        if overflow not in OVERFLOW_POLICIES:
            raise ValueError(
                f"overflow must be one of {OVERFLOW_POLICIES}, "
                f"got {overflow!r}")
        self._ckpt = ckpt
        self._max_queue = max(1, int(max_queue))
        self._overflow = overflow
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._in_flight: Optional[int] = None  # the step being written
        self._failures: List[Tuple[int, BaseException]] = []
        self._stop = False
        self._warned_drop = False
        self._thread: Optional[threading.Thread] = None
        m = observe.metrics()
        self._depth_g = m.gauge("dl4j_tpu_ckpt_queue_depth")
        self._saves_c = m.counter("dl4j_tpu_ckpt_async_saves_total")
        self._dropped_c = m.counter("dl4j_tpu_ckpt_dropped_total")
        self._blocked_c = m.counter("dl4j_tpu_ckpt_blocked_total")
        self._write_h = m.histogram("dl4j_tpu_ckpt_write_seconds")

    # ------------------------------------------------------- trainer side
    def _ensure_thread(self) -> None:
        with self._cv:
            if self._thread is None or not self._thread.is_alive():
                self._stop = False  # a stopped writer restarts on use
                self._thread = threading.Thread(
                    target=self._run, name="ckpt-writer", daemon=True)
                self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Drain the queue and retire the thread (idempotent; a later
        ``submit`` starts a new one)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
        self._thread = None

    def take_failures(self) -> List[Tuple[int, BaseException]]:
        with self._cv:
            out, self._failures = self._failures, []
        return out

    def submit(self, step: int, host_state: Dict[str, Any]) -> None:
        """Enqueue a host snapshot under the overflow policy; raises a
        failure of an earlier write first."""
        failures = self.take_failures()
        if failures:
            raise CheckpointWriteError(failures)
        self._ensure_thread()
        with self._cv:
            if len(self._q) >= self._max_queue:
                if self._overflow == "drop_oldest":
                    dropped_step, _ = self._q.popleft()
                    self._dropped_c.inc()
                    # this policy's normal backpressure: warn once
                    log = (logger.warning if not self._warned_drop
                           else logger.debug)
                    self._warned_drop = True
                    log("async checkpoint queue full: dropped the pending "
                        "snapshot of step %d (drop_oldest; counted in "
                        "dl4j_tpu_ckpt_dropped_total)", dropped_step)
                else:  # block
                    self._blocked_c.inc()
                    while len(self._q) >= self._max_queue and not self._stop:
                        self._cv.wait(timeout=0.1)
            self._q.append((step, host_state))
            self._depth_g.set(len(self._q))
            self._cv.notify_all()

    def wait_until_finished(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued snapshot is written (or dropped) and
        none is in flight; False on timeout."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            while self._q or self._in_flight is not None:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        return False
                self._cv.wait(timeout=remaining if remaining is not None
                              else 0.5)
        return True

    def pending(self) -> int:
        with self._cv:
            return len(self._q) + (self._in_flight is not None)

    # -------------------------------------------------------- writer side
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(timeout=0.5)
                if self._stop and not self._q:
                    return
                was_full = len(self._q) >= self._max_queue
                step, host_state = self._q.popleft()
                if self._overflow == "drop_oldest" and was_full:
                    # under backpressure only, the newest state wins; a
                    # queue that is not full writes every snapshot in
                    # order (more fallback points)
                    while self._q:
                        self._dropped_c.inc()
                        step, host_state = self._q.popleft()
                self._in_flight = step
                depth = len(self._q)
                self._depth_g.set(depth)
                self._cv.notify_all()
            t0 = time.perf_counter()
            try:
                self._ckpt._write_and_record(step, host_state)
                dt = time.perf_counter() - t0
                self._write_h.observe(dt)
                self._saves_c.inc()
                observe.log_event("ckpt_async", step=step,
                                  write_s=round(dt, 6), queue_depth=depth)
            except BaseException as e:  # raised on the next save
                logger.warning(
                    "async checkpoint write for step %d failed: %r", step, e)
                with self._cv:
                    self._failures.append((step, e))
            finally:
                with self._cv:
                    self._in_flight = None
                    self._cv.notify_all()


# ---------------------------------------------------------------------------
# the checkpointer
# ---------------------------------------------------------------------------


class TrainingCheckpointer:
    """Checkpoint the full training state for exact resume:
    ``save(step, net)``, ``save_async(step, net)``, ``restore(net)`` →
    step.

    State protocol: a net either has ``training_state()`` /
    ``apply_training_state(state)`` (``SameDiff``), or the attributes
    ``params``, ``opt_state``, ``net_state``, ``iteration_count``,
    ``epoch_count``, and optionally ``batch_in_epoch`` (the data cursor)
    and ``_gen`` (the dropout stream's ``torch.Generator``)
    (``MultiLayerNetwork``, ``ComputationGraph``)."""

    def __init__(self, directory: str, keep_last: Optional[int] = 3,
                 use_orbax: Optional[bool] = None,
                 max_queue: int = 2, overflow: str = "drop_oldest"):
        if use_orbax:
            raise ValueError(
                "use_orbax=True: orbax is a JAX library; the port writes "
                "the .npz checkpoints (use_orbax=False or None)")
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.keep_last = keep_last
        self._saved: list = []
        # retention-only verify memo keyed on (size, mtime_ns): pruning
        # must not re-hash the newest checkpoint on every save; the torn
        # write changes the signature. restore() always verifies afresh.
        self._verify_cache: Dict[str, Tuple[Tuple[int, int], bool]] = {}
        # serializes marker, _saved and retention across the training
        # thread and the writer thread
        self._io_lock = threading.RLock()
        self._writer = _AsyncWriter(self, max_queue=max_queue,
                                    overflow=overflow)
        self._load_marker()
        # a writer killed mid-write leaves its step_*.npz.tmp behind
        self._cleanup_orphan_tmps()

    # ------------------------------------------------------------------ save
    @staticmethod
    def _state_of(net) -> Dict[str, Any]:
        """The net's training state, its leaves as they live (tensors on
        the device)."""
        if hasattr(net, "training_state"):
            return dict(net.training_state())
        state = {
            "params": net.params,
            "opt_state": net.opt_state,
            "net_state": net.net_state,
            "iteration": np.asarray(net.iteration_count),
            "epoch": np.asarray(net.epoch_count),
            # completed batches of the current epoch: a resume replays
            # exactly the unseen rest
            "data_cursor": np.asarray(getattr(net, "batch_in_epoch", 0)),
        }
        gen = getattr(net, "_gen", None)
        if gen is not None:
            # the dropout stream is part of exact resume
            state[RNG_STATE_KEY] = gen.get_state()
        return state

    @staticmethod
    def _sha256_of(path: str) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()

    def _write_npz(self, step: int, state) -> Tuple[str, str]:
        """The durable write of a host snapshot: temporary file, fsync,
        sha256 of the bytes meant, ``os.replace``. Runs on the caller's
        thread (``save``) or the writer's (``save_async``)."""
        path = os.path.join(self.dir, f"step_{step}.npz")
        flat = {key: np.asarray(leaf) for key, leaf in keystr_leaves(state)}
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        checksum = self._sha256_of(tmp)
        # the writer dies mid-write: the checkpoint is lost and its .tmp
        # orphaned (swept by __init__ and wait_until_finished)
        faults.maybe_fail("worker_death")
        os.replace(tmp, path)
        if faults.should_fire("checkpoint_torn_write"):
            # corruption after the publish: what the marker's checksum
            # and restore's fallback are for
            with open(path, "r+b") as f:
                f.truncate(max(1, os.path.getsize(path) // 2))
        return path, checksum

    def _write_and_record(self, step: int, state) -> str:
        """Durable write, then the marker and retention (both threads)."""
        path, checksum = self._write_npz(step, state)
        with self._io_lock:
            self._record_saved(step, path, checksum)
            self._retain()
            # one marker write a save, after retention settles
            self._write_marker()
        observe.metrics().counter("dl4j_tpu_checkpoint_saves_total").inc()
        return path

    def save(self, step: int, net) -> str:
        """Synchronous save: the caller waits for the durable write (the
        SIGTERM snapshot, and the listener's default)."""
        failures = self._writer.take_failures()
        if failures:
            raise CheckpointWriteError(failures)
        return self._write_and_record(step, host_snapshot(
            self._state_of(net)))

    def save_async(self, step: int, net) -> None:
        """Asynchronous save: the host snapshot now (the training
        thread's only cost), the durable write on the writer thread. A
        failed background write raises here on the next call."""
        self._writer.submit(step, host_snapshot(self._state_of(net)))

    def wait_until_finished(self, timeout: Optional[float] = None) -> bool:
        """Drain the async queue (before a restore or exit); once drained,
        sweep the ``.tmp`` files a dead writer left."""
        ok = self._writer.wait_until_finished(timeout=timeout)
        if ok:
            self._cleanup_orphan_tmps()
        return ok

    def _cleanup_orphan_tmps(self) -> None:
        """Remove leftover temporaries; only with no write in flight."""
        with self._io_lock:
            for tmp in glob.glob(os.path.join(self.dir, "step_*.npz.tmp")):
                try:
                    os.remove(tmp)
                except OSError:  # best effort
                    pass

    def drain_failures(self) -> List[Tuple[int, BaseException]]:
        """Take and clear the background-write failures without raising
        (the fit-end and preemption paths decide on a compensating
        synchronous save instead)."""
        return self._writer.take_failures()

    def close(self, timeout: float = 30.0) -> None:
        """Drain pending writes and retire the writer thread (a later
        ``save_async`` restarts it)."""
        self._writer.wait_until_finished(timeout=timeout)
        self._writer.stop()

    def pending_async(self) -> int:
        """Queued + in-flight async writes."""
        return self._writer.pending()

    def _record_saved(self, step: int, path: str,
                      checksum: Optional[str]) -> None:
        """Insert sorted by step (a synchronous save can land while older
        async writes are queued). Call under ``_io_lock``."""
        entry = (step, path, checksum)
        self._saved = [e for e in self._saved if e[0] != step]
        idx = len(self._saved)
        while idx > 0 and self._saved[idx - 1][0] > step:
            idx -= 1
        self._saved.insert(idx, entry)

    def _write_marker(self) -> None:
        """Atomic marker update: a crash loses the newest entry, never
        the marker."""
        marker = os.path.join(self.dir, "latest.json")
        tmp = marker + ".tmp"
        newest = self._saved[-1] if self._saved else (None, None, None)
        with open(tmp, "w") as f:
            json.dump({"step": newest[0], "path": newest[1],
                       "saved": [[s, p, c] for s, p, c in self._saved]}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, marker)

    def _retain(self) -> None:
        """``keep_last`` pruning, oldest first, never deleting the newest
        checkpoint whose checksum verifies. Call under ``_io_lock``."""
        if self.keep_last is None or len(self._saved) <= self.keep_last:
            return
        newest_intact = next(
            ((s, p, c) for s, p, c in reversed(self._saved)
             if self._verify_for_retention(p, c)), None)
        idx = 0
        while len(self._saved) > self.keep_last and idx < len(self._saved):
            entry = self._saved[idx]
            if entry == newest_intact:
                idx += 1  # the only restorable checkpoint stays
                continue
            self._saved.pop(idx)
            _, old, _ = entry
            self._verify_cache.pop(old, None)
            if os.path.isdir(old):
                shutil.rmtree(old, ignore_errors=True)
            elif os.path.exists(old):
                os.remove(old)

    def _load_marker(self) -> None:
        marker = os.path.join(self.dir, "latest.json")
        if os.path.exists(marker):
            with open(marker) as f:
                d = json.load(f)
            # [step, path] pairs from before the checksums still load
            self._saved = [(e[0], e[1], e[2] if len(e) > 2 else None)
                           for e in d.get("saved", [])
                           if os.path.exists(e[1])]
            self._saved.sort(key=lambda e: e[0])

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        with self._io_lock:
            return self._saved[-1][0] if self._saved else None

    def _verify(self, path: str, checksum: Optional[str]) -> bool:
        """sha256 against the marker (skipped for an entry without one)."""
        if checksum is None or os.path.isdir(path):
            return True
        try:
            return self._sha256_of(path) == checksum
        except OSError:
            return False

    def _verify_for_retention(self, path: str,
                              checksum: Optional[str]) -> bool:
        """:meth:`_verify`, memoized on the file's (size, mtime_ns)."""
        try:
            st = os.stat(path)
        except OSError:
            return False
        key = (st.st_size, st.st_mtime_ns)
        hit = self._verify_cache.get(path)
        if hit is not None and hit[0] == key:
            return hit[1]
        ok = self._verify(path, checksum)
        self._verify_cache[path] = (key, ok)
        return ok

    def restore(self, net, step: Optional[int] = None) -> Optional[int]:
        """Restore into ``net`` (initialized, so its state has the
        checkpoint's structure); returns the step restored, or None.

        With ``step=None`` the checkpoints are tried newest first: one
        whose checksum does not match or whose load raises is skipped
        with a warning. An explicitly requested ``step`` that is corrupt
        raises."""
        with self._io_lock:
            saved = list(self._saved)
        if not saved:
            return None
        if step is None:
            candidates = list(reversed(saved))
        else:
            wanted = next(((s, p, c) for s, p, c in saved if s == step),
                          None)
            if wanted is None:
                raise ValueError(
                    f"no checkpoint recorded for step {step} under "
                    f"{self.dir} (retention may have pruned it); known "
                    f"steps: {[s for s, _, _ in saved]}")
            candidates = [wanted]
        newest = candidates[0][0]
        m = observe.metrics()
        for cand_step, path, checksum in candidates:
            if not self._verify(path, checksum):
                m.counter("dl4j_tpu_checkpoint_corrupt_total").inc()
                if step is not None:
                    raise IOError(
                        f"checkpoint step {cand_step} at {path} failed its "
                        f"integrity check (torn write?)")
                logger.warning(
                    "checkpoint step %d at %s failed its integrity check; "
                    "falling back to the next-newest intact checkpoint",
                    cand_step, path)
                continue
            try:
                restored = self._load_state(net, path)
            except Exception as e:
                m.counter("dl4j_tpu_checkpoint_corrupt_total").inc()
                if step is not None:
                    raise
                logger.warning(
                    "checkpoint step %d at %s failed to load (%r); falling "
                    "back", cand_step, path, e)
                continue
            if cand_step != newest:
                m.counter("dl4j_tpu_checkpoint_fallback_total").inc()
                observe.log_event("checkpoint_fallback",
                                  wanted=newest, used=cand_step)
            self._apply_state(net, restored)
            return cand_step
        logger.warning(
            "no intact checkpoint under %s: restore skipped (training "
            "resumes from the net's current state)", self.dir)
        return None

    def _load_state(self, net, path: str) -> Dict[str, Any]:
        """The checkpoint at ``path`` in the structure of the net's state,
        each leaf in the kind, dtype and device of the net's own."""
        with np.load(path) as data:
            def load(key, leaf):
                if key not in data.files and key.startswith(_OPTIONAL_KEYS):
                    # a checkpoint without this stream or cursor (the
                    # other package's, or an older one): keep the net's
                    return leaf
                return _as_leaf(data[key], leaf)

            return _map_leaves(load, self._state_of(net))

    @staticmethod
    def _apply_state(net, restored: Dict[str, Any]) -> None:
        """Write the restored state into the net: each array copied into
        the tensor already in its place (``nn/compiled.commit``), so the
        net keeps its buffers — a captured training step's static state —
        and its next step replays (the JAX restore's same-shape
        assignment, which keeps the jitted step)."""
        if hasattr(net, "apply_training_state"):
            net.apply_training_state(restored)
            return
        net.params = commit(net.params, restored["params"])
        net.opt_state = commit(net.opt_state, restored["opt_state"])
        net.net_state = commit(net.net_state, restored["net_state"])
        net.iteration_count = int(restored["iteration"])
        net.epoch_count = int(restored["epoch"])
        if "data_cursor" in restored:
            net.batch_in_epoch = int(restored["data_cursor"])
        gen = getattr(net, "_gen", None)
        if gen is not None and RNG_STATE_KEY in restored:
            gen.set_state(restored[RNG_STATE_KEY])


class CheckpointTrainingListener:
    """Periodic :class:`TrainingCheckpointer` saves as a training listener.

    ``asynchronous=True`` sends the periodic saves through the background
    writer. ``fit_done`` saves synchronously when the last step missed the
    ``every_n_iterations`` boundary, or when the tail's background write
    failed; ``on_preemption`` takes the final SIGTERM snapshot. A save
    that raises in ``iteration_done`` warns once and training goes on: a
    broken disk costs durability, not the run."""

    #: fit loops that call listeners once a tBPTT segment
    #: (ComputationGraph) skip this one mid-batch and call it once at the
    #: batch boundary: a snapshot mid-batch could not resume exactly
    defers_mid_tbptt = True

    def __init__(self, checkpointer: TrainingCheckpointer,
                 every_n_iterations: int = 100, asynchronous: bool = False):
        self.ckpt = checkpointer
        self.every = max(1, every_n_iterations)
        self.asynchronous = asynchronous
        self.last_saved_iteration: Optional[int] = None
        self._warned = False

    def _save(self, model, iteration: int, sync: bool = False) -> None:
        try:
            if self.asynchronous and not sync:
                self.ckpt.save_async(iteration, model)
            else:
                self.ckpt.save(iteration, model)
            self.last_saved_iteration = iteration
        except Exception as e:
            if not self._warned:
                self._warned = True
                logger.warning(
                    "checkpoint save at iteration %d failed (%r): training "
                    "continues WITHOUT durability; further failures "
                    "suppressed", iteration, e)

    def iteration_done(self, model, iteration, epoch, score):
        if getattr(model, "_tbptt_mid_batch", False):
            return  # deferred to the batch boundary
        if iteration % self.every == 0:
            self._save(model, iteration)

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def fit_done(self, model):
        """The final checkpoint: a run whose last step missed the
        boundary keeps its tail. ``last_saved_iteration`` moves on
        submission, so drain the writer first and save synchronously if
        the tail's write failed."""
        it = int(getattr(model, "iteration_count",
                         getattr(model, "_step", 0)))
        if not it:
            return
        failed = []
        if self.asynchronous:
            self.ckpt.wait_until_finished(timeout=60.0)
            failed = self.ckpt.drain_failures()
            if failed:
                logger.warning(
                    "async checkpoint write(s) for step(s) %s failed in "
                    "the background: taking a compensating synchronous "
                    "final save", [s for s, _ in failed])
        if failed or it != self.last_saved_iteration:
            self._save(model, it, sync=True)

    def on_preemption(self, model):
        """The SIGTERM grace period: one final synchronous snapshot (a
        stale background failure must not abort it)."""
        it = int(getattr(model, "iteration_count",
                         getattr(model, "_step", 0)))
        self.ckpt.wait_until_finished(timeout=30.0)
        self.ckpt.drain_failures()
        self._save(model, it, sync=True)
