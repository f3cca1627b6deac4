"""Multi-process bootstrap, per-rank data sharding, the launcher and
cluster-wide evaluation.

Counterpart of ``deeplearning4j_tpu/parallel/launch.py``. Where the JAX
package calls ``jax.distributed.initialize`` and then runs one SPMD
program over the global mesh, each process of the port joins a
``torch.distributed`` process group — NCCL for the card, gloo for the
CPU — and runs its rank's share (``parallel/mesh.py``). The layout comes
from the same variables: ``DL4J_TPU_COORDINATOR`` (``host:port``, or an
``init_method`` URL such as ``file:///path``), ``DL4J_TPU_NUM_PROCS`` and
``DL4J_TPU_PROC_ID``.

Run a script as N coordinated workers, relaunched from their checkpoints
after a failure::

    python -m deeplearning4j_tpu_torch.parallel.launch --nprocs 2 \\
        --restarts 1 -- my_fit_script.py arg1 arg2
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.environment import resolve_device


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> Optional[torch.device]:
    """Join the process group the ``DL4J_TPU_*`` variables describe (or
    the arguments): NCCL when ``device`` (the card unless the caller passes
    the CPU) is a GPU, one card a process (rank modulo the cards), gloo on
    the CPU. Returns the rank's device, or None when no coordinator is set
    (a single-process run: nothing to join)."""
    coordinator_address = (coordinator_address
                           or os.environ.get("DL4J_TPU_COORDINATOR"))
    if num_processes is None and "DL4J_TPU_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["DL4J_TPU_NUM_PROCS"])
    if process_id is None and "DL4J_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["DL4J_TPU_PROC_ID"])
    if coordinator_address is None:
        return None
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, world_size=num_processes,
                            rank=process_id,
                            device_id=dev if dev.type == "cuda" else None)
    return dev


def _rank_world(process_id, num_processes):
    up = dist.is_initialized()
    pid = process_id if process_id is not None else (
        dist.get_rank() if up else 0)
    n = num_processes if num_processes is not None else (
        dist.get_world_size() if up else 1)
    return pid, n


def host_shard(items: Sequence, process_id: Optional[int] = None,
               num_processes: Optional[int] = None) -> list:
    """Rank i's share of a work list (files, example ranges):
    ``items[i::N]`` (the VirtualDataSetIterator partitioning role)."""
    pid, n = _rank_world(process_id, num_processes)
    return list(items)[pid::n]


class ShardedDataSetIterator:
    """One rank's shard of a dataset iterator (defaults: the process
    group's rank and size; on a mesh with axes beside ``data``, pass the
    rank's data coordinate and the data axis size).

    A base iterator with file-level sharding (``shard_files()``) is
    sharded once here and iterated whole: each rank reads 1/N of the
    files. Otherwise the batches are dealt round-robin, and every rank
    still reads the whole base (one warning says so)."""

    def __init__(self, base, process_id: Optional[int] = None,
                 num_processes: Optional[int] = None):
        self.base = base
        self.pid, self.n = _rank_world(process_id, num_processes)
        self._file_sharded = False
        if hasattr(base, "shard_files") and self.n > 1:
            if getattr(base, "_dl4j_file_sharded", False):
                raise ValueError(
                    "this reader was already file-sharded by another "
                    "ShardedDataSetIterator — wrapping it twice would "
                    "compound to 1/N² of the data; reuse the first wrapper "
                    "or construct a fresh reader")
            base.shard_files(self.pid, self.n)
            base._dl4j_file_sharded = True
            self._file_sharded = True
        elif self.n > 1:
            import warnings

            warnings.warn(
                "ShardedDataSetIterator: base iterator has no shard_files();"
                " falling back to batch round-robin — every rank still runs"
                " the full ETL. Give the reader file-level sharding for"
                " O(global/N) input cost.", stacklevel=2)

    @property
    def batch_size(self):
        return self.base.batch_size

    def reset(self):
        self.base.reset()

    def __iter__(self):
        if self._file_sharded:
            yield from self.base
            return
        for i, ds in enumerate(self.base):
            if i % self.n == self.pid:
                yield ds


# ---------------------------------------------------------------------------
# The launcher: N workers joined through the DL4J_TPU_* variables; on a
# worker failure the survivors are killed and the job relaunched, the
# workers resuming from their latest checkpoint.
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(nprocs: int, argv: Sequence[str], restarts: int = 0,
           env_extra: Optional[dict] = None, timeout: float = 600.0) -> int:
    """Run ``argv`` (a script and its arguments) as ``nprocs`` coordinated
    worker processes. Each attempt takes a fresh coordinator port; a
    worker that fails kills the attempt, and up to ``restarts`` further
    attempts follow. Returns 0 when an attempt succeeded, 124 when the
    workers ran past ``timeout`` seconds (not retried), 1 otherwise."""
    import subprocess
    import sys
    import time

    for attempt in range(restarts + 1):
        port = _free_port()
        procs = []
        for pid in range(nprocs):
            env = dict(os.environ)
            env.update(env_extra or {})
            env.update({
                "DL4J_TPU_COORDINATOR": f"127.0.0.1:{port}",
                "DL4J_TPU_NUM_PROCS": str(nprocs),
                "DL4J_TPU_PROC_ID": str(pid),
            })
            procs.append(subprocess.Popen(
                [sys.executable] + list(argv), env=env))
        deadline = time.time() + timeout
        failed = timed_out = False
        while procs:
            for p in list(procs):
                rc = p.poll()
                if rc is None:
                    continue
                procs.remove(p)
                if rc != 0:
                    failed = True
            timed_out = bool(procs) and time.time() > deadline
            if failed or timed_out:
                for p in procs:  # the survivors may wait in a collective
                    p.terminate()  # on the dead rank
                for p in procs:
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
                break
            time.sleep(0.1)
        if not failed and not timed_out:
            return 0
        if timed_out and not failed:
            print(f"[launch] attempt {attempt + 1}: workers exceeded the "
                  f"--timeout of {timeout:.0f}s and were killed (not a "
                  f"worker failure; raise --timeout for long jobs)",
                  flush=True)
            return 124
        print(f"[launch] attempt {attempt + 1}/{restarts + 1} failed "
              f"(worker crash)"
              + ("; relaunching (workers resume from checkpoint)"
                 if attempt < restarts else ""),
              flush=True)
    return 1


def main(args: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.parallel.launch",
        description="Multi-process training launcher: N workers joined "
                    "through torch.distributed; on a failure the job is "
                    "relaunched and the workers resume from their latest "
                    "checkpoint.")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--restarts", type=int, default=0,
                    help="relaunch attempts after a worker failure")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-attempt wall-clock limit (seconds)")
    ap.add_argument("argv", nargs="+",
                    help="worker script and its args (prefix with --)")
    ns = ap.parse_args(args)
    return launch(ns.nprocs, ns.argv, restarts=ns.restarts,
                  timeout=ns.timeout)


def distributed_evaluate(net, iterator, evaluation=None):
    """Cluster-wide evaluation (dl4j-spark's ``doEvaluation``): each rank
    evaluates its shard of ``iterator`` (a ``ShardedDataSetIterator``),
    then the confusion matrices are summed over the process group, so
    every rank returns the same global ``Evaluation``. Every rank issues
    the same two collectives (the class count, then the matrix), also a
    rank that saw no batch. One process: plain ``evaluate``."""
    local = net.evaluate(iterator, evaluation=evaluation)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local
    dev = net.device if dist.get_backend() == "nccl" else torch.device("cpu")
    n = torch.tensor([int(local.num_classes or 0)], dtype=torch.int64,
                     device=dev)
    dist.all_reduce(n, op=dist.ReduceOp.MAX)
    k = int(n.item())
    conf = np.zeros((k, k), np.int64)
    if local.confusion is not None:
        ln = local.confusion.shape[0]
        conf[:ln, :ln] = local.confusion
    total = torch.from_numpy(conf).to(dev)
    dist.all_reduce(total)
    local.num_classes = k
    local.confusion = total.cpu().numpy()
    return local


if __name__ == "__main__":
    raise SystemExit(main())
