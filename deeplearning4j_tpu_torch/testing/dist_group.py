"""A gloo process group on the CPU for the parallel package's tests.

The JAX package tests its mesh code on 8 virtual CPU devices of one
process. The port's counterpart is a group of real processes, one a rank,
joined by ``torch.distributed`` over gloo: :func:`run_group` writes the
cases to a work directory, starts ``world`` processes of this module
(``python -m deeplearning4j_tpu_torch.testing.dist_group DIR RANK WORLD
THREADS``), and returns what each rank's cases returned.

* Each group has its own rendezvous: a ``FileStore`` file in the work
  directory (``file://`` init method), so groups of parallel test workers
  never meet.
* Each rank runs ``torch.set_num_threads(THREADS)``: its share of the
  calling test worker's threads.
* A case is ``(name, "module:function", kwargs)``; every rank runs every
  case in order (the collectives of a case must line up across ranks)
  and writes ``{name: result}`` to ``out<rank>.pkl``. A case that raises
  ends its process with the traceback on stderr; the other ranks are then
  killed and :func:`run_group` raises with the output.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time
from typing import Any, Dict, List, Sequence, Tuple

Case = Tuple[str, str, Dict[str, Any]]


def run_group(workdir: str, world: int, cases: Sequence[Case], *,
              threads: int = 1, timeout: float = 240.0) -> List[dict]:
    """Run ``cases`` on a fresh group of ``world`` ranks (module
    docstring); returns each rank's ``{name: result}`` in rank order."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "cases.pkl"), "wb") as f:
        pickle.dump(list(cases), f)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    logs = [open(os.path.join(workdir, f"log{r}.txt"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", __name__, workdir, str(r), str(world),
         str(threads)], stdout=logs[r], stderr=subprocess.STDOUT, env=env,
        cwd=root) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        text = []
        for r in range(world):
            logs[r].seek(0)
            text.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                        + logs[r].read()[-4000:])
        for f in logs:
            f.close()
        raise RuntimeError("process group failed:\n" + "\n".join(text))
    for f in logs:
        f.close()
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _worker(workdir: str, rank: int, world: int, threads: int) -> int:
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.launch import (
        initialize_distributed)

    torch.set_num_threads(threads)
    initialize_distributed(f"file://{os.path.join(workdir, 'rendezvous')}",
                           world, rank, device="cpu")
    with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    results = {}
    for name, target, kwargs in cases:
        module, fn = target.split(":")
        results[name] = getattr(importlib.import_module(module), fn)(
            **kwargs)
    with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                     int(sys.argv[4])))
