"""The port's tests share the CPU with the other workers of a parallel
test run.

Under pytest-xdist every worker imports every test module while it
collects, before any test runs. Importing this module there sets the
worker's torch intra-op threads to its share of the cores
(``cpu_count // workers``, at least one). torch's default, one thread a
core in every worker, oversubscribes the cores: on an 8-core host with
6 workers, eleven of the heaviest port test files took 363 s with the
default and 252 s with the share. Outside xdist
(``PYTEST_XDIST_WORKER_COUNT`` unset) torch keeps its default.
"""

import os
from typing import Mapping, Optional

import torch


def worker_threads(environ: Mapping[str, str] = os.environ,
                   cpus: Optional[int] = None) -> Optional[int]:
    """A parallel test run's worker's share of the cores, or None outside
    one."""
    workers = int(environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if not workers:
        return None
    return max(1, (cpus or os.cpu_count() or 1) // workers)


SHARE = worker_threads()
if SHARE is not None:
    torch.set_num_threads(SHARE)


def test_worker_threads_share_the_cores():
    assert worker_threads({}, 8) is None
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "6"}, 8) == 1
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "2"}, 8) == 4
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "16"}, 8) == 1
    if SHARE is not None:
        assert torch.get_num_threads() == SHARE
