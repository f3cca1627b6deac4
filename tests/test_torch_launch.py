"""The port's launcher (``parallel/launch.py``): N workers joined over
gloo from the ``DL4J_TPU_*`` layout, a worker failure killing the attempt
and a relaunch resuming from the checkpoint — the JAX package's
``tests/test_launch_elastic.py`` with the port's worker
(``testing/distributed_fit.py``: ``ParallelWrapper`` data parallelism,
rank 0 saving every 4 steps)."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_launcher(tmp_path, tag, crash_at=0, restarts=0, nprocs=2,
                 steps=12):
    out = tmp_path / f"{tag}_out.json"
    ckdir = tmp_path / f"{tag}_ck"
    argv = [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.launch",
            "--nprocs", str(nprocs), "--restarts", str(restarts),
            "--timeout", "240", "--",
            "-m", "deeplearning4j_tpu_torch.testing.distributed_fit",
            "--steps", str(steps), "--checkpoint-dir", str(ckdir),
            "--checkpoint-every", "4", "--out", str(out), "--device", "cpu"]
    if crash_at:
        argv += ["--crash-at", str(crash_at),
                 "--crash-marker", str(tmp_path / f"{tag}_marker")]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = str(max(1, torch.get_num_threads() // nprocs))
    proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=500)
    return proc, out


def test_clean_multiprocess_fit(tmp_path):
    proc, out = run_launcher(tmp_path, "clean")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    res = json.loads(out.read_text())
    assert res["final_iteration"] == 12
    assert res["first_step"] == 0
    assert len(res["losses"]) == 12
    assert res["losses"][-1] < res["losses"][0]


def test_kill_worker_and_resume_matches_uninterrupted(tmp_path):
    ref_proc, ref_out = run_launcher(tmp_path, "ref")
    assert ref_proc.returncode == 0, ref_proc.stdout + ref_proc.stderr
    ref = json.loads(ref_out.read_text())
    # rank 0 dies at step 10 (after the step-8 checkpoint); one restart
    proc, out = run_launcher(tmp_path, "fault", crash_at=10, restarts=1)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "injected crash" in proc.stdout
    assert "relaunching" in proc.stdout
    res = json.loads(out.read_text())
    assert res["first_step"] == 8
    assert res["final_iteration"] == 12
    np.testing.assert_allclose(res["losses"], ref["losses"][8:], rtol=0,
                               atol=1e-6)
    assert res["param_sha256"] == ref["param_sha256"]


def test_launcher_reports_failure_when_no_restarts(tmp_path):
    proc, _ = run_launcher(tmp_path, "nofix", crash_at=6, restarts=0)
    assert proc.returncode == 1
    assert "injected crash" in proc.stdout


def test_parallel_check_over_four_ranks(tmp_path):
    """``testing/parallel_check.py`` (the multi-GPU check) at its CPU
    widths through the launcher: every case within its bound against the
    one-rank run."""
    out = tmp_path / "check.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = str(max(1, torch.get_num_threads() // 4))
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.launch",
         "--nprocs", "4", "--timeout", "240", "--", "-m",
         "deeplearning4j_tpu_torch.testing.parallel_check", "--small",
         "--device", "cpu", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    res = json.loads(out.read_text())
    assert res["ok"] and res["world"] == 4 and res["backend"] == "gloo"
    cases = {c["case"]: c for c in res["parallel_check"]}
    assert set(cases) == {"moe_ep", "moe_dp", "bn_dp", "ring", "ulysses"}
    assert "all_to_all" in cases["moe_ep"]["collectives"]
    assert all(c["ok"] for c in cases.values())
