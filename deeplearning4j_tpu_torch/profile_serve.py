"""Where a serving step's time goes, on the card.

    python -m deeplearning4j_tpu_torch.profile_serve [--eager] [--trace out.json]

Serves GPT at GPT-2-small width (GptConfig.base(), float32, random weights
from a numpy seed, as ``chip_smoke.py`` does) through the port's
GenerativeEngine — its prefill, write-prompt and decode steps replayed as
CUDA-graph captures, or with ``--eager`` run op by op under
``disable_capture()`` — then profiles with ``torch.profiler`` (CPU + CUDA
activities):

* ``prefill`` — one admission of a 512-token prompt (the TTFT path);
* ``decode``  — steady decode steps with all 8 slots active.

For each it prints one JSON line: host wall time per step, summed device
kernel time per step, the device's busy share (kernel time / wall; idle =
1 - busy) and the kernels with the most device time. Needs a GPU; the
numbers are the card's, printed beside its name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np

_DECODE_STEPS = 10  # profiled decode steps, after 3 warm ones

def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _profile(fn, steps: int, trace_path=None, *, steps_per_call: int = 1,
             top: int = 8, named=()):
    """Profile ``steps`` calls of ``fn`` (each ``steps_per_call`` steps of
    the workload); every per-step figure is over ``steps *
    steps_per_call`` steps. ``top`` kernels by device time are listed, and
    for each substring in ``named`` the kernels whose name holds it are
    summed, wherever they rank."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps *= steps_per_call
    if trace_path:
        prof.export_chrome_trace(trace_path)
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and getattr(e.device_type, "name", "") == "CUDA"]
    total_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:top]
    return {
        "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_ms_per_step": (total_us / 1e3 / steps) if total_us else None,
        "device_busy_share": (total_us / 1e6 / wall) if total_us else None,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels": [{"name": e.key[:80], "calls_per_step":
                         e.count / steps, "ms_per_step":
                         _device_us(e) / 1e3 / steps} for e in top],
        "named_kernels": {s: {
            "calls_per_step": sum(e.count for e in kernels if s in e.key)
            / steps,
            "ms_per_step": sum(_device_us(e) for e in kernels if s in e.key)
            / 1e3 / steps} for s in named},
    }


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="write the decode window's Chrome trace here")
    ap.add_argument("--eager", action="store_true",
                    help="run the steps op by op (disable_capture)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deeplearning4j_tpu_torch.ops.capture import disable_capture

    with disable_capture() if args.eager else contextlib.nullcontext():
        return _serve(args)


def _serve(args) -> int:
    import torch

    from deeplearning4j_tpu_torch.models.gpt import (
        GptConfig, GptModel, init_gpt_params)
    from deeplearning4j_tpu_torch.serving import GenerativeEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = GptConfig.base()
    model = GptModel(cfg, device=dev, params=init_gpt_params(
        cfg, seed=0, device=dev, std=2.0 / math.sqrt(cfg.hidden)))
    eng = GenerativeEngine(model, max_slots=8, page_size=16,
                           max_pages_per_seq=64, max_prompt=512, seed=0,
                           device=dev)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    # warm-up admission + decode (cuBLAS handles, kernel libraries)
    eng.generate([prompt], max_new_tokens=2)

    def admit_one():
        eng.submit(prompt, max_new_tokens=1)
        eng.step()  # admits (prefill), then retires: max_new_tokens == 1

    out = {"card": card, "model": "GptConfig.base()", "dtype": "float32",
           "captured": not args.eager}
    print(json.dumps({"phase": "prefill", **out,
                      **_profile(admit_one, 3)}), flush=True)

    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, 256).astype(np.int32),
                   max_new_tokens=4 + _DECODE_STEPS + 3, eos_token=-1)
    eng.step()       # admits all 8
    for _ in range(3):
        eng.step()   # warm decode
    print(json.dumps({"phase": "decode", "active_slots": 8, **out,
                      **_profile(eng.step, _DECODE_STEPS, args.trace,
                                 named=("paged_decode",))}),
          flush=True)
    while eng.scheduler.has_work():
        eng.step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
