"""Where a ResNet-50 training step's time goes, on the card.

    python -m deeplearning4j_tpu_torch.profile_train [--eager] [--trace out.json]

Trains ResNet-50 at full width (224×224×3, 1000 classes, random weights
from the port's seed) through ``ResNet50(...).init()`` → ``fit`` in the
two configurations of ``chip_smoke.py``'s train phases, with the same
settings (deterministic cuDNN, TF32 off):

* ``train``       — ``ResNet50()``, float32, batch 32;
* ``train_fused`` — ``ResNet50(fused_blocks=True, dtype="mixed")``,
  batch 128.

After 2 warm steps it profiles 3 steps with ``torch.profiler`` and prints
one JSON line per configuration: host wall time per step, summed device
kernel time per step, the device's busy share, the kernels with the
most device time (``profile_serve``'s summary), the fused
BN-apply/matmul/BN-statistics kernels' own time (``bn_matmul_stats``,
both designs) and the fused updater's (``fused_updater``). Needs a GPU; the numbers are the card's, printed beside
its name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

import numpy as np

from deeplearning4j_tpu_torch.profile_serve import _profile

_WARM, _STEPS = 2, 3


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="write the fused configuration's Chrome trace here")
    ap.add_argument("--eager", action="store_true",
                    help="run the training steps op by op (disable_capture); "
                         "by default each is a CUDA-graph replay")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    from deeplearning4j_tpu_torch.ops.capture import disable_capture

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    with disable_capture() if args.eager else contextlib.nullcontext():
        _run(args, card, dev)
    return 0


def _run(args, card, dev) -> None:
    """Each configuration: warm steps (the step's capture), then the
    profiled steps."""
    import torch

    from deeplearning4j_tpu_torch.datasets import synthetic_image_batch
    from deeplearning4j_tpu_torch.models import ResNet50

    for phase, fused, dtype, batch in (("train", False, "float32", 32),
                                       ("train_fused", True, "mixed", 128)):
        net = ResNet50(fused_blocks=fused, dtype=dtype, device=dev).init()
        x, lab = synthetic_image_batch(batch, 224, 224, 3, 1000, seed=100)
        y = np.eye(1000, dtype=np.float32)[lab]

        def step():
            net.fit(x, y, batch_size=batch)

        for _ in range(_WARM):
            step()
        torch.cuda.synchronize()
        trace = args.trace if fused else None
        print(json.dumps({"phase": phase, "card": card,
                          "model": f"ResNet50(fused_blocks={fused}, "
                                   f"dtype={dtype!r})", "batch": batch,
                          "captured": not args.eager,
                          **_profile(step, _STEPS, trace,
                                     named=("bn_matmul_stats",
                                            "fused_updater"))}), flush=True)
        del net
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
