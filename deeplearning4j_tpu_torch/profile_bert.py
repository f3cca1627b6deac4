"""Where a BERT-base training step's time goes, on the card.

    python -m deeplearning4j_tpu_torch.profile_bert [--eager] [--trace out.json]

Trains BERT-base at full width (``BertConfig.base()``, random weights
from the port's seed, attention and FFN dropout 0.1) through
``BertModel(...)`` → ``fit_*`` in the two configurations of
``chip_smoke.py``'s BERT phases, with the same settings (TF32 off):

* ``bert_train`` — float32, ``fit_classifier``, batch 32 × seq 128,
  ragged rows (16…128 tokens);
* ``bert_mlm``   — bfloat16, ``fit_mlm``, batch 8 × seq 512.

After 2 warm steps it profiles 3 steps with ``torch.profiler`` and prints
one JSON line per configuration: host wall time per step, summed device
kernel time per step, the device's busy share and the kernels with the
most device time (``profile_serve``'s summary), and the fused updater's
own time (``fused_updater``). Needs a GPU; the numbers
are the card's, printed beside its name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

from deeplearning4j_tpu_torch.profile_serve import _profile

_WARM, _STEPS = 2, 3
CONFIGS = (("bert_train", "float32", "classifier", 32, 128, 16),
           ("bert_mlm", "bfloat16", "mlm", 8, 512, None))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="write bert_train's Chrome trace here")
    ap.add_argument("--eager", action="store_true",
                    help="run the training steps op by op (disable_capture); "
                         "by default each is a CUDA-graph replay")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_bert: no GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deeplearning4j_tpu_torch.models.bert import BertConfig
    from deeplearning4j_tpu_torch.ops.capture import disable_capture

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = BertConfig.base()
    with disable_capture() if args.eager else contextlib.nullcontext():
        _run(args, card, dev, cfg)
    return 0


def _run(args, card, dev, cfg) -> None:
    """Each configuration: warm steps (the step's capture), then the
    profiled steps."""
    import torch

    from deeplearning4j_tpu_torch.datasets import synthetic_bert_batch
    from deeplearning4j_tpu_torch.models.bert import BertModel

    for phase, dtype, task, batch, seq, min_len in CONFIGS:
        model = BertModel(cfg, seed=0, dtype=getattr(torch, dtype),
                          device=dev)
        data = synthetic_bert_batch(
            batch, seq, cfg.vocab_size, seed=300, min_len=min_len,
            task="seq_classification" if task == "classifier"
            else "unsupervised")
        fit = model.fit_classifier if task == "classifier" else model.fit_mlm

        def step():
            fit([data])

        for _ in range(_WARM):
            step()
        torch.cuda.synchronize()
        trace = args.trace if phase == "bert_train" else None
        print(json.dumps({"phase": phase, "card": card,
                          "model": f"BertModel(BertConfig.base(), "
                                   f"dtype={dtype})", "task": task,
                          "batch": batch, "seq": seq,
                          "captured": not args.eager,
                          **_profile(step, _STEPS, trace,
                                     named=("fused_updater",))}), flush=True)
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
