"""Where an imported BERT-base forward's time goes, on the card.

    python -m deeplearning4j_tpu_torch.profile_import [--trace out.json]

Builds the ONNX bytes of a BERT-base-width encoder with the port's builder
(``testing.onnx_builder.BERT_BASE_ONNX``: 12 layers, d 768, 12 heads, ff
3072, vocab 30522, random weights from a numpy seed), imports them with
``import_onnx`` onto the card, and runs ``sd.output(feeds, ["y"])`` on
batch 32 × seq 128 with ragged rows — ``chip_smoke.py``'s ``onnx_bert``
main path: the optimized plan of ~450 nodes, eager, with 72
``fused_matmul_bias_act`` and 12 ``dot_product_attention`` kernel
launches a forward (TF32 off). After 2 warm forwards it profiles 3 with
``torch.profiler`` and prints one JSON line: host wall time per forward,
summed device kernel time, the device's busy share and the kernels with
the most device time. Needs a GPU; the numbers are the card's, printed
beside its name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from deeplearning4j_tpu_torch.profile_serve import _profile

_WARM, _STEPS = 2, 3


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="write the Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_import: no GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deeplearning4j_tpu_torch.imports import import_onnx
    from deeplearning4j_tpu_torch.testing.onnx_builder import (
        BERT_BASE_ONNX, bert_onnx_feeds, bert_onnx_model)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = BERT_BASE_ONNX
    sd = import_onnx(bert_onnx_model(**cfg), device=torch.device("cuda", 0))
    feeds = bert_onnx_feeds(cfg["batch"], cfg["seq"], cfg["vocab"])

    def forward():
        sd.output(feeds, ["y"])

    for _ in range(_WARM):
        forward()
    torch.cuda.synchronize()
    st = sd.last_compile_stats
    print(json.dumps({"phase": "onnx_bert", "card": card, "config": cfg,
                      "plan_nodes": st.nodes_after, "fusions": st.fusions,
                      **_profile(forward, _STEPS, args.trace)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
