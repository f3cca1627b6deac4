"""Where an imported BERT-base forward's, a fine-tune step's or an int8
forward's time goes, on the card.

    python -m deeplearning4j_tpu_torch.profile_import [--finetune | --int8] [--eager] [--trace out.json]

Builds the ONNX bytes of a BERT-base-width encoder with the port's builder
(``testing.onnx_builder.BERT_BASE_ONNX``: 12 layers, d 768, 12 heads, ff
3072, vocab 30522, random weights from a numpy seed) and imports them with
``import_onnx`` onto the card; batch 32 × seq 128 with ragged rows, TF32
off.

* Default — ``chip_smoke.py``'s ``onnx_bert`` main path:
  ``sd.output(feeds, ["y"])``, the optimized plan of ~450 nodes replayed
  as one CUDA-graph capture (``--eager``: run node by node under
  ``disable_capture()``), with 72 ``fused_matmul_bias_act`` and 12
  ``dot_product_attention`` kernel launches a forward. 2 warm forwards,
  then 3 profiled.
* ``--finetune`` — ``chip_smoke.py``'s ``sd_bert_finetune`` main path
  ("SameDiff BERT-base step time"): the token-classification head
  (dense → LayerNorm → GELU → 9 tags) added in SameDiff, Adam lr 5e-5,
  ``sd.fit`` on one repeated batch, each step a replay of the training
  unit's capture (``--eager``: op by op). 2 warm steps, then 3 profiled
  steps in one ``fit``; the port's kernel launches a step are read from
  the wrappers' counters over those steps.
* ``--int8`` — ``chip_smoke.py``'s ``int8_bert`` main path: the same
  weights and feeds with every dense MatMul a ``matmul_int8``
  (``testing.int8_bert.bert_int8_encoder`` through ``SameDiff``; no ONNX
  bytes), ``sd.output(feeds, ["y"])`` (captured, or ``--eager``), 73 int8
  GEMM + 73 row-quantize and 12 flash launches a forward. 2 warm forwards,
  then 3 profiled.

Prints one JSON line: host wall time per forward or step, summed device
kernel time, the device's busy share and the kernels with the most device
time. Needs a GPU; the numbers are the card's, printed beside its name
and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

from deeplearning4j_tpu_torch.profile_serve import _profile

_WARM, _STEPS = 2, 3


def _port_launches() -> dict:
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    return dict(ca.launch_counts(),
                fused_layer_norm=cl.fused_layer_norm_kernel.launches,
                fused_matmul_bias_act=cm.fused_matmul.launches,
                fused_updater=cu.fused_updater.launches,
                fused_updater_leaves=cu.fused_updater.leaves,
                **{f"int8_{k}": v for k, v in cq.launch_counts().items()})


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--finetune", action="store_true",
                      help="profile sd.fit steps instead of forwards")
    mode.add_argument("--int8", action="store_true",
                      help="profile the int8 encoder's forwards")
    ap.add_argument("--trace", default=None,
                    help="write the Chrome trace here")
    ap.add_argument("--eager", action="store_true",
                    help="run sd.output node by node (disable_capture)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_import: no GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeplearning4j_tpu_torch.ops.capture import disable_capture

    with disable_capture() if args.eager else contextlib.nullcontext():
        return _profile_import(args)


def _profile_import(args) -> int:
    import torch

    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.imports import import_onnx
    from deeplearning4j_tpu_torch.nn.updater import Adam
    from deeplearning4j_tpu_torch.testing import onnx_builder as ob
    from deeplearning4j_tpu_torch.testing.int8_bert import bert_int8_encoder

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = ob.BERT_BASE_ONNX
    dev = torch.device("cuda", 0)
    if args.int8:
        sd = SameDiff(device=dev)
        bert_int8_encoder(sd, ob.bert_onnx_weights(**{
            k: cfg[k] for k in ("layers", "seq", "d", "ff", "vocab")}),
            batch=cfg["batch"], seq=cfg["seq"], heads=cfg["heads"])
    else:
        sd = import_onnx(ob.bert_onnx_model(**cfg), device=dev)
    feeds = ob.bert_onnx_feeds(cfg["batch"], cfg["seq"], cfg["vocab"])
    if not args.finetune:
        def forward():
            sd.output(feeds, ["y"])

        for _ in range(_WARM):
            forward()
        torch.cuda.synchronize()
        st = sd.last_compile_stats
        before = _port_launches()
        prof = _profile(forward, _STEPS, args.trace, top=12)
        after = _port_launches()
        print(json.dumps({
            "phase": "int8_bert" if args.int8 else "onnx_bert", "card": card,
            "captured": not args.eager,
            "config": cfg, "plan_nodes": st.nodes_after,
            "fusions": st.fusions,
            "port_kernel_launches_per_forward": {
                k: (after[k] - before[k]) / _STEPS for k in after
                if after[k] != before[k]},
            **prof}), flush=True)
        return 0

    _, loss = ob.add_token_head(
        sd, f"l{cfg['layers'] - 1}_out", ob.token_head_arrays(cfg["d"]),
        cfg["batch"], cfg["seq"])
    sd.set_training_config(TrainingConfig(
        updater=Adam(learning_rate=5e-5),
        data_set_feature_mapping=["ids", "mask"],
        data_set_label_mapping=["labels"], loss_variables=[loss]))
    batch = ob.TokenBatch(feeds, ob.token_labels(cfg["batch"], cfg["seq"]))
    sd.fit([batch] * _WARM)
    torch.cuda.synchronize()
    before = _port_launches()
    prof = _profile(lambda: sd.fit([batch] * _STEPS), 1, args.trace,
                    steps_per_call=_STEPS, top=16,
                    named=("fused_updater",))
    after = _port_launches()
    st = sd.last_compile_stats
    print(json.dumps({
        "phase": "sd_bert_finetune", "card": card, "config": cfg,
        "plan_nodes": st.nodes_after, "fusions": st.fusions,
        "leaves": len(sd.training_state()["params"]),
        "port_kernel_launches_per_step": {
            k: (after[k] - before[k]) / _STEPS for k in after},
        **prof}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
