"""Where a MultiLayerNetwork training step's time goes, on the card.

    python -m deeplearning4j_tpu_torch.profile_mln [--trace out.json] [--zoo]

Trains the three networks of ``chip_smoke.py``'s sequential phases
(``testing/sequential.py``: LeNet at batch 64; the BiLSTM tagger, 32 ×
128 with ragged right-padded masks; the character LSTM, one batch of 32
× 1000 in 20 tBPTT segments) through ``fit`` with TF32 off, the tagger
also under ``helper_mode="generic"`` (the LSTM recurrence as the generic
Python scan instead of cuDNN). After 2 warm calls it profiles 3 calls
with ``torch.profiler`` and prints one JSON line per configuration:
host wall time per step (per batch for the character LSTM), summed device
kernel time, the device's busy share, the kernels with the most device
time (``profile_serve``'s summary), and the device time of the kernels
whose names hold ``RNN`` / ``LSTM`` (cuDNN's recurrence), ``gemm`` and
``fused_updater``. Needs a GPU; the numbers are the card's, printed
beside its name and power limit.

``--zoo`` profiles ``chip_smoke.py``'s ``zoo_cnn`` cells instead
(``testing/zoo_cnn.py``): one ``fit`` step of each trainable zoo model at
its defaults and batch, and one ``output`` of each detector, with the
device time of the kernels whose names hold ``conv``, ``gemm``,
``pool``, ``norm`` and ``fused_updater``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from deeplearning4j_tpu_torch.profile_serve import _profile

_WARM, _STEPS = 2, 3
_NAMED = ("RNN", "LSTM", "gemm", "fused_updater")
_ZOO_NAMED = ("conv", "gemm", "pool", "norm", "fused_updater")


def _sequential_cells(dev):
    """(phase, mode, build) for each sequential cell; ``build()`` gives
    (net, step, batch, input shape)."""
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.testing import sequential as S

    def cell(make, data):
        net = make()
        return (net, lambda: net.fit(data, batch_size=data.num_examples()),
                data.num_examples(), data.features.shape)

    tg = S.TAGGER

    def tagger():
        conf = S.tagger_conf(tg["features"], tg["hidden"], tg["tags"])
        data = S.tagger_batches(tg["batch"], tg["seq"], tg["min_len"],
                                tg["features"], tg["tags"], 1)[0][0]
        return cell(lambda: MultiLayerNetwork(conf, device=dev).init(),
                    data)

    return [
        ("lenet", "auto", lambda: cell(
            lambda: LeNet(device=dev).init(),
            S.lenet_batches(S.LENET["batch"], 1)[0])),
        ("bilstm_tagger", "auto", tagger),
        ("bilstm_tagger", "generic", tagger),
        ("char_lstm", "auto", lambda: cell(
            lambda: MultiLayerNetwork(S.char_conf(
                S.CHAR["vocab"], S.CHAR["hidden"], S.CHAR["tbptt"]),
                device=dev).init(),
            S.char_batch(S.CHAR["batch"], S.CHAR["seq"], S.CHAR["vocab"]))),
    ]


def _zoo_cells(dev):
    """(phase, mode, build) for each zoo_cnn cell; ``build()`` gives
    (net, step, batch, input shape)."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.testing import zoo_cnn as Z

    def trainer(name, batch):
        model = getattr(zoo, name)(device=dev)
        net = model.init()
        (x, y), = Z.batches(model, batch, 1)[0]
        return net, lambda: net.fit(x, y, batch_size=batch), batch, x.shape

    def detector(name, batch):
        model = getattr(zoo, name)(device=dev)
        net = model.init()
        x = Z.batches(model, batch, 0)[1][0]
        return net, lambda: net.output(x), batch, x.shape

    return ([(name, "auto", lambda n=name, b=batch: trainer(n, b))
             for name, batch, _ in Z.TRAIN]
            + [(name, "auto", lambda n=name, b=batch: detector(n, b))
               for name, batch in Z.DETECT])


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="write the tagger's (cuDNN) Chrome trace here")
    ap.add_argument("--zoo", action="store_true",
                    help="profile the zoo_cnn cells instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_mln: no GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    from deeplearning4j_tpu_torch.environment import environment

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    env = environment()
    cells = _zoo_cells(dev) if args.zoo else _sequential_cells(dev)
    named = _ZOO_NAMED if args.zoo else _NAMED
    for phase, mode, build in cells:
        net, step, batch, shape = build()
        env.helper_mode = mode
        try:
            for _ in range(_WARM):
                step()
            torch.cuda.synchronize()
            trace = args.trace if (phase, mode) == ("bilstm_tagger",
                                                    "auto") else None
            line = _profile(step, _STEPS, trace, named=named)
        finally:
            env.helper_mode = "auto"
        print(json.dumps({"phase": phase, "helper_mode": mode, "card": card,
                          "batch": batch, "shape": list(shape), **line}),
              flush=True)
        del net, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
