"""A data-parallel fit worker for the launcher (the port of the JAX
package's ``examples/distributed_fit.py``)::

    python -m deeplearning4j_tpu_torch.parallel.launch --nprocs 2 \\
        --restarts 1 -- -m deeplearning4j_tpu_torch.testing.distributed_fit \\
        --steps 12 --checkpoint-dir /tmp/ck --device cpu

Each process joins the group from the launcher's ``DL4J_TPU_*`` layout,
feeds its rows of every global batch (the same global data on every rank,
drawn from the step number), and trains through ``ParallelWrapper``; rank
0 saves the state every ``--checkpoint-every`` steps, and a relaunched
worker restores the latest checkpoint and goes on from the next step.
``--crash-at K`` with ``--crash-marker PATH``: rank 0 dies hard at step K
on the first attempt only (the marker makes the relaunch skip it).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np


def make_step_batch(step: int, global_batch: int, n_in: int, n_out: int):
    """The global batch of a step: every rank derives the same data and
    takes its own rows."""
    r = np.random.RandomState(1000 + step)
    x = r.randn(global_batch, n_in).astype(np.float32)
    w_true = np.linspace(-1, 1, n_in * n_out).reshape(n_in, n_out)
    logits = x @ w_true
    y = (logits == logits.max(axis=1, keepdims=True)).astype(np.float32)
    return x, y


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--checkpoint-every", type=int, default=4)
    ap.add_argument("--out", default=None,
                    help="rank 0 writes the losses and a parameter digest")
    ap.add_argument("--crash-at", type=int, default=0)
    ap.add_argument("--crash-marker", default=None)
    ap.add_argument("--device", default=None,
                    help="the rank's device (the card unless 'cpu')")
    ns = ap.parse_args()

    import torch

    from deeplearning4j_tpu_torch import nn
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.listeners import TrainingListener
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, TrainingCheckpointer, initialize_distributed,
        make_mesh)

    dev = initialize_distributed(device=ns.device)
    rank = torch.distributed.get_rank()
    world = torch.distributed.get_world_size()
    n_in, n_out = 8, 4
    net = nn.MultiLayerNetwork(
        nn.builder().seed(7).updater(nn.Sgd(learning_rate=0.1)).list()
        .layer(nn.DenseLayer(n_out=16, activation="tanh"))
        .layer(nn.OutputLayer(n_out=n_out, activation="softmax",
                              loss="mcxent"))
        .set_input_type(nn.InputType.feed_forward(n_in)).build(),
        device=dev).init()

    ck = TrainingCheckpointer(ns.checkpoint_dir, use_orbax=False)
    restored = ck.restore(net)
    start = net.iteration_count if restored is not None else 0
    if restored is not None:
        print(f"[rank {rank}] resumed from step {start}", flush=True)

    local = ns.global_batch // world
    batches = []
    for step in range(start, ns.steps):
        x, y = make_step_batch(step, ns.global_batch, n_in, n_out)
        batches.append(DataSet(x[rank * local:(rank + 1) * local],
                               y[rank * local:(rank + 1) * local]))

    losses = []

    class Recorder(TrainingListener):
        def iteration_done(self, model, iteration, epoch, loss):
            losses.append(float(loss))
            if (ns.crash_at and iteration == ns.crash_at and rank == 0
                    and ns.crash_marker
                    and not os.path.exists(ns.crash_marker)):
                with open(ns.crash_marker, "w") as f:
                    f.write("crashed")
                print(f"[rank 0] injected crash at step {iteration}",
                      flush=True)
                os._exit(17)

    net.set_listeners(Recorder())
    pw = ParallelWrapper(net, mesh=make_mesh(device=dev))
    pw.fit(batches, epochs=1, checkpointer=ck,
           checkpoint_every=ns.checkpoint_every)

    if rank == 0 and ns.out:
        digest = hashlib.sha256()
        for tree in net.params:
            for k in sorted(tree):
                digest.update(tree[k].detach().cpu().numpy().tobytes())
        with open(ns.out, "w") as f:
            json.dump({"first_step": start, "losses": losses,
                       "param_sha256": digest.hexdigest(),
                       "final_iteration": net.iteration_count}, f)
    print(f"[rank {rank}] done at step {net.iteration_count}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
