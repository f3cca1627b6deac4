"""The parallel package on several GPUs (NCCL), each case held against the
one-card path — run under the launcher::

    python -m deeplearning4j_tpu_torch.parallel.launch --nprocs 4 -- \\
        -m deeplearning4j_tpu_torch.testing.parallel_check \\
        --out parallel_check.json

(``--device cpu`` runs it over gloo on the CPU at the ``--small`` widths.)
Every rank runs every case; rank 0 then runs the same work alone, with no
step context (what one card runs), and compares:

* ``moe_ep`` — the MoE network of chip_smoke's ``parallel_moe`` (Switch-
  Base-8 FFN widths, 4096 rows a step) through ``ParallelWrapper`` on a
  ``{"data": N/2, "expert": 2}`` mesh with ``moe_ep_rules()``: each rank
  holds 4 of the 8 experts, tokens reach them by all-to-all;
* ``moe_dp`` — the same network on ``{"data": N}``: global capacity, slot
  order and aux loss across the data ranks;
* ``bn_dp`` — Dense → BatchNormalization → softmax on ``{"data": N}``:
  the batch statistics all-reduced;
* ``ring`` / ``ulysses`` — attention over a ``{"seq": N}`` mesh at (B 2,
  H 12, T 2048, D 64), forward and the gradients of Σ out·c.

The training cases report the losses, the parameters' move against the
one-card run's (relative L2, ``_move_distance`` of chip_smoke) and the
host wall of a step (the multi-rank steps run op by op; the one-card run
is captured). Rank 0 writes the JSON and the process exits 1 when a case
is outside its bound.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

MOVE_RTOL = 1e-3     # parameter moves, relative L2 (chip_smoke's RNN_MOVE_RTOL)
LOSS_RTOL = 1e-4     # each step's loss, relative
ATTN_TOL = 1e-4      # float32 attention, forward and gradients, absolute
STEPS = 3


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _clone(tree):
    from deeplearning4j_tpu_torch.models._tree import map_tree

    return map_tree(lambda t: t.detach().clone(), tree)


def _move_distance(a, b, start) -> float:
    from deeplearning4j_tpu_torch.models._tree import leaf_paths

    num = den = 0.0
    for (_, x), (_, y), (_, s) in zip(leaf_paths(a), leaf_paths(b),
                                      leaf_paths(start)):
        num += float(((x.float() - y.float()) ** 2).sum())
        den += float(((y.float() - s.float()) ** 2).sum())
    return math.sqrt(num) / max(math.sqrt(den), 1e-30)


def _moe_conf(small: bool):
    from deeplearning4j_tpu_torch import nn

    d, h = (32, 64) if small else (768, 3072)
    return (nn.builder().seed(26).updater(nn.Adam(learning_rate=1e-3))
            .list()
            .layer(nn.DenseLayer(n_out=d, activation="gelu"))
            .layer(nn.MoELayer(d_hidden=h, n_experts=8, top_k=1,
                               capacity_factor=1.25, activation="relu"))
            .layer(nn.OutputLayer(n_out=10, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(nn.InputType.feed_forward(d)).build())


def _bn_conf(small: bool):
    from deeplearning4j_tpu_torch import nn

    d = 32 if small else 1024
    return (nn.builder().seed(27).updater(nn.Adam(learning_rate=1e-3))
            .list()
            .layer(nn.DenseLayer(n_out=d, activation="relu"))
            .layer(nn.BatchNormalization())
            .layer(nn.OutputLayer(n_out=10, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(nn.InputType.feed_forward(d)).build())


def _batches(rows, width, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rows, width)).astype(np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)])
            for _ in range(STEPS)]


def _train_case(name, conf, axes, rules, batches, dev, rank):
    """The case on every rank, then on rank 0 alone: the line (rank 0)."""
    from deeplearning4j_tpu_torch import nn
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.ops.collectives import mesh_groups
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh

    net = nn.MultiLayerNetwork(conf, device=dev).init()
    start = _clone(net.params)
    mesh = make_mesh(axes, device=dev)
    g = mesh_groups(mesh)
    d = g.size("data") if "data" in g.shape else 1
    i = g.index("data") if d > 1 else 0
    pw = ParallelWrapper(net, mesh=mesh, tp_rules=rules)
    losses, times = [], []
    for x, y in batches:
        n = x.shape[0] // d
        _sync(dev)
        t0 = time.perf_counter()
        pw.fit([DataSet(x[i * n:(i + 1) * n], y[i * n:(i + 1) * n])])
        _sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(net._score))
    hlo = pw.lower_step_hlo(*(a[i * n:(i + 1) * n] for a in batches[0]))
    ops = sorted({ln.split(" over ")[0] for ln in hlo.splitlines()[1:]})
    dist.barrier()
    if rank != 0:
        dist.barrier()
        return None
    ref = nn.MultiLayerNetwork(conf, device=dev).init()
    ref_losses, ref_times = [], []
    for x, y in batches:
        _sync(dev)
        t0 = time.perf_counter()
        ref.fit(x, y, batch_size=x.shape[0])
        _sync(dev)
        ref_times.append(time.perf_counter() - t0)
        ref_losses.append(ref.score())
    dist.barrier()
    move = _move_distance(net.params, ref.params, start)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    return {"case": name, "mesh": axes, "rows_a_step": batches[0][0].shape[0],
            "params": net.num_params(), "losses": losses,
            "losses_one_card": ref_losses, "loss_max_rel_diff": loss_rel,
            "param_move_rel_diff": move, "collectives": ops,
            "step_ms": [t * 1e3 for t in times],
            "step_ms_one_card": [t * 1e3 for t in ref_times],
            "ok": bool(move <= MOVE_RTOL and loss_rel <= LOSS_RTOL)}


def _attention_case(which, small, dev, rank, world):
    from deeplearning4j_tpu_torch.parallel import (
        make_mesh, ring_attention, ulysses_attention)

    b, h, t, d = (2, 4, 64, 16) if small else (2, 12, 2048, 64)
    gen = torch.Generator(device=dev).manual_seed(29)
    q, k, v, c = (torch.randn((b, h, t, d), generator=gen, device=dev)
                  for _ in range(4))
    mesh = make_mesh({"seq": world}, device=dev)
    n = t // world
    part = slice(rank * n, (rank + 1) * n)
    leaves = [a[:, :, part].contiguous().requires_grad_(True)
              for a in (q, k, v)]
    _sync(dev)
    t0 = time.perf_counter()
    if which == "ring":
        out = ring_attention(*(a.reshape(b * h, n, d) for a in leaves),
                             mesh=mesh, causal=True).reshape(b, h, n, d)
    else:
        out = ulysses_attention(*leaves, mesh=mesh, causal=True)
    grads = torch.autograd.grad((out * c[:, :, part]).sum(), leaves)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    full = [a.clone().requires_grad_(True) for a in (q, k, v)]
    keep = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    s = (full[0] @ full[1].transpose(-1, -2)) / math.sqrt(d)
    want = torch.softmax(torch.where(keep, s, torch.full_like(s, -1e30)),
                         dim=-1) @ full[2]
    want_grads = torch.autograd.grad((want * c).sum(), full)
    err = max([(out - want[:, :, part]).abs().max().item()] + [
        (g - w[:, :, part]).abs().max().item()
        for g, w in zip(grads, want_grads)])
    worst = torch.tensor([err], device=dev)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return {"case": which, "shape": [b, h, t, d], "causal": True,
            "max_abs_err": float(worst), "fwd_bwd_ms_rank0": ms,
            "ok": bool(float(worst) <= ATTN_TOL)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--small", action="store_true",
                    help="narrow widths (a CPU rehearsal)")
    ns = ap.parse_args()

    from deeplearning4j_tpu_torch.parallel import (
        initialize_distributed, moe_ep_rules)

    dev = initialize_distributed(device=ns.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if rank == 0:  # one build, then every rank loads it
            from deeplearning4j_tpu_torch.ops import _build
            _build.build()
    dist.barrier()
    rows = 256 if ns.small else 4096
    moe_w = 32 if ns.small else 768
    bn_w = 32 if ns.small else 1024
    cases = [
        _train_case("moe_ep", _moe_conf(ns.small),
                    {"data": world // 2, "expert": 2}, moe_ep_rules(),
                    _batches(rows, moe_w, 1), dev, rank),
        _train_case("moe_dp", _moe_conf(ns.small), {"data": world}, None,
                    _batches(rows, moe_w, 2), dev, rank),
        _train_case("bn_dp", _bn_conf(ns.small), {"data": world}, None,
                    _batches(rows // 4, bn_w, 3), dev, rank),
        _attention_case("ring", ns.small, dev, rank, world),
        _attention_case("ulysses", ns.small, dev, rank, world),
    ]
    ok = all(c["ok"] for c in cases if c is not None)
    if rank == 0:
        line = {"parallel_check": cases, "world": world,
                "backend": dist.get_backend(), "ok": ok}
        if dev.type == "cuda":
            import subprocess

            line["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip().splitlines()
        print(json.dumps(line), flush=True)
        if ns.out:
            with open(ns.out, "w") as f:
                json.dump(line, f, indent=1)
    flags = torch.tensor([int(ok)], device=dev)
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    dist.destroy_process_group()
    return 0 if int(flags) else 1


if __name__ == "__main__":
    sys.exit(main())
