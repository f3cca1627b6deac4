"""The cases the parallel package's tests run on a gloo group
(``testing/dist_group.py``). Each runs on every rank and returns numpy
results; the test process holds them against the JAX package, which it
runs on its 8 virtual CPU devices. Inputs (configurations as JSON,
parameters, batches) come from the test: drawn there from a seed or by
the JAX package.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models._tree import map_tree
from deeplearning4j_tpu_torch.ops import collectives
from deeplearning4j_tpu_torch.ops.collectives import StepContext, mesh_groups
from deeplearning4j_tpu_torch.parallel import launch
from deeplearning4j_tpu_torch.parallel.mesh import (
    DEFAULT_TP_RULES, P, ParallelInference, ParallelWrapper, make_mesh,
    mesh_shape, moe_ep_rules, param_specs, shard_params)

RULES = {None: None, "tp": DEFAULT_TP_RULES,
         "ep": moe_ep_rules("expert")}


def _numpy(tree):
    return map_tree(lambda t: t.detach().cpu().numpy().copy(), tree)


def _net(kind: str, conf_json: str, params):
    from deeplearning4j_tpu_torch import nn

    if kind == "graph":
        conf = nn.ComputationGraphConfiguration.from_json(conf_json)
        return nn.ComputationGraph(conf, device="cpu").init(params)
    conf = nn.MultiLayerConfiguration.from_json(conf_json)
    return nn.MultiLayerNetwork(conf, device="cpu").init(params)


def _rows(x, groups, split: Optional[List[int]] = None):
    """The rank's rows of a global batch: its data coordinate's equal
    share, or ``split`` (rows a data rank) for a ragged batch."""
    d = groups.size("data") if "data" in groups.shape else 1
    i = groups.index("data") if d > 1 else 0
    sizes = split or [x.shape[0] // d] * d
    lo = sum(sizes[:i])
    return x[lo:lo + sizes[i]]


def mesh_case(world: int) -> Dict[str, Any]:
    out = {"default": mesh_shape(make_mesh(device="cpu"))}
    if world % 2 == 0:
        m = make_mesh({"data": world // 2, "model": 2}, device="cpu")
        out["two_axes"] = mesh_shape(m)
        out["coords"] = mesh_groups(m).coords
        out["type"] = type(m).__name__
    try:
        make_mesh({"data": world + 1}, device="cpu")
    except ValueError as e:
        out["error"] = str(e)
    return out


def shard_case(conf_json: str, params, axes: Dict[str, int],
               rules: str) -> Dict[str, Any]:
    net = _net("mln", conf_json, params)
    mesh = make_mesh(axes, device="cpu")
    return {"specs": {k: tuple(v) for k, v in param_specs(
                net.params, mesh, RULES[rules]).items()},
            "local": _numpy(shard_params(net.params, mesh, RULES[rules])),
            "coords": mesh_groups(mesh).coords}


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: List[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def fit_case(kind: str, conf_json: str, params, batches,
             axes: Optional[Dict[str, int]] = None,
             rules: Optional[str] = None,
             split: Optional[List[int]] = None,
             hlo: bool = False) -> Dict[str, Any]:
    """``ParallelWrapper.fit`` over ``batches`` (global (x, y) pairs, each
    rank feeding its rows), one epoch. Returns the whole parameters,
    updater and layer state after it, the losses the listeners saw, the
    warnings logged, and with ``hlo`` the collectives of one step."""
    from deeplearning4j_tpu_torch.nn.listeners import TrainingListener

    net = _net(kind, conf_json, params)
    mesh = make_mesh(axes, device="cpu")
    groups = mesh_groups(mesh)
    losses = []

    class Record(TrainingListener):
        def iteration_done(self, model, iteration, epoch, loss):
            losses.append(float(loss))

    net.set_listeners(Record())
    pw = ParallelWrapper(net, mesh=mesh, tp_rules=RULES[rules])
    data = [DataSet(_rows(x, groups, split), _rows(y, groups, split))
            for x, y in batches]
    out = {}
    if hlo:
        x, y = data[0].features, data[0].labels
        out["hlo"] = pw.lower_step_hlo(x, y)
    handler = _Warnings()
    log = logging.getLogger("deeplearning4j_tpu_torch.parallel.mesh")
    log.addHandler(handler)
    try:
        pw.fit(data, epochs=1, batch_size=len(data[0].features))
    finally:
        log.removeHandler(handler)
    out.update({"params": _numpy(net.params), "opt_state":
                _numpy(net.opt_state), "net_state": _numpy(net.net_state),
                "losses": losses, "warnings": handler.messages,
                "iteration": net.iteration_count})
    if kind == "mln":
        out["params_flat"] = net.params_flat()
    return out


def data_case(conf_json: str, params, x, y) -> Dict[str, Any]:
    """host_shard and ShardedDataSetIterator with the group's defaults,
    and distributed_evaluate over each rank's shard of the batches."""
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator

    net = _net("mln", conf_json, params)
    base = ListDataSetIterator(DataSet(x, y), batch_size=8)
    it = launch.ShardedDataSetIterator(base)
    shard = [ds.features for ds in it]
    ev = launch.distributed_evaluate(
        net, launch.ShardedDataSetIterator(
            ListDataSetIterator(DataSet(x, y), batch_size=8)))
    return {"host_shard": launch.host_shard(list(range(10))),
            "shard_first_rows": [s[0].tolist() for s in shard],
            "confusion": ev.confusion, "accuracy": ev.accuracy()}


def inference_case(conf_json: str, params, x) -> Dict[str, Any]:
    net = _net("mln", conf_json, params)
    pi = ParallelInference(net, mesh=make_mesh(device="cpu"), max_batch=8)
    return {"output": pi.output(x), "direct": net.output(x)}


def moe_forward_case(params, x, c, n_experts: int, capacity_factor: float,
                     world: int) -> Dict[str, Any]:
    """``moe.moe_forward`` on the rank's tokens and experts; the gradient
    of J = Σ_global y·c + 0.01·aux (each rank's loss weighted so that the
    ranks' mean is J, then reduced as ParallelWrapper reduces)."""
    from deeplearning4j_tpu_torch.parallel.moe import moe_forward

    mesh = make_mesh({"expert": world}, device="cpu")
    groups = mesh_groups(mesh)
    rules = [(r".*/(W1|W2)", P("expert", None, None))]
    full = map_tree(torch.from_numpy, params)
    local = shard_params(full, mesh, rules)
    leaves = map_tree(lambda t: t.clone().requires_grad_(True), local)
    n = x.shape[0] // world
    i = groups.index("expert")
    xs = torch.from_numpy(x[i * n:(i + 1) * n])
    cs = torch.from_numpy(c[i * n:(i + 1) * n])
    y, aux = moe_forward(mesh, n_experts=n_experts,
                         capacity_factor=capacity_factor)(leaves, xs)
    loss = world * torch.sum(y * cs) + 0.01 * aux
    grads = dict(zip(leaves, torch.autograd.grad(
        loss, [leaves[k] for k in leaves])))
    grads = StepContext(groups, param_specs(full, mesh, rules)
                        ).reduce_gradients(grads)
    return {"y": y.detach().numpy(), "aux": float(aux),
            "grads": _numpy(grads)}


def attention_case(q, k, v, c, causal: bool, world: int,
                   which: str) -> Dict[str, Any]:
    """ring (q, k, v as (BH, T, D)) or ulysses ((B, H, T, D)) attention on
    the rank's sequence shard; gradients of Σ_global out·c."""
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        ring_attention)
    from deeplearning4j_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = make_mesh({"seq": world}, device="cpu")
    i = mesh_groups(mesh).index("seq")
    dim = 1 if which == "ring" else 2
    t = q.shape[dim] // world

    def mine(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.take(a, range(i * t, (i + 1) * t), axis=dim)))

    qs, ks, vs = (mine(a).requires_grad_(True) for a in (q, k, v))
    fn = ring_attention if which == "ring" else ulysses_attention
    out = fn(qs, ks, vs, mesh=mesh, axis="seq", causal=causal)
    gq, gk, gv = torch.autograd.grad(torch.sum(out * mine(c)),
                                     [qs, ks, vs])
    res = {"out": out.detach().numpy(), "dq": gq.numpy(), "dk": gk.numpy(),
           "dv": gv.numpy()}
    if which == "ulysses":
        try:
            ulysses_attention(qs[:, :1].detach(), ks[:, :1].detach(),
                              vs[:, :1].detach(), mesh=mesh, axis="seq")
        except ValueError as e:
            res["error"] = str(e)
    return res


def ring_self_case(x, wq, wk, wv, wo, world: int) -> Dict[str, Any]:
    """``RingSelfAttention`` on the rank's shard of the sequence of ``x``
    (N, T, d), causal."""
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        RingSelfAttention)

    mesh = make_mesh({"seq": world}, device="cpu")
    t = x.shape[1] // world
    i = mesh_groups(mesh).index("seq")
    layer = RingSelfAttention(mesh, num_heads=2, causal=True)
    out = layer(torch.from_numpy(np.ascontiguousarray(x[:, i * t:(i + 1) * t])),
                *(torch.from_numpy(w) for w in (wq, wk, wv, wo)))
    return {"out": out.numpy()}

def _stage(p, x):
    return torch.tanh(x @ p["W"] + p["b"])


def pipeline_case(stacked, x, microbatches: List[int],
                  axes: Dict[str, int]) -> Dict[str, Any]:
    """``pipeline_forward`` of the tanh stage on the rank's stage slice
    at each microbatch count."""
    from deeplearning4j_tpu_torch.parallel.pipeline import pipeline_forward

    mesh = make_mesh(axes, device="cpu")
    groups = mesh_groups(mesh)
    n, i = groups.size("pipe"), groups.index("pipe")
    local = map_tree(lambda a: torch.from_numpy(a).chunk(n)[i].clone(),
                     stacked)
    xs = torch.from_numpy(_rows(x, groups))
    return {m: pipeline_forward(_stage, mesh, num_microbatches=m)(
        local, xs).numpy() for m in microbatches}


def _mse_head(hp, feats, y):
    return torch.mean((feats @ hp["Wo"] - y) ** 2)


def _xent_head(hp, feats, y):
    logp = torch.log_softmax(feats @ hp["W"], dim=-1)
    return -torch.mean(torch.sum(y * logp, dim=-1))


def pipeline_trainer_case(stacked, head, x, y, steps: int,
                          axes: Dict[str, int], updater: str,
                          confs: bool = False) -> Dict[str, Any]:
    """``PipelineParallelTrainer`` for ``steps`` steps (the tanh stage and
    an MSE head, or with ``confs`` a DenseLayer(tanh) stage built from
    its configuration and a softmax head), started from the JAX
    parameters; returns the rank's stage slice, the head and the
    losses."""
    from deeplearning4j_tpu_torch import nn
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelineParallelTrainer)

    mesh = make_mesh(axes, device="cpu")
    upd = {"sgd": nn.Sgd(learning_rate=0.05),
           "adam": nn.Adam(learning_rate=0.01)}[updater]
    if confs:
        d = x.shape[-1]
        tr = PipelineParallelTrainer.from_confs(
            [nn.DenseLayer(n_out=d, activation="tanh")], _xent_head, d,
            mesh, num_microbatches=4, updater=upd, head_params=head,
            device="cpu")
    else:
        tr = PipelineParallelTrainer(_stage, _mse_head, mesh,
                                     num_microbatches=4, updater=upd,
                                     device="cpu")
    tr.init_params(stacked, head)
    groups = mesh_groups(mesh)
    losses = tr.fit(_rows(x, groups), _rows(y, groups), steps=steps)
    return {"stage": _numpy(tr.stacked_params), "head":
            _numpy(tr.head_params), "losses": losses,
            "stage_index": groups.index("pipe")}


def collectives_case(world: int) -> Dict[str, Any]:
    """The collectives and their adjoints on small tensors."""
    mesh = make_mesh({"data": world}, device="cpu")
    g = mesh_groups(mesh)
    r = g.index("data")
    t = torch.full((2,), float(r + 1), requires_grad=True)
    ctx = StepContext(g)
    with collectives.use(ctx):
        s = collectives.all_reduce(t, g, "data")
        a = collectives.all_gather(t, g, "data")
        sh = collectives.ring_shift(t, g, "data")
        x = collectives.all_to_all(
            torch.arange(world * 2, dtype=torch.float32).reshape(world, 2)
            + 100 * r, g, "data")
    (s.sum() + (a * torch.arange(a.numel())).sum() + sh.sum()).backward()
    return {"sum": s.detach().numpy(), "gather": a.detach().numpy(),
            "shift": sh.detach().numpy(), "a2a": x.numpy(),
            "grad": t.grad.numpy(),
            "record": [(op, axes) for op, axes, _, _ in ctx.record]}
