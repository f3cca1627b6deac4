"""Expert parallelism: a top-1 mixture-of-experts FFN with its experts
sharded over an ``expert`` mesh axis and tokens dispatched by all-to-all.

Counterpart of ``deeplearning4j_tpu/parallel/moe.py`` (Switch-Transformer
/ GShard recipe: top-1 routing, a per-expert capacity with drop-and-pass-
through overflow, the load-balancing aux loss). Where the JAX package runs
``shard_map`` over the mesh, each rank here runs the per-device body on
its own tokens and experts, and ``all_to_all_single`` moves the capacity
buffers (``ops/collectives.py``, differentiable).
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.ops import collectives
from deeplearning4j_tpu_torch.ops.collectives import mesh_groups
from deeplearning4j_tpu_torch.parallel.mesh import P


def init_moe_params(gen, n_experts: int, d_model: int, d_hidden: int,
                    dtype=torch.float32, device=None):
    """Router and per-expert MLP weights, experts stacked on the leading
    axis (shard it over the ``expert`` axis). ``gen``: a
    ``torch.Generator`` or an int seed."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))
    dev = resolve_device(device)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * std).to(device=dev, dtype=dtype)

    return {
        "router": normal((d_model, n_experts), (1.0 / d_model) ** 0.5),
        "W1": normal((n_experts, d_model, d_hidden), (2.0 / d_model) ** 0.5),
        "W2": normal((n_experts, d_hidden, d_model), (2.0 / d_hidden) ** 0.5),
    }


def moe_spec(axis: str = "expert"):
    """The specs of :func:`init_moe_params`' leaves: experts sharded, the
    router replicated."""
    return {"router": P(), "W1": P(axis, None, None),
            "W2": P(axis, None, None)}


def moe_forward(mesh, *, n_experts: int, capacity_factor: float = 1.25,
                axis: str = "expert"):
    """``f(params, x) -> (y, aux_loss)``: top-1 expert-parallel MoE.

    On each rank ``params`` holds its ``n_experts / ep`` experts (the
    leading axis of ``W1`` / ``W2``, as ``shard_params`` cuts them with
    the rule ``(r".*/(W1|W2)", P(axis, None, None))``) and the router, and
    ``x`` (tokens,
    d_model) its tokens. Each rank routes its tokens with a capacity of
    ceil(cf·tokens/E) a expert, an all-to-all ships the (E, C, d) buffer
    to the experts' ranks, the local experts run one batched matmul pair,
    a second all-to-all brings the results back, and tokens past capacity
    pass through unchanged. ``aux_loss`` is the ranks' mean."""
    groups = mesh_groups(mesh)
    ep = groups.size(axis)
    if n_experts % ep:
        raise ValueError(f"{n_experts} experts over {ep} '{axis}' ranks")
    per_rank = n_experts // ep

    def run(params, x):
        t_local, d = x.shape
        cap = int(math.ceil(capacity_factor * t_local / n_experts))
        probs = torch.softmax(x @ params["router"], dim=-1)
        idx = torch.argmax(probs, dim=-1)
        gate = torch.gather(probs, 1, idx[:, None])[:, 0]
        onehot = (idx[:, None] == torch.arange(n_experts,
                                               device=x.device)).to(x.dtype)
        aux = n_experts * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
        pos = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1,
                           idx[:, None])[:, 0].to(torch.int64)
        keep = pos < cap
        e_at = torch.where(keep, idx, 0)
        c_at = torch.where(keep, pos, 0)
        buf = x.new_zeros((n_experts, cap, d)).index_put(
            (e_at, c_at), torch.where(keep[:, None], x, 0.0),
            accumulate=True)
        recv = collectives.all_to_all(buf.reshape(ep, per_rank, cap, d),
                                      groups, axis)
        tokens = recv.transpose(0, 1).reshape(per_rank, ep * cap, d)
        h = torch.relu(torch.einsum("etd,edh->eth", tokens, params["W1"]))
        out = torch.einsum("eth,ehd->etd", h, params["W2"])
        out = out.reshape(per_rank, ep, cap, d).transpose(0, 1)
        back = collectives.all_to_all(out, groups, axis).reshape(
            n_experts, cap, d)
        got = back[e_at, c_at]
        y = torch.where(keep[:, None], gate[:, None] * got, x)
        return y, collectives.all_reduce(aux, groups, axis) / ep

    return run

