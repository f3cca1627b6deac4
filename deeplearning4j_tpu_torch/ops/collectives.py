"""Collectives of a multi-process step: differentiable, recorded, and
skipped where there is nothing to exchange.

The JAX package is single-controller: one process drives the whole device
mesh and GSPMD computes every op over the global batch, inserting the
collectives itself. The port is multi-controller: one process a device,
joined by ``torch.distributed`` (NCCL on ``cuda``, gloo on the CPU). Each
process computes its rank's share, and the exchanges the JAX compiler
inserts are explicit calls here:

* :func:`all_reduce`, :func:`all_gather`, :func:`all_to_all` and
  :func:`ring_shift` are ``torch.autograd.Function`` s whose backward is
  the forward's adjoint (an all-reduce's is an all-reduce, an all-gather's
  an all-reduce of the gradient then the rank's chunk, an all-to-all's an
  all-to-all, a shift's the opposite shift). With adjoint collectives,
  each rank's backward of its own loss gives its copies of the parameters
  their share of d(Σ_ranks loss)/dθ, whatever crosses ranks on the way:
  the gradient rule of :meth:`StepContext.reduce_gradients` rests on it.
* Each runs over the ranks that vary along a set of mesh axes
  (:class:`MeshGroups`: one process group a subset of the axes, made once
  per mesh). Over a group of one rank nothing is issued.
* Every collective issued while a :class:`StepContext` is active is
  appended to its ``record`` as (op, axes, shape, dtype):
  ``ParallelWrapper.lower_step_hlo`` reads it as the JAX package reads
  the compiled HLO.

:class:`StepContext` is what a training step consults for the
batch-coupled quantities (batch-norm statistics, a mixture-of-experts
layer's capacity, slot order and load-balance loss, a masked loss's
count), for the parameters it holds sharded and for the gradient
all-reduce. No context is active outside ``ParallelWrapper.fit`` and
``lower_step_hlo`` over more than one rank: one card runs the network's
own step, with no collective and nothing recorded.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

# mixture-of-experts leaves a layer consumes as its rank's expert shard
# (a spec sharding dim 0 only) instead of gathering them
EXPERT_LEAVES = ("We1", "We2", "be1", "be2")

_ACTIVE: List["StepContext"] = []


class MeshGroups:
    """The process groups of a mesh: one for each subset of its axes,
    holding the ranks that differ only along those axes (the rank's own
    group of each). ``mesh`` is a ``DeviceMesh``; the groups are made
    when this is built, by every rank at the same point."""

    def __init__(self, mesh):
        self.names: Tuple[str, ...] = tuple(mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.names, mesh.shape))
        self.world = int(math.prod(self.shape.values()))
        self.coords: Dict[str, int] = dict(zip(
            self.names, mesh.get_coordinate() or [0] * len(self.names)))
        self.groups: Dict[Tuple[str, ...], Any] = {}
        if self.world == 1:
            return
        ranks = mesh.mesh.reshape(tuple(self.shape[n] for n in self.names))
        wide = [n for n in self.names if self.shape[n] > 1]
        for r in range(1, len(wide) + 1):
            for axes in itertools.combinations(wide, r):
                dims = [self.names.index(a) for a in axes]
                rest = [d for d in range(len(self.names)) if d not in dims]
                moved = ranks.permute(*rest, *dims).reshape(
                    -1, math.prod(self.shape[a] for a in axes))
                mine, _ = dist.new_subgroups_by_enumeration(
                    [row.tolist() for row in moved])
                self.groups[axes] = mine

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name, a sequence of names or None for every axis)
        as a tuple in mesh order, the names of size one left out."""
        if axes is None:
            axes = self.names
        elif isinstance(axes, str):
            axes = (axes,)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"mesh has no axis {unknown}: {self.names}")
        return tuple(a for a in self.names if a in axes and self.shape[a] > 1)

    def size(self, axes) -> int:
        return int(math.prod(self.shape[a] for a in self.axes(axes)))

    def index(self, axes) -> int:
        """The rank's position in its group over ``axes`` (row-major)."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        return self.groups[self.axes(axes)]


def mesh_groups(mesh) -> MeshGroups:
    """The :class:`MeshGroups` of ``mesh`` (``parallel.mesh.make_mesh``
    makes them; a mesh built otherwise gets them on its first use, which
    every rank must reach at the same point)."""
    g = getattr(mesh, "_dl4j_groups", None)
    if g is None:
        g = MeshGroups(mesh)
        mesh._dl4j_groups = g
    return g


def _record(op: str, axes, t: torch.Tensor) -> None:
    if _ACTIVE:
        _ACTIVE[-1].record.append((op, tuple(axes), tuple(t.shape),
                                   str(t.dtype).replace("torch.", "")))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, axes):
        ctx.groups, ctx.axes = groups, axes
        out = t.contiguous().clone()
        _record("all_reduce", axes, out)
        dist.all_reduce(out, group=groups.group(axes))
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        _record("all_reduce", ctx.axes, out)
        dist.all_reduce(out, group=ctx.groups.group(ctx.axes))
        return out, None, None


def all_reduce(t: torch.Tensor, groups: MeshGroups, axes) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axes`` (adjoint: the same)."""
    axes = groups.axes(axes)
    if not axes:
        return t
    return _AllReduce.apply(t, groups, axes)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, axes, dim):
        ctx.groups, ctx.axes, ctx.dim = groups, axes, dim
        n = groups.size(axes)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        _record("all_gather", axes, t)
        dist.all_gather(parts, t, group=groups.group(axes))
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        full = g.contiguous().clone()
        _record("all_reduce", ctx.axes, full)
        dist.all_reduce(full, group=ctx.groups.group(ctx.axes))
        n = ctx.groups.size(ctx.axes)
        i = ctx.groups.index(ctx.axes)
        return full.chunk(n, dim=ctx.dim)[i].contiguous(), None, None, None


def all_gather(t: torch.Tensor, groups: MeshGroups, axes,
               dim: int = 0) -> torch.Tensor:
    """The ranks' equal chunks along ``dim`` concatenated in group order
    (adjoint: the gradient summed over the group, then the rank's chunk:
    an all-reduce, as gloo has no reduce-scatter)."""
    axes = groups.axes(axes)
    if not axes:
        return t
    return _AllGather.apply(t, groups, axes, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, axes):
        ctx.groups, ctx.axes = groups, axes
        t = t.contiguous()
        out = torch.empty_like(t)
        _record("all_to_all", axes, t)
        dist.all_to_all_single(out, t, group=groups.group(axes))
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        _record("all_to_all", ctx.axes, g)
        dist.all_to_all_single(out, g, group=ctx.groups.group(ctx.axes))
        return out, None, None


def all_to_all(t: torch.Tensor, groups: MeshGroups, axes) -> torch.Tensor:
    """``t`` (n, ...) with chunk j sent to rank j of the group; row j of
    the result is what rank j sent here (``all_to_all_single``; its own
    adjoint)."""
    axes = groups.axes(axes)
    if not axes:
        return t
    if t.shape[0] != groups.size(axes):
        raise ValueError(f"all_to_all over {axes} needs a leading dim of "
                         f"{groups.size(axes)}, got {tuple(t.shape)}")
    return _AllToAll.apply(t, groups, axes)


def _shift(t: torch.Tensor, groups: MeshGroups, axes, step: int):
    g = groups.group(axes)
    n, i = groups.size(axes), groups.index(axes)
    t = t.contiguous()
    out = torch.empty_like(t)
    _record("ring_shift", axes, t)
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(g, (i + step) % n),
                      group=g),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(g, (i - step) % n), group=g)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, axes):
        ctx.groups, ctx.axes = groups, axes
        return _shift(t, groups, axes, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.groups, ctx.axes, -1), None, None


def ring_shift(t: torch.Tensor, groups: MeshGroups, axes) -> torch.Tensor:
    """``t`` sent to the next rank of the group's ring, the previous
    rank's received (``jax.lax.ppermute`` with i → i + 1; adjoint: the
    shift back)."""
    axes = groups.axes(axes)
    if not axes:
        return t
    return _RingShift.apply(t, groups, axes)


# ---------------------------------------------------------------------------
# The step context
# ---------------------------------------------------------------------------


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one entry of a partition spec."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def path_key(path) -> str:
    """A leaf's path as the rules match it: ``/0/W``, ``/moe/We1``."""
    return "".join(f"/{k}" for k in path)


class StepContext:
    """What a training step over a mesh consults (module docstring).

    ``groups``: the mesh's :class:`MeshGroups`; ``specs``: the
    partition spec of each parameter leaf the rank holds sharded, by
    path string (``/0/W`` for a sequential network's first layer, the
    layer name for a graph's); every other leaf is replicated.
    ``split``: whether the ranks of the ``data`` axis hold different rows
    of the batch (False for a ragged batch run replicated).

    The objective of a step is J = (1/M) Σ_ranks L_rank over the M ranks,
    each L_rank its own rows' loss computed with the global batch
    statistics: with equal shards that is the loss of the global batch.
    Through the adjoint collectives each rank's backward gives its copy
    of a leaf its share of M·dJ/dθ; the copies of a leaf are the ranks
    that differ along the axes it is not sharded on, so its gradient is
    the sum over that group divided by M."""

    def __init__(self, groups: MeshGroups, specs: Optional[Dict[str, tuple]]
                 = None, *, split: bool = True):
        self.groups = groups
        self.specs = dict(specs or {})
        self.split = split
        self.record: List[tuple] = []
        self.expert_axis: Optional[str] = None
        for path, spec in self.specs.items():
            if (path.rsplit("/", 1)[-1] in EXPERT_LEAVES and spec
                    and spec[0] is not None
                    and all(e is None for e in spec[1:])):
                self.expert_axis = spec_axes(spec[0])[0]

    # ------------------------------------------------------------ the batch
    def data_axes(self) -> Tuple[str, ...]:
        """The axes the batch rows are split over this step."""
        if not self.split or "data" not in self.groups.shape:
            return ()
        return self.groups.axes("data")

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks holding the other rows of the
        batch (differentiable)."""
        return all_reduce(t, self.groups, self.data_axes())

    def data_size(self) -> int:
        return self.groups.size(self.data_axes())

    def data_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``t`` stacked on a new leading axis, in data
        order (not differentiable: counts)."""
        axes = self.data_axes()
        if not axes:
            return t[None]
        return all_gather(t.detach()[None], self.groups, axes)

    # ------------------------------------------------------- the parameters
    def _sharded(self, path) -> Optional[tuple]:
        spec = self.specs.get(path_key(path))
        if spec is None or all(not spec_axes(e) for e in spec):
            return None
        return spec

    def consumes_shard(self, path, spec) -> bool:
        return (path[-1] in EXPERT_LEAVES and self.expert_axis is not None
                and spec_axes(spec[0]) == (self.expert_axis,)
                and all(e is None for e in spec[1:]))

    def forward_params(self, params):
        """The parameter tree the forward reads: each leaf the rank holds
        sharded gathered whole (differentiable), except a
        mixture-of-experts layer's expert shards, which its layer
        dispatches to."""
        from deeplearning4j_tpu_torch.models._tree import leaf_paths, rebuild

        by_path = {}
        for path, leaf in leaf_paths(params):
            spec = self._sharded(path)
            if spec is not None and not self.consumes_shard(path, spec):
                for dim, entry in enumerate(spec):
                    if spec_axes(entry):
                        leaf = all_gather(leaf, self.groups,
                                          spec_axes(entry), dim)
            by_path[path] = leaf
        return rebuild(params, by_path)

    def reduce_gradients(self, grads):
        """Each gradient leaf summed over the ranks holding a copy of its
        leaf, divided by the rank count (class docstring): one all-reduce
        for each group of leaves that share their copies and dtype."""
        from deeplearning4j_tpu_torch.models._tree import leaf_paths, rebuild

        buckets: Dict[tuple, list] = {}
        for path, g in leaf_paths(grads):
            spec = self._sharded(path) or ()
            held = {a for e in spec for a in spec_axes(e)}
            axes = tuple(a for a in self.groups.names if a not in held)
            buckets.setdefault((self.groups.axes(axes), g.dtype),
                               []).append((path, g))
        scale = 1.0 / self.groups.world
        out = {}
        for (axes, _), items in buckets.items():
            flat = torch.cat([g.reshape(-1) for _, g in items])
            flat = all_reduce(flat, self.groups, axes) * scale
            for (path, g), part in zip(items, flat.split(
                    [g.numel() for _, g in items])):
                out[path] = part.view(g.shape)
        return rebuild(grads, out)

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """J, the mean of the ranks' losses (what the step reports)."""
        return all_reduce(loss.detach(), self.groups, None) / self.groups.world


def active() -> Optional[StepContext]:
    """The step context in force, or None (one rank: no collective)."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use(ctx: Optional[StepContext]):
    """``ctx`` in force inside the block (nothing changes for None)."""
    if ctx is None:
        yield None
        return
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


def data_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data ranks of the active context (itself
    without one)."""
    ctx = active()
    return t if ctx is None else ctx.data_sum(t)


def data_size() -> int:
    ctx = active()
    return 1 if ctx is None else ctx.data_size()


def forward_params(params):
    ctx = active()
    return params if ctx is None else ctx.forward_params(params)


def reduce_gradients(grads):
    ctx = active()
    return grads if ctx is None else ctx.reduce_gradients(grads)


def mean_loss(loss: torch.Tensor) -> torch.Tensor:
    ctx = active()
    return loss if ctx is None else ctx.mean_loss(loss)


# the routing rule's reason of a step that issues collectives: it runs op
# by op (nn/compiled.py), the exchanges outside any captured graph
COLLECTIVES = "step_issues_collectives"


def routing() -> Optional[str]:
    """:data:`COLLECTIVES` while a context is active, else None."""
    return COLLECTIVES if _ACTIVE else None


def split_rows(n: int, parts: int) -> List[int]:
    """``torch.tensor_split``'s sizes of ``n`` rows in ``parts``."""
    q, r = divmod(n, parts)
    return [q + (i < r) for i in range(parts)]
