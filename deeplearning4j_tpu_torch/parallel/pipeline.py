"""Pipeline parallelism: GPipe microbatches over the ranks of a ``pipe``
mesh axis.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``. Each rank of
the axis holds one stage's parameters (its slice of the stacked tree);
the batch is cut into M microbatches. In the forward, stage s takes
microbatch j from stage s − 1 (stage 0 from the input), runs the stage
function and sends the result to stage s + 1; the last stage's outputs
are summed over the axis (zeros elsewhere), so every rank returns the
whole output, as the JAX ``psum`` does. In the backward the schedule runs
in reverse: the gradient of microbatch j arrives from stage s + 1, the
stage's graph of that microbatch gives the gradients of its parameters
and input, and the input's goes to stage s − 1. The whole schedule is one
``torch.autograd.Function`` (plain ``send``/``recv`` are not
differentiable); the stage function itself runs under autograd, once a
microbatch, with no bubble ticks (the JAX scan's padded ticks compute
nothing that is kept).

The stage function must keep the activation's shape, the usual
transformer-block setting; a head runs outside the pipeline.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.models._tree import leaf_paths, map_tree, rebuild
from deeplearning4j_tpu_torch.ops import collectives
from deeplearning4j_tpu_torch.ops.collectives import (
    StepContext, mesh_groups, path_key)
from deeplearning4j_tpu_torch.parallel.mesh import P


def stack_stage_params(per_stage_params) -> Any:
    """A list of per-stage trees stacked on a new leading axis — the
    layout :func:`pipeline_spec` shards over the ``pipe`` axis."""
    first = per_stage_params[0]
    paths = [p for p, _ in leaf_paths(first)]
    by_path = {}
    for path in paths:
        leaves = []
        for tree in per_stage_params:
            for k in path:
                tree = tree[k]
            leaves.append(tree)
        by_path[path] = torch.stack(leaves)
    return rebuild(first, by_path)


def pipeline_spec(stacked_params, axis: str = "pipe"):
    """Each leaf's spec: the stage axis sharded over ``axis``."""
    return map_tree(lambda x: P(axis, *([None] * (x.ndim - 1))),
                    stacked_params)


def _peer(group, i):
    return dist.get_global_rank(group, i)


class _GPipe(torch.autograd.Function):
    """The schedule (module docstring). Inputs: the stage function, the
    stage tree (leaves' paths), the groups and axis, M, x, the leaves."""

    @staticmethod
    def forward(ctx, stage_fn, paths, template, groups, axis, m, x,
                *leaves):
        g = groups.group(axis)
        s, n = groups.index(axis), groups.size(axis)
        micro = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        with torch.enable_grad():
            p_leaves = [t.detach().requires_grad_(t.requires_grad)
                        for t in leaves]
            params = rebuild(template, dict(zip(paths, p_leaves)))
            ins, outs = [], []
            for j in range(m):
                if s == 0:
                    a = micro[j].detach()
                else:
                    a = torch.empty_like(micro[j])
                    dist.recv(a, _peer(g, s - 1), group=g)
                a.requires_grad_(s > 0 or x.requires_grad)
                y = stage_fn(params, a)
                if s < n - 1:
                    dist.send(y.detach().contiguous(), _peer(g, s + 1),
                              group=g)
                ins.append(a)
                outs.append(y)
        ctx.run = (groups, axis, m, ins, outs, p_leaves,
                   x.requires_grad)
        if s == n - 1:
            return torch.cat([y.detach() for y in outs])
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, grad):
        groups, axis, m, ins, outs, p_leaves, x_grad = ctx.run
        g = groups.group(axis)
        s, n = groups.index(axis), groups.size(axis)
        wants = [t for t in p_leaves if t.requires_grad]
        p_grads = [torch.zeros_like(t) for t in wants]
        x_grads: List[torch.Tensor] = [None] * m
        chunks = grad.reshape((m, grad.shape[0] // m)
                              + tuple(grad.shape[1:]))
        for j in reversed(range(m)):
            if s == n - 1:
                gy = chunks[j].contiguous()
            else:
                gy = torch.empty_like(outs[j])
                dist.recv(gy, _peer(g, s + 1), group=g)
            need = ([ins[j]] if ins[j].requires_grad else []) + wants
            got = torch.autograd.grad(outs[j], need, gy, allow_unused=True)
            got = [torch.zeros_like(t) if d is None else d
                   for t, d in zip(need, got)]
            if ins[j].requires_grad:
                ga, got = got[0], got[1:]
                if s > 0:
                    dist.send(ga.contiguous(), _peer(g, s - 1), group=g)
                else:
                    x_grads[j] = ga
            for acc, d in zip(p_grads, got):
                acc += d
        ctx.run = None
        it = iter(p_grads)
        leaf_grads = [next(it) if t.requires_grad else None
                      for t in p_leaves]
        gx = torch.cat(x_grads) if (x_grad and s == 0) else None
        return (None, None, None, None, None, None, gx, *leaf_grads)


def pipeline_forward(stage_fn: Callable, mesh, *, num_microbatches: int,
                     axis: str = "pipe"):
    """``f(stage_params, x)``: ``stage_fn`` run as a GPipe pipeline over
    the mesh's ``axis``. ``stage_params``: this rank's stage — the tree
    :func:`stack_stage_params` makes, cut to the rank's slice (a leading
    axis of 1, as ``shard_params`` with :func:`pipeline_spec`'s rules cuts
    it). ``stage_fn(stage_tree, x_micro) -> y_micro`` keeps the shape. x:
    the rank's batch (its ``data`` rows on a data × pipe mesh), the batch
    divisible by ``num_microbatches``. Returns the pipeline's output on
    every rank of the axis."""
    groups = mesh_groups(mesh)

    def run(stage_params, x):
        if x.shape[0] % num_microbatches:
            raise ValueError(f"batch {x.shape[0]} is not divisible by "
                             f"{num_microbatches} microbatches")
        stage = map_tree(lambda t: t[0], stage_params)
        if groups.size(axis) == 1:
            return stage_fn(stage, x)
        paths = [p for p, _ in leaf_paths(stage)]
        leaves = [t for _, t in leaf_paths(stage)]
        out = _GPipe.apply(stage_fn, paths, stage, groups, axis,
                           num_microbatches, x, *leaves)
        return collectives.all_reduce(out, groups, axis)

    return run


class PipelineParallelTrainer:
    """Pipeline-parallel trainer: stages of shape-preserving blocks and an
    output head, trained by autograd through the schedule, with the
    network API's updaters (schedules included), listeners and
    ``TrainingCheckpointer`` (JAX pipeline.py:120).

    ``head_fn(head_params, feats, labels) -> scalar loss`` runs outside
    the pipeline, on every rank. Each rank holds its stage's slice of the
    stacked tree (``stacked_params``, a leading axis of 1) and the whole
    head; the gradients are all-reduced as ``ParallelWrapper``'s are
    (``collectives.StepContext.reduce_gradients``: the stage leaves over
    the ranks that share the stage, the head over all), then one fused
    updater call updates them all."""

    def __init__(self, stage_fn: Callable, head_fn: Callable, mesh, *,
                 num_microbatches: int, axis: str = "pipe", updater=None,
                 listeners=(), checkpointer=None,
                 checkpoint_every: int = 50, device=None):
        from deeplearning4j_tpu_torch.environment import resolve_device
        from deeplearning4j_tpu_torch.nn.updater import Sgd, get_updater

        self.stage_fn = stage_fn
        self.head_fn = head_fn
        self.mesh = mesh
        self.axis = axis
        self.num_microbatches = num_microbatches
        self.device = resolve_device(device if device is not None else
                                     getattr(mesh, "_dl4j_device", None))
        self.updater = (get_updater(updater) if updater is not None
                        else Sgd(learning_rate=0.1))
        self.listeners = list(listeners)
        self.checkpointer = checkpointer
        self.checkpoint_every = checkpoint_every
        self.step_count = 0
        self.epoch_count = 0
        self.stacked_params = None
        self.head_params = None
        self.opt_state = None
        self.score = float("nan")
        self._groups = mesh_groups(mesh)
        self._fwd = pipeline_forward(stage_fn, mesh,
                                     num_microbatches=num_microbatches,
                                     axis=axis)

    # ------------------------------------------------------------- builders
    @classmethod
    def from_confs(cls, block_confs, head_fn: Callable, input_feats, mesh,
                   *, num_microbatches: int, n_stages=None, seed: int = 0,
                   head_params=None, axis: str = "pipe", device=None,
                   **kw) -> "PipelineParallelTrainer":
        """A stage made of layer configurations (e.g. a transformer block
        as ``SelfAttentionLayer`` + ``DenseLayer``), the same on every
        stage with its own weights (drawn from ``seed`` and the stage
        index). ``input_feats``: a feed-forward width or an
        ``InputType``."""
        from deeplearning4j_tpu_torch.environment import resolve_device
        from deeplearning4j_tpu_torch.nn import conf as C
        from deeplearning4j_tpu_torch.nn.layers import build_layer

        dev = resolve_device(device if device is not None else
                             getattr(mesh, "_dl4j_device", None))
        groups = mesh_groups(mesh)
        n_stages = n_stages or groups.shape[axis]
        in_type = (input_feats if isinstance(input_feats, C.InputType)
                   else C.InputType.feed_forward(input_feats))
        b = C.builder().seed(seed).list()
        for lc in block_confs:
            b.layer(lc)
        built = b.set_input_type(in_type).build()
        itype = built.input_type
        impls = []
        for lc in built.layers:
            impl = build_layer(built, lc, itype, dev)
            impls.append(impl)
            itype = impl.otype
        if itype.flat_size() != in_type.flat_size():
            raise ValueError(
                f"pipeline stages must be shape-preserving: block maps "
                f"{in_type.flat_size()} -> {itype.flat_size()} features")

        def stage_fn(stage_params, x):
            for impl, p in zip(impls, stage_params):
                x, _, _ = impl.apply(p, x, impl.init_state(), train=True,
                                     rng=None, mask=None)
            return x

        per_stage = []
        for s in range(n_stages):
            gen = torch.Generator().manual_seed(seed * 1000003 + s)
            per_stage.append([impl.init(gen) for impl in impls])
        trainer = cls(stage_fn, head_fn, mesh,
                      num_microbatches=num_microbatches, axis=axis,
                      device=dev, **kw)
        trainer.init_params(stack_stage_params(per_stage), head_params or {})
        return trainer

    def init_params(self, stacked_params, head_params) -> None:
        """``stacked_params``: the whole stack (a leading axis of the stage
        count; the rank keeps its slice) or the rank's slice already;
        numpy arrays or tensors."""
        from deeplearning4j_tpu_torch.models._tree import params_from_numpy

        stacked = params_from_numpy(stacked_params, self.device)
        n, i = self._groups.size(self.axis), self._groups.index(self.axis)
        first = next(t for _, t in leaf_paths(stacked))
        if first.shape[0] == n and n > 1:
            stacked = map_tree(lambda t: t[i:i + 1].clone(), stacked)
        self.stacked_params = stacked
        self.head_params = params_from_numpy(head_params, self.device)
        self.opt_state = map_tree(self.updater.init_state,
                                  [self.stacked_params, self.head_params])

    # -------------------------------------------------------------- training
    def loss_fn(self, stacked_params, head_params, x, y):
        return self.head_fn(head_params, self._fwd(stacked_params, x), y)

    def _context(self):
        specs = {path_key((0,) + path):
                 P(self.axis, *([None] * (t.ndim - 1)))
                 for path, t in leaf_paths(self.stacked_params)}
        return StepContext(self._groups, specs)

    def fit_step(self, x, y) -> float:
        """One step: the loss and gradients through the pipeline, the
        gradient all-reduce, the updater, the listeners and the periodic
        checkpoint. Returns the loss (the mean of the ranks')."""
        from deeplearning4j_tpu_torch.autodiff.samediff import canonical

        x, y = canonical(x, self.device), canonical(y, self.device)
        params = [self.stacked_params, self.head_params]
        leaves = map_tree(lambda t: t.detach().requires_grad_(True), params)
        loss = self.loss_fn(leaves[0], leaves[1], x, y)
        paths = [p for p, _ in leaf_paths(leaves)]
        grads = torch.autograd.grad(loss, [t for _, t in leaf_paths(leaves)],
                                    allow_unused=True)
        grads = rebuild(leaves, {
            p: g if g is not None else torch.zeros_like(t)
            for p, g, (_, t) in zip(paths, grads, leaf_paths(leaves))})
        ctx = self._context() if self._groups.world > 1 else None
        with torch.no_grad():
            if ctx is not None:
                grads = ctx.reduce_gradients(grads)
                loss = ctx.mean_loss(loss)
            step = torch.tensor(self.step_count, dtype=torch.int32,
                                device=self.device)
            flat_p = [t for _, t in leaf_paths(params)]
            flat_g = [t for _, t in leaf_paths(grads)]
            flat_s = [self._state_at(path) for path in paths]
            new_p, new_s = self.updater.apply_fused_many(
                flat_p, flat_g, flat_s, self.updater.lr(step), step)
            params = rebuild(params, dict(zip(paths, new_p)))
            self.opt_state = rebuild(params, dict(zip(paths, new_s)))
        self.stacked_params, self.head_params = params
        score = float(loss)
        self.score = score
        self.step_count += 1
        for lst in self.listeners:
            lst.iteration_done(self, self.step_count, 0, score)
        if (self.checkpointer is not None
                and self.step_count % self.checkpoint_every == 0):
            self.checkpointer.save(self.step_count, self)
        return score

    def _state_at(self, path):
        tree = self.opt_state
        for k in path:
            tree = tree[k]
        return tree

    def fit(self, x, y, steps: int = 1) -> List[float]:
        return [self.fit_step(x, y) for _ in range(steps)]

    # ---- the TrainingCheckpointer / listener protocol (net-like view) ----
    @property
    def params(self):
        return [self.stacked_params, self.head_params]

    @params.setter
    def params(self, value):
        self.stacked_params, self.head_params = value

    @property
    def net_state(self):
        return {}

    @net_state.setter
    def net_state(self, value):
        pass

    @property
    def iteration_count(self):
        return self.step_count

    @iteration_count.setter
    def iteration_count(self, value):
        self.step_count = int(value)
