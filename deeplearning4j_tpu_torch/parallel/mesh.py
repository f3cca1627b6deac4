"""Device-mesh data, tensor and expert parallelism: ``make_mesh``, the
sharding rules, ``ParallelWrapper`` and ``ParallelInference``.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. The JAX package is
single-controller: one process drives every device of a
``jax.sharding.Mesh`` and GSPMD partitions one jitted step over it. The
port is multi-controller: one process a device, joined by
``torch.distributed`` (``parallel/launch.py`` brings the group up), each
computing its rank's share; the exchanges GSPMD inserts are the calls of
``ops/collectives.py``.

* :func:`make_mesh` — a ``torch.distributed.device_mesh.DeviceMesh`` over
  the initialized world with the JAX axis names (default ``{"data":
  world}``), its process groups made once (``collectives.MeshGroups``).
  With no process group up it is a world of one on the default device,
  and nothing is ever exchanged.
* :data:`DEFAULT_TP_RULES`, :func:`moe_ep_rules`, :func:`param_specs`
  and :func:`shard_params` — the JAX (regex → PartitionSpec) rules, mapped
  onto explicit per-rank shards: a rank holds only its chunk of a sharded
  leaf (chunks along each sharded dim, in the order of the ranks along its
  axes); a spec that does not divide the leaf is replicated, loudly.
* :class:`ParallelWrapper` — each rank feeds its own rows of the global
  batch (ranks that share a ``data`` coordinate feed the same rows) and
  runs the network's own training step inside a
  :class:`~deeplearning4j_tpu_torch.ops.collectives.StepContext`: sharded
  leaves gathered for the forward, batch statistics, mixture-of-experts
  capacity and the masked-loss counts taken over the global batch, the
  gradients all-reduced before the updater, which every rank then runs
  on its own leaves (the fused updater kernel on the card). The result
  equals the one-device step on the global batch. On one rank no context
  is set: ``fit`` runs exactly the network's own (captured) step.
* :class:`ParallelInference` — batched serving with a request queue and a
  dynamic-batching thread; the forward padded to ``max_batch`` rows is one
  ``CapturedUnit``, captured once per input shape and replayed.
"""

from __future__ import annotations

import logging
import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, ListDataSetIterator)
from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.ops import collectives
from deeplearning4j_tpu_torch.ops.collectives import (
    StepContext, mesh_groups, path_key, spec_axes)

logger = logging.getLogger(__name__)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a leaf dim, an axis name,
    a tuple of axis names or None (not sharded)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def make_mesh(axes: Optional[Dict[str, int]] = None, device=None):
    """A ``DeviceMesh`` with axes of these sizes, e.g. ``{"data": 2,
    "expert": 2}`` (row-major over the ranks; default: every rank on one
    ``data`` axis). The axis sizes must multiply to the world size, as
    the JAX package's must to the device count. ``device``: where the
    rank's tensors live (the card unless the caller passes the CPU); with
    no process group up the mesh is a world of one on it."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    axes = dict(axes or {"data": world})
    total = int(math.prod(axes.values()))
    if total != world:
        raise ValueError(f"mesh axes {axes} need {total} devices, have "
                         f"{world}")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    names, shape = tuple(axes), tuple(axes.values())
    if dist.is_initialized():
        mesh = init_device_mesh(dev.type, shape, mesh_dim_names=names)
    else:
        mesh = DeviceMesh(dev.type, torch.zeros(shape, dtype=torch.int),
                          mesh_dim_names=names, _init_backend=False,
                          _rank=0)
    mesh._dl4j_device = dev
    mesh_groups(mesh)
    return mesh


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` (``jax.sharding.Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# ---------------------------------------------------------------------------
# Sharding rules (regex on the leaf path -> PartitionSpec)
# ---------------------------------------------------------------------------

# Megatron-style column/row pairs, conv output channels, and everything
# else replicated (JAX mesh.py:62)
DEFAULT_TP_RULES: List[Tuple[str, PartitionSpec]] = [
    (r".*/(Wq|Wk|Wv|W1)$", P(None, "model")),   # column-parallel
    (r".*/(Wo|W2)$", P("model", None)),          # row-parallel
    (r".*/(bq|bk|bv|b1)$", P("model")),
    (r".*/W$", P(None, None, None, "model")),    # conv HWIO: out channels
    (r".*/RW$", P(None, "model")),
    (r".*", P()),                                 # everything else replicated
]


def moe_ep_rules(axis: str = "expert") -> List[Tuple[str, PartitionSpec]]:
    """Expert-parallel rules for ``MoELayer`` leaves (leading expert axis
    sharded over ``axis``); prepend to :data:`DEFAULT_TP_RULES` or use
    alone (JAX mesh.py:76)."""
    return [
        (r".*/(We1|We2)$", P(axis, None, None)),
        (r".*/(be1|be2)$", P(axis, None)),
        (r".*/Weg$", P()),
    ]


def _spec_for(path: str, rules) -> PartitionSpec:
    for pat, spec in rules:
        if re.fullmatch(pat, path):
            return spec
    return P()


def _leaves(tree):
    from deeplearning4j_tpu_torch.models._tree import leaf_paths

    return list(leaf_paths(tree))


def param_specs(params, mesh, rules=None) -> Dict[str, PartitionSpec]:
    """The spec of each leaf of ``params`` that the rules shard, by path
    string (``/0/W``, ``/moe/We1``; replicated leaves are left out). A
    rule of the form P(None, ..., axis) shards the last dim whatever the
    leaf's rank; a spec that does not divide its leaf falls back to
    replication, with a warning (JAX mesh.py:107)."""
    rules = list(rules or [(r".*", P())])
    shape = mesh_shape(mesh)
    specs = {}
    for path, leaf in _leaves(params):
        key = path_key(path)
        spec = _spec_for(key, rules)
        nd = leaf.ndim
        if (len(spec) and len(spec) != nd and spec[-1] is not None
                and all(a is None for a in spec[:-1])):
            spec = P(*([None] * (nd - 1) + [spec[-1]])) if nd else P()
        ok = True
        for dim, entry in enumerate(spec):
            axes = spec_axes(entry)
            if not axes:
                continue
            size = math.prod(shape[a] for a in axes)
            if dim >= nd or leaf.shape[dim] % size != 0:
                ok = False
        if not ok and any(spec_axes(e) for e in spec):
            logger.warning(
                "TP: param %s shape %s not divisible by spec %s on mesh %s "
                "— replicating this leaf", key, tuple(leaf.shape), spec,
                shape)
        if ok and any(math.prod(shape[a] for a in spec_axes(e)) > 1
                      for e in spec):
            specs[key] = P(*spec)
    return specs


def _chunk(t: torch.Tensor, spec, groups) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            t = t.chunk(groups.size(axes), dim=dim)[groups.index(axes)]
    return t.clone()


def _gather(t: torch.Tensor, spec, groups) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            t = collectives.all_gather(t, groups, axes, dim)
    return t


def _map_specs(tree, specs, fn, prefix=()):
    """``tree`` with ``fn(leaf, spec)`` at each leaf whose path has a spec
    (an updater state dict below a leaf takes the leaf's spec for each
    tensor of the leaf's shape)."""
    if isinstance(tree, dict):
        return {k: _map_specs(v, specs, fn, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(v, specs, fn, prefix + (i,))
                for i, v in enumerate(tree)]
    for cut in range(len(prefix), 0, -1):
        spec = specs.get(path_key(prefix[:cut]))
        if spec is not None:
            return fn(tree, spec) if tree.ndim == len(spec) else tree
    return tree


def shard_params(params, mesh, rules=None):
    """``params`` with each leaf the rules shard cut to this rank's chunk
    (:func:`param_specs`); replicated leaves are returned as they are."""
    specs = param_specs(params, mesh, rules)
    groups = mesh_groups(mesh)
    return _map_specs(params, specs, lambda t, s: _chunk(t, s, groups))


def gather_params(params, mesh, specs):
    """The inverse of :func:`shard_params`: every rank's chunks of each
    sharded leaf gathered whole (a collective: every rank calls it)."""
    groups = mesh_groups(mesh)
    with torch.no_grad():
        return _map_specs(params, specs, lambda t, s: _gather(t, s, groups))


# ---------------------------------------------------------------------------
# ParallelWrapper
# ---------------------------------------------------------------------------


class _Batch:
    """One step's tensors on the device and whether the data ranks hold
    different rows (False: a ragged batch run replicated)."""

    def __init__(self, ds, x, y, fm, lm, split=True):
        self.ds, self.x, self.y, self.fm, self.lm = ds, x, y, fm, lm
        self.split = split


class ParallelWrapper:
    """Data-parallel (and tensor / expert-parallel) trainer over a mesh
    (module docstring; ParallelWrapper.java). Usage, on every rank::

        pw = ParallelWrapper(net, mesh=make_mesh({"data": 8}))
        pw.fit(iterator, epochs=3)        # the rank's rows of each batch

    ``tp_rules`` shard selected leaves (:data:`DEFAULT_TP_RULES`,
    :func:`moe_ep_rules`); the network holds its rank's shards during
    ``fit`` and the whole leaves again after it. ``prefetch``: batches
    placed on the device ahead of the step (the double buffer)."""

    def __init__(self, net, mesh=None, tp_rules=None, prefetch: int = 2):
        self.net = net
        self.mesh = mesh if mesh is not None else make_mesh(
            device=net.device)
        self.tp_rules = tp_rules
        self.prefetch = prefetch
        self._is_graph = hasattr(net.conf, "network_inputs")
        self._groups = mesh_groups(self.mesh)
        self._warned_ragged = False

    # ------------------------------------------------------------- the data
    def _place(self, arr):
        """A host array as the step's tensor on the net's device; a copy
        from pinned memory that does not wait on the card."""
        if arr is None:
            return None
        from deeplearning4j_tpu_torch.autodiff.samediff import canonical

        t = canonical(arr)
        dev = self.net.device
        if dev.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    def _data_axes(self):
        if "data" not in self._groups.shape:
            return ()
        return self._groups.axes("data")

    def _ragged(self, rows: int) -> bool:
        """Whether the data ranks' batches differ in size (a collective of
        one number a rank)."""
        axes = self._data_axes()
        if not axes:
            return False
        mine = torch.tensor([rows], dtype=torch.int64, device=self.net.device)
        sizes = collectives.all_gather(mine, self._groups, axes).tolist()
        return len(set(sizes)) > 1

    def _gathered(self, arr):
        """Every data rank's rows of ``arr`` concatenated in data order
        (rows padded to the largest for the exchange)."""
        if arr is None:
            return None
        axes = self._data_axes()
        t = self._place(arr)
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
        sizes = collectives.all_gather(n, self._groups, axes).tolist()
        most = max(sizes)
        pad = t.new_zeros((most - t.shape[0],) + tuple(t.shape[1:]))
        every = collectives.all_gather(torch.cat([t, pad]), self._groups,
                                       axes)
        return torch.cat([every[i * most:i * most + s]
                          for i, s in enumerate(sizes)])

    def _batch(self, ds) -> _Batch:
        feats = ds.features
        many = isinstance(feats, (list, tuple))
        put, split = self._place, True
        rows = int(np.shape(feats[0] if many else feats)[0])
        if self._ragged(rows):
            if not self._warned_ragged:
                self._warned_ragged = True
                logger.warning(
                    "ParallelWrapper: the data ranks' batches differ in size "
                    "(this rank %d rows, %d data ranks) — this batch runs "
                    "REPLICATED via an all-gather of the shards (correct, "
                    "but no DP speedup). Size batches equally.", rows,
                    self._groups.size(self._data_axes()))
            put, split = self._gathered, False
        return _Batch(ds, [put(f) for f in feats] if many else put(feats),
                      put(ds.labels), put(ds.features_mask),
                      put(ds.labels_mask), split)

    def _double_buffered(self, data):
        """Batch i + 1 placed on the device before batch i is yielded: the
        copy of the next batch overlaps the current step (JAX
        mesh.py:248)."""
        queue: List[_Batch] = []
        for ds in data:
            queue.append(self._batch(ds))
            if len(queue) >= max(1, self.prefetch):
                yield queue.pop(0)
        yield from queue

    # ------------------------------------------------------------- the step
    def _specs(self) -> Dict[str, PartitionSpec]:
        if not self.tp_rules:
            return {}
        return param_specs(self.net.params, self.mesh, self.tp_rules)

    def _shard(self, specs) -> None:
        net = self.net
        if net.conf.gradient_normalization:
            raise ValueError(
                "gradient normalization takes a layer's whole gradient: "
                "it is not supported with sharded leaves (tp_rules)")
        cut = lambda t, s: _chunk(t, s, self._groups)  # noqa: E731
        net.params = _map_specs(net.params, specs, cut)
        net.opt_state = _map_specs(net.opt_state, specs, cut)

    def _unshard(self, specs) -> None:
        net = self.net
        net.params = gather_params(net.params, self.mesh, specs)
        net.opt_state = gather_params(net.opt_state, self.mesh, specs)

    def _context(self, specs, split: bool) -> Optional[StepContext]:
        if self._groups.world == 1:
            return None
        return StepContext(self._groups, specs, split=split)

    def _step(self, b: _Batch):
        net = self.net
        if self._is_graph:
            ins = net.conf.network_inputs
            out = net.conf.network_outputs[0]
            feats = b.x if isinstance(b.x, list) else [b.x]
            return net._train_step(
                dict(zip(ins, feats)), {out: b.y},
                None if b.fm is None else {ins[0]: b.fm},
                None if b.lm is None else {out: b.lm})
        return net._train_step(b.x, b.y, b.fm, b.lm)[0]

    def lower_step_hlo(self, features, labels) -> str:
        """The collectives one training step issues on this mesh, one line
        each — ``op over axes: dtype[shape]`` — in the order issued (the
        JAX package returns the compiled HLO, whose all-reduce /
        all-to-all lines tests read the same way). The step runs once on a
        copy of the network's state, which is then put back. One rank
        issues none."""
        net = self.net
        lines = [f"step collectives on mesh {mesh_shape(self.mesh)}"]
        if self._groups.world == 1:
            return "\n".join(lines + ["(one rank: none)"])
        from deeplearning4j_tpu_torch.models._tree import map_tree

        clone = lambda tree: map_tree(lambda t: t.clone(), tree)  # noqa
        saved = (clone(net.params), clone(net.opt_state),
                 clone(net.net_state), net.iteration_count,
                 net._gen.get_state())
        specs = self._specs()
        if specs:
            self._shard(specs)
        ctx = StepContext(self._groups, specs)
        try:
            with collectives.use(ctx):
                self._step(self._batch(DataSet(np.asarray(features),
                                               np.asarray(labels))))
        finally:
            (net.params, net.opt_state, net.net_state, net.iteration_count,
             gen) = saved
            net._gen.set_state(gen)
        for op, axes, shape, dtype in ctx.record:
            lines.append(f"{op} over {','.join(axes)}: {dtype}{list(shape)}")
        return "\n".join(lines)

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            checkpointer=None, checkpoint_every: int = 0) -> None:
        """Train on this rank's rows of each batch (a ``DataSet`` is cut
        into ``batch_size`` batches). ``checkpointer`` (a
        ``TrainingCheckpointer``) and ``checkpoint_every`` N iterations:
        every N steps the whole state is gathered and rank 0 saves it, so
        a relaunched job resumes mid-fit (JAX mesh.py:291)."""
        net = self.net
        if isinstance(data, DataSet):
            data = ListDataSetIterator(data, batch_size=batch_size)
        specs = self._specs()
        if specs:
            self._shard(specs)
        try:
            for _ in range(epochs):
                for lst in net.listeners:
                    lst.on_epoch_start(net)
                for b in self._double_buffered(data):
                    net.last_batch_size = b.ds.num_examples()
                    with collectives.use(self._context(specs, b.split)):
                        loss = self._step(b)
                    net._score = loss
                    net.iteration_count += 1
                    if (checkpointer is not None and checkpoint_every
                            and net.iteration_count % checkpoint_every == 0):
                        self._checkpoint(checkpointer, specs)
                    for lst in net.listeners:
                        lst.iteration_done(net, net.iteration_count,
                                           net.epoch_count, loss)
                net.epoch_count += 1
                for lst in net.listeners:
                    lst.on_epoch_end(net)
        finally:
            if specs:
                self._unshard(specs)

    def _checkpoint(self, checkpointer, specs) -> None:
        net = self.net
        shards = (net.params, net.opt_state)
        if specs:
            self._unshard(specs)
        try:
            if not dist.is_initialized() or dist.get_rank() == 0:
                checkpointer.save(net.iteration_count, net)
        finally:
            net.params, net.opt_state = shards


# ---------------------------------------------------------------------------
# ParallelInference
# ---------------------------------------------------------------------------


class ParallelInference:
    """Batched serving (ParallelInference.java; JAX mesh.py:358).

    * ``output(x)`` — a direct batched call: on several ranks each runs its
      data share of the rows and the outputs are gathered, so every rank
      returns the whole.
    * the serving loop (``start()`` / ``predict(x)`` / ``stop()``) — a
      request queue and a thread batching up to ``max_batch`` rows or
      ``window_ms``; one forward a batch, padded to ``max_batch`` rows so
      every call replays one captured graph; replies scattered to their
      callers. On several ranks each serves its own clients.

    ``predict`` is thread-safe; concurrent clients each get their own rows
    back. The padded forward is the ``CapturedUnit`` ``unit`` (key
    ``serve`` of the recompile ledger's graph ``parallel``)."""

    def __init__(self, net, mesh=None, *, max_batch: int = 32,
                 window_ms: float = 3.0):
        from deeplearning4j_tpu_torch.ops.capture import CapturedUnit

        self.net = net
        self.mesh = mesh if mesh is not None else make_mesh(
            device=net.device)
        self._is_graph = hasattr(net.conf, "network_inputs")
        self.max_batch = int(max_batch)
        self.window_ms = float(window_ms)
        self.unit = CapturedUnit(self._forward, device=net.device,
                                 name="serve")
        self._queue = None
        self._worker = None
        self._stop = False
        self._obs = None  # serving instruments, resolved once in start()

    @staticmethod
    def generative(model, **engine_kwargs):
        """Facade to the continuous-batching generative tier: a
        :class:`~deeplearning4j_tpu_torch.serving.GenerativeEngine` over a
        decoder model, with the same lifecycle shape as this class
        (``start`` / ``submit`` / ``stop``)."""
        from deeplearning4j_tpu_torch.serving import GenerativeEngine

        return GenerativeEngine(model, **engine_kwargs)

    # ----------------------------------------------------------- the forward
    def _forward(self, x):
        from deeplearning4j_tpu_torch.nn import dtype as DT

        net = self.net
        with torch.no_grad(), DT.precision_scope(net.conf.dtype):
            if self._is_graph:
                ins = net.conf.network_inputs[0]
                acts, _ = net._forward(net.params, net.net_state, {ins: x},
                                       None, train=False)
                return acts[net.conf.network_outputs[0]]
            out, _ = net._forward(net.params, net.net_state, x, None,
                                  train=False, rng=None)
            return out

    def _run_padded(self, data: np.ndarray) -> np.ndarray:
        """The forward over ``data`` in chunks of ``max_batch`` rows, the
        last padded with its last row: every chunk one replay of the unit
        (one capture a row shape)."""
        from deeplearning4j_tpu_torch.autodiff.samediff import canonical
        from deeplearning4j_tpu_torch.models._tree import leaf_paths
        from deeplearning4j_tpu_torch.nn.dtype import host_array

        n = data.shape[0]
        pad = (-n) % self.max_batch
        if pad:
            data = np.concatenate([data, np.repeat(data[-1:], pad, axis=0)])
        net = self.net
        reads = [t for tree in (net.params, net.net_state)
                 for _, t in leaf_paths(tree)]
        outs = []
        for i in range(0, data.shape[0], self.max_batch):
            chunk = canonical(data[i:i + self.max_batch], net.device)
            observe.note_jit_signature(
                self.unit, graph="parallel", key="serve",
                signature=observe.signature_of(x=chunk))
            outs.append(host_array(self.unit(chunk, key="serve",
                                             reads=reads)))
        return np.concatenate(outs)[:n]

    def output(self, x) -> np.ndarray:
        x = np.asarray(x)
        groups = mesh_groups(self.mesh)
        axes = groups.axes("data") if "data" in groups.shape else ()
        if not axes:
            return self._run_padded(x)
        d = groups.size(axes)
        rows = -(-x.shape[0] // d)
        pad = rows * d - x.shape[0]
        full = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)]) \
            if pad else x
        i = groups.index(axes)
        mine = torch.from_numpy(np.ascontiguousarray(
            self._run_padded(full[i * rows:(i + 1) * rows])))
        mine = mine.to(self.net.device)
        every = collectives.all_gather(mine, groups, axes)
        return every.cpu().numpy()[:x.shape[0]]

    # ------------------------------------------------------------- serving
    def start(self) -> "ParallelInference":
        import queue as _queue
        import threading

        if self._worker is not None:
            return self
        m = observe.metrics()
        self._obs = {
            "requests": m.counter("dl4j_tpu_serving_requests_total"),
            "request_h": m.histogram("dl4j_tpu_serving_request_seconds"),
            "wait_h": m.histogram("dl4j_tpu_serving_queue_wait_seconds"),
            "batch_h": m.histogram("dl4j_tpu_serving_batch_seconds"),
            "occupancy_h": m.histogram("dl4j_tpu_serving_batch_occupancy"),
            "batches": m.counter("dl4j_tpu_serving_batches_total"),
            "rows": m.counter("dl4j_tpu_serving_rows_total"),
            "depth": m.gauge("dl4j_tpu_serving_queue_depth"),
        }
        self._queue = _queue.Queue()
        self._stop = False
        # an injected backend failure at start surfaces here, not as a
        # serving loop the first predict() waits on forever
        faults.maybe_fail("backend_init_fail")
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self._worker.start()
        return self

    def stop(self) -> None:
        import queue as _queue

        self._stop = True
        if self._worker is not None:
            self._queue.put(None)  # wake the worker
            self._worker.join(timeout=10)
            self._worker = None
            # fail still-queued requests so blocked predict() callers wake
            while True:
                try:
                    item = self._queue.get_nowait()
                except _queue.Empty:
                    break
                if item is not None and not item[1].done():
                    item[1].set_exception(
                        RuntimeError("ParallelInference stopped before this "
                                     "request was served"))

    def predict(self, x) -> np.ndarray:
        """One example (features without the batch dim) or a small batch
        through the batching queue; returns its output rows. Every request
        lands in ``dl4j_tpu_serving_requests_total`` and its enqueue →
        reply latency in ``dl4j_tpu_serving_request_seconds``, on the
        client's thread."""
        import time as _time
        from concurrent.futures import Future

        if self._worker is None:
            raise RuntimeError("serving loop not running — call start()")
        x = np.asarray(x)
        fut = Future()
        t0 = _time.perf_counter()
        self._queue.put((x, fut, t0))
        try:
            return fut.result()
        finally:
            self._obs["requests"].inc()
            self._obs["request_h"].observe(_time.perf_counter() - t0)

    def _serve_loop(self) -> None:
        import queue as _queue
        import time as _time

        depth_g = self._obs["depth"]
        while not self._stop:
            try:
                first = self._queue.get(timeout=0.1)
            except _queue.Empty:
                continue
            if first is None:
                continue
            batch = [first]
            rows = self._rows(first[0])
            deadline = _time.monotonic() + self.window_ms / 1e3
            while rows < self.max_batch:
                timeout = deadline - _time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._queue.get(timeout=timeout)
                except _queue.Empty:
                    break
                if item is None:
                    continue
                batch.append(item)
                rows += self._rows(item[0])
            depth_g.set(self._queue.qsize())
            self._run_batch(batch)

    def _rows(self, x) -> int:
        return x.shape[0] if x.ndim == self._req_ndim() else 1

    def _req_ndim(self) -> int:
        # a batched request's rank (a single example has one dim less)
        conf = self.net.conf
        itype = (conf.input_types.get(conf.network_inputs[0])
                 if self._is_graph else getattr(conf, "input_type", None))
        kind = getattr(itype, "kind", "") if itype is not None else ""
        return {"convolutional": 4, "convolutional3d": 5,
                "recurrent": 3}.get(kind, 2)

    def _run_batch(self, batch) -> None:
        import time as _time

        try:
            # a backend worker dying mid-batch: every future of the batch
            # gets the exception, the loop survives for the next batch
            faults.maybe_fail("backend_init_fail")
            t_dispatch = _time.perf_counter()
            obs = self._obs
            xs, futs, sizes = [], [], []
            for x, fut, t_enq in batch:
                obs["wait_h"].observe(t_dispatch - t_enq)
                xb = x if x.ndim == self._req_ndim() else x[None]
                xs.append(xb)
                futs.append(fut)
                sizes.append(xb.shape[0])
            data = np.concatenate(xs, axis=0)
            n = data.shape[0]
            obs["batches"].inc()
            obs["rows"].inc(n)
            # filled rows over the padded rows run
            slots = -(-n // self.max_batch) * self.max_batch
            obs["occupancy_h"].observe(n / slots)
            out = self._run_padded(data)
            t_done = _time.perf_counter()
            obs["batch_h"].observe(t_done - t_dispatch)
            observe.tracer().complete_between(
                "serving_batch", t_dispatch, t_done, category="serving",
                rows=n, requests=len(batch))
            observe.log_event("serving_batch", rows=n, requests=len(batch),
                              batch_seconds=round(t_done - t_dispatch, 6))
            off = 0
            for fut, sz in zip(futs, sizes):
                fut.set_result(out[off:off + sz])
                off += sz
        except Exception as e:  # every caller of the batch gets it
            for _, fut, _t in batch:
                if not fut.done():
                    fut.set_exception(e)
