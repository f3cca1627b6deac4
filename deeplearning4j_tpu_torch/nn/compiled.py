"""Compiled training: the trainers' counterpart of ``jax.jit(train_step,
donate_argnums=...)``.

The JAX package jits every training step (``MultiLayerNetwork`` and
``ComputationGraph`` ``_make_train_step``, BERT's ``_cls_step`` /
``_mlm_step``, SameDiff's ``_train_step_fn`` and ``calculate_gradients``)
and scans many steps in one call (``fit_scanned``, ``fit_mlm_scanned``).
In the port each trainer keeps a :class:`TrainUnits`: one
:class:`~deeplearning4j_tpu_torch.ops.capture.CapturedUnit` per step key,
captured once per batch signature on the card and replayed after, eager
on the CPU and under ``disable_capture()``. The scanned entry points
replay their unit once a step with no host read between steps and read
the chunk's losses back once.

What a training unit needs that an inference unit does not:

* **The iteration on the device.** :class:`DeviceIteration` holds it as an
  int32 0-d tensor beside the trainer's Python count; the learning rate,
  the schedules and the updater's coefficients are computed from it on
  the device (``nn/updater.py``), and the step adds one to it in place. A
  count the caller changed (a restore, a test) is written into it before
  the next step.
* **Donated state.** On the card the step writes its parameters, updater
  state, layer state and iteration in place (``donate``); they are the
  unit's ``state`` (``CapturedUnit``), whose addresses join the signature
  and whose versions move after every replay. On the CPU the step returns
  new tensors and the trainer rebinds them, as JAX ignores donation
  there.
* **Live randomness.** The trainer's generators are registered with every
  graph, so each replay draws new dropout masks, the same ones the eager
  steps draw.
* **The copied-out loss.** A replay overwrites its outputs; :meth:`run`
  returns copies unless the caller copies them out itself (the scanned
  loops write each step's loss into the chunk's device vector).
* **Routing.** A step that must read the host (the masked cuDNN LSTM reads
  its mask's lengths, a SameDiff while loop or conditional its
  predicate) is routed to eager by a rule the trainer decides
  from the configuration and the feeds before any capture — never by
  catching a failed capture. The ledger records the routing once per
  (key, signature, reason) (``RecompileLedger.routed``) and
  ``dl4j_tpu_capture_skipped_total{unit,reason}`` counts each routed step.

Each unit reports one ``first_compile`` per key and ``new_shape`` per
further signature to the recompile ledger (``observe.note_jit_signature``),
as the JAX package's jitted steps do, and ``state_moved`` for a capture
that only moved donated or read tensors called for (a trainer that
rebound its state instead of writing into it).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.capture import CapturedUnit


class DeviceIteration:
    """A trainer's iteration as an int32 0-d tensor on its device."""

    def __init__(self, device):
        self.tensor = torch.zeros((), dtype=torch.int32, device=device)
        self._holds = 0  # what the tensor holds once the queued steps ran

    def at(self, count: int) -> torch.Tensor:
        """The tensor, holding ``count`` (written first when the trainer's
        count moved without a step: a restore, a caller's assignment)."""
        if count != self._holds:
            self.tensor.fill_(count)
            self._holds = count
        return self.tensor

    def advanced(self, n: int = 1) -> None:
        """The queued steps added ``n`` to the tensor in place."""
        self._holds += n


def donates(device) -> bool:
    """Whether a trainer on ``device`` updates its state in place: on the
    card, where its buffers are a captured graph's static state."""
    return torch.device(device).type == "cuda"


def commit(old, new):
    """The state tree ``new`` a step computed, committed onto ``old``:
    each tensor copied into the old tensor of its place (kept as it is
    when the step returned that very tensor), so the addresses a captured
    graph reads stay put. A leaf without an old tensor of its shape and
    dtype is taken as new."""
    if isinstance(new, dict):
        old = old if isinstance(old, dict) else {}
        return {k: commit(old.get(k), v) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        old = old if isinstance(old, (list, tuple)) and len(old) == len(
            new) else [None] * len(new)
        return type(new)(commit(o, n) for o, n in zip(old, new))
    if (isinstance(new, torch.Tensor) and isinstance(old, torch.Tensor)
            and old is not new and old.shape == new.shape
            and old.dtype == new.dtype and old.device == new.device):
        old.copy_(new.detach())
        return old
    return new.detach() if isinstance(new, torch.Tensor) else new


def tensors_of(*trees) -> list:
    """Every tensor leaf of the trees (dicts in sorted-key order, lists
    and tuples in order)."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            out.append(t)

    for tree in trees:
        walk(tree)
    return out


class TrainUnits:
    """A trainer's compiled steps (module docstring): ``graph`` names the
    trainer in the recompile ledger (``"mln"``, ``"graph"``, ``"bert"``,
    ``"samediff"``); ``generators`` are the ``torch.Generator`` objects its
    steps draw from."""

    def __init__(self, device, graph: str,
                 generators: Sequence[torch.Generator] = ()):
        self.device = torch.device(device)
        self.graph = graph
        self.generators = tuple(generators)
        self.iteration = DeviceIteration(self.device)
        self.units: Dict[str, CapturedUnit] = {}
        self._body: Optional[Callable[..., Any]] = None
        self._position: Optional[torch.Tensor] = None  # a scan's step

    def _call(self, *args):
        return self._body(*args)

    def unit(self, key: str) -> CapturedUnit:
        u = self.units.get(key)
        if u is None:
            u = CapturedUnit(self._call, device=self.device,
                             generators=self.generators, name=key)
            self.units[key] = u
        return u

    def run(self, key: str, body: Callable[..., Any],
            args: Sequence[torch.Tensor], *, layout: Any = (),
            state: Sequence[torch.Tensor] = (),
            reads: Sequence[torch.Tensor] = (), signature: str = "",
            eager_reason: Optional[str] = None, copy_out: bool = True,
            note: Optional[Callable[[CapturedUnit], None]] = None):
        """``body(*args)`` as the unit ``key``: captured on the card (per
        signature: ``layout`` — what ``body`` makes of ``args`` — the
        arguments' shapes and the addresses of the ``state`` tensors it
        writes in place and of the ``reads`` it only reads), eager on the
        CPU, under ``disable_capture()`` and when ``eager_reason`` routes
        it. Returns ``body``'s outputs; replayed outputs are copied unless
        ``copy_out`` is False (they then hold until the unit's next call).
        ``note(unit)`` reports the call to the recompile ledger in the
        trainer's own way (``note_jit_signature`` by default)."""
        from deeplearning4j_tpu_torch import observe

        unit = self.unit(key)
        if note is not None:
            note(unit)
        else:
            observe.note_jit_signature(unit, graph=self.graph, key=key,
                                       signature=signature)
        if eager_reason is not None:
            observe.ledger().routed(graph=self.graph, key=key,
                                    signature=signature, reason=eager_reason)
            observe.metrics().counter("dl4j_tpu_capture_skipped_total",
                                      unit=key, reason=eager_reason).inc()
            return body(*args)
        self._body = body
        try:
            out = unit(*args, key=(key, layout), state=state, reads=reads,
                       ledger=(self.graph, signature))
        finally:
            self._body = None
        if not (copy_out and unit.captured()):
            return out
        if isinstance(out, torch.Tensor):
            return out.clone()
        if isinstance(out, dict):
            return {k: v.clone() for k, v in out.items()}
        return type(out)(t.clone() for t in out)

    def scan(self, key: str, step: Callable[..., torch.Tensor],
             stacks: Sequence[torch.Tensor], n: int, *, per_step: bool,
             state: Callable[[], Sequence[torch.Tensor]], signature: str,
             start: int, batch_size: int,
             advance: Callable[[torch.Tensor], None],
             notify: Optional[Callable[[int, float], None]] = None,
             layout: Any = ()) -> np.ndarray:
        """``n`` steps of ``step(*batch) -> loss`` as the unit ``key``
        from the trainer's iteration ``start``, with no host read between
        them: the counterpart of a ``lax.scan`` over the train step.
        ``per_step``: step k trains on row k of each tensor of ``stacks``
        (staged to the device once; the graph reads the row through the
        unit's position tensor, which it advances), else every step on
        ``stacks`` themselves. ``state()``: the donated tensors of the
        next step; ``layout``: what ``step`` makes of ``stacks``.

        The chunk's epilogue, in this order: the device iteration moves
        by ``n``; ``advance(losses)`` moves the trainer's own count (the
        losses a float32 device vector); the losses are read back, the
        chunk's one host read; ``dl4j_tpu_train_steps_total``,
        ``dl4j_tpu_train_examples_total`` (``batch_size`` a step) and
        ``dl4j_tpu_host_to_device_transfers_total`` (one a stack)
        labelled ``model=graph`` and the span ``fit_scanned`` are
        recorded; ``notify(iteration, loss)`` fires once a step in order,
        with the JAX package's iteration numbers ``start + k + 1``.
        Returns the losses (float32 numpy)."""
        from deeplearning4j_tpu_torch import observe

        self.iteration.at(start)
        t0 = time.perf_counter()
        pos = self._position
        if pos is None:
            pos = self._position = torch.zeros((), dtype=torch.int64,
                                               device=self.device)
        pos.zero_()

        def body(*batch):
            if per_step:
                row = pos.view(1)
                batch = [b.index_select(0, row)[0] for b in batch]
                pos.add_(1)
            return step(*batch)

        losses = torch.empty(n, dtype=torch.float32, device=self.device)
        for k in range(n):
            losses[k] = self.run(key, body, stacks,
                                 layout=(per_step, layout),
                                 state=list(state()) + [pos],
                                 signature=signature, copy_out=False)
        self.iteration.advanced(n)
        advance(losses)
        host = losses.cpu().numpy()  # the chunk's one host read
        m = observe.metrics()
        m.counter("dl4j_tpu_train_steps_total", model=self.graph).inc(n)
        m.counter("dl4j_tpu_train_examples_total", model=self.graph).inc(
            n * batch_size)
        m.counter("dl4j_tpu_host_to_device_transfers_total",
                  model=self.graph).inc(len(stacks))
        observe.tracer().complete_between(
            "fit_scanned", t0, time.perf_counter(), category="train",
            steps=n)
        if notify is not None:
            for k in range(n):
                notify(start + k + 1, float(host[k]))
        return host

    def reset(self) -> None:
        """Drop every unit's graphs and pools."""
        for u in self.units.values():
            u.reset()
        self.units.clear()


# the routing rule's reason: cuDNN's masked LSTM reads the mask's lengths
# on the host (ops/cudnn_lstm.py right_padded_lengths)
MASKED_LSTM = "masked_lstm_reads_host"
# the routing rule's reason of a SameDiff graph holding a while loop or a
# conditional: its predicate is read on the host before it branches
# (autodiff/samediff.py SameDiff._routing)
CONTROL_FLOW = "control_flow_reads_host"
# the routing rule's reason of a SameDiff graph holding a node that seeds a
# fresh generator on every run (an imported ONNX random node): a CUDA-graph
# capture refuses the seeding (autodiff/samediff.py seeds_generator)
SEEDED_RANDOM = "random_node_seeds_generator"


def runs_lstm(layer) -> bool:
    """Whether ``layer`` runs the ``lstm_layer`` op (itself, or the layer
    a Bidirectional or LastTimeStep wrapper holds)."""
    from deeplearning4j_tpu_torch.nn.layers import LSTMImpl

    inner = [getattr(layer, a) for a in ("fwd_layer", "bwd_layer",
                                         "inner_layer") if hasattr(layer, a)]
    return isinstance(layer, LSTMImpl) or any(runs_lstm(x) for x in inner)


def mask_routing(layers, masks) -> Optional[str]:
    """The routing rule of a network's step: :data:`MASKED_LSTM` when a
    features mask is fed to a network that runs an LSTM, else None."""
    if any(m is not None for m in masks) and any(runs_lstm(x)
                                                 for x in layers):
        return MASKED_LSTM
    return None


def flatten_rnn(states):
    """Carried RNN states (a list or name-keyed dict of None, a tensor or
    an (h, c) tuple) as (tensors, spec)."""
    items = states.items() if isinstance(states, dict) else enumerate(states)
    flat, spec = [], []
    for k, st in items:
        if st is None:
            spec.append((k, None))
        elif isinstance(st, tuple):
            spec.append((k, len(st)))
            flat.extend(st)
        else:
            spec.append((k, 0))
            flat.append(st)
    return flat, (isinstance(states, dict), tuple(spec))


def unflatten_rnn(spec, flat):
    """The inverse of :func:`flatten_rnn`."""
    as_dict, entries = spec
    flat = list(flat)
    out = {}
    for k, n in entries:
        if n is None:
            out[k] = None
        elif n == 0:
            out[k] = flat.pop(0)
        else:
            out[k] = tuple(flat.pop(0) for _ in range(n))
    return out if as_dict else [out[k] for k, _ in entries]
